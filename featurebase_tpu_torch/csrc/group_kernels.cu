// Hand-written Hopper kernels for GroupBy (sm_90a).
//
// Two kernels, each behind a plain C launcher that ops/cuda_kernels.py loads
// with ctypes, as it loads csrc/bitmap_kernels.cu and csrc/bsi_kernels.cu.
// Launchers take device pointers and the caller's stream, launch, and return
// a cudaError_t (0 on success); they never synchronise and never allocate.
// Both are one AND-popcount matrix product over every shard of a GroupBy:
//
//   out[g, c] = sum over shards s, over the shard's bits k of
//               A[s, g, k] & B[s, c, k]
//
// pair_counts (kernel E) is the counterpart of the XLA programs
//   featurebase_tpu/ops/bitwise.py stacked_pair_counts (:175) and, at S = 1,
//   count_and_pairs (:123): A holds the masks of one or two dimensions
//   (f_i [& h_j]) [& filter], B the rows of the last dimension.
// bsi_sum_groups (kernel F) is the counterpart of bsi.py sum_groups_stacked
//   (:611) and, at S = 1, sum_groups_kernel (:333): A holds the groups of one
//   to three dimensions (f_i [& g_j [& h_k]]) [& filter], in
//   itertools.product order (the last dimension fastest); B holds the
//   2D + 1 classes of a BSI group: plane p & exists & ~sign (p < D), plane p
//   & exists & sign, and exists.  The host finishes each group's sum.
//
// Operands are read where they live.  Each launch gets a table of row
// addresses, (S, P) uint64: for each shard, the address of every row it may
// read (a dimension's rows, the filter, B's rows or BSI planes) in the
// fragments' device mirrors, 0 for a row the shard lacks, which reads as
// zeros without touching memory.  Neither the group masks nor the classes
// are written anywhere: each is formed in registers, a word at a time, from
// the rows staged in shared memory as the product reads it.
//
// Bound.  Bytes: each staged row is read once a launch (per output region,
// below; the main path's shapes have one).  Operations: G x C x 2^20
// AND-popcounts a shard.  The popcount unit does 16 a clock per SM (the CUDA
// programming guide's throughput table, compute capability 9.0), 4.2e12 a
// second, 1.34e14 bit products; the tensor cores' 1-bit product
// (mma.sync m16n8k256 .b1 .and.popc, 32,768 bit products an instruction)
// does about 39 times that (chip_smoke.py's tc_rate phase measures both),
// so the product runs there alone.  At 128 shards of 131,072-byte rows at
// 3.35 TB/s: GroupBy(f, g) reads 8 + 4 rows a shard, 201 MB, bound by bytes
// at 60 us; a GroupBy+Sum of 8 x 4 groups at D = 14 reads 8 + 4 + 16 rows,
// 470 MB (140 us), and does 3.9e9 popcounts (32 x 29 a column word): 930 us
// on the popcount unit, about 25 us on the tensor cores, so it is bound by
// bytes.
//
// Design.  A persistent grid, about one block per SM (more where the
// occupancy allows), walks the (shard, chunk) tiles of every shard: chunks
// of CW words (32 to 256, the most that fit 100 KB of shared memory, so
// that at least two blocks share an SM), tile t of a
// block then t + gridDim.x.  blockIdx.y picks an output region of 16 MT
// groups x 8 NT classes (MT, NT in {1, 2, 4} x {1, 4}); the main path's
// shapes fit one region.  Each tile:
//   1. stage: the rows the region reads go to shared memory with cp.async
//      (16 bytes when every row address is 16-byte aligned and W % 4 == 0,
//      else 4) into a ring of kStages buffers: the next tile's copies are
//      in flight while this one is prepared and multiplied (a third buffer
//      measured no faster).  Absent rows and words past W are stored as
//      zeros;
//   2. prepare: the filter is ANDed into the first dimension's rows in
//      place, and for F the two sides exists & ~sign and exists & sign are
//      formed once (2 rows), so that a group's word is the AND of one row
//      of each dimension and a class's the AND of a plane and a side;
//   3. multiply on the tensor cores, each lane reading its rows' words
//      straight from shared memory: each warp owns every 16 x 8 tile of the
//      region (register accumulators, indices fixed at compile time) for
//      one in eight of the chunk's 256-bit k-steps, and issues MT x NT
//      mma.sync .b1 .and.popc a step.
// The counters stay in registers over the block's whole run of tiles and
// are reduced once, at its end, through shared memory into 64-bit block
// slots.  Across blocks: per-block slots; the last block of each region to
// finish (an atomic ticket a region, which that block resets, as kernels
// A, C and D reset theirs) adds its region's slots: no memset, and integer
// sums equal in any order.  Counts are int64 at the output.  A block's
// 32-bit counters count at most its tiles x CW x 32 bits; the planner caps a
// block's tiles at (2^31 - 1) / (CW x 32) (2048 shards' worth at CW = 256;
// more shards add blocks), so they never overflow before the flush to
// int64 at the block's end.  D from 1 to 63 shares one build.
// chip_smoke.py also builds it with FB_ABLATE_COPY (no copies: the product
// runs on stale rows) and FB_ABLATE_COMPUTE (no product) to show where a
// launch's time goes; neither build gives right counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 63;
constexpr int kMaxDims = 3;
constexpr int kPad = 4;             // words of padding after each smem row
constexpr int kStages = 2;          // staging buffers: tiles in flight + 1
constexpr int kStageMax = 320;      // staged rows a tile, at most
constexpr int kSmemBudget = 100 * 1024;  // two blocks an SM, at least
constexpr int kSmemCap = 227 * 1024;

enum { kModeRows = 0, kModeBsi = 1 };

struct ProductArgs {
  const unsigned long long* table;  // (S, P) row addresses, 0 = absent
  long long W;                      // words a row
  int S, P;
  int nd;                           // dimensions of A (1..3)
  int n[kMaxDims];                  // rows of each dimension
  int col0[kMaxDims];               // table column of each one's first row
  int stride[kMaxDims];             // groups between its consecutive rows
  int filt_col;                     // table column of the filter, or -1
  int b_col;                        // table column of B's first row
  int GA, NB, D;                    // groups, B's outputs, BSI depth
  int CW, lcw4;                     // chunk words; log2(CW / 4)
  int chunks;                       // chunks a shard
  unsigned int n_tiles;             // S x chunks
  int MT, NT;                       // region: 16 MT groups x 8 NT outputs
  int regions_b;                    // regions along B
  int stage_rows;                   // staged rows a tile, at most
};

// ---- small helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// D += popc(A & B) over a 16 x 8 tile and 256 bits.  A: rows gid and
// gid + 8, words tig and tig + 4 of the k-step; B: column gid, words tig
// and tig + 4; D: (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, 2 tig),
// (gid + 8, 2 tig + 1).
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same shape in int8: 16 x 8 outputs over 32 bytes.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The last block of region blockIdx.y to finish: true in every thread of
// that block.  Each thread fences its own slot writes first; the region's
// ticket counts the blocks of the region (gridDim.x).
__device__ __forceinline__ bool last_of_run(unsigned int* tickets, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(tickets + blockIdx.y) : "memory");
    *flag = prev == gridDim.x - 1;
  }
  __syncthreads();
  return *flag;
}

// Output k of region blockIdx.y summed over the region's blocks: slot words
// of a block are `width` apart; neighbouring threads read neighbouring words.
__device__ __forceinline__ unsigned long long run_total(
    const unsigned long long* slots, int width, int k) {
  const unsigned long long* p =
      slots + (long long)blockIdx.y * gridDim.x * width + k;
  unsigned long long v = 0;
#pragma unroll 8
  for (unsigned int b = 0; b < gridDim.x; ++b)
    v += __ldcg(p + (long long)b * width);
  return v;
}

// ---- the product ------------------------------------------------------------

// Shared state a block sets up once for its region.
struct Region {
  int ga0, cb0;           // first group and first B output of the region
  int staged;             // staged rows a tile (the zero row included)
  int d0_rows;            // staged rows of dimension 0 (the first ones)
  int filt_pos;           // staged row of the filter, or -1
  int b_pos;              // staged row of B's first row
  int zrow;               // a staged row of zeros
  int side;               // F: rows side, side + 1 hold exists & ~sign,
                          // exists & sign (formed, after the staged rows)
  int vr, vc;             // valid groups and outputs of the region
};

// The staged rows each of the region's groups ANDs: pos[g][d] for dimension
// d (-1 past nd; the zero row for a group past GA).
struct RegionTables {
  int scol[kStageMax];          // table column of each staged row, or -1
  short pos[64][kMaxDims];
  Region r;
  int last;
};

__device__ void setup_region(const ProductArgs& a, int mode,
                             RegionTables& rt) {
  const int tid = threadIdx.x;
  const int rows_a = 16 * a.MT, cols_b = 8 * a.NT;
  const int ra = blockIdx.y / a.regions_b, rb = blockIdx.y % a.regions_b;
  const int ga0 = ra * rows_a, cb0 = rb * cols_b;
  const int ga_end = min(ga0 + rows_a, a.GA);
  __shared__ int dim_base[kMaxDims], first_q[kMaxDims], wrap[kMaxDims];
  if (tid == 0) {
    int base = 0;
    // d is fixed at compile time in each step: a runtime index into the
    // argument's arrays would copy the arguments to a stack frame
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d >= a.nd) break;
      const int first = ga0 / a.stride[d];
      const int span = (ga_end - 1) / a.stride[d] - first + 1;
      const bool full = span > a.n[d];
      const int cnt = full ? a.n[d] : span;
      const int start = full ? 0 : first % a.n[d];
      for (int t = 0; t < cnt; ++t)
        rt.scol[base + t] = a.col0[d] + (start + t) % a.n[d];
      dim_base[d] = base;
      first_q[d] = first;
      wrap[d] = full;
      if (d == 0) rt.r.d0_rows = cnt;
      base += cnt;
    }
    rt.r.filt_pos = -1;
    if (a.filt_col >= 0) {
      rt.scol[base] = a.filt_col;
      rt.r.filt_pos = base++;
    }
    rt.r.b_pos = base;
    if (mode == kModeRows) {
      for (int c = 0; c < cols_b; ++c)
        rt.scol[base + c] = cb0 + c < a.NB ? a.b_col + cb0 + c : -1;
      base += cols_b;
    } else {
      for (int j = 0; j < a.D + 2; ++j) rt.scol[base + j] = a.b_col + j;
      base += a.D + 2;
    }
    rt.scol[base] = -1;
    rt.r.zrow = base++;
    rt.r.staged = base;
    rt.r.side = base;
    rt.r.ga0 = ga0;
    rt.r.cb0 = cb0;
    rt.r.vr = ga_end - ga0;
    rt.r.vc = min(cols_b, a.NB - cb0);
  }
  __syncthreads();
  if (tid < rows_a) {
    const int ga = ga0 + tid;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      short p = -1;
      if (d < a.nd) {
        const int q = ga / a.stride[d];
        p = ga >= a.GA ? (short)rt.r.zrow
                       : (short)(dim_base[d] + (wrap[d] ? q % a.n[d]
                                                        : q - first_q[d]));
      }
      rt.pos[tid][d] = p;
    }
  }
  __syncthreads();
}

// Copies of tile t's staged rows into `dst` (rows CW + kPad words apart).
template <int V>
__device__ __forceinline__ void stage(const ProductArgs& a,
                                      const RegionTables& rt, unsigned int t,
                                      uint32_t* dst) {
#ifdef FB_ABLATE_COPY  // measurement only: multiply stale rows
  return;
#endif
  const unsigned int s = t / (unsigned int)a.chunks;
  const long long w0 = (long long)(t - s * a.chunks) * a.CW;
  const unsigned long long* trow = a.table + (long long)s * a.P;
  const int cwp = a.CW + kPad;
  const int per_row_log = V == 4 ? a.lcw4 : a.lcw4 + 2;  // log2(CW / V)
  const int n = rt.r.staged << per_row_log;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int j = e >> per_row_log;
    const int v = e & ((1 << per_row_log) - 1);
    const int col = rt.scol[j];
    const unsigned long long row = col >= 0 ? __ldg(trow + col) : 0ull;
    const long long word = w0 + (long long)v * V;
    uint32_t* d = dst + j * cwp + v * V;
    if (row == 0ull || word >= a.W) {
      if constexpr (V == 4)
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      else
        *d = 0u;
    } else {
      const void* src = reinterpret_cast<const uint32_t*>(row) + word;
      if constexpr (V == 4)
        cp_async16(d, src);
      else
        cp_async4(d, src);
    }
  }
}

__device__ __forceinline__ uint4 and4(uint4 x, uint4 y) {
  return make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}

// What the product reads besides the staged rows: the filter ANDed into
// dimension 0's rows in place (so a group's word is the AND of one row of
// each dimension), and for F the two sides of the BSI group.
__device__ __forceinline__ void prepare(const ProductArgs& a, int mode,
                                        const RegionTables& rt,
                                        uint32_t* sb) {
  const int cwp = a.CW + kPad, q = a.CW / 4;
  if (rt.r.filt_pos >= 0) {
    const uint32_t* f = sb + rt.r.filt_pos * cwp;
    const int n = rt.r.d0_rows << a.lcw4;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e >> a.lcw4, v = (e & (q - 1)) * 4;
      uint4* x = reinterpret_cast<uint4*>(sb + r * cwp + v);
      *x = and4(*x, *reinterpret_cast<const uint4*>(f + v));
    }
  }
  if (mode != kModeBsi) return;
  const uint32_t* ex = sb + rt.r.b_pos * cwp;
  uint32_t* pos = sb + rt.r.side * cwp;
  for (int v = threadIdx.x * 4; v < a.CW; v += kThreads * 4) {
    const uint4 xe = *reinterpret_cast<const uint4*>(ex + v);
    const uint4 xs = *reinterpret_cast<const uint4*>(ex + cwp + v);
    *reinterpret_cast<uint4*>(pos + v) =
        make_uint4(xe.x & ~xs.x, xe.y & ~xs.y, xe.z & ~xs.z, xe.w & ~xs.w);
    *reinterpret_cast<uint4*>(pos + cwp + v) = and4(xe, xs);
  }
}

// Word offsets of the rows a group's word ANDs (-1 past nd).
__device__ __forceinline__ void group_rows(const RegionTables& rt, int g,
                                           int cwp, int (&off)[kMaxDims]) {
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    const int p = rt.pos[g][d];
    off[d] = p >= 0 ? p * cwp : -1;
  }
}

// Word offsets of B's output c of the region: E its row (side unused);
// F a plane and a side (plane p & pos, plane p & neg, exists & exists),
// the zero row past NB.
template <int MODE>
__device__ __forceinline__ void b_rows(const ProductArgs& a,
                                       const RegionTables& rt, int c,
                                       int cwp, int& off, int& side) {
  if constexpr (MODE == kModeRows) {
    off = (rt.r.b_pos + c) * cwp;
    side = off;
  } else {
    const int k = rt.r.cb0 + c;
    int plane = rt.r.zrow, sd = rt.r.zrow;
    if (k < a.D) {
      plane = rt.r.b_pos + 2 + k;
      sd = rt.r.side;
    } else if (k < 2 * a.D) {
      plane = rt.r.b_pos + 2 + k - a.D;
      sd = rt.r.side + 1;
    } else if (k == 2 * a.D) {
      plane = sd = rt.r.b_pos;
    }
    off = plane * cwp;
    side = sd * cwp;
  }
}

// A group's word at word w: the AND of its rows.
__device__ __forceinline__ uint32_t a_word(const uint32_t* sb,
                                           const int (&off)[kMaxDims],
                                           int nd, int w) {
  uint32_t x = sb[off[0] + w];
  if (nd > 1) x &= sb[off[1] + w];
  if (nd > 2) x &= sb[off[2] + w];
  return x;
}

template <int MODE>
__device__ __forceinline__ uint32_t b_word(const uint32_t* sb, int off,
                                           int side, int w) {
  if constexpr (MODE == kModeRows)
    return sb[off + w];
  else
    return sb[off + w] & sb[side + w];
}

// The product over every (shard, chunk) tile of the block's run: MT x NT
// tiles of mma.sync a warp, each group's and output's words read straight
// from the staged rows.
template <int MODE, int MT, int NT, int V>
__device__ __forceinline__ void product(const ProductArgs& a,
                                        unsigned long long* __restrict__ out,
                                        unsigned long long* __restrict__ slots,
                                        unsigned int* __restrict__ tickets) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ RegionTables rt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  setup_region(a, MODE, rt);
  const int cwp = a.CW + kPad, nd = a.nd;
  const int rows_a = 16 * a.MT, cols_b = 8 * a.NT;
  const int buf_words = a.stage_rows * cwp;   // one staging buffer

  // each lane's rows, fixed over the run: rows gid and gid + 8 of each
  // 16-row tile, column gid of each 8-column tile
  int aoff[2 * MT][kMaxDims], boff[NT], soff[NT];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i)
    group_rows(rt, 16 * (i / 2) + gid + 8 * (i % 2), cwp, aoff[i]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    b_rows<MODE>(a, rt, 8 * j + gid, cwp, boff[j], soff[j]);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  // kStages - 1 tiles in flight ahead of the one being multiplied; each
  // commit group is one tile's copies (empty past the block's last tile)
  unsigned int t = blockIdx.x;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    const unsigned int ts = t + st * gridDim.x;
    if (ts < a.n_tiles) stage<V>(a, rt, ts, smem + st * buf_words);
    cp_async_commit();
  }
  for (int buf = 0; t < a.n_tiles; t += gridDim.x) {
    const unsigned int tn = t + (kStages - 1) * gridDim.x;
    const int next = buf == 0 ? kStages - 1 : buf - 1;  // the freed buffer
    if (tn < a.n_tiles) stage<V>(a, rt, tn, smem + next * buf_words);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    uint32_t* sb = smem + buf * buf_words;
    buf = buf == kStages - 1 ? 0 : buf + 1;
#ifdef FB_ABLATE_COMPUTE  // measurement only: the copies and waits alone
    continue;
#endif
    prepare(a, MODE, rt, sb);
    __syncthreads();
    const int ksteps = a.CW / 8;
    for (int ks = warp; ks < ksteps; ks += kWarps) {
      const int kw = ks * 8 + tig;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        af[i][0] = a_word(sb, aoff[2 * i], nd, kw);
        af[i][1] = a_word(sb, aoff[2 * i + 1], nd, kw);
        af[i][2] = a_word(sb, aoff[2 * i], nd, kw + 4);
        af[i][3] = a_word(sb, aoff[2 * i + 1], nd, kw + 4);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bf[j][0] = b_word<MODE>(sb, boff[j], soff[j], kw);
        bf[j][1] = b_word<MODE>(sb, boff[j], soff[j], kw + 4);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_b1(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // the block's counters, once: each warp's 32-bit partials through
  // shared memory into one 64-bit total an output of the region
  const int region = rows_a * cols_b;
  uint32_t* mine = smem + warp * region;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int g = 16 * i + gid, c = 8 * j + 2 * tig;
      mine[g * cols_b + c] = (uint32_t)acc[i][j][0];
      mine[g * cols_b + c + 1] = (uint32_t)acc[i][j][1];
      mine[(g + 8) * cols_b + c] = (uint32_t)acc[i][j][2];
      mine[(g + 8) * cols_b + c + 1] = (uint32_t)acc[i][j][3];
    }
  __syncthreads();
  unsigned long long* my_slots =
      slots + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * region;
  for (int o = tid; o < region; o += kThreads) {
    unsigned long long v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += smem[w * region + o];
    my_slots[o] = v;
  }
  if (!last_of_run(tickets, &rt.last)) return;
  for (int o = tid; o < region; o += kThreads) {
    const int g = o / cols_b, c = o % cols_b;
    if (g < rt.r.vr && c < rt.r.vc)
      out[(long long)(rt.r.ga0 + g) * a.NB + rt.r.cb0 + c] =
          run_total(slots, region, o);
  }
  if (tid == 0) tickets[blockIdx.y] = 0;  // ready for the next launch
}

template <int MT, int NT, int V>
__global__ void __launch_bounds__(kThreads, 1)
pair_counts_kernel(const ProductArgs a, unsigned long long* __restrict__ out,
                   unsigned long long* __restrict__ slots,
                   unsigned int* __restrict__ tickets) {
  product<kModeRows, MT, NT, V>(a, out, slots, tickets);
}

template <int MT, int NT, int V>
__global__ void __launch_bounds__(kThreads, 1)
bsi_sum_groups_kernel(const ProductArgs a,
                      unsigned long long* __restrict__ out,
                      unsigned long long* __restrict__ slots,
                      unsigned int* __restrict__ tickets) {
  product<kModeBsi, MT, NT, V>(a, out, slots, tickets);
}

// ---- the rates --------------------------------------------------------------

// Eight independent chains of popcount and add a thread, `iters` steps each:
// the card's 32-bit popcount rate (chip_smoke.py's popc_rate).
__global__ void __launch_bounds__(kThreads)
popc_rate_kernel(unsigned int* __restrict__ out, int iters) {
  unsigned int x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * 2654435761u + j * 97u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] += __popc(x[j] ^ 0x9E3779B9u);
  }
  unsigned int v = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) v ^= x[j];
  if (v == 0x12345678u) out[blockIdx.x] = v;  // keeps the chains live
}

// Eight independent accumulator chains of mma.sync a warp, `iters` steps
// each: the tensor cores' rate in the 1-bit AND-popcount form (B1 true) or
// in int8 (chip_smoke.py's tc_rate).
template <bool B1>
__global__ void __launch_bounds__(kThreads)
tc_rate_kernel(unsigned int* __restrict__ out, int iters) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = threadIdx.x * 2654435761u + j * 97u;
  b[0] = a[0] ^ 0x9E3779B9u;
  b[1] = a[1] ^ 0x7F4A7C15u;
  int d[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[c][k] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if constexpr (B1)
        mma_b1(d[c], a, b);
      else
        mma_s8(d[c], a, b);
    }
  }
  int v = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) v ^= d[c][k];
  if (v == 0x12345678) out[blockIdx.x] = (unsigned int)v;
}

// ---- launch -----------------------------------------------------------------

using ProductKernel = decltype(&pair_counts_kernel<1, 1, 4>);

// Forms: mode x (MT, NT) x V.
constexpr int kShapes = 6;   // (MT, NT) in {1, 2, 4} x {1, 4}
constexpr int kForms = 2 * kShapes * 2;

#define FB_FORMS(K)                                                      \
  K<1, 1, 4>, K<1, 4, 4>, K<2, 1, 4>, K<2, 4, 4>, K<4, 1, 4>, K<4, 4, 4>, \
      K<1, 1, 1>, K<1, 4, 1>, K<2, 1, 1>, K<2, 4, 1>, K<4, 1, 1>, K<4, 4, 1>
const ProductKernel kTable[kForms] = {FB_FORMS(pair_counts_kernel),
                                      FB_FORMS(bsi_sum_groups_kernel)};
#undef FB_FORMS

int form_index(int mode, int MT, int NT, int V) {
  const int shape = (MT == 1 ? 0 : MT == 2 ? 2 : 4) + (NT == 1 ? 0 : 1);
  return mode * (kForms / 2) + (V == 4 ? 0 : kShapes) + shape;
}

// Per device: SMs, and whether each form may take the large shared memory.
struct DeviceInfo {
  int sms = 0;
  bool smem_set[kForms] = {};
};
DeviceInfo g_devices[64];

cudaError_t device_info(DeviceInfo** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[dev];
  if (d.sms == 0) {
    int sms = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// spec: mode, vec, S, P, nd, n0, n1, n2, col0_0, col0_1, col0_2, filt_col,
// b_col, NB, D (kSpecWords ints).
constexpr int kSpecWords = 15;

struct Plan {
  int form;
  int smem;
  ProductArgs a;
  dim3 grid;
  long long n_slots;
  int runs;
};

cudaError_t plan_product(const int* spec, long long W, Plan* p) {
  const int mode = spec[0], V = spec[1];
  ProductArgs& a = p->a;
  a.table = nullptr;
  a.W = W;
  a.S = spec[2];
  a.P = spec[3];
  a.nd = spec[4];
  if ((mode != kModeRows && mode != kModeBsi) || (V != 4 && V != 1) ||
      a.S <= 0 || a.P <= 0 || W <= 0 || a.nd < 1 || a.nd > kMaxDims ||
      (V == 4 && W % 4 != 0))
    return cudaErrorInvalidValue;
  long long GA = 1;
  for (int d = 0; d < kMaxDims; ++d) {
    a.n[d] = d < a.nd ? spec[5 + d] : 1;
    a.col0[d] = d < a.nd ? spec[8 + d] : 0;
    if (a.n[d] <= 0 || a.col0[d] < 0 || a.col0[d] + a.n[d] > a.P)
      return cudaErrorInvalidValue;
    GA *= a.n[d];
  }
  if (GA >= (1ll << 30)) return cudaErrorInvalidValue;
  a.GA = (int)GA;
  int st = 1;
  for (int d = a.nd - 1; d >= 0; --d) {
    a.stride[d] = st;
    st *= a.n[d];
  }
  for (int d = a.nd; d < kMaxDims; ++d) a.stride[d] = 1;
  a.filt_col = spec[11];
  a.b_col = spec[12];
  a.NB = spec[13];
  a.D = spec[14];
  if (a.filt_col >= a.P || a.NB <= 0) return cudaErrorInvalidValue;
  if (mode == kModeBsi) {
    if (a.D < 1 || a.D > kMaxDepth || a.NB != 2 * a.D + 1 || a.b_col < 0 ||
        a.b_col + a.D + 2 > a.P)
      return cudaErrorInvalidValue;
  } else if (a.b_col < 0 || a.b_col + a.NB > a.P) {
    return cudaErrorInvalidValue;
  }
  // the region: MT in {1, 2, 4}, NT in {1, 4}
  a.MT = GA <= 16 ? 1 : GA <= 32 ? 2 : 4;
  a.NT = a.NB <= 8 ? 1 : 4;
  const int rows_a = 16 * a.MT, cols_b = 8 * a.NT;
  const long long regions_a = (GA + rows_a - 1) / rows_a;
  a.regions_b = (a.NB + cols_b - 1) / cols_b;
  const long long runs = regions_a * a.regions_b;
  if (runs > 65535) return cudaErrorInvalidConfiguration;
  p->runs = (int)runs;
  // staged rows a tile, at most, over the regions
  int staged = 0;
  for (int d = 0; d < a.nd; ++d) {
    const int span = (rows_a - 1) / a.stride[d] + 2;
    staged += span < a.n[d] ? span : a.n[d];
  }
  staged += (a.filt_col >= 0) + (mode == kModeRows ? cols_b : a.D + 2) + 1;
  if (staged > kStageMax) return cudaErrorInvalidValue;
  // a buffer's rows: the staged ones and, for F, the two sides
  a.stage_rows = staged + (mode == kModeBsi ? 2 : 0);
  // chunk words: the most that fit the shared-memory budget
  const int region = rows_a * cols_b;
  const int red = kWarps * region * 4;   // the end-of-run reduction
  int cw = 256, lcw4 = 6;
  auto bytes = [&](int c) {
    return kStages * a.stage_rows * (c + kPad) * 4;
  };
  while (cw > 32 && bytes(cw) > kSmemBudget) {
    cw /= 2;
    --lcw4;
  }
  if (bytes(cw) > kSmemBudget) return cudaErrorInvalidValue;
  a.CW = cw;
  a.lcw4 = lcw4;
  p->smem = bytes(cw) > red ? bytes(cw) : red;
  const long long chunks = (W + cw - 1) / cw;
  if (chunks * a.S >= (1ll << 31)) return cudaErrorInvalidValue;
  a.chunks = (int)chunks;
  a.n_tiles = (unsigned int)(chunks * a.S);
  p->form = form_index(mode, a.MT, a.NT, V);
  DeviceInfo* info = nullptr;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  if (!info->smem_set[p->form]) {
    e = cudaFuncSetAttribute(kTable[p->form],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemCap - (int)sizeof(RegionTables) - 1024);
    if (e != cudaSuccess) return e;
    info->smem_set[p->form] = true;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kTable[p->form],
                                                    kThreads, p->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the grid: about the card's resident blocks over the regions, and
  // enough blocks that none takes more tiles than its 32-bit counters hold
  const long long cap = (long long)info->sms * per_sm;
  long long gx = cap / runs;
  if (gx < 1) gx = 1;
  if (gx > a.n_tiles) gx = a.n_tiles;
  const long long max_tiles = ((1ll << 31) - 1) / ((long long)cw * 32);
  const long long least = (a.n_tiles + max_tiles - 1) / max_tiles;
  if (gx < least) gx = least;
  p->grid = dim3((unsigned int)gx, (unsigned int)runs, 1);
  p->n_slots = runs * gx * region;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The deepest group kernel F takes, and the words of a launch spec.
int fb_group_limits(int* max_depth, int* spec_words) {
  *max_depth = kMaxDepth;
  *spec_words = kSpecWords;
  return 0;
}

// Slot words (int64) and tickets (uint32) that a launch of `spec` needs,
// and its chunk words and output regions.
int fb_group_product_slots(const int* spec, long long W, long long* n_slots,
                           int* n_tickets, int* chunk_words) {
  Plan p;
  const cudaError_t e = plan_product(spec, W, &p);
  if (e == cudaSuccess) {
    *n_slots = p.n_slots;
    *n_tickets = p.runs;
    *chunk_words = p.a.CW;
  }
  return (int)e;
}

// Kernel E (spec mode 0) or F (mode 1).  table: (S, P) uint64 row
// addresses on the device, 0 for an absent row; every nonzero address
// 16-byte aligned when spec's vec is 4.  out: (GA, NB) int64.  slots:
// n_slots int64 of scratch, at least fb_group_product_slots' count, no
// zeroing.  tickets: n_tickets uint32, at least its count, 0 before the
// launch and 0 again after it.
int fb_group_product(const int* spec, long long W, const void* table,
                     void* out, void* slots, long long n_slots, void* tickets,
                     int n_tickets, void* stream) {
  Plan p;
  const cudaError_t e = plan_product(spec, W, &p);
  if (e != cudaSuccess) return (int)e;
  if (table == nullptr || out == nullptr || slots == nullptr ||
      tickets == nullptr || p.n_slots > n_slots || p.runs > n_tickets)
    return (int)cudaErrorInvalidValue;
  p.a.table = static_cast<const unsigned long long*>(table);
  kTable[p.form]<<<p.grid, kThreads, p.smem,
                   static_cast<cudaStream_t>(stream)>>>(
      p.a, static_cast<unsigned long long*>(out),
      static_cast<unsigned long long*>(slots),
      static_cast<unsigned int*>(tickets));
  return (int)cudaGetLastError();
}

// The popcount-rate loop on `blocks` x 256 threads, `iters` steps of eight
// chains a thread (8 x iters x 256 x blocks popcounts).  out: `blocks`
// uint32 of scratch, almost never written.
int fb_popc_rate(void* out, int blocks, int iters, void* stream) {
  if (out == nullptr || blocks <= 0 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  popc_rate_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int*>(out), iters);
  return (int)cudaGetLastError();
}

// The tensor-core rate loop: `blocks` x 256 threads, `iters` steps of eight
// mma.sync a warp (8 x iters x 8 x blocks instructions): b1 != 0 the 1-bit
// AND-popcount form (m16n8k256, 32,768 bit products each), else int8
// (m16n8k32, 4,096 products each).
int fb_tc_rate(void* out, int blocks, int iters, int b1, void* stream) {
  if (out == nullptr || blocks <= 0 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  auto k = b1 ? tc_rate_kernel<true> : tc_rate_kernel<false>;
  k<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int*>(out), iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
