// Hand-written Hopper kernel for Var and Corr (sm_90a): kernel H'.
//
// One kernel behind plain C launchers that ops/cuda_kernels.py loads with
// ctypes, as it loads the other sources of csrc/.  The launcher takes device
// pointers and the caller's stream, launches, and returns a cudaError_t (0
// on success); it never synchronises and never allocates.
//
// What it computes.  The counterpart of the XLA programs
// featurebase_tpu/ops/bsi.py var_moments_stacked (:782) and
// corr_moments_stacked (:815): every raw count of a Var (one BSI group x) or
// a Corr (two groups x and y) under a filter, summed over the shards, in one
// launch.  With the mask P = exists_x [& exists_y] [& filter], formed on
// chip, and for each magnitude plane
//   X_i = x_i & P,   Xs_i = x_i & sx & P,   Sx = sx & P   (sx: x's sign)
// and Y_j, Ys_j, Sy alike, write a.b for the set bits of a & b.  Every count
// the two programs take is one such cell, or a difference of a few:
//   cnt = P.P
//   n_i = |x_i & P & sx| = X_i.Sx,   p_i = |x_i & P & ~sx| = X_i.P - X_i.Sx
//   sq_ij = |x_i & x_j & P| = X_i.X_j   (the reference masks the square by
//           exists and filter, not by sign), and y's alike;
// and for Corr's four sign classes of x_i & y_j & P, with T = X_i.Y_j,
// A = Xs_i.Y_j, B = X_i.Ys_j and C = Xs_i.Ys_j (inclusion-exclusion over
// the two signs):
//   mm = |. & sx & sy| = C                 mp = |. & sx & ~sy| = A - C
//   pm = |. & ~sx & sy| = B - C            pp = |. & ~sx & ~sy| = T - A - B + C
// (pm: x positive, y negative, as bsi.py:853-861 orders them).  So the
// product of the rows {X, Xs, Y, P} by the columns {X, Y, Ys, P, Sx, Sy}
// holds them all; ops/cuda_kernels.py _var_parts and _corr_parts read them
// out of it.
//
// The basis.  The classes form one list L, in groups of 16 (an mma.sync row
// tile), each group under one mask, so a lane forms a group's mask once a
// k-step:
//   Var:  L = X_0 .. X_{D-1}, P, Sx (mask P; P is the ones row & P, Sx the
//         sign row & P).  Rows L[0, D + 1), columns L[0, D + 2).
//   Corr: with gx = ceil(Dx / 16) and gm = ceil((Dx + Dy + 2) / 16),
//         L[0, 16 gx)             Xs_0 .. Xs_{Dx-1}, then zeros (mask P & sx)
//         L[16 gx, 16 (gx + gm))  X_0 .., Y_0 .., P, Sx, then zeros (mask P)
//         L[16 (gx + gm), ..)     Sy, Ys_0 .. Ys_{Dy-1}          (mask P & sy)
//         Rows L[0, 16 gx + Dx + Dy + 1) (through P), columns L[16 gx, |L|).
// out[r, c] = L[r] . L[c0 + c] (c0 = 0 for Var, 16 gx for Corr), (R, C)
// int64.  Rows and columns are windows of the same list, so the words a
// lane loads for a row tile (classes gid and gid + 8 of a group) are its
// words for the two column tiles of that group: each class word is loaded
// once a lane a k-step and feeds both operands.  Var at D = 14: 15 x 16, one
// row tile by two column tiles, 2 mma.sync a 256-bit k-step; Corr at depths
// 14 and 12: 43 x 45, 3 x 6 tiles (18), where the product of the 2D + 1 sign
// classes of each group with themselves takes 8 and 32; at 31 x 31, 95 x 96
// (72).
//
// Bound.  Bytes: each staged row (the filter, exists, sign and the planes of
// each group) is read once a launch: Var at D = 14 reads 17 rows a shard,
// at 128 shards 285 MB (85 us at 3.35 TB/s); Corr of depths 14 and 12 31
// rows, 520 MB (155 us).  Operations: R x C bit products a column (Var 15 x
// 16, 2.1e10 at 128 shards; Corr 43 x 45, 8.1e10) on the tensor cores'
// 1-bit form (mma.sync m16n8k256 .b1 .and.popc; chip_smoke.py's tc_rate
// measures about 5e15 a second): 4 and 16 us.  So H' is bound by bytes.
//
// Design.  A persistent grid, about the card's resident blocks, walks the
// (shard, chunk) tiles of every shard: chunks of CW words (64 to 256), tile
// t of a block then t + gridDim.x.  Each tile stages every row of the
// launch once, with cp.async (16 bytes when every row address is 16-byte
// aligned and W % 4 == 0, else 4), into a ring of three buffers: the copies
// of the next two tiles are in flight while one is multiplied, one barrier
// a tile.  The planner takes the largest CW at which two blocks share an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), so that one block's
// copies and product overlap another's barrier.  Absent rows and words
// past W are stored as zeros; every buffer also holds a row of zeros and a
// row of ones (the classes P, Sy and the zero classes read them).  Each warp takes one in WK of a tile's 256-bit
// k-steps, for one role: a role is NTW of the form's column tiles (the
// deep Corr forms split their 12 column tiles among 4 roles, so a warp keeps
// 72 counters; the others have one role).  A k-step: a lane loads exists,
// filter [and y's exists] words and forms P, P & sx [and P & sy] in
// registers, then one 64-bit shared load of each class row it reads (words
// 2 tig and 2 tig + 1: the k-step's words in another order, the same for
// both operands), ANDed with its group's mask, and issues MG x NTW mma.sync.
// The counters stay in registers over the block's run of tiles; at its end
// the warps' 32-bit partials are summed through shared memory and added to
// the zeroed output with 64-bit atomics (integer sums equal in any order).
// A block's 32-bit counters count at most its tiles x CW x 32 bits: the
// planner caps a block's tiles at (2^31 - 1) / (CW x 32).  Depths 1 to 31
// (the executor's device route).
// chip_smoke.py also builds it with FB_ABLATE_COPY (no copies: the product
// runs on stale rows) and FB_ABLATE_COMPUTE (no product) to show where a
// launch's time goes; neither build gives right counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 31;
constexpr int kSpecWords = 9;
constexpr int kPad = 8;    // words after each staged row: the 64-bit loads
                           // of 4 class rows by 4 lanes fall in 32 banks
constexpr int kStages = 3;     // ring buffers, by default
constexpr int kMaxStages = 8;  // the most a launch spec may ask for
constexpr int kSmemCap = 227 * 1024;

struct Args {
  const unsigned long long* table;  // (S, Rs) row addresses, 0 = absent
  unsigned long long* out;          // (R, C) int64, zeroed by the caller
  long long W;                      // words a row
  int Rs;                           // staged rows a tile (table columns)
  int Dx, Dy;                       // depths (Dy: Corr only)
  int f_row, x_row, y_row;          // staged rows of the filter (or the
                                    // ones row), of x's and y's exists
  int gx, gm;                       // Corr's groups of Xs; of X, Y, P, Sx
  int R, C, c0;                     // output rows and columns; the class
                                    // of column 0
  int CW, lcw;                      // chunk words; log2(CW)
  int rs;                           // words a staged row takes, CW + kPad
  int stages;                       // buffers in the ring
  int buf_words;                    // words a buffer: (Rs + 2) rows
  int chunks;                       // chunks a shard
  unsigned int n_tiles;             // S x chunks
  int vec4;                         // 16-byte copies
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

// The same for a ring depth known at run time (n = stages - 2, 0 to 6).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// D += popc(A & B) over a 16 x 8 tile and 256 bits.  A: rows gid and
// gid + 8, k-words tig and tig + 4; B: column gid, k-words tig and tig + 4;
// D: (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, 2 tig), (gid + 8, 2 tig + 1).
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint2 ld2(const uint32_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ uint2 and2(uint2 x, uint2 y) {
  return make_uint2(x.x & y.x, x.y & y.y);
}

// ---- the basis --------------------------------------------------------------

// The staged row whose AND with its group's mask is class c of L (the zero
// row past the classes).  The ones row stands for P (and Sy, under P & sy).
template <int NF>
__device__ int class_row(const Args& a, int c) {
  const int zero = a.Rs, ones = a.Rs + 1, xp = a.x_row + 2;
  if constexpr (NF == 1) {
    if (c < a.Dx) return xp + c;
    if (c == a.Dx) return ones;            // P
    if (c == a.Dx + 1) return a.x_row + 1; // Sx
    return zero;
  } else {
    const int yp = a.y_row + 2;
    if (c < 16 * a.gx) return c < a.Dx ? xp + c : zero;   // Xs
    c -= 16 * a.gx;
    if (c < 16 * a.gm) {
      if (c < a.Dx) return xp + c;         // X
      c -= a.Dx;
      if (c < a.Dy) return yp + c;         // Y
      if (c == a.Dy) return ones;          // P
      if (c == a.Dy + 1) return a.x_row + 1;   // Sx
      return zero;
    }
    c -= 16 * a.gm;
    if (c == 0) return ones;               // Sy
    if (c <= a.Dy) return yp + c - 1;      // Ys
    return zero;
  }
}

// A form: NF fields; the lane loads groups of L below GL; MG row tiles (16
// classes each) by NT column tiles (8 each) from column tile N0, split among
// WO roles of NTW column tiles, each role's warps taking one in WK k-steps.
template <int NF_, int GL_, int MG_, int N0_, int NT_, int WO_>
struct Form {
  static constexpr int NF = NF_, GL = GL_, MG = MG_, N0 = N0_, NT = NT_;
  static constexpr int WO = WO_, NTW = NT_ / WO_, WK = kWarps / WO_;
  static_assert(NT_ % WO_ == 0 && kWarps % WO_ == 0, "roles");
  static_assert(MG_ <= GL_ && (N0_ + NT_ - 1) / 2 < GL_, "groups");
  // whether role R reads group g: a row tile, or a column tile's group
  __host__ __device__ static constexpr bool reads(int R, int g) {
    if (g < MG_) return true;
    for (int j = 0; j < NTW; ++j)
      if ((N0_ + R * NTW + j) / 2 == g) return true;
    return false;
  }
};

// Copies of tile t's staged rows into `dst` (rows rs words apart).
template <int V>
__device__ __forceinline__ void stage(const Args& a, unsigned int t,
                                      uint32_t* dst) {
#ifdef FB_ABLATE_COPY  // measurement only: multiply stale rows
  return;
#endif
  const unsigned int s = t / (unsigned int)a.chunks;
  const long long w0 = (long long)(t - s * a.chunks) * a.CW;
  const unsigned long long* trow = a.table + (long long)s * a.Rs;
  const int lg = V == 4 ? a.lcw - 2 : a.lcw;   // log2(CW / V)
  const int n = a.Rs << lg;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int j = e >> lg;
    const int v = (e & ((1 << lg) - 1)) * V;
    const unsigned long long row = __ldg(trow + j);
    const long long word = w0 + v;
    uint32_t* d = dst + j * a.rs + v;
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

// The lane's word offsets in a buffer: the rows of its classes (16 g + gid
// and 16 g + 8 + gid of each group) and of the masks' rows, at word 2 tig.
template <class F>
struct Lane {
  int cls[F::GL][2];
  int ex, f, ey, sx, sy;
};

// A warp's k-steps of one tile for role R: masks, class words, mma.sync.
template <class F, int R>
__device__ __forceinline__ void multiply(const Args& a, const uint32_t* sb,
                                         const Lane<F>& ln, int k0,
                                         int (&acc)[F::MG][F::NTW][4]) {
  const int ksteps = a.CW >> 3;
  for (int ks = k0; ks < ksteps; ks += F::WK) {
    const uint32_t* p = sb + ks * 8;
    uint2 pm = and2(ld2(p + ln.ex), ld2(p + ln.f));
    uint2 psx = pm, psy = pm;
    if constexpr (F::NF == 2) {
      pm = and2(pm, ld2(p + ln.ey));
      psx = and2(pm, ld2(p + ln.sx));
      psy = and2(pm, ld2(p + ln.sy));
    }
    uint2 cw[F::GL][2];
#pragma unroll
    for (int g = 0; g < F::GL; ++g) {
      if (!F::reads(R, g)) continue;
      uint2 m = pm;
      if constexpr (F::NF == 2)
        m = g < a.gx ? psx : g < a.gx + a.gm ? pm : psy;
      cw[g][0] = and2(ld2(p + ln.cls[g][0]), m);
      cw[g][1] = and2(ld2(p + ln.cls[g][1]), m);
    }
#pragma unroll
    for (int i = 0; i < F::MG; ++i) {
      const uint32_t af[4] = {cw[i][0].x, cw[i][1].x, cw[i][0].y,
                              cw[i][1].y};
#pragma unroll
      for (int j = 0; j < F::NTW; ++j) {
        constexpr int n0 = F::N0 + R * F::NTW;
        const int n = n0 + j;
        const uint32_t bf[2] = {cw[n / 2][n % 2].x, cw[n / 2][n % 2].y};
        mma_b1(acc[i][j], af, bf);
      }
    }
  }
}

template <class F>
__device__ __forceinline__ void multiply_role(const Args& a,
                                              const uint32_t* sb,
                                              const Lane<F>& ln, int role,
                                              int k0,
                                              int (&acc)[F::MG][F::NTW][4]) {
  if constexpr (F::WO == 1) {
    multiply<F, 0>(a, sb, ln, k0, acc);
  } else {
    static_assert(F::WO == 4, "one or four roles");
    switch (role) {
      case 0: multiply<F, 0>(a, sb, ln, k0, acc); break;
      case 1: multiply<F, 1>(a, sb, ln, k0, acc); break;
      case 2: multiply<F, 2>(a, sb, ln, k0, acc); break;
      default: multiply<F, 3>(a, sb, ln, k0, acc); break;
    }
  }
}

template <int NF, int GL, int MG, int N0, int NT, int WO>
__global__ void __launch_bounds__(kThreads, 1)
moments_kernel(const Args a) {
  using F = Form<NF, GL, MG, N0, NT, WO>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int role = warp % F::WO, k0 = warp / F::WO;

  // every buffer's two constant rows: zeros, then ones
  for (int e = tid; e < (a.stages * 2) << a.lcw; e += kThreads) {
    const int b = e >> (a.lcw + 1), r = (e >> a.lcw) & 1;
    smem[b * a.buf_words + (a.Rs + r) * a.rs + (e & (a.CW - 1))] =
        r ? ~0u : 0u;
  }
  Lane<F> ln;
#pragma unroll
  for (int g = 0; g < F::GL; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ln.cls[g][h] = class_row<NF>(a, 16 * g + 8 * h + gid) * a.rs + 2 * tig;
  ln.ex = a.x_row * a.rs + 2 * tig;
  ln.f = a.f_row * a.rs + 2 * tig;
  ln.sx = (a.x_row + 1) * a.rs + 2 * tig;
  ln.ey = a.y_row * a.rs + 2 * tig;
  ln.sy = (a.y_row + 1) * a.rs + 2 * tig;

  int acc[MG][F::NTW][4];
#pragma unroll
  for (int i = 0; i < MG; ++i)
#pragma unroll
    for (int j = 0; j < F::NTW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  // stages - 1 tiles in flight ahead of the one multiplied; each commit
  // group is one tile's copies (empty past the block's last tile)
  const unsigned int step = gridDim.x;
  unsigned int t = blockIdx.x;
  for (int st = 0; st < a.stages - 1; ++st) {
    const unsigned int ts = t + st * step;
    if (ts < a.n_tiles) {
      if (a.vec4)
        stage<4>(a, ts, smem + st * a.buf_words);
      else
        stage<1>(a, ts, smem + st * a.buf_words);
    }
    cp_async_commit();
  }
  int cur = 0, nxt = a.stages - 1;
  for (; t < a.n_tiles; t += step) {
    // tile t has landed, and every warp is done with the buffer it frees
    cp_async_wait_pending(a.stages - 2);
    __syncthreads();
    const unsigned int tn = t + (a.stages - 1) * step;
    if (tn < a.n_tiles) {
      if (a.vec4)
        stage<4>(a, tn, smem + nxt * a.buf_words);
      else
        stage<1>(a, tn, smem + nxt * a.buf_words);
    }
    cp_async_commit();
    const uint32_t* sb = smem + cur * a.buf_words;
    cur = cur + 1 == a.stages ? 0 : cur + 1;
    nxt = nxt + 1 == a.stages ? 0 : nxt + 1;
#ifndef FB_ABLATE_COMPUTE  // measurement only: the copies and waits alone
    multiply_role<F>(a, sb, ln, role, k0, acc);
#endif
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's counts: each warp's 32-bit partials through shared memory,
  // summed over the warps of its role, added to the output
  constexpr int per_role = MG * F::NTW * 128;   // 4 counters x 32 lanes a tile
  uint32_t* mine = smem + (k0 * F::WO + role) * per_role;
#pragma unroll
  for (int i = 0; i < MG; ++i)
#pragma unroll
    for (int j = 0; j < F::NTW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        mine[((i * F::NTW + j) * 4 + k) * 32 + lane] = (uint32_t)acc[i][j][k];
  __syncthreads();
  for (int o = tid; o < F::WO * per_role; o += kThreads) {
    unsigned long long v = 0;
#pragma unroll
    for (int k = 0; k < F::WK; ++k) v += smem[k * F::WO * per_role + o];
    if (v == 0) continue;
    const int r = o / per_role, rem = o - r * per_role;
    const int l = rem & 31, k = (rem >> 5) & 3, tile = rem >> 7;
    const int i = tile / F::NTW, j = tile - i * F::NTW;
    const int row = 16 * i + (l >> 2) + 8 * (k >> 1);
    const int col = 8 * (N0 + r * F::NTW + j) + 2 * (l & 3) + (k & 1) - a.c0;
    if (row < a.R && col >= 0 && col < a.C)
      atomicAdd(a.out + (long long)row * a.C + col, v);
  }
}

// ---- launch -----------------------------------------------------------------

using MomentsKernel = void (*)(const Args);

// The forms: Var at D <= 14, <= 30 and 31; Corr with gx = 1 (its main-path
// form, then the rest) and with gx = 2.
struct FormShape {
  int nf, GL, MG, N0, NT, WO;
};
#define FB_MOMENT_FORMS(X)                                         \
  X(1, 1, 1, 0, 2, 1), X(1, 2, 2, 0, 4, 1), X(1, 3, 2, 0, 5, 1),  \
      X(2, 4, 3, 2, 6, 1), X(2, 7, 4, 2, 12, 4), X(2, 8, 6, 4, 12, 4)
#define FB_SHAPE(nf, gl, mg, n0, nt, wo) FormShape{nf, gl, mg, n0, nt, wo}
#define FB_KERNEL(nf, gl, mg, n0, nt, wo) \
  &moments_kernel<nf, gl, mg, n0, nt, wo>
constexpr FormShape kShapes[] = {FB_MOMENT_FORMS(FB_SHAPE)};
const MomentsKernel kKernels[] = {FB_MOMENT_FORMS(FB_KERNEL)};
#undef FB_KERNEL
#undef FB_SHAPE
#undef FB_MOMENT_FORMS
constexpr int kForms = sizeof(kShapes) / sizeof(kShapes[0]);

// Per device: SMs, whether each form may take the large shared memory, and
// the resident blocks an SM of each (form, shared bytes) asked so far.
struct Occupancy {
  int form, smem, per_sm;
};
struct DeviceInfo {
  int sms = 0;
  bool smem_set[kForms] = {};
  Occupancy seen[256];
  int n_seen = 0;
};
DeviceInfo g_devices[64];
std::mutex g_lock;

cudaError_t resident_blocks(DeviceInfo& d, int form, int smem, int* per_sm) {
  for (int i = 0; i < d.n_seen; ++i)
    if (d.seen[i].form == form && d.seen[i].smem == smem) {
      *per_sm = d.seen[i].per_sm;
      return cudaSuccess;
    }
  if (!d.smem_set[form]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kKernels[form], cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemCap);
    if (e != cudaSuccess) return e;
    d.smem_set[form] = true;
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kKernels[form], kThreads, smem);
  if (e != cudaSuccess) return e;
  if (d.n_seen < 256) d.seen[d.n_seen++] = Occupancy{form, smem, *per_sm};
  return cudaSuccess;
}

struct Plan {
  Args a;
  int form, smem, per_sm, grid;
  long long staged_bytes;
};

// spec: vec, S, P, nf, Dx, Dy, has_filter, cw, stages (kSpecWords ints; cw
// and stages 0 for the planner's choice).  The table's P columns are the
// filter (if any), x's D + 2 planes (exists, sign, magnitudes) and, for
// Corr, y's.
cudaError_t plan_moments(const int* spec, long long W, Plan* p) {
  Args& a = p->a;
  const int vec = spec[0], S = spec[1], P = spec[2], nf = spec[3];
  const int hasf = spec[6], cw_req = spec[7], st_req = spec[8];
  a.table = nullptr;
  a.out = nullptr;
  a.W = W;
  a.Dx = spec[4];
  a.Dy = nf == 2 ? spec[5] : 0;
  if ((vec != 4 && vec != 1) || S <= 0 || W <= 0 || (vec == 4 && W % 4) ||
      (nf != 1 && nf != 2) || a.Dx < 1 || a.Dx > kMaxDepth ||
      (nf == 2 && (a.Dy < 1 || a.Dy > kMaxDepth)) || (hasf != 0 && hasf != 1)
      || P != hasf + a.Dx + 2 + (nf == 2 ? a.Dy + 2 : 0) ||
      (cw_req != 0 && cw_req != 64 && cw_req != 128 && cw_req != 256) ||
      (st_req != 0 && (st_req < 2 || st_req > kMaxStages)))
    return cudaErrorInvalidValue;
  a.vec4 = vec == 4;
  a.Rs = P;
  a.x_row = hasf;
  a.y_row = hasf + a.Dx + 2;
  a.f_row = hasf ? 0 : P + 1;   // no filter: the ones row
  // the layout of L, the output and the form that covers them
  int L;
  if (nf == 1) {
    a.gx = a.gm = 0;
    a.c0 = 0;
    a.R = a.Dx + 1;
    L = a.C = a.Dx + 2;
  } else {
    a.gx = (a.Dx + 15) / 16;
    a.gm = (a.Dx + a.Dy + 2 + 15) / 16;
    a.c0 = 16 * a.gx;
    a.R = a.c0 + a.Dx + a.Dy + 1;
    L = 16 * (a.gx + a.gm) + 1 + a.Dy;
    a.C = L - a.c0;
  }
  const int gl = (L + 15) / 16, mg = (a.R + 15) / 16, nt = (a.C + 7) / 8;
  int form;
  if (nf == 1)
    form = a.Dx <= 14 ? 0 : a.Dx <= 30 ? 1 : 2;
  else if (a.gx == 1)
    form = gl <= 4 && mg <= 3 && nt <= 6 ? 3 : 4;
  else
    form = 5;
  const FormShape& f = kShapes[form];
  if (gl > f.GL || mg > f.MG || nt > f.NT || 8 * f.N0 != a.c0)
    return cudaErrorInvalidValue;   // a form table out of step with L
  p->form = form;
  DeviceInfo* d = nullptr;
  {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    d = &g_devices[dev];
    if (d->sms == 0) {
      int sms = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      d->sms = sms;
    }
  }
  // chunk words: a ring of kStages buffers (two tiles in flight a block),
  // and the largest chunk at which two blocks share an SM, else the largest
  // that fits.  On the H100 a second resident block counted for more than
  // a deeper ring: Corr at 14 x 12 over 128 shards took 221-223 us with two
  // blocks of 2-3 stages and 310-315 us with one of 4-8.
  const int stages = st_req ? st_req : kStages;
  const int red = kWarps * f.MG * (f.NT / f.WO) * 128 * 4;
  a.CW = 0;
  for (int cw = 256; cw >= 64; cw /= 2) {
    if (cw_req && cw != cw_req) continue;
    const int ring = stages * (P + 2) * (cw + kPad) * 4;
    const int smem = ring > red ? ring : red;
    if (smem > kSmemCap) continue;
    int per_sm = 0;
    const cudaError_t e = resident_blocks(*d, form, smem, &per_sm);
    if (e != cudaSuccess) return e;
    if (per_sm >= 1 && (a.CW == 0 || (p->per_sm < 2 && per_sm >= 2))) {
      a.CW = cw;
      p->smem = smem;
      p->per_sm = per_sm;
    }
  }
  if (a.CW == 0) return cudaErrorInvalidConfiguration;
  a.stages = stages;
  a.lcw = a.CW == 256 ? 8 : a.CW == 128 ? 7 : 6;
  a.rs = a.CW + kPad;
  a.buf_words = (P + 2) * a.rs;
  const long long chunks = (W + a.CW - 1) / a.CW;
  if (chunks * S >= (1ll << 31)) return cudaErrorInvalidValue;
  a.chunks = (int)chunks;
  a.n_tiles = (unsigned int)(chunks * S);
  // the grid: the card's resident blocks, and enough blocks that none takes
  // more tiles than its 32-bit counters hold
  long long grid = (long long)d->sms * p->per_sm;
  if (grid > a.n_tiles) grid = a.n_tiles;
  const long long max_tiles = ((1ll << 31) - 1) / ((long long)a.CW * 32);
  const long long least = (a.n_tiles + max_tiles - 1) / max_tiles;
  if (grid < least) grid = least;
  p->grid = (int)grid;
  p->staged_bytes = (long long)S * P * W * 4;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The deepest field kernel H' takes, and the words of a launch spec.
int fb_moments_limits(int* max_depth, int* spec_words) {
  *max_depth = kMaxDepth;
  *spec_words = kSpecWords;
  return 0;
}

// The plan of a launch of `spec` over W words a row, into info (int64, 10
// words): output rows R and columns C, form, chunk words, ring stages,
// staged rows a tile, resident blocks an SM, grid blocks, shared bytes a
// block, and the bytes the launch stages (every row of the table once).
int fb_moments_plan(const int* spec, long long W, long long* info) {
  Plan p;
  cudaError_t e;
  {
    std::lock_guard<std::mutex> hold(g_lock);
    e = plan_moments(spec, W, &p);
  }
  if (e != cudaSuccess) return (int)e;
  const long long v[10] = {p.a.R, p.a.C, p.form, p.a.CW, p.a.stages,
                           p.a.Rs, p.per_sm, p.grid, p.smem, p.staged_bytes};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return 0;
}

// Kernel H'.  table: (S, P) uint64 row addresses on the device, 0 for an
// absent row; every nonzero address 16-byte aligned when spec's vec is 4.
// out: (R, C) int64 as fb_moments_plan gives them, zeroed; the launch adds
// its counts to it.
int fb_moments(const int* spec, long long W, const void* table, void* out,
               long long n_out, void* stream) {
  Plan p;
  cudaError_t e;
  {
    std::lock_guard<std::mutex> hold(g_lock);
    e = plan_moments(spec, W, &p);
  }
  if (e != cudaSuccess) return (int)e;
  if (table == nullptr || out == nullptr ||
      n_out < (long long)p.a.R * p.a.C)
    return (int)cudaErrorInvalidValue;
  p.a.table = static_cast<const unsigned long long*>(table);
  p.a.out = static_cast<unsigned long long*>(out);
  kKernels[p.form]<<<p.grid, kThreads, p.smem,
                     static_cast<cudaStream_t>(stream)>>>(p.a);
  return (int)cudaGetLastError();
}

}  // extern "C"
