// Hand-written Hopper kernels for the BSI aggregates (sm_90a).
//
// Two kernels, each behind a plain C launcher that ops/cuda_kernels.py loads
// with ctypes, as it loads csrc/bitmap_kernels.cu.  Launchers take device
// pointers and the caller's stream, launch, and return a cudaError_t (0 on
// success); they never synchronise and never allocate.  Both read a BSI
// group of D + 2 planes a shard (plane 0 exists, plane 1 sign, plane 2 + i
// magnitude bit i) and a filter row a shard, of W int32 words each, named
// by a table of addresses: entry s * (D + 2) + p is plane p of shard s,
// entry S * (D + 2) + s shard s's filter row.  A zero address is an absent
// row: an absent magnitude or sign plane reads as zeros, and a shard whose
// exists plane or filter row is absent has no column.  So one launch reads
// every shard's fragment mirror in place; a stacked (S, D + 2, W) group's
// table is its base and strides (`affine`), and needs no copy.
//
// bsi_sum_planes (kernel C') is the counterpart of the XLA program
//   featurebase_tpu/ops/bsi.py sum_planes_stacked (:378).  With
//   e = exists & filter, it counts the set bits of plane_i & e & ~sign and
//   of plane_i & e & sign for every magnitude plane i, and of e, over every
//   shard: 2D + 1 int64.  Sum's total is finished on the host from them
//   (parallel/agg.py finalize_sum).
// bsi_min_max (kernel D') is the counterpart of min_max_stacked (:399) and
//   of the per-shard descents of minmax_parts_kernel / _descend
//   (:200-278).  Per shard it runs the greedy bit-sliced descents from the
//   top plane down that a Min (pos-min, neg-max) or a Max (pos-max,
//   neg-min) needs, and gives each as (magnitude, count of the columns at
//   it) in an S x 4 x 2 int64 array (pos-min, pos-max, neg-min, neg-max;
//   the two descents that did not run are (0, 0)).  No decode is built: a
//   thread descends over one word of 32 columns at a time, and the
//   (magnitude, count) pairs combine associatively (keep the smaller or
//   larger magnitude, add the counts on a tie) over words, items and
//   blocks.  The host finishes either of the reference's two semantics
//   from them (ops/bsi.py).  Magnitudes are 64-bit, so every depth the
//   port's Field allows (1 to 63 planes) runs in the same build; the depth
//   is a launch argument.
//
// Bound: bytes.  Each kernel reads (D + 3) x S x W x 4 bytes once and writes
// a few hundred: at S = 128, W = 32768, D = 14, 285 MB (85 us at 3.35 TB/s);
// at S = 1, 2.2 MB (0.67 us).  The first kernels C and D cut a launch into
// fixed tiles of 2,048 and 8,192 words of one shard, so S = 1 ran 16 blocks
// of C and 4 of D on 132 SMs, and a thread of D walked 8 groups x D planes
// with each plane's load on the descent's dependent chain; every per-shard
// caller launched once a shard.  The design (C' and D'):
// - work is (shard, chunk of words) items; the chunk halves until every SM
//   has an item (C' and D' 128 words at S = 1, W = 32,768), and a
//   persistent grid (the occupancy calculator's resident blocks at most,
//   each with as many items) walks items b, b + grid, ...; each item's row
//   addresses are loaded an item ahead;
// - C' keeps e & ~sign and e & sign of its words in registers and walks
//   the planes, 4 planes x up to 2 groups of 16 bytes a lane in flight
//   (ld.global.nc.L1::no_allocate; the first planes' loads go out with
//   exists, sign and the filter, the next planes' before this plane's
//   reductions), with one warp-wide reduction (__reduce_add_sync) per plane
//   and sign; each lane holds 4 of the 2D + 1 counters in registers.  An
//   item of fewer words than the block has lanes splits its planes among
//   `parts` sets of warps.  The block's counters are added to a per-stream
//   accumulator with a fire and forget atomic (red.add), and the last block
//   to finish (a ticket it resets) copies them out and zeroes them: no
//   memset, a call is one device operation (the first C's per-block slots,
//   summed by the last block, were slower at every shape measured);
// - D' runs only the two descents a Min or a Max needs.  A thread descends
//   over its groups of 16 bytes (128 columns as one set) one after another,
//   the planes' loop unrolled 8 times, so 8 planes' loads are in flight and
//   no load waits behind a descent step; each item's pairs are combined in
//   the block into one slot, and the last block combines every shard's
//   slots, 256 / S lanes a shard (a warp a shard took 16 turns at
//   S = 128, a tenth of the kernel on the H100).  Staging each item's rows
//   in shared memory by TMA bulk copies, two items' buffers with one in
//   flight a SM, streamed at half this form's rate at S = 128 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 63;               // magnitude planes (values fit int64)
constexpr int kMaxPlanes = kMaxDepth + 2;   // a shard's group
constexpr int kLaneCounters = 4;            // kernel C' counters held by each lane
constexpr int kMaxCounters = 32 * kLaneCounters;
static_assert(2 * kMaxDepth + 1 <= kMaxCounters,
              "kernel C's lanes must hold every counter");
constexpr int kSumGroups = 2;        // 16-byte groups of a C' lane in an item
constexpr int kPlaneUnroll = 4;      // C' planes a lane has in flight
constexpr int kMinMaxChunkMax = 8192;  // words of a D' item
constexpr int kDescentUnroll = 8;      // D' planes a thread has in flight
constexpr int kInlineAddrs = 440;    // table entries carried in the launch
constexpr int kSlotWords = 4;        // a D' slot: (mag, count) x 2 descents

template <int V>
struct Vec {
  uint32_t w[V];
};

// One launch: the address table (inline, a device array, or a stacked
// group's base and strides) and how it cuts the work into items of `chunk`
// words of one shard.
struct BsiArgs {
  unsigned long long addrs[kInlineAddrs];
  const unsigned long long* table;   // device table, or null: addrs
  // affine table (a stacked group): plane p of shard s at base + s * s_step
  // + p * p_step, shard s's filter row at f_base + s * f_step (bytes)
  int affine;
  unsigned long long base, f_base;
  long long s_step, p_step, f_step;
  long long W;
  int S, D, P;          // P = D + 2 planes a shard
  int chunk;            // words of an item
  int n_chunks;         // items a shard
  long long n_items;
  int parts;            // C': sets of warps that split an item's planes
  int groups;           // C': 16-byte (or 4-byte) groups of a lane
};
static_assert(sizeof(BsiArgs) + 64 < 4096, "the BSI kernels' arguments must "
              "fit the kernel's parameter space");

__device__ __forceinline__ unsigned long long plane_addr(const BsiArgs& a,
                                                         long long s, int p) {
  if (a.affine) return a.base + s * a.s_step + p * a.p_step;
  const unsigned long long* t = a.table != nullptr ? a.table : a.addrs;
  return t[s * a.P + p];
}

__device__ __forceinline__ unsigned long long filter_addr(const BsiArgs& a,
                                                          long long s) {
  if (a.affine) return a.f_base + s * a.f_step;
  const unsigned long long* t = a.table != nullptr ? a.table : a.addrs;
  return t[(long long)a.S * a.P + s];
}

// V words at address `addr` (bytes) plus word i, not allocated in L1; zeros
// for an absent row or a word at or past `n`.
template <int V>
__device__ __forceinline__ Vec<V> row_words(unsigned long long addr,
                                            long long i, long long n) {
  Vec<V> r;
  if (addr == 0 || i >= n) {
#pragma unroll
    for (int j = 0; j < V; ++j) r.w[j] = 0u;
    return r;
  }
  const uint32_t* p = reinterpret_cast<const uint32_t*>(addr) + i;
  if constexpr (V == 4) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]) : "l"(p));
  } else {
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n"
        : "=r"(r.w[0]) : "l"(p));
  }
  return r;
}

__device__ __forceinline__ void red_add(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;\n"
               :: "l"(p), "l"(v) : "memory");
}

// The last block of a launch: true in every thread of the block that
// finishes last.  Each thread fences its own writes first.
__device__ __forceinline__ bool last_block_done(unsigned int* ticket,
                                                int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(ticket) : "memory");
    *flag = prev == gridDim.x - 1;
  }
  __syncthreads();
  return *flag;
}

// ---- kernel C' --------------------------------------------------------------

// V: words a group (4: 16-byte loads, every address 16-byte aligned and
// W % 4 == 0; else 1).  An item of C words: the block's threads are
// `parts` sets of kThreads / parts (whole warps); thread tw of part q
// holds groups tw, tw + kThreads / parts, ... (a.groups of them) of the
// chunk and counts planes q, q + parts, ...  acc: the 2D + 1 counters (zero
// before the launch and again after it).
template <int V>
__global__ void __launch_bounds__(kThreads)
bsi_sum_planes_kernel(const __grid_constant__ BsiArgs a,
                      unsigned long long* __restrict__ out,
                      unsigned long long* __restrict__ acc,
                      unsigned int* __restrict__ ticket) {
  __shared__ unsigned long long warp_acc[kWarps][kMaxCounters];
  __shared__ unsigned long long item_addr[2][kMaxPlanes + 1];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, K = 2 * D + 1, P = a.P;
  const int part_threads = kThreads / a.parts;
  const int part = tid / part_threads, tw = tid - part * part_threads;
  // counter k: k < D positive plane k, D <= k < 2D negative plane k - D,
  // 2D the count; lane k % 32 holds it in acc<k / 32>.  Named scalars and
  // selects keep the four in registers (an array indexed by k would live
  // in a stack frame).
  unsigned long long acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
  static_assert(kLaneCounters == 4, "one accumulator per lane counter");
  auto add = [&](int k, unsigned int v) {  // k is warp-uniform
    const unsigned long long x = lane == (k & 31) ? v : 0u;
    const int j = k >> 5;
    acc0 += j == 0 ? x : 0ull;
    acc1 += j == 1 ? x : 0ull;
    acc2 += j == 2 ? x : 0ull;
    acc3 += j == 3 ? x : 0ull;
  };
  const int n_local =
      (int)((a.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // thread p <= P holds row p's address (P: the filter) of the next item
  auto addr_of = [&](long long item) -> unsigned long long {
    const long long s = item / a.n_chunks;
    return tid < P ? plane_addr(a, s, tid) : filter_addr(a, s);
  };
  unsigned long long next = 0;
  if (tid <= P) next = addr_of(blockIdx.x);
  for (int i = 0; i < n_local; ++i) {
    const long long item = blockIdx.x + (long long)i * gridDim.x;
    const long long s = item / a.n_chunks;
    const long long w0 = (item - s * a.n_chunks) * a.chunk;
    // buffer i & 1 was last read in item i - 2, before the barrier of i - 1
    unsigned long long* ad = item_addr[i & 1];
    if (tid <= P) ad[tid] = next;
    __syncthreads();
    if (i + 1 < n_local && tid <= P) next = addr_of(item + gridDim.x);
    const unsigned long long ea = ad[0], sa = ad[1], fa = ad[P];
    if (ea == 0 || fa == 0) continue;   // a shard without columns
    long long wi[kSumGroups];
#pragma unroll
    for (int q = 0; q < kSumGroups; ++q)
      wi[q] = q < a.groups ? w0 + ((long long)q * part_threads + tw) * V : a.W;
    // the planes d0, d0 + parts, ... (kPlaneUnroll of them) into x
    Vec<V> x[kPlaneUnroll][kSumGroups];
    auto load_planes = [&](int d0) {
#pragma unroll
      for (int u = 0; u < kPlaneUnroll; ++u) {
        const int d = d0 + u * a.parts;
        const unsigned long long pa = d < D ? ad[2 + d] : 0ull;
#pragma unroll
        for (int q = 0; q < kSumGroups; ++q)
          x[u][q] = row_words<V>(pa, wi[q], a.W);
      }
    };
    // the first planes' loads go out with exists, sign and the filter
    load_planes(part);
    Vec<V> pos[kSumGroups], neg[kSumGroups];
    unsigned int ec = 0;
#pragma unroll
    for (int q = 0; q < kSumGroups; ++q) {
      const Vec<V> ex = row_words<V>(ea, wi[q], a.W),
                   sg = row_words<V>(sa, wi[q], a.W),
                   f = row_words<V>(fa, wi[q], a.W);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t e = ex.w[j] & f.w[j];
        pos[q].w[j] = e & ~sg.w[j];
        neg[q].w[j] = e & sg.w[j];
        ec += __popc(e);
      }
    }
    if (part == 0) add(2 * D, __reduce_add_sync(0xFFFFFFFFu, ec));
    const int step = kPlaneUnroll * a.parts;
    for (int d0 = part; d0 < D; d0 += step) {
      unsigned int cp[kPlaneUnroll], cn[kPlaneUnroll];
#pragma unroll
      for (int u = 0; u < kPlaneUnroll; ++u) {
        cp[u] = cn[u] = 0;
#pragma unroll
        for (int q = 0; q < kSumGroups; ++q) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            cp[u] += __popc(x[u][q].w[j] & pos[q].w[j]);
            cn[u] += __popc(x[u][q].w[j] & neg[q].w[j]);
          }
        }
      }
      if (d0 + step < D) load_planes(d0 + step);
#pragma unroll
      for (int u = 0; u < kPlaneUnroll; ++u) {
        const int d = d0 + u * a.parts;
        if (d >= D) break;
        add(d, __reduce_add_sync(0xFFFFFFFFu, cp[u]));
        add(D + d, __reduce_add_sync(0xFFFFFFFFu, cn[u]));
      }
    }
  }
  warp_acc[warp][lane] = acc0;
  warp_acc[warp][32 + lane] = acc1;
  warp_acc[warp][64 + lane] = acc2;
  warp_acc[warp][96 + lane] = acc3;
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    unsigned long long v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_acc[w][k];
    if (v != 0) red_add(acc + k, v);
  }
  if (!last_block_done(ticket, &last)) return;
  for (int k = tid; k < K; k += kThreads) {
    out[k] = __ldcg(acc + k);
    acc[k] = 0ull;   // zero again for the next launch on this stream
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch on this stream
}

// ---- kernel D' --------------------------------------------------------------

// (magnitude, count of columns at it); count 0 is the empty set.
struct Ext {
  unsigned long long mag, cnt;
};

template <bool MAX>
__device__ __forceinline__ Ext combine(const Ext a, const Ext b) {
  if (a.cnt == 0) return b;
  if (b.cnt == 0) return a;
  if (a.mag == b.mag) return Ext{a.mag, a.cnt + b.cnt};
  return (MAX ? a.mag > b.mag : a.mag < b.mag) ? a : b;
}

// Combines the pairs of each `width` neighbouring lanes (a power of two up
// to 32) into the first of them.
template <bool MAX>
__device__ __forceinline__ Ext warp_combine(Ext e, int width = 32) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const Ext o{__shfl_down_sync(0xFFFFFFFFu, e.mag, off, width),
                __shfl_down_sync(0xFFFFFFFFu, e.cnt, off, width)};
    e = combine<MAX>(e, o);
  }
  return e;
}

// One plane of a greedy descent over the columns of c (reference
// bsi.py:252 _descend): maximising, t = c & plane; minimising,
// t = c & ~plane; c keeps t where t has a column.  The magnitude's next
// bit (planes run from the top down, so mag = 2 mag + bit) is set when
// the maximising step keeps t, or when the minimising step cannot (and c
// is not empty).  An absent plane (all zeros) sets no bit and keeps c.
// Branch-free: `t` differs between threads.
template <int V, bool MAX>
__device__ __forceinline__ void descend_step(Vec<V>& c, const Vec<V>& x,
                                             unsigned long long& mag,
                                             bool nonempty) {
  Vec<V> t;
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t.w[j] = MAX ? (c.w[j] & x.w[j]) : (c.w[j] & ~x.w[j]);
    any |= t.w[j];
  }
  const bool hit = any != 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) c.w[j] = hit ? t.w[j] : c.w[j];
  mag = 2 * mag + (MAX ? hit : (!hit && nonempty));
}

// The end of an item: the block's pairs of the two descents into slot
// `item` (thread 0 the positive one, thread 1 the negative one).
template <bool IS_MIN>
__device__ __forceinline__ void item_slot(Ext ep, Ext en, Ext (*warp_ext)[2],
                                          unsigned long long* slots,
                                          long long item) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  ep = warp_combine<!IS_MIN>(ep);
  en = warp_combine<IS_MIN>(en);
  if (lane == 0) {
    warp_ext[warp][0] = ep;
    warp_ext[warp][1] = en;
  }
  __syncthreads();
  if (tid < 2) {
    Ext x = warp_ext[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      x = tid == 0 ? combine<!IS_MIN>(x, warp_ext[w][0])
                   : combine<IS_MIN>(x, warp_ext[w][1]);
    slots[item * kSlotWords + 2 * tid] = x.mag;
    slots[item * kSlotWords + 2 * tid + 1] = x.cnt;
  }
}

// The last block: every shard's slots combined into out (S, 4, 2).  Each
// shard has `lanes` neighbouring threads (256 / S, a power of two up to
// 32, at least 1), lane l taking its slots l, l + lanes, ..., four loads
// in flight, so a round covers 256 / lanes shards.
template <bool IS_MIN>
__device__ __forceinline__ void finish_shards(const BsiArgs& a,
                                              unsigned long long* out,
                                              const unsigned long long* slots) {
  int lanes = 32;
  while (lanes > 1 && (long long)lanes * a.S > kThreads) lanes >>= 1;
  const int l = threadIdx.x % lanes;
  const long long per_round = kThreads / lanes;
  for (long long s0 = 0; s0 < a.S; s0 += per_round) {   // block-uniform
    const long long s = s0 + threadIdx.x / lanes;
    Ext p{0ull, 0ull}, q{0ull, 0ull};
    const unsigned long long* base = slots + s * a.n_chunks * kSlotWords;
    for (int c0 = l; s < a.S && c0 < a.n_chunks; c0 += 4 * lanes) {
      Ext ps[4], qs[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + lanes * k;
        const unsigned long long* sl = base + (long long)c * kSlotWords;
        const bool in = c < a.n_chunks;
        ps[k] = in ? Ext{__ldcg(sl), __ldcg(sl + 1)} : Ext{0ull, 0ull};
        qs[k] = in ? Ext{__ldcg(sl + 2), __ldcg(sl + 3)} : Ext{0ull, 0ull};
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        p = combine<!IS_MIN>(p, ps[k]);
        q = combine<IS_MIN>(q, qs[k]);
      }
    }
    p = warp_combine<!IS_MIN>(p, lanes);
    q = warp_combine<IS_MIN>(q, lanes);
    if (l == 0 && s < a.S) {
      // (S, 4, 2): pos-min, pos-max, neg-min, neg-max
      unsigned long long* o = out + s * 8;
      const int kp = IS_MIN ? 0 : 1, kn = IS_MIN ? 3 : 2;
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = 0ull;
      o[2 * kp] = p.mag;
      o[2 * kp + 1] = p.cnt;
      o[2 * kn] = q.mag;
      o[2 * kn + 1] = q.cnt;
    }
  }
}

// V: words a group (4: 16-byte loads, every address 16-byte aligned and
// W % 4 == 0; else 1).  IS_MIN: the descents pos-min and neg-max (a Min),
// else pos-max and neg-min.  A group's rows, in the order it needs them:
// the filter, exists, sign, then the magnitude planes from the top down
// (R = D + 3), their addresses in shared memory.  Thread t descends over
// groups t, t + kThreads, ... of each item, one after another, the loop
// over the planes unrolled kDescentUnroll times, so that many planes'
// loads are in flight before their steps.
template <int V, bool IS_MIN>
__global__ void __launch_bounds__(kThreads)
bsi_min_max_kernel(const __grid_constant__ BsiArgs a,
                   unsigned long long* __restrict__ out,
                   unsigned long long* __restrict__ slots,
                   unsigned int* __restrict__ ticket) {
  __shared__ unsigned long long item_rows[2][kMaxPlanes + 1];
  __shared__ Ext warp_ext[kWarps][2];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int P = a.P, R = a.D + 3;
  const int n_local =
      (int)((a.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // thread r < R holds the address of row r of the next item
  auto row_of = [&](long long item) -> unsigned long long {
    const long long s = item / a.n_chunks;
    return tid == 0 ? filter_addr(a, s)
                    : plane_addr(a, s, tid < 3 ? tid - 1 : P + 2 - tid);
  };
  unsigned long long next = 0;
  if (tid < R) next = row_of(blockIdx.x);
  for (int i = 0; i < n_local; ++i) {
    const long long item = blockIdx.x + (long long)i * gridDim.x;
    const long long s = item / a.n_chunks;
    const long long w0 = (item - s * a.n_chunks) * a.chunk;
    const int groups = (int)(min((long long)a.chunk, a.W - w0) + V - 1) / V;
    // buffer i & 1 was last read in item i - 2, before the barrier of i - 1
    unsigned long long* rows = item_rows[i & 1];
    if (tid < R) rows[tid] = next;
    __syncthreads();
    if (i + 1 < n_local && tid < R) next = row_of(item + gridDim.x);
    Ext ep{0ull, 0ull}, en{0ull, 0ull};   // the positive, negative descents
    const bool live = rows[0] != 0 && rows[1] != 0;   // filter and exists
    for (int g = tid; live && g < groups; g += kThreads) {
      const long long j = w0 + (long long)g * V;
      const Vec<V> f = row_words<V>(rows[0], j, a.W),
                   ex = row_words<V>(rows[1], j, a.W),
                   sg = row_words<V>(rows[2], j, a.W);
      Vec<V> cp, cn;
      uint32_t any_p = 0, any_n = 0;
#pragma unroll
      for (int w = 0; w < V; ++w) {
        const uint32_t e = ex.w[w] & f.w[w];
        cp.w[w] = e & ~sg.w[w];
        cn.w[w] = e & sg.w[w];
        any_p |= cp.w[w];
        any_n |= cn.w[w];
      }
      unsigned long long mp = 0, mn = 0;
#pragma unroll kDescentUnroll
      for (int r = 3; r < R; ++r) {
        const Vec<V> x = row_words<V>(rows[r], j, a.W);
        descend_step<V, !IS_MIN>(cp, x, mp, any_p != 0u);
        descend_step<V, IS_MIN>(cn, x, mn, any_n != 0u);
      }
      unsigned int pp = 0, pn = 0;
#pragma unroll
      for (int w = 0; w < V; ++w) {
        pp += __popc(cp.w[w]);
        pn += __popc(cn.w[w]);
      }
      ep = combine<!IS_MIN>(ep, Ext{mp, pp});
      en = combine<IS_MIN>(en, Ext{mn, pn});
    }
    item_slot<IS_MIN>(ep, en, warp_ext, slots, item);
  }
  if (!last_block_done(ticket, &last)) return;
  finish_shards<IS_MIN>(a, out, slots);
  if (tid == 0) *ticket = 0;
}

// ---- launch -----------------------------------------------------------------

using BsiKernel = decltype(&bsi_sum_planes_kernel<4>);
// C' (V = 4, V = 1); D' (V = 4, V = 1) x (Min, Max)
constexpr int kForms = 6;
const BsiKernel kFormTable[kForms] = {
    bsi_sum_planes_kernel<4>, bsi_sum_planes_kernel<1>,
    bsi_min_max_kernel<4, true>, bsi_min_max_kernel<4, false>,
    bsi_min_max_kernel<1, true>, bsi_min_max_kernel<1, false>};

// Per device: SMs and the resident blocks a SM of each form.
struct DeviceInfo {
  int sms = 0;
  int blocks[kForms] = {};
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
    for (int f = 0; f < kForms; ++f) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d.blocks[f], kFormTable[f], kThreads, 0);
      if (e != cudaSuccess) return e;
      if (d.blocks[f] < 1) return cudaErrorInvalidConfiguration;
    }
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// How a launch cuts S shards of W words: the chunk, the items, the grid
// and (C') the parts and groups.
struct Plan {
  int chunk, parts, groups, form;
  long long n_chunks, n_items;
  unsigned int grid;
};

// Kernel `which` (0 = C', 1 = D') over S shards of D planes of W words;
// vec 4 when W % 4 == 0 and every address is 16-byte aligned, else 1.
cudaError_t plan_launch(int which, int S, int D, long long W, int vec,
                        int is_min, Plan* p) {
  if (S <= 0 || W <= 0 || D < 1 || D > kMaxDepth || (vec != 4 && vec != 1) ||
      (vec == 4 && W % 4 != 0) || W >= (1LL << 31))
    return cudaErrorInvalidValue;
  DeviceInfo* info = nullptr;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  auto items = [&](long long c) { return (long long)S * ((W + c - 1) / c); };
  const long long lo = 32LL * vec;
  long long c = which == 0 ? (long long)kThreads * vec * kSumGroups
                           : kMinMaxChunkMax;
  while (c > lo && c / 2 >= W) c /= 2;
  while (c > lo && items(c) < info->sms) c /= 2;
  p->chunk = (int)c;
  p->n_chunks = (W + c - 1) / c;
  p->n_items = items(c);
  p->parts = p->groups = 1;
  if (which == 0) {
    const long long group = (long long)kThreads * vec;
    p->parts = c >= group ? 1 : (int)(group / c);
    p->groups = c >= group ? (int)(c / group) : 1;
    p->form = vec == 4 ? 0 : 1;
  } else {
    p->form = 2 + (vec == 4 ? 0 : 2) + (is_min ? 0 : 1);
  }
  const int blocks = info->blocks[p->form];
  // as many blocks as give each the same count of items, within the
  // resident slots
  const long long slots = (long long)info->sms * blocks;
  const long long per_block = (p->n_items + slots - 1) / slots;
  p->grid = (unsigned int)((p->n_items + per_block - 1) / per_block);
  return cudaSuccess;
}

cudaError_t fill_args(const unsigned long long* host_table,
                      const void* dev_table, const long long* affine, int S,
                      int D, long long W, const Plan& p, BsiArgs* a) {
  const long long entries = (long long)S * (D + 3);
  if (affine == nullptr && dev_table == nullptr &&
      (host_table == nullptr || entries > kInlineAddrs))
    return cudaErrorInvalidValue;
  a->table = static_cast<const unsigned long long*>(dev_table);
  a->affine = affine != nullptr;
  a->base = a->f_base = 0;
  a->s_step = a->p_step = a->f_step = 0;
  if (a->affine) {
    a->base = (unsigned long long)affine[0];
    a->s_step = affine[1];
    a->p_step = affine[2];
    a->f_base = (unsigned long long)affine[3];
    a->f_step = affine[4];
  } else if (a->table == nullptr) {
    for (long long i = 0; i < entries; ++i) a->addrs[i] = host_table[i];
  }
  a->W = W;
  a->S = S;
  a->D = D;
  a->P = D + 2;
  a->chunk = p.chunk;
  a->n_chunks = (int)p.n_chunks;
  a->n_items = p.n_items;
  a->parts = p.parts;
  a->groups = p.groups;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The deepest group a launch takes, and the table entries that ride in a
// launch (S x (D + 3) at most; a larger table is a device array).
int fb_bsi_limits(int* max_depth, int* inline_addrs) {
  *max_depth = kMaxDepth;
  *inline_addrs = kInlineAddrs;
  return 0;
}

// The scratch a launch of kernel `which` (0 = C', 1 = D') needs, in int64:
// C' the 2D + 1 counters (zero before the launch, zero again after it); D'
// 4 a item (no zeroing).
int fb_bsi_scratch(int which, int S, int D, long long W, int vec, int is_min,
                   long long* words) {
  Plan p;
  const cudaError_t e = plan_launch(which, S, D, W, vec, is_min, &p);
  if (e != cudaSuccess) return (int)e;
  *words = which == 1 ? kSlotWords * p.n_items : (long long)(2 * D + 1);
  return 0;
}

// Kernel C' over the address table: host_table when it has at most
// kInlineAddrs entries (it rides in the launch), else dev_table, the same
// entries on the device, or for a stacked group `affine`: {base, shard
// step, plane step, filter base, filter step} in bytes.  out ((2D + 1,)
// int64: positive plane counts, negative plane counts, the count); acc as
// fb_bsi_scratch says; ticket a uint32 that is 0 before the launch and 0
// again after it.
int fb_bsi_sum_planes(const unsigned long long* host_table,
                      const void* dev_table, const long long* affine, int S,
                      int D, long long W, int vec, void* out, void* acc,
                      long long n_acc, void* ticket, void* stream) {
  Plan p;
  cudaError_t e = plan_launch(0, S, D, W, vec, 0, &p);
  if (e != cudaSuccess) return (int)e;
  if (out == nullptr || acc == nullptr || ticket == nullptr ||
      n_acc < 2 * D + 1)
    return (int)cudaErrorInvalidValue;
  BsiArgs a;
  if ((e = fill_args(host_table, dev_table, affine, S, D, W, p, &a)) !=
      cudaSuccess)
    return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<unsigned long long*>(out);
  auto* ac = static_cast<unsigned long long*>(acc);
  auto* tk = static_cast<unsigned int*>(ticket);
  if (p.form == 0) bsi_sum_planes_kernel<4><<<p.grid, kThreads, 0, st>>>(a, o, ac, tk);
  else bsi_sum_planes_kernel<1><<<p.grid, kThreads, 0, st>>>(a, o, ac, tk);
  return (int)cudaGetLastError();
}

// Kernel D' over the same tables: is_min 1 runs pos-min and neg-max, 0
// pos-max and neg-min.  out ((S, 4, 2) int64: per shard pos-min, pos-max,
// neg-min, neg-max, each as (magnitude, count), the two that did not run
// (0, 0)); slots as fb_bsi_scratch says; ticket as for kernel C'.
int fb_bsi_min_max(const unsigned long long* host_table, const void* dev_table,
                   const long long* affine, int S, int D, long long W,
                   int vec, int is_min, void* out, void* slots,
                   long long n_slots, void* ticket, void* stream) {
  Plan p;
  cudaError_t e = plan_launch(1, S, D, W, vec, is_min, &p);
  if (e != cudaSuccess) return (int)e;
  if (out == nullptr || slots == nullptr || ticket == nullptr ||
      kSlotWords * p.n_items > n_slots)
    return (int)cudaErrorInvalidValue;
  BsiArgs a;
  if ((e = fill_args(host_table, dev_table, affine, S, D, W, p, &a)) !=
      cudaSuccess)
    return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<unsigned long long*>(out);
  auto* sl = static_cast<unsigned long long*>(slots);
  auto* tk = static_cast<unsigned int*>(ticket);
  switch (p.form) {
    case 2: bsi_min_max_kernel<4, true><<<p.grid, kThreads, 0, st>>>(a, o, sl, tk); break;
    case 3: bsi_min_max_kernel<4, false><<<p.grid, kThreads, 0, st>>>(a, o, sl, tk); break;
    case 4: bsi_min_max_kernel<1, true><<<p.grid, kThreads, 0, st>>>(a, o, sl, tk); break;
    default: bsi_min_max_kernel<1, false><<<p.grid, kThreads, 0, st>>>(a, o, sl, tk); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
