// Hand-written Hopper kernels for GroupBy (sm_90a).
//
// Two kernels, each behind a plain C launcher that ops/cuda_kernels.py loads
// with ctypes, as it loads csrc/bitmap_kernels.cu and csrc/bsi_kernels.cu.
// Launchers take device pointers and the caller's stream, launch, and return
// a cudaError_t (0 on success); they never synchronise and never allocate.
// Both are AND-popcount products: they count intersections of many rows
// with many rows without writing a single intersection.
//
// pair_counts (kernel E) is the counterpart of the XLA programs
//   featurebase_tpu/ops/bitwise.py stacked_pair_counts (:175) and, at S = 1,
//   count_and_pairs (:123): masks (S, F, W) x rows (S, R, W), optionally
//   under a filter (S, W) -> (F, R) int64, entry (f, r) the set bits of
//   masks[s, f] & rows[s, r] [& filter[s]] over every shard s.  The filter
//   fuses stacked_mask_filter (:193), so the stacked two-dimension GroupBy
//   reads its first dimension once.
// bsi_sum_groups (kernel F) is the counterpart of bsi.py sum_groups_stacked
//   (:611) and, at S = 1, sum_groups_kernel (:333): a stacked BSI group
//   (S, D + 2, W) (plane 0 exists, plane 1 sign, plane 2 + i magnitude bit
//   i) x masks (S, G, W) -> (G, 2D + 1) int64, per group the set bits of
//   each plane under mask & exists & ~sign, then under mask & exists & sign,
//   then of mask & exists: kernel C's counters (csrc/bsi_kernels.cu) with G
//   masks in place of its one filter.  The host finishes each group's sum.
//
// Bound: popcounts as often as bytes.  E does F x R popcounts for every
// F + R (+ 1) words it reads, F does G x (2D + 1) for every D + 2 + G.  The
// card's 32-bit popcount rate is 16 a clock per SM (the CUDA programming
// guide's instruction throughput table, compute capability 9.0): 132 SMs at
// 1.98 GHz give 4.2e12 a second, 1.25 for each 4-byte word that 3.35 TB/s
// brings.  So E is bound by bytes while F x R / (F + R) stays under about 5
// (the main path's 8 x 4: 2.7), and F by popcounts at any group count the
// main path gives it (32 groups at D = 14: 19 a word).  chip_smoke.py
// measures the rate with popc_rate_kernel below and reports which binds.
// Design, simple and right first: a block owns a run of (shard, chunk)
// tiles of 256 x V words (V = 4 with 16-byte loads when W % 4 == 0 and every
// array is 16-byte aligned, else V = 1) and one tile of the outputs
// (blockIdx.y): for E, 8 mask rows x RT rows, RT in {1, 2, 4, 8} by R; for
// F, a run of groups sized so that the grid fills the card.  E keeps its
// RT rows of a tile in registers, streams its 8 masks past them and adds
// 8 x RT per-thread counters in registers (indices fixed at compile time:
// runtime-indexed arrays go to a stack frame).  F keeps
// exists & ~sign and exists & sign of its words, and for each group of its
// run and each plane adds a warp-reduced (__reduce_add_sync) count into
// the block's counters in shared memory (32-bit atomics).  Across blocks:
// per-block slots; the last block of each output run to finish (an atomic
// ticket a run, which that block resets, as kernels A, C and D reset
// theirs) adds its run's slots, neighbouring threads on neighbouring
// outputs: no memset, and integer sums equal in any order.  F and R, G and D are
// runtime values; D from 1 to 63 shares one build.  Both are candidates for
// the tensor cores' 1-bit AND-popcount product (mma.sync .b1.and.popc) in
// a later version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairRows = 8;          // kernel E: mask rows of an output tile
constexpr int kMaxDepth = 63;         // kernel F: magnitude planes
constexpr int kGroupCounters = 4064;  // kernel F: shared counters a block
static_assert(2 * kMaxDepth + 1 <= kGroupCounters,
              "a block must hold the counters of one group");

template <int V>
struct Vec {
  uint32_t w[V];
};

// V words of a row from word i; words at or past W read as 0 (with V = 4,
// W % 4 == 0, so a vector lies wholly inside or outside the row).
template <int V>
__device__ __forceinline__ Vec<V> load(const int32_t* row, long long i,
                                       long long W) {
  Vec<V> r;
  if (i >= W) {
#pragma unroll
    for (int j = 0; j < V; ++j) r.w[j] = 0u;
    return r;
  }
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + i));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else {
    r.w[0] = (uint32_t)__ldg(row + i);
  }
  return r;
}

template <int V>
__device__ __forceinline__ unsigned int popc_and(const Vec<V>& a,
                                                 const Vec<V>& b) {
  unsigned int c = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) c += __popc(a.w[j] & b.w[j]);
  return c;
}

// Tiles a block may take: its counters then stay below 2^31 (a tile adds at
// most 32 x 1024 to a counter).
constexpr long long kMaxTilesPerBlock = 1ll << 16;

// The last block of output run blockIdx.y to finish: true in every thread
// of that block.  Each thread fences its own slot writes first; the run's
// ticket counts the blocks of the run (gridDim.x).
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

// Output k of run blockIdx.y summed over the run's blocks: slot words of a
// block are `width` apart; neighbouring threads read neighbouring words.
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

// How a launch cuts its words into tiles: S x tps tiles of 256 x V words.
// Tile indices are 32-bit (the launchers refuse 2^31 tiles or more), so the
// tile loop divides in 32 bits.
struct Tiles {
  long long W;
  unsigned int tps;      // tiles per shard
  unsigned int n_tiles;  // S x tps
};

// ---- kernel E ---------------------------------------------------------------

struct PairArgs {
  Tiles t;
  int F, R;
  int r_tiles;        // output tiles along R: ceil(R / RT)
};

template <int RT, int V>
__global__ void __launch_bounds__(kThreads)
pair_counts_kernel(const int32_t* __restrict__ masks,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ filt, const PairArgs a,
                   unsigned long long* __restrict__ out,
                   unsigned long long* __restrict__ slots,
                   unsigned int* __restrict__ tickets) {
  constexpr int kOut = kPairRows * RT;
  __shared__ unsigned long long warp_acc[kWarps][kOut];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = (blockIdx.y / a.r_tiles) * kPairRows;
  const int r0 = (blockIdx.y % a.r_tiles) * RT;
  const int nf = min(kPairRows, a.F - f0), nr = min(RT, a.R - r0);
  const long long W = a.t.W;
  const bool filtered = filt != nullptr;
  Vec<V> zero;
#pragma unroll
  for (int j = 0; j < V; ++j) zero.w[j] = 0u;
  unsigned int cnt[kPairRows][RT];
#pragma unroll
  for (int f = 0; f < kPairRows; ++f)
#pragma unroll
    for (int r = 0; r < RT; ++r) cnt[f][r] = 0u;
  for (unsigned int t = blockIdx.x; t < a.t.n_tiles; t += gridDim.x) {
    const unsigned int s = t / a.t.tps;
    const long long i = (long long)(t - s * a.t.tps) * (kThreads * V) +
                        (long long)tid * V;
    const int32_t* rs = rows + ((long long)s * a.R + r0) * W;
    const int32_t* ms = masks + ((long long)s * a.F + f0) * W;
    // every load of the tile first, so that they are in flight together
    Vec<V> x[RT], m[kPairRows];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      x[r] = r < nr ? load<V>(rs + r * W, i, W) : zero;
#pragma unroll
    for (int f = 0; f < kPairRows; ++f)
      m[f] = f < nf ? load<V>(ms + f * W, i, W) : zero;
    if (filtered) {
      const Vec<V> fw = load<V>(filt + s * W, i, W);
#pragma unroll
      for (int f = 0; f < kPairRows; ++f)
#pragma unroll
        for (int j = 0; j < V; ++j) m[f].w[j] &= fw.w[j];
    }
#pragma unroll
    for (int f = 0; f < kPairRows; ++f)
      if (f < nf) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (r < nr) cnt[f][r] += popc_and<V>(m[f], x[r]);
      }
  }
  // the block's counters: warps (a warp's sum is below 2^31, see
  // kMaxTilesPerBlock), then shared memory
#pragma unroll
  for (int f = 0; f < kPairRows; ++f)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const unsigned int v = __reduce_add_sync(0xFFFFFFFFu, cnt[f][r]);
      if (lane == 0) warp_acc[warp][f * RT + r] = v;
    }
  __syncthreads();
  unsigned long long v = 0;
  if (tid < kOut) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_acc[w][tid];
  }
  const int f = tid / RT, r = tid % RT;
  const bool mine = tid < kOut && f < nf && r < nr;
  if (tid < kOut)
    slots[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kOut + tid] = v;
  if (!last_of_run(tickets, &last)) return;
  if (mine) out[(long long)(f0 + f) * a.R + r0 + r] = run_total(slots, kOut,
                                                                tid);
  if (tid == 0) tickets[blockIdx.y] = 0;  // ready for the next launch
}

// ---- kernel F ---------------------------------------------------------------

struct GroupArgs {
  Tiles t;
  long long shard_stride;  // (D + 2) x W words between shards of the group
  int G, D;
  int run;                 // groups of a block: an output run along y
};

// A minimum of one block an SM: by default ptxas holds this kernel to 40
// registers and keeps a stack frame; with the bound it takes 46-48 and none.
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
bsi_sum_groups_kernel(const int32_t* __restrict__ group,
                      const int32_t* __restrict__ masks, const GroupArgs a,
                      unsigned long long* __restrict__ out,
                      unsigned long long* __restrict__ slots,
                      unsigned int* __restrict__ tickets) {
  // the run's counters, below 2^31 (kMaxTilesPerBlock): 32-bit shared
  // atomics, which the card has natively
  __shared__ unsigned int acc[kGroupCounters];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31;
  const int D = a.D, K = 2 * D + 1;
  const int g0 = blockIdx.y * a.run, ng = min(a.run, a.G - g0);
  const int n_acc = ng * K;
  const long long W = a.t.W;
  for (int k = tid; k < n_acc; k += kThreads) acc[k] = 0u;
  __syncthreads();
  for (unsigned int t = blockIdx.x; t < a.t.n_tiles; t += gridDim.x) {
    const unsigned int s = t / a.t.tps;
    const long long i = (long long)(t - s * a.t.tps) * (kThreads * V) +
                        (long long)tid * V;
    const int32_t* gs = group + s * a.shard_stride;
    const Vec<V> ex = load<V>(gs, i, W), sg = load<V>(gs + W, i, W);
    Vec<V> pos_all, neg_all;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      pos_all.w[j] = ex.w[j] & ~sg.w[j];
      neg_all.w[j] = ex.w[j] & sg.w[j];
    }
    for (int q = 0; q < ng; ++q) {
      const Vec<V> m = load<V>(masks + ((long long)s * a.G + g0 + q) * W, i,
                               W);
      Vec<V> pos, neg;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        pos.w[j] = m.w[j] & pos_all.w[j];
        neg.w[j] = m.w[j] & neg_all.w[j];
      }
      unsigned int* cq = acc + q * K;
      // mask & exists is pos | neg, disjoint: its count is the sum
      const unsigned int ec = __reduce_add_sync(
          0xFFFFFFFFu, popc_and<V>(pos, pos) + popc_and<V>(neg, neg));
      if (lane == 0) atomicAdd(cq + 2 * D, ec);
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        const Vec<V> x = load<V>(gs + (long long)(2 + d) * W, i, W);
        const unsigned int cp = __reduce_add_sync(0xFFFFFFFFu,
                                                  popc_and<V>(x, pos));
        const unsigned int cn = __reduce_add_sync(0xFFFFFFFFu,
                                                  popc_and<V>(x, neg));
        if (lane == 0) {
          atomicAdd(cq + d, cp);
          atomicAdd(cq + D + d, cn);
        }
      }
    }
  }
  __syncthreads();
  const int run_k = a.run * K;  // slot words of a block
  for (int k = tid; k < n_acc; k += kThreads)
    slots[((long long)blockIdx.y * gridDim.x + blockIdx.x) * run_k + k] =
        acc[k];
  if (!last_of_run(tickets, &last)) return;
  for (int k = tid; k < n_acc; k += kThreads)
    out[(long long)g0 * K + k] = run_total(slots, run_k, k);
  if (tid == 0) tickets[blockIdx.y] = 0;
}

// ---- the popcount rate ------------------------------------------------------

// Eight independent chains of popcount and add a thread, `iters` steps each:
// the card's 32-bit popcount rate, which bounds E and F (chip_smoke.py).
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

// ---- launch -----------------------------------------------------------------

using PairKernel = decltype(&pair_counts_kernel<8, 4>);
using GroupKernel = decltype(&bsi_sum_groups_kernel<4>);
constexpr int kPairForms = 8;   // RT in {1, 2, 4, 8} x V in {4, 1}
const PairKernel kPairTable[kPairForms] = {
    pair_counts_kernel<1, 4>, pair_counts_kernel<2, 4>,
    pair_counts_kernel<4, 4>, pair_counts_kernel<8, 4>,
    pair_counts_kernel<1, 1>, pair_counts_kernel<2, 1>,
    pair_counts_kernel<4, 1>, pair_counts_kernel<8, 1>};
const GroupKernel kGroupTable[2] = {bsi_sum_groups_kernel<4>,
                                    bsi_sum_groups_kernel<1>};

// Per device: SMs and resident blocks a SM of each form.
struct DeviceInfo {
  int sms = 0;
  int pair_blocks[kPairForms] = {};
  int group_blocks[2] = {};
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
    for (int f = 0; f < kPairForms; ++f) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d.pair_blocks[f], kPairTable[f], kThreads, 0);
      if (e != cudaSuccess) return e;
      if (d.pair_blocks[f] < 1) return cudaErrorInvalidConfiguration;
    }
    for (int f = 0; f < 2; ++f) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d.group_blocks[f], kGroupTable[f], kThreads, 0);
      if (e != cudaSuccess) return e;
      if (d.group_blocks[f] < 1) return cudaErrorInvalidConfiguration;
    }
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tiles of S rows of W words, or false past 2^31 - 1 tiles.
bool tiles_of(int S, long long W, int V, Tiles* t) {
  const long long tps = (W + (long long)kThreads * V - 1) /
                        ((long long)kThreads * V);
  if (tps * S >= (1ll << 31)) return false;
  t->W = W;
  t->tps = (unsigned int)tps;
  t->n_tiles = (unsigned int)(tps * S);
  return true;
}

// Kernel E's launch: form, arguments, grid and the slot words it needs.
struct PairPlan {
  int form;
  int runs;  // output runs: blocks along y, one ticket each
  PairArgs a;
  dim3 grid;
  long long n_slots;
};

cudaError_t plan_pairs(const void* masks, const void* rows, const void* filt,
                       int S, int F, int R, long long W, PairPlan* p) {
  if (masks == nullptr || rows == nullptr || S <= 0 || F <= 0 || R <= 0 ||
      W <= 0)
    return cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(masks) && aligned16(rows) &&
                   aligned16(filt);
  const int span = R < kPairRows ? R : kPairRows;
  const int rt_index = span <= 1 ? 0 : span <= 2 ? 1 : span <= 4 ? 2 : 3;
  const int RT = 1 << rt_index;
  DeviceInfo* info = nullptr;
  const cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  p->form = (vec ? 0 : 4) + rt_index;
  if (!tiles_of(S, W, vec ? 4 : 1, &p->a.t)) return cudaErrorInvalidValue;
  p->a.F = F;
  p->a.R = R;
  p->a.r_tiles = (R + RT - 1) / RT;
  const long long out_tiles =
      (long long)((F + kPairRows - 1) / kPairRows) * p->a.r_tiles;
  if (out_tiles > 65535) return cudaErrorInvalidConfiguration;
  p->runs = (int)out_tiles;
  const long long cap = (long long)info->sms * info->pair_blocks[p->form];
  long long gx = cap / out_tiles;
  if (gx < 1) gx = 1;
  if (gx > p->a.t.n_tiles) gx = p->a.t.n_tiles;
  const long long least = (p->a.t.n_tiles + kMaxTilesPerBlock - 1) /
                          kMaxTilesPerBlock;
  if (gx < least) gx = least;
  p->grid = dim3((unsigned int)gx, (unsigned int)out_tiles, 1);
  p->n_slots = out_tiles * gx * kPairRows * RT;
  return cudaSuccess;
}

// Kernel F's launch.  The group run is as long as the shared counters allow
// while the grid still has a block for each resident slot of the card.
struct GroupPlan {
  int form;
  int runs;
  GroupArgs a;
  dim3 grid;
  long long n_slots;
};

cudaError_t plan_groups(const void* group, const void* masks, int S, int G,
                        int D, long long W, GroupPlan* p) {
  if (group == nullptr || masks == nullptr || S <= 0 || G <= 0 || W <= 0 ||
      D < 1 || D > kMaxDepth)
    return cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(group) && aligned16(masks);
  DeviceInfo* info = nullptr;
  const cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  p->form = vec ? 0 : 1;
  if (!tiles_of(S, W, vec ? 4 : 1, &p->a.t)) return cudaErrorInvalidValue;
  p->a.shard_stride = (long long)(D + 2) * W;
  p->a.G = G;
  p->a.D = D;
  const int K = 2 * D + 1;
  const long long cap = (long long)info->sms * info->group_blocks[p->form];
  const long long n_tiles = p->a.t.n_tiles;
  long long runs = (cap + n_tiles - 1) / n_tiles;
  if (runs > G) runs = G;
  long long run = (G + runs - 1) / runs;
  if (run * K > kGroupCounters) run = kGroupCounters / K;
  runs = (G + run - 1) / run;
  if (runs > 65535) return cudaErrorInvalidConfiguration;
  p->runs = (int)runs;
  p->a.run = (int)run;
  long long gx = cap / runs;
  if (gx < 1) gx = 1;
  if (gx > p->a.t.n_tiles) gx = p->a.t.n_tiles;
  const long long least = (p->a.t.n_tiles + kMaxTilesPerBlock - 1) /
                          kMaxTilesPerBlock;
  if (gx < least) gx = least;
  p->grid = dim3((unsigned int)gx, (unsigned int)runs, 1);
  p->n_slots = runs * gx * run * K;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The deepest group kernel F takes.
int fb_group_limits(int* max_depth) {
  *max_depth = kMaxDepth;
  return 0;
}

// Slot words (int64) and tickets (uint32) that a launch of kernel E over
// these arrays needs.
int fb_pair_counts_slots(const void* masks, const void* rows,
                         const void* filt, int S, int F, int R, long long W,
                         long long* n_slots, int* n_tickets) {
  PairPlan p;
  const cudaError_t e = plan_pairs(masks, rows, filt, S, F, R, W, &p);
  if (e == cudaSuccess) {
    *n_slots = p.n_slots;
    *n_tickets = p.runs;
  }
  return (int)e;
}

// Kernel E.  masks ((S, F, W) int32), rows ((S, R, W) int32) and filt
// ((S, W) int32, or null for none), each contiguous -> out ((F, R) int64).
// slots: n_slots int64 of scratch, at least fb_pair_counts_slots' count, no
// zeroing.  tickets: n_tickets uint32, at least its count, 0 before the
// launch and 0 again after it.
int fb_pair_counts(const void* masks, const void* rows, const void* filt,
                   int S, int F, int R, long long W, void* out, void* slots,
                   long long n_slots, void* tickets, int n_tickets,
                   void* stream) {
  PairPlan p;
  const cudaError_t e = plan_pairs(masks, rows, filt, S, F, R, W, &p);
  if (e != cudaSuccess) return (int)e;
  if (out == nullptr || slots == nullptr || tickets == nullptr ||
      p.n_slots > n_slots || p.runs > n_tickets)
    return (int)cudaErrorInvalidValue;
  kPairTable[p.form]<<<p.grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(masks), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(filt), p.a,
      static_cast<unsigned long long*>(out),
      static_cast<unsigned long long*>(slots),
      static_cast<unsigned int*>(tickets));
  return (int)cudaGetLastError();
}

// Slot words and tickets that a launch of kernel F over these arrays needs.
int fb_bsi_sum_groups_slots(const void* group, const void* masks, int S,
                            int G, int D, long long W, long long* n_slots,
                            int* n_tickets) {
  GroupPlan p;
  const cudaError_t e = plan_groups(group, masks, S, G, D, W, &p);
  if (e == cudaSuccess) {
    *n_slots = p.n_slots;
    *n_tickets = p.runs;
  }
  return (int)e;
}

// Kernel F.  group ((S, D + 2, W) int32) and masks ((S, G, W) int32), each
// contiguous -> out ((G, 2D + 1) int64: per group the positive plane counts,
// the negative plane counts, the count).  slots and tickets as for kernel E.
int fb_bsi_sum_groups(const void* group, const void* masks, int S, int G,
                      int D, long long W, void* out, void* slots,
                      long long n_slots, void* tickets, int n_tickets,
                      void* stream) {
  GroupPlan p;
  const cudaError_t e = plan_groups(group, masks, S, G, D, W, &p);
  if (e != cudaSuccess) return (int)e;
  if (out == nullptr || slots == nullptr || tickets == nullptr ||
      p.n_slots > n_slots || p.runs > n_tickets)
    return (int)cudaErrorInvalidValue;
  kGroupTable[p.form]<<<p.grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(group), static_cast<const int32_t*>(masks),
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

}  // extern "C"
