// Hand-written Hopper kernels for the BSI aggregates (sm_90a).
//
// Two kernels, each behind a plain C launcher that ops/cuda_kernels.py loads
// with ctypes, as it loads csrc/bitmap_kernels.cu.  Launchers take device
// pointers and the caller's stream, launch, and return a cudaError_t (0 on
// success); they never synchronise and never allocate.  Both read a stacked
// BSI group, an (S, D + 2, W) int32 array (plane 0 exists, plane 1 sign,
// plane 2 + i magnitude bit i), and an (S, W) int32 filter.
//
// bsi_sum_planes (kernel C) is the counterpart of the XLA program
//   featurebase_tpu/ops/bsi.py sum_planes_stacked (:378).  With
//   e = exists & filter, it counts the set bits of plane_i & e & ~sign and
//   of plane_i & e & sign for every magnitude plane i, and of e, over every
//   shard: 2D + 1 int64.  Sum's total is finished on the host from them
//   (parallel/agg.py finalize_sum).
// bsi_min_max (kernel D) is the counterpart of min_max_stacked (:399) and
//   of the per-shard descents of minmax_parts_kernel / _descend
//   (:200-278).  Per shard it runs the four greedy bit-sliced descents
//   (pos-min, pos-max, neg-min, neg-max) from the top plane down, and gives
//   each as (magnitude, count of the columns at it): S x 4 x 2 int64.  No
//   decode is built: a thread descends over its own V words at once (the
//   reference's whole-shard descent, restricted to 32 V columns), and the
//   (magnitude, count) pairs combine associatively (keep the smaller or
//   larger magnitude, add the counts on a tie) over words, threads, tiles
//   and blocks.  The host finishes either of the reference's two semantics
//   from them (ops/bsi.py).  Magnitudes are 64-bit, so every depth the
//   port's Field allows (1 to 63 planes) runs in the same build; the depth
//   is a launch argument.
//
// Bound: bytes.  Each kernel reads (D + 3) x S x W x 4 bytes once and writes
// a few hundred: at S = 128, W = 32768, D = 14, 285 MB (85 us at 3.35 TB/s).
// Kernel D also does about a dozen word operations per plane word (four
// descents), near the card's integer rate for those bytes at D = 14.
// Design: a tile is a few groups of 256 x V consecutive words of one shard
// (V = 4 with 16-byte loads when W % 4 == 0 and both arrays are 16-byte
// aligned, else V = 1): 2 groups for kernel C, 8 for kernel D, whose tile
// ends in a block reduction; persistent blocks, as many as the occupancy
// calculator fits, stride over the tiles.  Kernel C keeps e & ~sign and
// e & sign of its words in registers and walks the planes with one
// warp-wide reduction (__reduce_add_sync) per plane and sign; each lane
// holds 4 of the 2D + 1 counters in registers.  Kernel D reduces each tile
// in the block into one slot.  Across blocks: per-block (C) or per-tile (D)
// slots, reduced by the last block to finish (an atomic ticket it resets,
// as kernel A does): no memset, and integer sums equal in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumGroups = 2;       // groups of a thread in a kernel C tile
constexpr int kMinMaxGroups = 8;    // and in a kernel D tile
constexpr int kMaxDepth = 63;       // magnitude planes (values fit int64)
constexpr int kLaneCounters = 4;    // kernel C counters held by each lane
constexpr int kMaxCounters = 32 * kLaneCounters;
static_assert(2 * kMaxDepth + 1 <= kMaxCounters,
              "kernel C's lanes must hold every counter");
constexpr int kDescents = 4;        // pos-min, pos-max, neg-min, neg-max
constexpr int kSlotWords = 2 * kDescents;  // a kernel D slot: (mag, count) x 4

template <int V>
struct Vec {
  uint32_t w[V];
};

// How a launch cuts (S, W) into tiles of kThreads x V x groups words.
struct Geometry {
  long long W;
  long long shard_stride;   // (D + 2) * W words between shards of the group
  long long tps;            // tiles per shard
  long long n_tiles;
  int S;
  int D;
};

// V words of a row from word i; words at or past W read as 0 (with V = 4,
// W % 4 == 0, so a group lies wholly inside or outside the row).
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
__device__ __forceinline__ unsigned int popc(const Vec<V>& x) {
  unsigned int c = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) c += __popc(x.w[j]);
  return c;
}

// Word i of a thread's group q in the tile starting at word w0.
template <int V>
__device__ __forceinline__ long long word_of(long long w0, int q, int tid) {
  return w0 + ((long long)q * kThreads + tid) * V;
}

// The last block of a launch: true in every thread of the block that
// finishes last.  Each thread fences its own slot writes first.
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

// ---- kernel C ---------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads)
bsi_sum_planes_kernel(const int32_t* __restrict__ group,
                      const int32_t* __restrict__ filt, const Geometry g,
                      unsigned long long* __restrict__ out,
                      unsigned long long* __restrict__ slots,
                      unsigned int* __restrict__ ticket) {
  __shared__ unsigned long long warp_acc[kWarps][kMaxCounters];
  __shared__ int last;
  constexpr long long kTile = (long long)kThreads * V * kSumGroups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = g.D, K = 2 * D + 1;
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
  for (long long t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const long long s = t / g.tps, w0 = (t % g.tps) * kTile;
    const int32_t* gs = group + s * g.shard_stride;
    const int32_t* fs = filt + s * g.W;
    Vec<V> pos[kSumGroups], neg[kSumGroups];
    unsigned int ec = 0;
#pragma unroll
    for (int q = 0; q < kSumGroups; ++q) {
      const long long i = word_of<V>(w0, q, tid);
      const Vec<V> ex = load<V>(gs, i, g.W), sg = load<V>(gs + g.W, i, g.W),
                   f = load<V>(fs, i, g.W);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t e = ex.w[j] & f.w[j];
        pos[q].w[j] = e & ~sg.w[j];
        neg[q].w[j] = e & sg.w[j];
        ec += __popc(e);
      }
    }
    add(2 * D, __reduce_add_sync(0xFFFFFFFFu, ec));
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const int32_t* plane = gs + (long long)(2 + d) * g.W;
      unsigned int cp = 0, cn = 0;
#pragma unroll
      for (int q = 0; q < kSumGroups; ++q) {
        const Vec<V> x = load<V>(plane, word_of<V>(w0, q, tid), g.W);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          cp += __popc(x.w[j] & pos[q].w[j]);
          cn += __popc(x.w[j] & neg[q].w[j]);
        }
      }
      add(d, __reduce_add_sync(0xFFFFFFFFu, cp));
      add(D + d, __reduce_add_sync(0xFFFFFFFFu, cn));
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
    slots[(long long)k * gridDim.x + blockIdx.x] = v;  // counter-major
  }
  if (!last_block_done(ticket, &last)) return;
  // each warp sums counters warp, warp + 8, ... over every block's slot,
  // four independent loads a lane in flight
  for (int k = warp; k < K; k += kWarps) {
    const unsigned long long* row = slots + (long long)k * gridDim.x;
    unsigned long long v = 0, v1 = 0, v2 = 0, v3 = 0;
    unsigned int b = lane;
    for (; b + 96 < gridDim.x; b += 128) {
      v += __ldcg(row + b);
      v1 += __ldcg(row + b + 32);
      v2 += __ldcg(row + b + 64);
      v3 += __ldcg(row + b + 96);
    }
    for (; b < gridDim.x; b += 32) v += __ldcg(row + b);
    v += v1 + v2 + v3;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) out[k] = v;
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch on this stream
}

// ---- kernel D ---------------------------------------------------------------

// (magnitude, count of columns at it); count 0 is the empty set.
struct Ext {
  unsigned long long mag, cnt;
};

__device__ __forceinline__ Ext combine(const Ext a, const Ext b, bool max) {
  if (a.cnt == 0) return b;
  if (b.cnt == 0) return a;
  if (a.mag == b.mag) return Ext{a.mag, a.cnt + b.cnt};
  return (max ? a.mag > b.mag : a.mag < b.mag) ? a : b;
}

// One plane of a greedy descent over the columns of c (reference
// bsi.py:252 _descend): maximising, t = c & plane; minimising,
// t = c & ~plane; c keeps t where t has a column.  The magnitude's bit d is
// set when the maximising step keeps t, or when the minimising step cannot
// (and c is not empty).  Branch-free: `any` differs between threads.
template <int V, bool MAX>
__device__ __forceinline__ void descend_step(Vec<V>& c, const Vec<V>& x,
                                             unsigned long long& mag, int d,
                                             uint32_t nonempty) {
  Vec<V> t;
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t.w[j] = MAX ? (c.w[j] & x.w[j]) : (c.w[j] & ~x.w[j]);
    any |= t.w[j];
  }
  const uint32_t m = any ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) c.w[j] = (t.w[j] & m) | (c.w[j] & ~m);
  const bool bit = MAX ? any != 0u : (any == 0u && nonempty != 0u);
  mag |= (unsigned long long)bit << d;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bsi_min_max_kernel(const int32_t* __restrict__ group,
                   const int32_t* __restrict__ filt, const Geometry g,
                   unsigned long long* __restrict__ out,
                   unsigned long long* __restrict__ slots,
                   unsigned int* __restrict__ ticket) {
  __shared__ Ext warp_ext[kWarps][kDescents];
  __shared__ int last;
  constexpr long long kTile = (long long)kThreads * V * kMinMaxGroups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (long long t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const long long s = t / g.tps, w0 = (t % g.tps) * kTile;
    const int32_t* gs = group + s * g.shard_stride;
    const int32_t* fs = filt + s * g.W;
    Ext acc[kDescents] = {};
    for (int q = 0; q < kMinMaxGroups; ++q) {
      const long long i = word_of<V>(w0, q, tid);
      const Vec<V> ex = load<V>(gs, i, g.W), sg = load<V>(gs + g.W, i, g.W),
                   f = load<V>(fs, i, g.W);
      Vec<V> c[kDescents];
      uint32_t any_pos = 0, any_neg = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t e = ex.w[j] & f.w[j];
        c[0].w[j] = c[1].w[j] = e & ~sg.w[j];
        c[2].w[j] = c[3].w[j] = e & sg.w[j];
        any_pos |= c[0].w[j];
        any_neg |= c[2].w[j];
      }
      unsigned long long mag[kDescents] = {};
#pragma unroll 4
      for (int d = g.D - 1; d >= 0; --d) {
        const Vec<V> x = load<V>(gs + (long long)(2 + d) * g.W, i, g.W);
        descend_step<V, false>(c[0], x, mag[0], d, any_pos);
        descend_step<V, true>(c[1], x, mag[1], d, any_pos);
        descend_step<V, false>(c[2], x, mag[2], d, any_neg);
        descend_step<V, true>(c[3], x, mag[3], d, any_neg);
      }
#pragma unroll
      for (int k = 0; k < kDescents; ++k)
        acc[k] = combine(acc[k], Ext{mag[k], popc(c[k])}, k & 1);
    }
    // the tile's four pairs: warps, then the block, into slot t
#pragma unroll
    for (int k = 0; k < kDescents; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const Ext o{__shfl_down_sync(0xFFFFFFFFu, acc[k].mag, off),
                    __shfl_down_sync(0xFFFFFFFFu, acc[k].cnt, off)};
        acc[k] = combine(acc[k], o, k & 1);
      }
      if (lane == 0) warp_ext[warp][k] = acc[k];
    }
    __syncthreads();
    if (tid < kDescents) {
      Ext a = warp_ext[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a = combine(a, warp_ext[w][tid], tid & 1);
      slots[t * kSlotWords + 2 * tid] = a.mag;
      slots[t * kSlotWords + 2 * tid + 1] = a.cnt;
    }
    __syncthreads();  // warp_ext is free for the next tile
  }
  if (!last_block_done(ticket, &last)) return;
  for (long long s = tid; s < g.S; s += kThreads) {
#pragma unroll
    for (int k = 0; k < kDescents; ++k) {
      Ext a{0ull, 0ull};
      for (long long tt = s * g.tps; tt < (s + 1) * g.tps; ++tt) {
        const Ext b{__ldcg(slots + tt * kSlotWords + 2 * k),
                    __ldcg(slots + tt * kSlotWords + 2 * k + 1)};
        a = combine(a, b, k & 1);
      }
      out[s * kSlotWords + 2 * k] = a.mag;
      out[s * kSlotWords + 2 * k + 1] = a.cnt;
    }
  }
  if (tid == 0) *ticket = 0;
}

// ---- launch -----------------------------------------------------------------

using BsiKernel = decltype(&bsi_sum_planes_kernel<4>);
constexpr int kForms = 4;  // (kernel C, kernel D) x (V = 4, V = 1)
const BsiKernel kFormTable[kForms] = {
    bsi_sum_planes_kernel<4>, bsi_sum_planes_kernel<1>,
    bsi_min_max_kernel<4>, bsi_min_max_kernel<1>};

// Per device: SMs and resident blocks a SM of each form.
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The geometry, form and grid of a launch of kernel `which` (0 = C, 1 = D).
cudaError_t plan_launch(int which, const void* group, const void* filt, int S,
                        int D, long long W, Geometry* g, int* form,
                        unsigned int* grid) {
  if (group == nullptr || filt == nullptr || S <= 0 || W <= 0 || D < 1 ||
      D > kMaxDepth)
    return cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(group) && aligned16(filt);
  DeviceInfo* info = nullptr;
  const cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  *form = 2 * which + (vec ? 0 : 1);
  const long long tile = (long long)kThreads * (vec ? 4 : 1) *
                         (which == 0 ? kSumGroups : kMinMaxGroups);
  g->W = W;
  g->shard_stride = (long long)(D + 2) * W;
  g->tps = (W + tile - 1) / tile;
  g->n_tiles = g->tps * S;
  g->S = S;
  g->D = D;
  const long long cap = (long long)info->sms * info->blocks[*form];
  *grid = (unsigned int)(g->n_tiles < cap ? g->n_tiles : cap);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The deepest group a launch takes, and the words of the smallest tile of
// either kernel (kernel C's scalar form), so S x ceil(W / it) bounds the
// tiles of any launch.
int fb_bsi_limits(int* max_depth, int* scalar_tile_words) {
  *max_depth = kMaxDepth;
  *scalar_tile_words =
      kThreads * (kSumGroups < kMinMaxGroups ? kSumGroups : kMinMaxGroups);
  return 0;
}

// Kernel C.  group ((S, D + 2, W) int32, contiguous) and filt ((S, W) int32,
// contiguous) -> out ((2D + 1,) int64: positive plane counts, negative plane
// counts, the count).  slots: n_slots int64 of scratch, (2D + 1) x the tiles
// of the launch always enough, no zeroing.  ticket: a uint32 that is 0
// before the launch and 0 again after it.
int fb_bsi_sum_planes(const void* group, const void* filt, int S, int D,
                      long long W, void* out, void* slots, long long n_slots,
                      void* ticket, void* stream) {
  Geometry g;
  int form = 0;
  unsigned int grid = 0;
  const cudaError_t e = plan_launch(0, group, filt, S, D, W, &g, &form, &grid);
  if (e != cudaSuccess) return (int)e;
  if (out == nullptr || slots == nullptr || ticket == nullptr ||
      (long long)(2 * D + 1) * grid > n_slots)
    return (int)cudaErrorInvalidValue;
  kFormTable[form]<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(group), static_cast<const int32_t*>(filt), g,
      static_cast<unsigned long long*>(out),
      static_cast<unsigned long long*>(slots),
      static_cast<unsigned int*>(ticket));
  return (int)cudaGetLastError();
}

// Kernel D.  The same inputs -> out ((S, 4, 2) int64: per shard pos-min,
// pos-max, neg-min, neg-max, each as (magnitude, count)).  slots: 8 x the
// tiles of the launch int64 of scratch; ticket as for kernel C.
int fb_bsi_min_max(const void* group, const void* filt, int S, int D,
                   long long W, void* out, void* slots, long long n_slots,
                   void* ticket, void* stream) {
  Geometry g;
  int form = 0;
  unsigned int grid = 0;
  const cudaError_t e = plan_launch(1, group, filt, S, D, W, &g, &form, &grid);
  if (e != cudaSuccess) return (int)e;
  if (out == nullptr || slots == nullptr || ticket == nullptr ||
      kSlotWords * g.n_tiles > n_slots)
    return (int)cudaErrorInvalidValue;
  kFormTable[form]<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(group), static_cast<const int32_t*>(filt), g,
      static_cast<unsigned long long*>(out),
      static_cast<unsigned long long*>(slots),
      static_cast<unsigned int*>(ticket));
  return (int)cudaGetLastError();
}

}  // extern "C"
