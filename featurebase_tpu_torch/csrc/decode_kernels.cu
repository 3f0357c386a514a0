// Hand-written Hopper kernels for the BSI decode family (sm_90a).
//
// Three kernels, each behind a plain C launcher that ops/cuda_kernels.py
// loads with ctypes, as it loads the other sources.  Launchers take device
// pointers and the caller's stream, launch, and return a cudaError_t (0 on
// success); they never synchronise and never allocate.  A BSI group is
// (D + 2) planes of W int32 words (plane 0 exists, plane 1 sign, plane
// 2 + i magnitude bit i); column c of a shard is bit c & 31 of word c >> 5.
// Values are sign and magnitude relative to the field's base, and the
// decode is int32, so D <= 31.
//
// bsi_decode (kernel G) is the counterpart of the XLA programs
//   featurebase_tpu/ops/bsi.py decode_values (:759) and decode_values_jit
//   (:482): a stacked (S, D + 2, W) group -> (S, 32 W) int32 values, each
//   the magnitude, negated where the sign bit is set (-acc, as
//   decode_values does), whatever the exists bit says.
//   Bound: bytes.  It reads the sign and D magnitude planes once and
//   writes 4 bytes a column: at S = 128, D = 14, 252 MB in and 537 MB out
//   (235 us at 3.35 TB/s); two thirds of the bytes are the writes.  It is a
//   bit-matrix transpose, so the design is about coalescing both sides: a
//   warp takes 32 consecutive words (1,024 columns), lane l loads word l of
//   each plane (one 128-byte load a plane), and lane l owns columns
//   128 j + 4 l .. + 3 of each of 8 blocks j, which it writes as one 16-byte
//   store a block (a warp's stores cover 512 consecutive bytes).  The
//   word holding a lane's 4 columns of block j is fetched from its owner
//   with one __shfl_sync a plane and block: 8 shuffles a plane for 32
//   columns, and the 32 values stay in registers until the stores.
// bsi_decode_gather (kernel G') is the counterpart of decode_gather
//   (:367): one shard's (D + 2, W) group and N columns -> (vals int32,
//   ok int32) of those columns.  One thread a column reads the word
//   c >> 5 of the exists, sign and D magnitude planes and takes bit c & 31.
//   Bound: latency (N is at most a shard's matched columns); what matters
//   is one launch a shard, not one a column.
// percentile_counts (kernel I) is the counterpart of the counting passes
//   of percentile_fused (:491-607).  Over stacked (S, 32 W) int32 values
//   (the cached decode), their (S, W) exists words and an (S, W) filter,
//   with x = value + base (int32) for every column whose exists and filter
//   bits are set, and K thresholds t_0 <= ... <= t_{K-1}, it builds the
//   histogram of the 2K + 1 bins the thresholds make (bin 2k: x between
//   t_{k-1} and t_k, bin 2k + 1: x == t_k; duplicates in t leave their
//   later bins empty), and the min and max of x: 2K + 3 int64.  The host
//   derives every count below, at and above each pivot of a bisection round
//   as prefix sums of the bins (ops/decode.py), where JAX compares every
//   value with 31 pivots twice.  K = 0 is the prep pass: bin 0 is the total.
//   Bound: bytes, 4 bytes a column of values and 1/4 byte of exists and
//   filter words (570 MB at S = 128: 170 us); a column costs a binary
//   search of the thresholds in shared memory (log2 K steps), which at
//   K = 129 (a round of 7 levels) stays under the bytes.  Design: as G, a
//   warp takes 1,024 columns, loads their exists & filter words (32 lanes,
//   one word each) and skips the values of a block of 4 columns none of
//   which is present; a lane reads its 4 values with one 16-byte load.
//   Values below t_0 or above t_{K-1} (most of them in the later rounds,
//   whose pivots crowd together) count in registers; the rest go to a
//   per-block histogram in shared memory.  Each block adds its nonzero bins
//   to the output with int64 atomics once, after a grid-stride loop over
//   every chunk, so a launch makes a few hundred thousand atomics at most.
//   The wrapper zeroes the bins and seeds the min and max.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 31;          // int32 values
constexpr int kMaxThresholds = 512;    // kernel I's thresholds a launch
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlocks = 8;             // 16-byte blocks of a lane in a chunk

__global__ void __launch_bounds__(kThreads)
bsi_decode_kernel(const uint32_t* __restrict__ group, long long shard_stride,
                  long long plane_stride, int S, int D, long long W,
                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long per_shard = (W + 31) / 32;
  const long long n_chunks = (long long)S * per_shard;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const int src = lane >> 3;          // word of a 4-word block this lane reads
  const int shift = (lane & 7) * 4;   // its first bit in that word
  const long long C = W * 32;
  for (long long chunk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       chunk < n_chunks; chunk += n_warps) {
    const long long s = chunk / per_shard;
    const long long w0 = (chunk - s * per_shard) * 32;
    const bool in = w0 + lane < W;
    const uint32_t* g = group + s * shard_stride + w0 + lane;
    uint32_t acc[kBlocks][4];
#pragma unroll
    for (int j = 0; j < kBlocks; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[j][b] = 0u;
#pragma unroll 2
    for (int p = 0; p < D; ++p) {
      const uint32_t word = in ? __ldg(g + (2LL + p) * plane_stride) : 0u;
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
        const uint32_t x = __shfl_sync(kFull, word, j * 4 + src) >> shift;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[j][b] |= ((x >> b) & 1u) << p;
      }
    }
    const uint32_t sign = in ? __ldg(g + plane_stride) : 0u;
    int32_t* o = out + s * C + w0 * 32 + lane * 4;
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
      const uint32_t x = __shfl_sync(kFull, sign, j * 4 + src) >> shift;
      int4 v;
      v.x = (int32_t)((x & 1u) ? 0u - acc[j][0] : acc[j][0]);
      v.y = (int32_t)((x & 2u) ? 0u - acc[j][1] : acc[j][1]);
      v.z = (int32_t)((x & 4u) ? 0u - acc[j][2] : acc[j][2]);
      v.w = (int32_t)((x & 8u) ? 0u - acc[j][3] : acc[j][3]);
      if (w0 + j * 4 + src < W) *reinterpret_cast<int4*>(o + j * 128) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bsi_decode_gather_kernel(const uint32_t* __restrict__ group,
                         long long plane_stride, int D,
                         const int32_t* __restrict__ cols, long long n,
                         int32_t* __restrict__ vals, int32_t* __restrict__ ok) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = cols[i];
  const uint32_t* g = group + (c >> 5);
  const int bit = c & 31;
  uint32_t mag = 0u;
  for (int p = 0; p < D; ++p)
    mag |= ((__ldg(g + (2LL + p) * plane_stride) >> bit) & 1u) << p;
  const bool neg = (__ldg(g + plane_stride) >> bit) & 1u;
  vals[i] = (int32_t)(neg ? 0u - mag : mag);
  ok[i] = (int32_t)((__ldg(g) >> bit) & 1u);
}

__global__ void __launch_bounds__(kThreads)
percentile_counts_kernel(const int32_t* __restrict__ vals, long long vals_stride,
                         const uint32_t* __restrict__ exists,
                         long long exists_stride,
                         const uint32_t* __restrict__ filt,
                         long long filt_stride, int S, long long W, int base,
                         const int32_t* __restrict__ thresholds, int K,
                         long long* __restrict__ out) {
  extern __shared__ int smem[];
  int* t = smem;                                             // K thresholds
  unsigned* hist = reinterpret_cast<unsigned*>(smem + K);    // 2K + 1 bins
  __shared__ int block_min, block_max;
  const int n_bins = 2 * K + 1;
  for (int i = threadIdx.x; i < K; i += kThreads) t[i] = thresholds[i];
  for (int i = threadIdx.x; i < n_bins; i += kThreads) hist[i] = 0u;
  if (threadIdx.x == 0) {
    block_min = INT_MAX;
    block_max = INT_MIN;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int src = lane >> 3, shift = (lane & 7) * 4;
  const int t_lo = K ? t[0] : 0, t_hi = K ? t[K - 1] : 0;
  unsigned below = 0u, above = 0u;
  int v_min = INT_MAX, v_max = INT_MIN;
  const long long per_shard = (W + 31) / 32;
  const long long n_chunks = (long long)S * per_shard;
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long chunk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       chunk < n_chunks; chunk += n_warps) {
    const long long s = chunk / per_shard;
    const long long w0 = (chunk - s * per_shard) * 32;
    const long long w = w0 + lane;
    const uint32_t e = w < W ? __ldg(exists + s * exists_stride + w) &
                                   __ldg(filt + s * filt_stride + w)
                             : 0u;
    if (__ballot_sync(kFull, e != 0u) == 0u) continue;
    const int32_t* v = vals + s * vals_stride + w0 * 32 + lane * 4;
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
      const unsigned nib = (__shfl_sync(kFull, e, j * 4 + src) >> shift) & 0xFu;
      if (nib == 0u) continue;
      const int4 q = __ldg(reinterpret_cast<const int4*>(v + j * 128));
      const int xs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (!((nib >> b) & 1u)) continue;
        const int x = (int)((unsigned)xs[b] + (unsigned)base);
        v_min = min(v_min, x);
        v_max = max(v_max, x);
        if (K == 0 || x < t_lo) {
          ++below;
        } else if (x > t_hi) {
          ++above;
        } else {   // t_lo <= x <= t_hi: the first k with t[k] >= x
          int lo = 0, hi = K - 1;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (t[mid] < x) lo = mid + 1; else hi = mid;
          }
          atomicAdd(&hist[t[lo] == x ? 2 * lo + 1 : 2 * lo], 1u);
        }
      }
    }
  }
  below = __reduce_add_sync(kFull, below);
  above = __reduce_add_sync(kFull, above);
  v_min = __reduce_min_sync(kFull, v_min);
  v_max = __reduce_max_sync(kFull, v_max);
  if (lane == 0) {
    if (below) atomicAdd(&hist[0], below);
    if (above) atomicAdd(&hist[n_bins - 1], above);
    atomicMin(&block_min, v_min);
    atomicMax(&block_max, v_max);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += kThreads)
    if (hist[i])
      atomicAdd(reinterpret_cast<unsigned long long*>(out + i),
                (unsigned long long)hist[i]);
  if (threadIdx.x == 0) {
    atomicMin(out + n_bins, (long long)block_min);
    atomicMax(out + n_bins + 1, (long long)block_max);
  }
}

int grid_for(long long warps_of_work) {
  const long long blocks = (warps_of_work + kWarps - 1) / kWarps;
  return (int)(blocks < 1 ? 1 : (blocks > INT_MAX ? INT_MAX : blocks));
}

}  // namespace

extern "C" {

int fb_decode_limits(int* max_depth, int* max_thresholds) {
  *max_depth = kMaxDepth;
  *max_thresholds = kMaxThresholds;
  return 0;
}

int fb_bsi_decode(const void* group, long long shard_stride,
                  long long plane_stride, int S, int D, long long W, void* out,
                  void* stream) {
  if (S <= 0 || W <= 0 || D < 1 || D > kMaxDepth) return cudaErrorInvalidValue;
  const long long chunks = (long long)S * ((W + 31) / 32);
  bsi_decode_kernel<<<grid_for(chunks), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)group, shard_stride, plane_stride, S, D, W,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int fb_bsi_decode_gather(const void* group, long long plane_stride, int D,
                         const void* cols, long long n, void* vals, void* ok,
                         void* stream) {
  if (n <= 0) return 0;
  if (D < 1 || D > kMaxDepth) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  bsi_decode_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)group, plane_stride, D, (const int32_t*)cols, n,
      (int32_t*)vals, (int32_t*)ok);
  return (int)cudaGetLastError();
}

int fb_percentile_counts(const void* vals, long long vals_stride,
                         const void* exists, long long exists_stride,
                         const void* filt, long long filt_stride, int S,
                         long long W, int base, const void* thresholds, int K,
                         void* out, void* stream) {
  if (S <= 0 || W <= 0 || K < 0 || K > kMaxThresholds)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * K + 1) * sizeof(int);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, percentile_counts_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (long long)S * ((W + 31) / 32);
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long needed = grid_for(chunks);
  if (blocks > needed) blocks = needed;
  percentile_counts_kernel<<<(unsigned)blocks, kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const int32_t*)vals, vals_stride, (const uint32_t*)exists, exists_stride,
      (const uint32_t*)filt, filt_stride, S, W, base,
      (const int32_t*)thresholds, K, (long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
