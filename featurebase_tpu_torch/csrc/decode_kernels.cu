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
// percentile_counts (kernel I') is the counterpart of the counting passes
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
//   filter words (570 MB at S = 128: 170 us).  The first kernel I ran a round
//   of 129 thresholds at 28% of that: a data-dependent binary search a
//   value (8 dependent shared loads), a branch and a shared atomic into one
//   histogram for the block's 8 warps, and one 16-byte load in flight a
//   lane.  The design of I':
//   - as G, a warp takes 1,024 columns and loads their exists & filter
//     words (32 lanes, one word each); a lane then issues all 8 of its
//     16-byte value loads, each predicated on its 4 columns' present bits,
//     before any compare;
//   - values below t_0 or above t_{K-1} (most of them in the later rounds,
//     whose pivots crowd together) count in registers with predicated
//     adds, as do the min and the max; a warp searches only when one of
//     its values lies between (a ballot);
//   - the search is a bucket table over [t_0, t_{K-1}]: a value whose
//     bucket holds no threshold (most of them) has its bin from one shared
//     load, the rest finish with a branchless lift over the bucket's few
//     thresholds, padded with INT_MAX (see kPctBuckets);
//   - each warp has its own histogram in shared memory (8 x (2K + 1) x 4
//     bytes, 33 KB at K = 512), summed once at the end of the block, and
//     each nonzero bin is added to the output with one int64 atomic, after
//     a grid-stride loop over every chunk;
//   - a round of at most 4 thresholds (the K = 2 rounds of nth 0 and 100,
//     which send almost every value to one bin) counts in registers
//     instead: per threshold, a lane's values above it and equal to it, 2K
//     predicated adds a value and no shared memory (kRegK).  Merging a
//     warp's equal bins with __match_any_sync before a shared atomic was
//     measured slower (PERF.md);
//   - the prep pass (K = 0) counts the present columns with a popcount of
//     their words and keeps only the min and the max.
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

// Kernel I' finds each value's bin with a search of a bounded number of
// steps.  By default a table of kBuckets buckets over [t_0, t_{K-1}]
// (built by each block) gives, for the value's bucket, the first threshold
// at or past the bucket's start and how many thresholds lie inside it: a
// bucket with none (most of them) is the bin itself, one with some takes a
// branchless lift over those few.  -DFB_PCT_BINARY builds the lift over all
// K thresholds instead (ceil(log2(K + 1)) steps, padded with INT_MAX).
// chip_smoke.py times both (`pct_ablation`).
#ifdef FB_PCT_BINARY
constexpr bool kPctBuckets = false;
#else
constexpr bool kPctBuckets = true;
#endif
constexpr int kBucketBits = 11;
constexpr int kBuckets = 1 << kBucketBits;
// rounds of at most this many thresholds count in registers: each lane
// keeps, for every threshold, how many of its values lie above it and how
// many equal it (2 K compares a value, no shared memory); the bins follow
// at the end of the block.  The K = 2 rounds of nth 0 and 100 send almost
// every value to one bin, which shared atomics would serialize.
constexpr int kRegK = 4;
// the forms of kernel I': the prep pass (K = 0: the count, the min and the
// max), a narrow round (K <= kRegK) and a wide one
enum PctForm { PCT_PREP = 0, PCT_REGS = 1, PCT_WIDE = 2 };

__host__ __device__ inline int bit_length(unsigned x) {
  int n = 0;
  while (x) {
    ++n;
    x >>= 1;
  }
  return n;
}

// Shared memory of kernel I' at K thresholds, in 4-byte words: the
// thresholds padded with INT_MAX past every index a search reads, a
// histogram a warp, and the bucket table.
__host__ __device__ inline int pct_padded(int K) { return K + (1 << bit_length(K)); }
__host__ __device__ inline int pct_smem_words(int K) {
  return K == 0      ? 0
         : K <= kRegK ? pct_padded(K)
                      : pct_padded(K) + kWarps * (2 * K + 1) +
                            (kPctBuckets ? kBuckets + 1 : 0);
}

// The first k in [0, K) with t[k] >= x, else K (the bucket table only).
__device__ __forceinline__ int first_at_least(const int* t, int K, long long x) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)t[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int FORM>
__global__ void __launch_bounds__(kThreads)
percentile_counts_kernel(const int32_t* __restrict__ vals, long long vals_stride,
                         const uint32_t* __restrict__ exists,
                         long long exists_stride,
                         const uint32_t* __restrict__ filt,
                         long long filt_stride, int S, long long W, int base,
                         const int32_t* __restrict__ thresholds, int K,
                         long long* __restrict__ out) {
  extern __shared__ int smem[];
  const int n_bins = 2 * K + 1;
  const int padded = pct_padded(K);
  int* t = smem;
  unsigned* hist = reinterpret_cast<unsigned*>(smem + padded);
  int* table = smem + padded + kWarps * n_bins;
  __shared__ int block_min, block_max;
  __shared__ unsigned long long block_count;
  __shared__ unsigned int reg_sums[2 * kRegK];
  if (threadIdx.x == 0) {
    block_min = INT_MAX;
    block_max = INT_MIN;
    block_count = 0;
  }
  if (threadIdx.x < 2 * kRegK) reg_sums[threadIdx.x] = 0u;
  int shift = 0;
  if constexpr (FORM != PCT_PREP) {
    for (int i = threadIdx.x; i < padded; i += kThreads)
      t[i] = i < K ? thresholds[i] : INT_MAX;
  }
  if constexpr (FORM == PCT_WIDE) {
    for (int i = threadIdx.x; i < kWarps * n_bins; i += kThreads) hist[i] = 0u;
    __syncthreads();
    if (kPctBuckets) {
      // table[b]: the first k with t_k >= t_0 + b << shift (low 16 bits) and
      // the thresholds below the next bucket's start from there (high 16)
      const unsigned span = (unsigned)t[K - 1] - (unsigned)t[0];
      shift = max(bit_length(span) - kBucketBits, 0);
      const int nb = (int)(span >> shift) + 1;   // buckets in use
      for (int b = threadIdx.x; b <= nb; b += kThreads)
        table[b] = first_at_least(t, K, (long long)t[0] + ((long long)b << shift));
      __syncthreads();
      int packed[(kBuckets + kThreads - 1) / kThreads];
#pragma unroll
      for (int i = 0; i < (kBuckets + kThreads - 1) / kThreads; ++i) {
        const int b = threadIdx.x + i * kThreads;
        packed[i] = b < nb ? table[b] | ((table[b + 1] - table[b]) << 16) : 0;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < (kBuckets + kThreads - 1) / kThreads; ++i) {
        const int b = threadIdx.x + i * kThreads;
        if (b < nb) table[b] = packed[i];
      }
    }
  }
  __syncthreads();
  const int t_lo = K ? t[0] : 0, t_hi = K ? t[K - 1] : 0;
  const int full_steps = bit_length((unsigned)K);
  // the bin of x, t_lo <= x <= t_hi (wide form)
  auto bin_of = [&](int x) {
    int k = 0, steps = full_steps;
    if (kPctBuckets) {
      const int e = table[((unsigned)x - (unsigned)t_lo) >> shift];
      k = e & 0xFFFF;
      steps = bit_length((unsigned)e >> 16);
      if (steps == 0) return 2 * k;   // no threshold in x's bucket
    }
    for (int st = 1 << (steps - 1); st > 0; st >>= 1)
      k += t[k + st - 1] < x ? st : 0;
    return 2 * k + (t[k] == x ? 1 : 0);
  };
  // narrow form: the thresholds in registers, and per threshold the lane's
  // values above it and equal to it
  int tr[kRegK];
  unsigned gt[kRegK], eq[kRegK];
#pragma unroll
  for (int k = 0; k < kRegK; ++k) {
    tr[k] = FORM == PCT_REGS && k < K ? t[k] : INT_MAX;
    gt[k] = eq[k] = 0u;
  }
  unsigned* h = hist + (threadIdx.x >> 5) * n_bins;   // this warp's bins
  const int lane = threadIdx.x & 31;
  const int src = lane >> 3, nib_shift = (lane & 7) * 4;
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
    if (__ballot_sync(kFull, e != 0u) == 0u) continue;   // warp-uniform
    const int32_t* v = vals + s * vals_stride + w0 * 32 + lane * 4;
    // every 16-byte load of the chunk in flight before any compare; bit
    // 4 j + b of `pres`: value b of block j is present
    uint32_t pres = 0u;
    int4 q[kBlocks];
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
      const uint32_t nib = (__shfl_sync(kFull, e, j * 4 + src) >> nib_shift) & 0xFu;
      pres |= nib << (4 * j);
      q[j] = nib ? __ldg(reinterpret_cast<const int4*>(v + j * 128))
                 : make_int4(0, 0, 0, 0);
    }
    below += __popc(pres);   // less those at or above t_lo (not prep)
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
      const int xs[4] = {q[j].x, q[j].y, q[j].z, q[j].w};
      unsigned mid = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const bool present = (pres >> (4 * j + b)) & 1u;
        const int x = (int)((unsigned)xs[b] + (unsigned)base);
        v_min = present ? min(v_min, x) : v_min;
        v_max = present ? max(v_max, x) : v_max;
        if constexpr (FORM == PCT_REGS) {
#pragma unroll
          for (int k = 0; k < kRegK; ++k) {
            gt[k] += present && x > tr[k];
            eq[k] += present && x == tr[k];
          }
        } else if constexpr (FORM == PCT_WIDE) {
          below -= present && x >= t_lo;
          above += present && x > t_hi;
          mid |= (unsigned)(present && x >= t_lo && x <= t_hi) << b;
        }
      }
      if constexpr (FORM == PCT_WIDE) {
        // warp-uniform: search only where some lane has a value between
        if (__any_sync(kFull, mid != 0u)) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int x = (int)((unsigned)xs[b] + (unsigned)base);
            if ((mid >> b) & 1u) atomicAdd(&h[bin_of(x)], 1u);
          }
        }
      }
    }
  }
  below = __reduce_add_sync(kFull, below);
  above = __reduce_add_sync(kFull, above);
  v_min = __reduce_min_sync(kFull, v_min);
  v_max = __reduce_max_sync(kFull, v_max);
  if constexpr (FORM == PCT_REGS) {
#pragma unroll
    for (int k = 0; k < kRegK; ++k) {
      gt[k] = __reduce_add_sync(kFull, gt[k]);
      eq[k] = __reduce_add_sync(kFull, eq[k]);
    }
  }
  if (lane == 0) {
    if (FORM == PCT_WIDE) {
      if (below) atomicAdd(&h[0], below);
      if (above) atomicAdd(&h[n_bins - 1], above);
    } else {
      atomicAdd(&block_count, (unsigned long long)below);   // the present
    }
    if constexpr (FORM == PCT_REGS) {
#pragma unroll
      for (int k = 0; k < kRegK; ++k) {
        if (k < K && gt[k]) atomicAdd(&reg_sums[2 * k], gt[k]);
        if (k < K && eq[k]) atomicAdd(&reg_sums[2 * k + 1], eq[k]);
      }
    }
    atomicMin(&block_min, v_min);
    atomicMax(&block_max, v_max);
  }
  __syncthreads();
  if (FORM == PCT_PREP) {
    if (threadIdx.x == 0 && block_count)
      atomicAdd(reinterpret_cast<unsigned long long*>(out), block_count);
  } else if (FORM == PCT_REGS) {
    // bin 2k + 1: x == t_k (empty for a repeat); bin 2k: t_{k-1} < x < t_k
    // (empty for a repeat), the values above t_{k-1} less those above or at
    // t_k; bin 0 the present less those at or above t_0; bin 2K above t_{K-1}
    if (threadIdx.x < (unsigned)n_bins) {
      const int i = threadIdx.x, k = i >> 1;
      const bool repeat = k > 0 && k < K && t[k] == t[k - 1];
      long long c;
      if (i == n_bins - 1) c = reg_sums[2 * (K - 1)];
      else if (i & 1) c = repeat ? 0 : reg_sums[2 * k + 1];
      else if (k == 0) c = (long long)block_count - reg_sums[0] - reg_sums[1];
      else c = repeat ? 0 : (long long)reg_sums[2 * (k - 1)] - reg_sums[2 * k] - reg_sums[2 * k + 1];
      if (c) atomicAdd(reinterpret_cast<unsigned long long*>(out + i),
                       (unsigned long long)c);
    }
  } else {
    for (int i = threadIdx.x; i < n_bins; i += kThreads) {
      unsigned long long c = 0;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) c += hist[wp * n_bins + i];
      if (c) atomicAdd(reinterpret_cast<unsigned long long*>(out + i), c);
    }
  }
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
  const size_t smem = (size_t)pct_smem_words(K) * sizeof(int);
  const int form = K == 0 ? PCT_PREP : K <= kRegK ? PCT_REGS : PCT_WIDE;
  const void* fn = form == PCT_PREP   ? (const void*)percentile_counts_kernel<PCT_PREP>
                   : form == PCT_REGS ? (const void*)percentile_counts_kernel<PCT_REGS>
                                      : (const void*)percentile_counts_kernel<PCT_WIDE>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (long long)S * ((W + 31) / 32);
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long needed = grid_for(chunks);
  if (blocks > needed) blocks = needed;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* v = (const int32_t*)vals;
  const uint32_t* ex = (const uint32_t*)exists;
  const uint32_t* fw = (const uint32_t*)filt;
  const int32_t* th = (const int32_t*)thresholds;
  long long* o = (long long*)out;
  if (form == PCT_PREP)
    percentile_counts_kernel<PCT_PREP><<<(unsigned)blocks, kThreads, smem, st>>>(
        v, vals_stride, ex, exists_stride, fw, filt_stride, S, W, base, th, K, o);
  else if (form == PCT_REGS)
    percentile_counts_kernel<PCT_REGS><<<(unsigned)blocks, kThreads, smem, st>>>(
        v, vals_stride, ex, exists_stride, fw, filt_stride, S, W, base, th, K, o);
  else
    percentile_counts_kernel<PCT_WIDE><<<(unsigned)blocks, kThreads, smem, st>>>(
        v, vals_stride, ex, exists_stride, fw, filt_stride, S, W, base, th, K, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
