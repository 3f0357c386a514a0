// Hand-written Hopper kernels of the count-and tuning harness (sm_90a).
//
// Four kernels, each behind a plain C launcher that ops/tune_kernels.py loads
// with ctypes.  As in bitmap_kernels.cu, launchers take device pointers and
// the caller's stream, launch, and return cudaGetLastError() (0 on success);
// they never synchronise and never allocate.  They replace the three Pallas
// kernels of tools/tune_count_kernel.py, and
// featurebase_tpu_torch/tools/tune_count_kernel.py sweeps them:
//
//   tune_ceiling         build_ceiling.run (:85): the two-stream read ceiling,
//                        acc + sum of (a ^ b) over every word, mod 2^32.
//                        The TPU body folds only row 0 of each (rows, cols)
//                        block (:82-83), because its DMA moves the whole block
//                        whatever the body touches.  On a GPU a word that is
//                        never used is never loaded, so this kernel folds
//                        every word it reads.  Its value therefore differs
//                        from the TPU ceiling's; neither is a popcount
//                        (`exact=False`, :102).
//   tune_csa_scalar      build_csa_smem.run (:121): acc + popcount(a & b)
//                        with a 4-way carry-save adder (_csa, :66-70) over
//                        the four lanes of each 16-byte load.  Each block
//                        reduces to one sum and makes one atomicAdd into a
//                        single 32-bit counter, which takes the place of the
//                        TPU's (1, 1) SMEM scalar carried over a sequential
//                        grid.
//   tune_direct_partial  _partial_call (:140) with build_direct_partial
//                        (:160): popcount(a & b), one partial per block, no
//                        atomics.  acc is added into block 0's partial
//                        (:168-172); the caller sums the partials.
//   tune_csa_partial     _partial_call with build_csa_partial (:176): the
//                        same with the carry-save adder.
//
// Bound: bytes.  Each kernel reads both streams once (2 x n x 4 bytes) and
// writes one word per block; at 3.35 TB/s two 256 MB streams take 160 us.
// Design: every thread keeps V 16-byte loads of each stream in flight
// (LDG.E.128), consecutive threads on consecutive 16-byte words, in a
// grid-stride loop over a grid of (resident blocks per SM) x SMs.  T
// (threads per block) and V take the place of the TPU's (rows, cols) VMEM
// blocks; the shapes the harness sweeps are instantiated below.
// Arithmetic is uint32 and wraps mod 2^32, as the TPU's int32 sums do
// (signed overflow would be undefined in C++).

#include <cuda_runtime.h>
#include <stdint.h>

// (T, V) launch shapes, mirrored in ops/tune_kernels.py::SHAPES; a shape
// not listed here fails at launch with cudaErrorInvalidValue.  T * V is at
// most 2048 so that the V loads of each stream stay in registers at
// __launch_bounds__(T).
#define FB_TUNE_SHAPES(X) \
  X(128, 8) X(256, 1) X(256, 2) X(256, 4) X(256, 8) X(512, 2) X(512, 4) \
  X(1024, 1) X(1024, 2)

namespace {

enum Kind : int {
  KIND_CEILING = 0, KIND_CSA_SCALAR = 1, KIND_DIRECT_PARTIAL = 2,
  KIND_CSA_PARTIAL = 3,
};

// What each kernel folds, for one 16-byte load of each stream (quad) and for
// one of the < 4 words after the last whole load (word).
struct CeilingFold {
  static __device__ __forceinline__ uint32_t quad(uint4 a, uint4 b) {
    return (a.x ^ b.x) + (a.y ^ b.y) + (a.z ^ b.z) + (a.w ^ b.w);
  }
  static __device__ __forceinline__ uint32_t word(uint32_t a, uint32_t b) {
    return a ^ b;
  }
};

struct DirectFold {
  static __device__ __forceinline__ uint32_t quad(uint4 a, uint4 b) {
    return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
           __popc(a.w & b.w);
  }
  static __device__ __forceinline__ uint32_t word(uint32_t a, uint32_t b) {
    return __popc(a & b);
  }
};

// The Pallas body groups rows i, i + r/4, i + r/2, i + 3r/4 (:106-114); any
// four words give the same total, so the four lanes of one load are grouped.
struct CsaFold {
  static __device__ __forceinline__ uint32_t quad(uint4 a, uint4 b) {
    const uint32_t w0 = a.x & b.x, w1 = a.y & b.y, w2 = a.z & b.z,
                   w3 = a.w & b.w;
    const uint32_t xy = w0 ^ w1;
    const uint32_t s1 = xy ^ w2;
    const uint32_t c1 = (w0 & w1) | (xy & w2);
    const uint32_t ones = s1 ^ w3, c2 = s1 & w3;
    return __popc(ones) + 2u * (__popc(c1) + __popc(c2));
  }
  static __device__ __forceinline__ uint32_t word(uint32_t a, uint32_t b) {
    return __popc(a & b);
  }
};

// Sum of a block's per-thread values; valid in thread 0.
template <int T>
__device__ __forceinline__ uint32_t block_sum(uint32_t s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, off);
  __shared__ uint32_t warp_sum[T / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  uint32_t total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < T / 32; ++w) total += warp_sum[w];
  }
  return total;
}

// This block's fold of both streams (n words each, 16-byte aligned): a
// grid-stride loop in steps of T x V 16-byte words, then the ragged last
// step, then (block 0) the < 4 words after the last whole load.
template <class Fold, int T, int V>
__device__ __forceinline__ uint32_t fold_streams(const uint32_t* __restrict__ a,
                                                 const uint32_t* __restrict__ b,
                                                 long long n) {
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  const long long n4 = n >> 2;
  const long long step = (long long)gridDim.x * (T * V);
  long long i = (long long)blockIdx.x * (T * V) + threadIdx.x;
  uint32_t s = 0;
  for (; i + (long long)(V - 1) * T < n4; i += step) {
    uint4 x[V], y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      x[v] = __ldg(a4 + i + v * T);
      y[v] = __ldg(b4 + i + v * T);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) s += Fold::quad(x[v], y[v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long j = i + v * T;
    if (j < n4) s += Fold::quad(__ldg(a4 + j), __ldg(b4 + j));
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const long long j = 4 * n4 + threadIdx.x;
    s += Fold::word(__ldg(a + j), __ldg(b + j));
  }
  return block_sum<T>(s);
}

// Scalar kernels: one atomicAdd per block into out[0], which the launcher
// presets to acc.  Partial kernels: out[blockIdx.x] = this block's sum, plus
// acc in block 0.  All four share one parameter list, so one launcher serves.
template <int T, int V>
__global__ void __launch_bounds__(T)
tune_ceiling_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    long long n, const uint32_t* __restrict__ acc, uint32_t* out) {
  const uint32_t s = fold_streams<CeilingFold, T, V>(a, b, n);
  if (threadIdx.x == 0) atomicAdd(out, s);
}

template <int T, int V>
__global__ void __launch_bounds__(T)
tune_csa_scalar_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                       long long n, const uint32_t* __restrict__ acc, uint32_t* out) {
  const uint32_t s = fold_streams<CsaFold, T, V>(a, b, n);
  if (threadIdx.x == 0) atomicAdd(out, s);
}

template <int T, int V>
__global__ void __launch_bounds__(T)
tune_direct_partial_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b, long long n,
                           const uint32_t* __restrict__ acc,
                           uint32_t* __restrict__ out) {
  const uint32_t s = fold_streams<DirectFold, T, V>(a, b, n);
  if (threadIdx.x == 0) out[blockIdx.x] = s + (blockIdx.x == 0 ? *acc : 0u);
}

template <int T, int V>
__global__ void __launch_bounds__(T)
tune_csa_partial_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b, long long n,
                        const uint32_t* __restrict__ acc,
                        uint32_t* __restrict__ out) {
  const uint32_t s = fold_streams<CsaFold, T, V>(a, b, n);
  if (threadIdx.x == 0) out[blockIdx.x] = s + (blockIdx.x == 0 ? *acc : 0u);
}

// The kernel of `kind` at (T, V), or null for a shape not instantiated.
const void* kernel_for(int kind, int t, int v) {
#define FB_TUNE_CASE(TT, VV)                                                  \
  if (t == TT && v == VV) {                                                   \
    switch (kind) {                                                           \
      case KIND_CEILING: return (const void*)tune_ceiling_kernel<TT, VV>;     \
      case KIND_CSA_SCALAR: return (const void*)tune_csa_scalar_kernel<TT, VV>; \
      case KIND_DIRECT_PARTIAL:                                               \
        return (const void*)tune_direct_partial_kernel<TT, VV>;               \
      case KIND_CSA_PARTIAL: return (const void*)tune_csa_partial_kernel<TT, VV>; \
      default: return nullptr;                                                \
    }                                                                         \
  }
  FB_TUNE_SHAPES(FB_TUNE_CASE)
#undef FB_TUNE_CASE
  return nullptr;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch(int kind, const void* a, const void* b, long long n, const void* acc,
           void* out, int t, int v, int blocks, void* stream) {
  const void* fn = kernel_for(kind, t, v);
  if (fn == nullptr || n <= 0 || blocks <= 0 || !aligned16(a) || !aligned16(b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_CEILING || kind == KIND_CSA_SCALAR) {
    cudaError_t e = cudaMemcpyAsync(out, acc, sizeof(uint32_t),
                                    cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
  }
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  const uint32_t* pacc = static_cast<const uint32_t*>(acc);
  uint32_t* pout = static_cast<uint32_t*>(out);
  void* args[] = {&pa, &pb, &n, &pacc, &pout};
  cudaError_t e = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3((unsigned)t),
                                   args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Grid of the kernel of `kind` at (T, V) over n words a stream on the
// current device: resident blocks per SM x SMs, but no more blocks than
// there are steps of T x V 16-byte words.  The partial kernels write one
// word a block, so the caller sizes their output with this.
int fb_tune_grid(int kind, int t, int v, long long n, int* blocks) {
  const void* fn = kernel_for(kind, t, v);
  if (fn == nullptr || n <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, t, 0);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)t * v * 4;
  const long long need = (n + per_block - 1) / per_block;
  const long long full = (long long)per_sm * sms;
  *blocks = (int)(need < full ? need : full);
  if (*blocks < 1) *blocks = 1;
  return 0;
}

// Each launcher: a and b are n int32 words (16-byte aligned), acc one int32
// word, all on the device.  Ceiling and csa_scalar: out is one word, preset
// to acc here on the stream.  The partials: out holds `blocks` words.
int fb_tune_ceiling(const void* a, const void* b, long long n, const void* acc,
                    void* out, int t, int v, int blocks, void* stream) {
  return launch(KIND_CEILING, a, b, n, acc, out, t, v, blocks, stream);
}

int fb_tune_csa_scalar(const void* a, const void* b, long long n, const void* acc,
                       void* out, int t, int v, int blocks, void* stream) {
  return launch(KIND_CSA_SCALAR, a, b, n, acc, out, t, v, blocks, stream);
}

int fb_tune_direct_partial(const void* a, const void* b, long long n,
                           const void* acc, void* out, int t, int v, int blocks,
                           void* stream) {
  return launch(KIND_DIRECT_PARTIAL, a, b, n, acc, out, t, v, blocks, stream);
}

int fb_tune_csa_partial(const void* a, const void* b, long long n, const void* acc,
                        void* out, int t, int v, int blocks, void* stream) {
  return launch(KIND_CSA_PARTIAL, a, b, n, acc, out, t, v, blocks, stream);
}

}  // extern "C"
