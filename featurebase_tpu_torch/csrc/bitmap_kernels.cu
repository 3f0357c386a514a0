// Hand-written Hopper kernels for the bitmap engine (sm_90a).
//
// Two kernels, each behind a plain C launcher that ops/cuda_kernels.py loads
// with ctypes.  Launchers take device pointers and the caller's stream,
// launch, and return cudaGetLastError() (0 on success); they never
// synchronise and never allocate.
//
// plan_eval (kernel A) replaces featurebase_tpu/ops/pallas_kernels.py
//   count_and_pallas (fused AND + popcount) and, through it, the XLA fusion
//   of executor/plan.py that evaluates a whole bitmap plan and counts it.
//   The host lowers a plan to a short register program over leaf "planes"
//   (each plane an (S, W) int32 array with a shard stride).  Every thread
//   runs the program over VEC consecutive words of one shard: each leaf word
//   is read from HBM once, intermediates live in a per-thread register file
//   in shared memory, and in count mode the result words never reach HBM
//   (popcount with __popc, warp reduction with __shfl_down_sync, one
//   64-bit atomicAdd per warp into the shard's counter).
//   Bound: bytes.  A query reads (planes x S x W x 4) bytes; on an H100 SXM
//   at 3.35 TB/s an intersect of two rows at S=64 is 16.8 MB, 5.0 us, and a
//   16-plane BSI comparison 134 MB, 40 us.  The design streams 16-byte loads
//   (one per plane per thread) with consecutive threads on consecutive words.
//
// row_counts (kernel B) replaces pallas_kernels.py count_and_rows_pallas and
//   popcount_rows_pallas: per-row popcount(tile & filter) for an (S, R, W)
//   tile against an optional (S, W) filter, giving (S, R) int64.  One block
//   per (row, shard) reads its row once with 16-byte loads (filter re-reads
//   across the R rows of a shard come mostly from L2), reduces in the block
//   and writes one count: no atomics, so counts are deterministic.
//   Bound: bytes, (S x R x W + S x W) x 4 bytes; TopN over 8 rows at S=64 is
//   67 MB (20 us at 3.35 TB/s) unfiltered, 75.5 MB (22.5 us) filtered.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Program limits (mirrored in ops/cuda_kernels.py); the whole program rides
// in the kernel's parameter space (< 4 KB), so a launch needs no copy.
constexpr int kMaxInstr = 640;
constexpr int kMaxPlanes = 48;
constexpr int kNumRegs = 12;

// Instruction word: op | dst << 8 | a << 16 | b << 24 (LOAD: a = plane).
enum Op : uint32_t {
  OP_LOAD = 0, OP_ZERO = 1, OP_ONES = 2, OP_AND = 3, OP_OR = 4,
  OP_XOR = 5, OP_ANDNOT = 6, OP_NOT = 7,
};

struct Program {
  const int32_t* plane[kMaxPlanes];
  long long stride[kMaxPlanes];  // words between shards of a plane
  uint32_t instr[kMaxInstr];
  int n_instr;
  int result;
};

constexpr int kEvalThreads = 128;

template <int VEC>
struct Words;
template <>
struct Words<4> {
  static __device__ __forceinline__ uint4 load(const int32_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void store(int32_t* p, uint4 v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ uint32_t apply(uint32_t op, uint32_t x, uint32_t y) {
  switch (op) {
    case OP_ZERO: return 0u;
    case OP_ONES: return 0xFFFFFFFFu;
    case OP_AND: return x & y;
    case OP_OR: return x | y;
    case OP_XOR: return x ^ y;
    case OP_ANDNOT: return x & ~y;
    default: return ~x;  // OP_NOT
  }
}

// VEC = 4: 16-byte loads (every plane 16-byte aligned, W % 4 == 0).
// VEC = 1: scalar fallback for irregular shapes (count_and over odd sizes).
template <int VEC>
__global__ void __launch_bounds__(kEvalThreads)
plan_eval_kernel(const Program p, long long W, int32_t* __restrict__ out,
                 unsigned long long* __restrict__ counts) {
  __shared__ uint32_t regs[kNumRegs][VEC][kEvalThreads];
  const int t = threadIdx.x;
  const long long s = blockIdx.y;
  unsigned int pc = 0;
  for (long long w = ((long long)blockIdx.x * kEvalThreads + t) * VEC; w < W;
       w += (long long)gridDim.x * kEvalThreads * VEC) {
    for (int k = 0; k < p.n_instr; ++k) {
      const uint32_t ins = p.instr[k];
      const uint32_t op = ins & 0xFF, d = (ins >> 8) & 0xFF;
      const uint32_t a = (ins >> 16) & 0xFF, b = ins >> 24;
      if (op == OP_LOAD) {
        const int32_t* src = p.plane[a] + s * p.stride[a] + w;
        if constexpr (VEC == 4) {
          const uint4 v = Words<4>::load(src);
          regs[d][0][t] = v.x; regs[d][1][t] = v.y;
          regs[d][2][t] = v.z; regs[d][3][t] = v.w;
        } else {
          regs[d][0][t] = (uint32_t)__ldg(src);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          regs[d][j][t] = apply(op, regs[a][j][t], regs[b][j][t]);
      }
    }
    uint32_t r[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      r[j] = regs[p.result][j][t];
      pc += __popc(r[j]);
    }
    if (out != nullptr) {
      int32_t* dst = out + s * W + w;
      if constexpr (VEC == 4)
        Words<4>::store(dst, make_uint4(r[0], r[1], r[2], r[3]));
      else
        dst[0] = (int32_t)r[0];
    }
  }
  if (counts != nullptr) {
    unsigned long long c = pc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
    if ((t & 31) == 0 && c != 0) atomicAdd(counts + s, c);
  }
}

constexpr int kRowThreads = 256;

template <bool VEC4, bool FILT>
__global__ void __launch_bounds__(kRowThreads)
row_counts_kernel(const int32_t* __restrict__ tile,
                  const int32_t* __restrict__ filt, int R, long long W,
                  long long* __restrict__ out) {
  const int r = blockIdx.x;
  const long long s = blockIdx.y;
  const int32_t* row = tile + (s * R + r) * W;
  const int32_t* f = FILT ? filt + s * W : nullptr;
  unsigned int pc = 0;
  if constexpr (VEC4) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    const uint4* f4 = reinterpret_cast<const uint4*>(f);
    const long long n4 = W / 4;
#pragma unroll 4
    for (long long i = threadIdx.x; i < n4; i += kRowThreads) {
      uint4 v = __ldg(row4 + i);
      if constexpr (FILT) {
        const uint4 m = __ldg(f4 + i);
        v.x &= m.x; v.y &= m.y; v.z &= m.z; v.w &= m.w;
      }
      pc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
  } else {
    for (long long i = threadIdx.x; i < W; i += kRowThreads) {
      uint32_t v = (uint32_t)__ldg(row + i);
      if constexpr (FILT) v &= (uint32_t)__ldg(f + i);
      pc += __popc(v);
    }
  }
  // per-thread counts fit in 32 bits: a row holds at most 32 * W bits and
  // each thread sees W / 256 words of it
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) pc += __shfl_down_sync(0xFFFFFFFFu, pc, off);
  __shared__ unsigned long long warp_sum[kRowThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = pc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < kRowThreads / 32; ++i) total += warp_sum[i];
    out[s * R + r] = (long long)total;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

int fb_limits(int* max_instr, int* max_planes, int* num_regs) {
  *max_instr = kMaxInstr;
  *max_planes = kMaxPlanes;
  *num_regs = kNumRegs;
  return 0;
}

// Evaluate a lowered plan over S shards of W words.  out_words ((S, W)
// int32, contiguous) and/or counts ((S,) int64, zeroed here on the stream)
// may be null.  planes/strides/instr are host arrays copied into the launch.
int fb_plan_eval(const uint32_t* instr, int n_instr, int result_reg,
                 const void* const* planes, const long long* strides,
                 int n_planes, int S, long long W, void* out_words,
                 void* counts, void* stream) {
  if (n_instr <= 0 || n_instr > kMaxInstr || n_planes < 0 ||
      n_planes > kMaxPlanes || result_reg < 0 || result_reg >= kNumRegs ||
      S <= 0 || S > 65535 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Program p = {};
  bool vec4 = (W % 4) == 0 && (out_words == nullptr || aligned16(out_words));
  for (int i = 0; i < n_planes; ++i) {
    p.plane[i] = static_cast<const int32_t*>(planes[i]);
    p.stride[i] = strides[i];
    vec4 = vec4 && aligned16(planes[i]) && (strides[i] % 4) == 0;
  }
  for (int i = 0; i < n_instr; ++i) {
    const uint32_t op = instr[i] & 0xFF, d = (instr[i] >> 8) & 0xFF;
    const uint32_t a = (instr[i] >> 16) & 0xFF, b = instr[i] >> 24;
    if (op > OP_NOT || d >= (uint32_t)kNumRegs ||
        (op == OP_LOAD ? a >= (uint32_t)n_planes
                       : (a >= (uint32_t)kNumRegs || b >= (uint32_t)kNumRegs)))
      return (int)cudaErrorInvalidValue;
    p.instr[i] = instr[i];
  }
  p.n_instr = n_instr;
  p.result = result_reg;
  unsigned long long* c = static_cast<unsigned long long*>(counts);
  if (c != nullptr) {
    cudaError_t e = cudaMemsetAsync(c, 0, sizeof(unsigned long long) * S, st);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = vec4 ? 4 : 1;
  const long long per_block = (long long)kEvalThreads * vec;
  long long bx = (W + per_block - 1) / per_block;
  if (bx > 0x7FFFFFFFLL) bx = 0x7FFFFFFFLL;  // the grid-stride loop covers the rest
  dim3 grid((unsigned)bx, (unsigned)S);
  int32_t* o = static_cast<int32_t*>(out_words);
  if (vec4)
    plan_eval_kernel<4><<<grid, kEvalThreads, 0, st>>>(p, W, o, c);
  else
    plan_eval_kernel<1><<<grid, kEvalThreads, 0, st>>>(p, W, o, c);
  return (int)cudaGetLastError();
}

// Per-row popcount of tile ((S, R, W) int32, contiguous) ANDed with filt
// ((S, W) int32, contiguous) or unfiltered when filt is null, into out
// ((S, R) int64).
int fb_row_counts(const void* tile, const void* filt, int S, int R,
                  long long W, void* out, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tile);
  const int32_t* f = static_cast<const int32_t*>(filt);
  long long* o = static_cast<long long*>(out);
  const bool vec4 = (W % 4) == 0 && aligned16(t) && (f == nullptr || aligned16(f));
  dim3 grid((unsigned)R, (unsigned)S);
  if (f != nullptr) {
    if (vec4) row_counts_kernel<true, true><<<grid, kRowThreads, 0, st>>>(t, f, R, W, o);
    else row_counts_kernel<false, true><<<grid, kRowThreads, 0, st>>>(t, f, R, W, o);
  } else {
    if (vec4) row_counts_kernel<true, false><<<grid, kRowThreads, 0, st>>>(t, f, R, W, o);
    else row_counts_kernel<false, false><<<grid, kRowThreads, 0, st>>>(t, f, R, W, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
