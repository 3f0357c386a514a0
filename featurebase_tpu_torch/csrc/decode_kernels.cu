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
// Kernels G'' and G''' name each shard's planes by a table of addresses in
// device memory: entry s * (D + 2) + p is plane p of shard s, 0 an absent
// plane, which reads as zeros.  So one launch reads every shard's fragment
// mirror in place, and a stacked (S, D + 2, W) group's table is its base
// and strides (`affine`), with nothing to copy.
//
// bsi_decode (kernel G'') is the counterpart of the XLA programs
//   featurebase_tpu/ops/bsi.py decode_values (:759) and decode_values_jit
//   (:482): S shards' groups -> (S, 32 W) int32 values, each the
//   magnitude, negated where the sign bit is set (-acc, as decode_values
//   does), whatever the exists bit says; a shard without data decodes to
//   zeros.  Bound: bytes.  It reads the sign and D magnitude planes once
//   and writes 4 bytes a column: at S = 128, D = 14, 252 MB in and 537 MB
//   out (235 us at 3.35 TB/s); two thirds of the bytes are the writes.
//   The first kernel G ran at 42% of that: a lane had about two plane
//   loads in flight, scattered each plane into its values bit by bit
//   (about 45 operations a value, with 8 shuffles a plane), and stored
//   nothing before it had read every plane.  The design of G'':
//   - work is (shard, 16 words) items, one a warp at a time, over a
//     persistent grid of the resident blocks;
//   - each warp keeps a ring of kStages items' planes in shared memory,
//     filled by cp.async (16-byte copies where every address allows, a
//     zero fill for an absent plane or a word past the row): the copies of
//     the next three items are in flight while it decodes one, with no
//     registers held for them (a form that loaded an item's D + 1 words
//     into registers, all at once, was read-bound: too few bytes in
//     flight, one item a warp);
//   - lanes 2i and 2i + 1 take word i, columns 0-15 and 16-31: each packs
//     its halves of planes r and r + 16 into register r (one byte permute)
//     and turns the 16 registers into the 16 values of its columns with
//     the last four stages of the 32 x 32 bit transpose of Hacker's
//     Delight 7-3 (about 10 operations a value, no shuffle; the first
//     stage is the packing), so the transpose holds 16 registers, not 32;
//   - the values go to the warp's 2 KB of shared memory in column order
//     through conflict-free addresses (each lane's four 16-byte chunks
//     permuted in registers, chunk q written at q ^ ((l >> 1) & 3)), and
//     one lane writes them out with one bulk copy (cp.async.bulk, shared
//     -> global), waited on just before the warp's next values go there
//     (faster on the card than reading them back for 16-byte streaming
//     stores, st.global.cs.v4: PERF.md).
// bsi_decode_gather (kernel G''') is the counterpart of decode_gather
//   (:367): S shards' groups (the same tables, exists plane included, in
//   device memory) and N columns, each an in-shard column id of one shard,
//   -> (vals int32, ok int32) of those columns, every shard in one launch.
//   A block takes an item of at most 256 columns of one shard (an item
//   table the host uploads with the address table and the columns in one
//   copy) and its shard's plane addresses into shared memory; one thread
//   a column reads word c >> 5 of the exists, sign and D magnitude planes,
//   every load issued before any is used, and takes bit c & 31; a shard
//   without data gives ok = 0.  Bound: latency (N is at most a few
//   thousand columns a shard); the first G' made one launch, a
//   device-synchronising range check and a fetch a shard, G''' one launch
//   and no sync over every shard.
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

constexpr int kGatherItem = kThreads;  // columns of a kernel G''' item
constexpr int kStages = 4;             // items in a G'' warp's load ring

// One launch of kernel G'': the plane-address table (a device array, or a
// stacked group's base and strides).
struct DecodeArgs {
  const unsigned long long* table;   // device table, or null: affine
  unsigned long long base;           // plane p of shard s at base +
  long long s_step, p_step;          // s * s_step + p * p_step (bytes)
  long long W;
  int S, D, P;                       // P = D + 2 planes a shard
};

__device__ __forceinline__ unsigned long long plane_addr(const DecodeArgs& a,
                                                         long long s, int p) {
  if (a.table == nullptr) return a.base + s * a.s_step + p * a.p_step;
  return a.table[s * a.P + p];
}

// Word i of the row at `addr` (bytes), not allocated in L1; 0 for an absent
// row or a word past the row.
__device__ __forceinline__ uint32_t row_word(unsigned long long addr,
                                             long long i, bool in) {
  uint32_t r = 0u;
  if (addr != 0 && in)
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n"
        : "=r"(r) : "l"(reinterpret_cast<const uint32_t*>(addr) + i));
  return r;
}

// One stage of the bit transpose of a lane's 16 registers: for rows k with
// bit J clear, the bits of row k whose column has bit J set trade places
// with the bits of row k + J whose column has it clear.  Register k holds
// row k (its low 16 bits) and row k + 16 (its high 16 bits) of a 32 x 16
// matrix, plane p's 16 bits in row p: that is the 32 x 32 transpose of
// Hacker's Delight 7-3 after its first stage, when columns 16-31 are zero,
// and the four stages left leave bit p of register c = bit c of row p.
template <int J, uint32_t MASK>
__device__ __forceinline__ void transpose_stage(uint32_t (&m)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k & J) continue;
    const uint32_t t = ((m[k] >> J) ^ m[k + J]) & MASK;
    m[k] ^= t << J;
    m[k + J] ^= t;
  }
}

__device__ __forceinline__ void cswap(uint32_t& a, uint32_t& b, bool c) {
  const uint32_t x = c ? b : a, y = c ? a : b;
  a = x;
  b = y;
}

// Copy V words (4: 16 bytes, 1: 4 bytes) from global to shared memory
// asynchronously (cp.async); `bytes` 0 copies nothing and zero-fills.
template <int V>
__device__ __forceinline__ void copy_async(uint32_t* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// Shared memory of kernel G'' a warp, in words: the load ring (kStages
// items of D + 1 planes of 16 words) and the 2 KB the values leave from.
__host__ __device__ inline int decode_warp_words(int D) {
  return kStages * (D + 1) * 16 + 512;
}

// A warp's item is 16 words of one shard (512 columns); lanes 2i and
// 2i + 1 take word i, columns 0-15 and 16-31.  ROWS: the planes the form
// holds (16 or 32); rows from ROWS up are zeros at compile time, rows from
// D up at run time.  V: the words of each copy into the ring (4 when W %
// 4 == 0 and every plane address is 16-byte aligned, else 1).
template <int ROWS, int V>
__global__ void __launch_bounds__(kThreads, 4)
bsi_decode_kernel(const __grid_constant__ DecodeArgs a,
                  int32_t* __restrict__ out, int per_shard, int n_items) {
  extern __shared__ int smem[];   // kernel I' shares the declaration
  const int lane = threadIdx.x & 31, half = lane & 1, wl = lane >> 1;
  const int swz = wl & 3;   // the lane's swizzle of its 4 chunks
  const int P1 = a.D + 1;   // planes read: the sign and D magnitudes
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) +
                   (threadIdx.x >> 5) * decode_warp_words(a.D);
  uint4* st = reinterpret_cast<uint4*>(ring + kStages * P1 * 16);
  const uint32_t pick = half ? 0x7632u : 0x5410u;   // its half of 2 words
  const int stride = gridDim.x * kWarps;
  // the copies of item `it` into ring slot `k`, one commit group (empty
  // past the last item)
  auto issue = [&](int it, int k) {
    if (it < n_items) {
      const int s = it / per_shard;
      const int w0 = (it - s * per_shard) * 16;
      uint32_t* dst = ring + k * P1 * 16;
      constexpr int per_plane = 16 / V;
      for (int j = lane; j < P1 * per_plane; j += 32) {
        const int q = j / per_plane, w = w0 + (j % per_plane) * V;
        const unsigned long long addr = plane_addr(a, s, 1 + q);
        const bool live = addr != 0 && w < a.W;
        copy_async<V>(dst + q * 16 + (j % per_plane) * V,
                      live ? reinterpret_cast<const uint32_t*>(addr) + w
                           : reinterpret_cast<const uint32_t*>(out),
                      live ? 4 * V : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(first + k * stride, k);
  int k = 0;
  for (int it = first; it < n_items; it += stride) {
    __syncwarp();   // every lane is done with the slot and the values
    issue(it + (kStages - 1) * stride, (k + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    __syncwarp();   // item it's copies, from every lane, have landed
    const uint32_t* src = ring + k * P1 * 16 + wl;
    const uint32_t sign = src[0] >> (16 * half);
    uint32_t m[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const uint32_t lo = r < a.D ? src[(1 + r) * 16] : 0u;
      const uint32_t hi = ROWS > 16 && r + 16 < a.D ? src[(17 + r) * 16] : 0u;
      m[r] = __byte_perm(lo, hi, pick);
    }
    transpose_stage<8, 0x00FF00FFu>(m);
    transpose_stage<4, 0x0F0F0F0Fu>(m);
    transpose_stage<2, 0x33333333u>(m);
    transpose_stage<1, 0x55555555u>(m);
    // m[c]: the magnitude of column 32 w + 16 half + c
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const uint32_t neg = (uint32_t)((int32_t)(sign << (31 - c)) >> 31);
      m[c] = (m[c] ^ neg) - neg;
    }
    const int s = it / per_shard;
    const int w0 = (it - s * per_shard) * 16;
    int32_t* o = out + (long long)s * a.W * 32 + w0 * 32;
    // register chunk q ^ swz to chunk q, so that the store of register
    // chunk q at q ^ swz leaves the warp's values in column order
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cswap(m[e], m[4 + e], swz & 1);
      cswap(m[8 + e], m[12 + e], swz & 1);
      cswap(m[e], m[8 + e], swz & 2);
      cswap(m[4 + e], m[12 + e], swz & 2);
    }
    if (lane == 0)   // the last bulk store has read the buffer
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      st[lane * 4 + (q ^ swz)] =
          make_uint4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      const int words = a.W - w0 < 16 ? (int)(a.W - w0) : 16;
      const unsigned saddr = (unsigned)__cvta_generic_to_shared(st);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n"
          :: "l"(o), "r"(saddr), "r"((unsigned)words * 128u) : "memory");
    }
    k = k + 1 == kStages ? 0 : k + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// items: (shard, first column, count) a block, count <= kGatherItem; table:
// P plane addresses a shard, in device memory beside them.
__global__ void __launch_bounds__(kThreads)
bsi_decode_gather_kernel(const unsigned long long* __restrict__ table, int P,
                         const int* __restrict__ items,
                         const int32_t* __restrict__ cols,
                         int32_t* __restrict__ vals, int32_t* __restrict__ ok) {
  __shared__ unsigned long long addr[kMaxDepth + 2];   // the block's shard's
  const int s = __ldg(items + 3 * blockIdx.x);
  const int first = __ldg(items + 3 * blockIdx.x + 1);
  const int count = __ldg(items + 3 * blockIdx.x + 2);
  if ((int)threadIdx.x < P)
    addr[threadIdx.x] = __ldg(table + (long long)s * P + threadIdx.x);
  const int i = first + threadIdx.x;
  const int c = (int)threadIdx.x < count ? __ldg(cols + i) : 0;
  __syncthreads();
  if ((int)threadIdx.x >= count) return;
  const long long w = c >> 5;
  const int bit = c & 31;
  // every plane's load in flight before any is used
  uint32_t x[kMaxDepth + 2];
#pragma unroll
  for (int p = 0; p < kMaxDepth + 2; ++p)
    x[p] = p < P ? row_word(addr[p], w, true) : 0u;
  uint32_t mag = 0u;
#pragma unroll
  for (int p = 0; p < kMaxDepth; ++p) mag |= ((x[2 + p] >> bit) & 1u) << p;
  const bool neg = (x[1] >> bit) & 1u;
  vals[i] = (int32_t)(neg ? 0u - mag : mag);
  ok[i] = (int32_t)((x[0] >> bit) & 1u);
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

// A launch's table: the device table's address, or the affine table.
cudaError_t fill_args(const void* dev_table, const long long* affine, int S,
                      int D, long long W, DecodeArgs* a) {
  if (S <= 0 || W <= 0 || W >= (1LL << 31) || D < 1 || D > kMaxDepth ||
      (dev_table == nullptr) == (affine == nullptr))
    return cudaErrorInvalidValue;
  a->table = static_cast<const unsigned long long*>(dev_table);
  a->base = 0;
  a->s_step = a->p_step = 0;
  if (affine != nullptr) {
    a->base = (unsigned long long)affine[0];
    a->s_step = affine[1];
    a->p_step = affine[2];
  }
  a->W = W;
  a->S = S;
  a->D = D;
  a->P = D + 2;
  return cudaSuccess;
}

// The forms of kernel G'': (planes it holds, words a copy) -> its entry.
using DecodeKernel = void (*)(DecodeArgs, int32_t*, int, int);
constexpr DecodeKernel kDecodeForms[4] = {
    bsi_decode_kernel<16, 4>, bsi_decode_kernel<16, 1>,
    bsi_decode_kernel<32, 4>, bsi_decode_kernel<32, 1>};

// The resident blocks of kernel G'' form `form` at depth D on the current
// device (its SMs times the occupancy calculator's blocks a SM with that
// depth's shared memory), cached a device.
cudaError_t decode_blocks(int form, int D, int* blocks) {
  static int cache[64][4][kMaxDepth + 1];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev][form][D] == 0) {
    const void* fn = (const void*)kDecodeForms[form];
    const int most = kWarps * decode_warp_words(kMaxDepth) * 4;
    if ((e = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(
             fn, cudaFuncAttributePreferredSharedMemoryCarveout,
             (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, kThreads, kWarps * decode_warp_words(D) * 4)) !=
            cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev][form][D] = sms * per_sm;
  }
  *blocks = cache[dev][form][D];
  return cudaSuccess;
}

int grid_for(long long warps_of_work) {
  const long long blocks = (warps_of_work + kWarps - 1) / kWarps;
  return (int)(blocks < 1 ? 1 : (blocks > INT_MAX ? INT_MAX : blocks));
}

}  // namespace

extern "C" {

// The deepest group kernels G'' and G''' take, kernel I's thresholds a
// launch and the columns of a G''' item.
int fb_decode_limits(int* max_depth, int* max_thresholds, int* gather_item) {
  *max_depth = kMaxDepth;
  *max_thresholds = kMaxThresholds;
  *gather_item = kGatherItem;
  return 0;
}

// Kernel G'' over S shards of D magnitude planes of W words, named by the
// address table: dev_table, an (S, D + 2) array in device memory, or for a
// stacked group `affine`: {base, shard step, plane step} in bytes (exactly
// one of the two); vec 4 when W % 4 == 0 and every plane address is
// 16-byte aligned, else 1.  out: (S, 32 W) int32, 16-byte aligned.
int fb_bsi_decode(const void* dev_table, const long long* affine, int S,
                  int D, long long W, int vec, void* out, void* stream) {
  DecodeArgs a;
  cudaError_t e = fill_args(dev_table, affine, S, D, W, &a);
  if (e != cudaSuccess) return (int)e;
  if (out == nullptr || (uintptr_t)out % 16 || (vec != 4 && vec != 1) ||
      (vec == 4 && W % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const long long per_shard = (W + 15) / 16;
  const long long n_items = (long long)S * per_shard;
  if (n_items > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int form = (D <= 16 ? 0 : 2) + (vec == 4 ? 0 : 1);
  int blocks = 0;
  if ((e = decode_blocks(form, D, &blocks)) != cudaSuccess) return (int)e;
  long long grid = (n_items + kWarps - 1) / kWarps;
  if (grid > blocks) grid = blocks;
  kDecodeForms[form]<<<(unsigned)grid, kThreads,
                       kWarps * decode_warp_words(D) * 4,
                       (cudaStream_t)stream>>>(a, (int32_t*)out,
                                               (int)per_shard, (int)n_items);
  return (int)cudaGetLastError();
}

// Kernel G''' over an (S, D + 2) table of plane addresses in device memory
// (0: absent): n_items items of (shard, first column, count <=
// kGatherItem) as int32 triples, cols the in-shard column ids (each below
// 32 W, checked by the caller), vals and ok one int32 a column.
int fb_bsi_decode_gather(const void* table, int S, int D, const void* items,
                         long long n_items, const void* cols, void* vals,
                         void* ok, void* stream) {
  if (n_items == 0) return 0;
  if (S <= 0 || D < 1 || D > kMaxDepth || n_items < 0 || n_items > INT_MAX ||
      table == nullptr || items == nullptr || cols == nullptr ||
      vals == nullptr || ok == nullptr)
    return (int)cudaErrorInvalidValue;
  bsi_decode_gather_kernel<<<(unsigned)n_items, kGatherItem, 0,
                             (cudaStream_t)stream>>>(
      (const unsigned long long*)table, D + 2, (const int*)items,
      (const int32_t*)cols, (int32_t*)vals, (int32_t*)ok);
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
