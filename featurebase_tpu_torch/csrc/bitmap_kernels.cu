// Hand-written Hopper kernels for the bitmap engine (sm_90a).
//
// Two kernels, each behind a plain C launcher that ops/cuda_kernels.py loads
// with ctypes.  Launchers take device pointers and the caller's stream,
// launch, and return a cudaError_t (0 on success); they never synchronise
// and never allocate.
//
// plan_eval (kernel A) replaces featurebase_tpu/ops/pallas_kernels.py
//   count_and_pallas (fused AND + popcount) and, through it, the XLA fusion
//   of executor/plan.py that evaluates a whole bitmap plan and counts it.
//   The host lowers a plan to a short program over leaf "planes" (each an
//   (S, W) int32 array with a shard stride): set-algebra instructions over
//   12 registers, and OP_BSI, which runs a whole unsigned BSI walk
//   (eq / lt / gt over `depth` magnitude planes, the predicate bits as a
//   mask in its payload) as one instruction.
//   Bound: bytes.  A query reads planes x S x W x 4 bytes and, in count
//   mode, writes S counts: at S = 128, W = 32768 an intersect of two rows
//   is 33.5 MB (10.0 us at 3.35 TB/s), a 16-plane BSI comparison 268 MB
//   (80.1 us).  The design keeps HBM busy whatever the program does:
//   - persistent blocks (two per SM, as the occupancy calculator finds)
//     walk contiguous runs of (shard, chunk) tiles, shard-major;
//   - one thread stages each tile with one TMA bulk copy per plane
//     (cp.async.bulk, global -> shared, completion on an mbarrier) into a
//     ring of 3 to 8 stages, so the next tiles are in flight while one is
//     evaluated.  The chunk and the ring's depth are sized per launch from
//     the plane count, and every plane is copied from HBM once per tile
//     however many instructions name it.  Thread 0 issues the first tiles'
//     copies before anything else; later tiles are issued by lane 0 of
//     each warp in turn;
//   - each thread evaluates the program on 4 or 8 words a step, reading
//     planes from the staged tile, with its register file in registers:
//     branch-free muxes over 2, 4 or 12 registers, the fewest the program
//     needs (the host renumbers registers; a switch on a register index
//     compiles to chains of branches).  A BSI walk is a few integer
//     operations per plane word, one warp-uniform branch per plane;
//   - counts are summed per (block, shard run) in 64 bits into a scratch
//     slot; the last block to finish (an atomic ticket it resets) adds the
//     slots of each shard.  No memset precedes the launch, so a Count is one
//     device operation, and the integer sums are the same in any order.
//   Shapes TMA cannot take (W % 4 != 0, a plane or stride not 16-byte
//   aligned) run the same tiles with scalar loads from global memory.
//
// row_counts (kernel B') replaces pallas_kernels.py count_and_rows_pallas
//   (:172) and popcount_rows_pallas (:203): per-row popcount(row & filter)
//   of S x R rows against an optional filter row a shard, giving (S, R)
//   int64.  Rows are named by a table of addresses (0 for an absent row,
//   whose count is 0), so one launch reads every shard's fragment mirror in
//   place; a stacked (S, R, W) tile's table is its base and strides.
//   Bound: bytes, (present rows + filter rows) x W x 4 read once and 8
//   bytes a count written: 151 MB (45.1 us at 3.35 TB/s) for 8 filtered rows
//   over 128 shards.  The first kernel B, a block per (shard, row), used 8
//   of 132 SMs at S = 1 and made every per-shard caller launch once a
//   shard.  The design:
//   - work is (shard, chunk of words) items: each stages its filter chunk
//     in shared memory once (the filter is read once, not once a row) and
//     ANDs and popcounts every row of its shard against it;
//   - the chunk halves from 4,096 words until every SM has an item (128
//     words at S = 1, W = 32,768: 256 items), and a persistent grid (no
//     more blocks than the occupancy calculator's resident ones, each with
//     as many items) walks items b, b + grid, ... at large S;
//   - the 8 warps split each row chunk into parts and read it in pieces
//     of 4 KB, every lane's 8 16-byte loads of a piece (two pieces, the
//     loop unrolled) in flight before its popcounts, with no block barrier
//     between rows (one an item, after the filter); the loads do not
//     allocate in L1 (ld.global.nc.L1::no_allocate), and each item's row
//     and filter addresses are loaded an item ahead;
//   - a unit's count is added to a per-stream accumulator with a fire and
//     forget atomic (red.add), and the last block to finish (a ticket it
//     resets, kernel A's pattern) copies the sums out and zeroes them, so
//     no memset precedes the launch and a call is one device operation;
//     a row that is a single unit (one chunk, one part) is written as is;
//   - the next item's filter chunk is copied by one TMA bulk copy while
//     this item's rows are read;
//   - tables of up to 440 entries (S = 1 at any R up to 439) ride in the
//     launch's parameters, as does a stacked tile's base and strides;
//     larger ones are copied to the device first.
//   -DFB_ROWS_STAGED builds the same kernel with each warp's row pieces
//   staged in shared memory by 1-D TMA bulk copies (cp.async.bulk, any
//   16-byte aligned address, no tensor map) through a ring of 4 pieces a
//   warp; chip_smoke.py times both (`row_ablation`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Program limits (mirrored in ops/cuda_kernels.py); the whole program rides
// in the kernel's parameter space (sizeof(Program) < 4 KB), so a launch
// needs no copy.
constexpr int kMaxInstr = 640;     // instruction words, BSI payloads included
constexpr int kMaxPlanes = 48;
constexpr int kNumRegs = 12;
constexpr int kMaxDepth = 32;      // BSI magnitude planes in one walk
constexpr int kChunkQuantum = 128; // words; staged chunks are multiples

// Instruction word: op | dst << 8 | a << 16 | b << 24 (LOAD: a = plane).
// OP_BSI: dst = walk(register a), followed by two payload words:
//   mask  bit i = predicate bit of magnitude plane i (i < depth)
//   info  first plane | depth << 8 | mode << 16 | allow_eq << 18
//         | top << 19 (predicate bit `depth`, the virtual all-zero plane)
enum Op : uint32_t {
  OP_LOAD = 0, OP_ZERO = 1, OP_ONES = 2, OP_AND = 3, OP_OR = 4,
  OP_XOR = 5, OP_ANDNOT = 6, OP_NOT = 7, OP_BSI = 8,
};
enum BsiMode : uint32_t { MODE_EQ = 0, MODE_LT = 1, MODE_GT = 2 };

struct Program {
  const int32_t* plane[kMaxPlanes];
  long long stride[kMaxPlanes];  // words between shards of a plane
  uint32_t instr[kMaxInstr];
  int n_instr;
  int result;
  int n_planes;
};
static_assert(sizeof(Program) + 128 < 4096, "a program must fit the "
              "kernel's parameter space beside the other arguments");

// How a launch cuts (S, W) into tiles of `chunk` words of one shard.
struct Tiling {
  long long W;
  long long chunk;        // words per plane per tile
  long long per_shard;    // tiles per shard
  long long n_tiles;
  long long per_block;    // consecutive tiles each block walks
  int S;
  int stages;             // tiles in the TMA ring
};

// Launch shape of kernel A.  (chip_smoke.py --ablate also builds it with
// FB_ABLATE_COPY, which drops the copies, or FB_ABLATE_COMPUTE, which drops
// the program: where a launch's time goes.)
constexpr int kEvalThreads = 256;
constexpr int kBlocksPerSm = 2;       // the register budget of each thread
constexpr int kVec = 4;               // words in a thread's 16-byte group
constexpr int kChunkSteps = 4;        // largest chunk, in steps of a block
constexpr int kMaxStages = 8;         // depth of the TMA ring
constexpr int kMinStages = 3;
constexpr int kStageBytes = 96 * 1024;  // the ring, per block
constexpr long long kScalarChunk = 8192;

// ---- words and the register file ------------------------------------------

template <int V>
struct Vec {
  uint32_t w[V];
};

template <int V>
__device__ __forceinline__ Vec<V> splat(uint32_t x) {
  Vec<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.w[j] = x;
  return r;
}

// A thread's V words of a step: one word (V = 1), 4 consecutive words
// (V = 4, 16 bytes), or two such groups `gap` words apart (V = 8; the
// second only while `two`).  Neighbouring threads read neighbouring 16
// bytes, so shared-memory reads have no bank conflicts.
template <int V>
__device__ __forceinline__ Vec<V> load_words(const uint32_t* p, long long gap,
                                             bool two) {
  if constexpr (V == 1) {
    return Vec<1>{{*p}};
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    if constexpr (V == 4) {
      return Vec<4>{{v.x, v.y, v.z, v.w}};
    } else {
      const uint4 u = two ? *reinterpret_cast<const uint4*>(p + gap)
                          : make_uint4(0u, 0u, 0u, 0u);
      return Vec<8>{{v.x, v.y, v.z, v.w, u.x, u.y, u.z, u.w}};
    }
  }
}

template <int V>
__device__ __forceinline__ void store_words(int32_t* p, long long gap,
                                            bool two, const Vec<V>& r) {
  if constexpr (V == 1) {
    *p = (int32_t)r.w[0];
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
    if constexpr (V == 8) {
      if (two)
        *reinterpret_cast<uint4*>(p + gap) =
            make_uint4(r.w[4], r.w[5], r.w[6], r.w[7]);
    }
  }
}

// A set-algebra opcode over whole vectors; one warp-uniform branch on op.
template <int V>
__device__ __forceinline__ Vec<V> apply(uint32_t op, const Vec<V>& x,
                                        const Vec<V>& y) {
  Vec<V> r;
  switch (op) {
    case OP_ZERO: return splat<V>(0u);
    case OP_ONES: return splat<V>(0xFFFFFFFFu);
    case OP_AND:
#pragma unroll
      for (int j = 0; j < V; ++j) r.w[j] = x.w[j] & y.w[j];
      return r;
    case OP_OR:
#pragma unroll
      for (int j = 0; j < V; ++j) r.w[j] = x.w[j] | y.w[j];
      return r;
    case OP_XOR:
#pragma unroll
      for (int j = 0; j < V; ++j) r.w[j] = x.w[j] ^ y.w[j];
      return r;
    case OP_ANDNOT:
#pragma unroll
      for (int j = 0; j < V; ++j) r.w[j] = x.w[j] & ~y.w[j];
      return r;
    default:  // OP_NOT
#pragma unroll
      for (int j = 0; j < V; ++j) r.w[j] = ~x.w[j];
      return r;
  }
}

// NR registers of V words, in registers.  A register is named by a
// warp-uniform program field, so reads and writes are branch-free bitwise
// muxes over every register (a switch on the index compiles to a chain of
// branches, dozens per instruction).  A mux costs a word operation per
// register, so the launcher picks the smallest file that holds the program
// (ProgramBuilder.build renumbers registers to the fewest).
template <int V, int NR>
struct RegFile {
  Vec<V> r[NR];
  __device__ __forceinline__ Vec<V> get(uint32_t i) const {
    Vec<V> x = r[0];
#pragma unroll
    for (int k = 1; k < NR; ++k) {
      const uint32_t m = i == (uint32_t)k ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) x.w[j] = (r[k].w[j] & m) | (x.w[j] & ~m);
    }
    return x;
  }
  __device__ __forceinline__ void set(uint32_t i, const Vec<V>& v) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const uint32_t m = i == (uint32_t)k ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) r[k].w[j] = (v.w[j] & m) | (r[k].w[j] & ~m);
    }
  }
};

// The unsigned walk of ops/bsi_traced.py _lower_u from the virtual plane
// `depth` down to plane 0, for one mode.  Per plane and word: b &= s or
// b &= ~s by the predicate bit; lt keeps b & ~s where the bit is 1, gt keeps
// b & s where it is 0.  The bit is warp-uniform: one branch per plane.
template <int V, uint32_t MODE, class Fetch>
__device__ __forceinline__ Vec<V> bsi_walk(Vec<V> b, uint32_t mask,
                                           uint32_t info, Fetch fetch) {
  const uint32_t first = info & 0xFF, depth = (info >> 8) & 0xFF;
  Vec<V> keep = splat<V>(0u);
  if ((info >> 19) & 1) {  // saturated predicate: the virtual plane's bit
    if (MODE == MODE_LT) keep = b;
    b = splat<V>(0u);
  }
#pragma unroll 4
  for (int i = (int)depth - 1; i >= 0; --i) {
    const Vec<V> s = fetch(first + i);
    if ((mask >> i) & 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (MODE == MODE_LT) keep.w[j] |= b.w[j] & ~s.w[j];
        b.w[j] &= s.w[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (MODE == MODE_GT) keep.w[j] |= b.w[j] & s.w[j];
        b.w[j] &= ~s.w[j];
      }
    }
  }
  if (MODE == MODE_EQ) return b;
  if ((info >> 18) & 1) {  // allow_eq
#pragma unroll
    for (int j = 0; j < V; ++j) keep.w[j] |= b.w[j];
  }
  return keep;
}

// The program's words are read from shared memory, where each block copies
// them once.
template <int V, int NR, class Fetch>
__device__ __forceinline__ Vec<V> run_program(const uint32_t* instr,
                                              int n_instr, int result,
                                              RegFile<V, NR>& R, Fetch fetch) {
  for (int k = 0; k < n_instr; ++k) {
    const uint32_t ins = instr[k];
    const uint32_t op = ins & 0xFF, d = (ins >> 8) & 0xFF;
    const uint32_t a = (ins >> 16) & 0xFF, b = ins >> 24;
    Vec<V> x;
    if (op == OP_LOAD) {
      x = fetch(a);
    } else if (op == OP_BSI) {
      const uint32_t mask = instr[k + 1], info = instr[k + 2];
      const uint32_t mode = (info >> 16) & 3;
      const Vec<V> side = R.get(a);
      x = mode == MODE_EQ   ? bsi_walk<V, MODE_EQ>(side, mask, info, fetch)
          : mode == MODE_LT ? bsi_walk<V, MODE_LT>(side, mask, info, fetch)
                            : bsi_walk<V, MODE_GT>(side, mask, info, fetch);
      k += 2;
    } else {
      x = apply<V>(op, R.get(a), R.get(b));
    }
    R.set(d, x);
  }
  return R.get(result);
}

template <int V>
__device__ __forceinline__ uint32_t popc(const Vec<V>& x) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) c += __popc(x.w[j]);
  return c;
}

// ---- TMA bulk copies and mbarriers ----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---- kernel A ---------------------------------------------------------------

// STAGED: planes come from the TMA ring (W % 4 == 0, planes and strides
// 16-byte aligned), V = 4 or 8 words a thread a step.  Otherwise: scalar
// loads from global memory, V = 1.  NR: registers in the file.
template <bool STAGED, int NR, int V>
__global__ void __launch_bounds__(kEvalThreads, kBlocksPerSm)
plan_eval_kernel(const __grid_constant__ Program p, const Tiling g,
                 int32_t* __restrict__ out,
                 unsigned long long* __restrict__ counts,
                 unsigned long long* __restrict__ partials,
                 unsigned int* __restrict__ ticket) {
  extern __shared__ __align__(128) uint32_t ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ unsigned long long warp_sum[kEvalThreads / 32];
  __shared__ int last_block;
  __shared__ uint32_t instr[kMaxInstr];
  __shared__ const int32_t* plane[kMaxPlanes];
  __shared__ long long stride[kMaxPlanes];
  const int tid = threadIdx.x;
  const long long t_begin = (long long)blockIdx.x * g.per_block;
  const long long t_end = min(t_begin + g.per_block, g.n_tiles);
  const int n_local = (int)(t_end - t_begin);
  const int P = p.n_planes, stages = g.stages;
  const long long stage_words = (long long)P * g.chunk;

  auto issue = [&](int i, const int32_t* const* src, const long long* str) {
    // stage local tile i (one thread)
    const long long t = t_begin + i, s = t / g.per_shard;
    const long long w0 = (t % g.per_shard) * g.chunk;
    const uint32_t bytes = (uint32_t)(min(g.chunk, g.W - w0) * 4);
    const int st = i % stages;
    const uint32_t bar = smem_addr(&full[st]);
#ifdef FB_ABLATE_COPY  // measurement only: evaluate stale tiles
    mbar_expect_tx(bar, 0u);
    (void)bytes; (void)src; (void)str; (void)s;
#else
    mbar_expect_tx(bar, bytes * (uint32_t)P);
    for (int pl = 0; pl < P; ++pl)
      bulk_copy(smem_addr(ring + st * stage_words + pl * g.chunk),
                src[pl] + s * str[pl] + w0, bytes, bar);
#endif
  };

  // Thread 0 stages the first tiles before anything else; later, tile i is
  // staged by lane 0 of warp i % 8, so no one warp waits on every tile's
  // copies.
  if (STAGED && tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(smem_addr(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < stages && i < n_local; ++i) issue(i, p.plane, p.stride);
  }
  constexpr int kWarps = kEvalThreads / 32;
  const bool issuer = (tid & 31) == 0;
  for (int k = tid; k < p.n_instr; k += kEvalThreads) instr[k] = p.instr[k];
  for (int k = tid; k < P; k += kEvalThreads) {
    plane[k] = p.plane[k];
    stride[k] = p.stride[k];
  }
  __syncthreads();

  RegFile<V, NR> R;
#pragma unroll
  for (int k = 0; k < NR; ++k) R.r[k] = splat<V>(0u);
  unsigned long long run = 0;  // this thread's count in the current shard
  for (int i = 0; i < n_local; ++i) {
    const long long t = t_begin + i, s = t / g.per_shard;
    const long long w0 = (t % g.per_shard) * g.chunk;
    const long long n = min(g.chunk, g.W - w0);
    uint32_t pc = 0;
    if constexpr (STAGED) {
      const int st = i % stages;
      mbar_wait(smem_addr(&full[st]), (uint32_t)(i / stages) & 1u);
      const uint32_t* base = ring + st * stage_words;
      // a step covers kEvalThreads groups of 4 words, twice at V = 8
      constexpr long long gap = (long long)kEvalThreads * kVec;
      for (long long o = tid * kVec; o < n; o += gap * (V / kVec)) {
        const bool two = o + gap < n;
        auto fetch = [&](uint32_t pl) {
          return load_words<V>(base + pl * g.chunk + o, gap, two);
        };
#ifdef FB_ABLATE_COMPUTE  // measurement only: no program, plane 0's words
        const Vec<V> r = fetch(0);
#else
        const Vec<V> r = run_program<V, NR>(instr, p.n_instr, p.result, R,
                                            fetch);
#endif
        pc += popc(r);
        if (out != nullptr) store_words<V>(out + s * g.W + w0 + o, gap, two, r);
      }
      __syncthreads();  // every thread is done with stage st
      if (issuer && (i + stages) % kWarps == tid >> 5 && i + stages < n_local) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(i + stages, plane, stride);
      }
    } else {
      for (long long o = tid; o < n; o += kEvalThreads) {
        auto fetch = [&](uint32_t pl) {
          return Vec<1>{{(uint32_t)__ldg(plane[pl] + s * stride[pl] + w0 + o)}};
        };
        const Vec<1> r = run_program<1, NR>(instr, p.n_instr, p.result, R,
                                            fetch);
        pc += popc(r);
        if (out != nullptr) out[s * g.W + w0 + o] = (int32_t)r.w[0];
      }
    }
    run += pc;
    if (counts != nullptr && (t + 1 == t_end || (t + 1) % g.per_shard == 0)) {
      // end of this block's run of tiles in shard s: one slot, at the
      // run's first tile
      unsigned long long c = run;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_down_sync(0xFFFFFFFFu, c, off);
      __syncthreads();  // thread 0 has read the last run's warp sums
      if ((tid & 31) == 0) warp_sum[tid >> 5] = c;
      __syncthreads();
      if (tid == 0) {
        unsigned long long total = 0;
#pragma unroll
        for (int w = 0; w < kEvalThreads / 32; ++w) total += warp_sum[w];
        partials[max(t_begin, s * g.per_shard)] = total;
      }
      run = 0;
    }
  }
  if (counts == nullptr) return;
  if (tid == 0) {
    // release this block's slots; the last block acquires every block's
    unsigned int prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(ticket) : "memory");
    last_block = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  // A shard's count is the sum of its runs' slots: the slot at its first
  // tile, and one at each block start inside it.  The sums are of integers,
  // so the order of the atomics does not change them.
  for (int s = tid; s < g.S; s += kEvalThreads)
    counts[s] = __ldcg(partials + (long long)s * g.per_shard);
  __syncthreads();
  for (long long b = tid + 1; b < gridDim.x; b += kEvalThreads) {
    const long long tb = b * g.per_block;
    if (tb % g.per_shard != 0)
      atomicAdd(counts + tb / g.per_shard, __ldcg(partials + tb));
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch on this stream
}

// ---- kernel B' --------------------------------------------------------------

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kPieceGroups = 8;        // groups a lane loads of a piece
constexpr int kRowChunkMax = 4096;     // words of a row in an item (VEC 4)
constexpr int kInlineAddrs = 440;      // table entries carried in the launch
constexpr int kRowStages = 4;          // each warp's TMA ring (staged build)
// chip_smoke.py builds B' both ways and times them: each warp's row pieces
// staged in shared memory by 1-D TMA bulk copies (-DFB_ROWS_STAGED), or
// read with 16-byte ld.global.nc loads straight into registers (the
// default).
#ifdef FB_ROWS_STAGED
constexpr bool kRowsStaged = true;
#else
constexpr bool kRowsStaged = false;
#endif

// One launch of B': the address table (row r of shard s at entry s * R + r,
// 0 for an absent row; with `filtered`, shard s's filter row at entry
// S * R + s, 0 for a shard without one) and how the launch cuts the work:
// items of `chunk` words of one shard, and each row's chunk in `parts`
// parts (a warp each; up to 8, as its pieces allow).  A table of up
// to kInlineAddrs entries rides in the launch itself, a larger one is a
// device array, and a stacked tile's (every row present, at fixed strides)
// is its base and strides.
struct RowArgs {
  unsigned long long addrs[kInlineAddrs];
  const unsigned long long* table;   // device table, or null: addrs
  // affine table (stacked tiles): row (s, r) at base + s * s_step + r *
  // r_step, filter row s at f_base + s * f_step (bytes)
  int affine;
  unsigned long long base, f_base;
  long long s_step, r_step, f_step;
  long long W;
  int chunk;             // words of each row in an item
  int n_chunks;          // items a shard
  long long n_items;
  int S, R;
  int filtered;
  int parts;             // warps a row chunk (1, 2, 4 or 8)
};
static_assert(sizeof(RowArgs) + 64 < 4096, "B's arguments must fit the "
              "kernel's parameter space");

template <int VEC>
__device__ __forceinline__ Vec<VEC> global_words(const uint32_t* p) {
  if constexpr (VEC == 4) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return Vec<4>{{v.x, v.y, v.z, v.w}};
  } else {
    uint32_t v;
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(p));
    return Vec<1>{{v}};
  }
}

__device__ __forceinline__ void red_add(unsigned int* p, unsigned int v) {
  asm volatile("red.relaxed.gpu.global.add.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// VEC: words a group (4: 16-byte loads, every address 16-byte aligned and
// W % 4 == 0; else 1).  An item's row chunk is read in pieces of 32 x
// kPieceGroups groups: lane l loads groups 32 q + l of a piece, every load
// of a piece in flight before its popcounts, ANDs them with the filter
// chunk in shared memory and popcounts.  Warp w takes units w, w + 8, ...
// of an item: unit u is part u % parts of row u / parts.  A unit's count
// is added to acc[s * R + r] (fire and forget), unless it is the row's
// only unit (one chunk, one part: written to out).  STAGED: each warp's
// pieces come through its own TMA ring (VEC 4 only).
template <int VEC, bool STAGED>
__global__ void __launch_bounds__(kRowThreads)
row_counts_kernel(const __grid_constant__ RowArgs a,
                  long long* __restrict__ out,
                  unsigned int* __restrict__ acc,
                  unsigned int* __restrict__ ticket) {
  constexpr int kPiece = 32 * kPieceGroups * VEC;   // words
  extern __shared__ __align__(128) uint32_t row_smem[];
  __shared__ __align__(8) uint64_t fbar[2];
  __shared__ __align__(8) uint64_t full[kRowWarps][kRowStages];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long* addrs = a.table != nullptr ? a.table : a.addrs;
  const long long filt_at = (long long)a.S * a.R;
  auto row_at = [&](long long s, int r) -> unsigned long long {
    return a.affine ? a.base + s * a.s_step + r * a.r_step
                    : addrs[s * a.R + r];
  };
  auto filter_of = [&](long long s) -> unsigned long long {
    return !a.filtered ? 0ull
           : a.affine  ? a.f_base + s * a.f_step
                       : addrs[filt_at + s];
  };
  const int C = a.chunk;
  const int part_pieces = (C + kPiece - 1) / kPiece / a.parts;
  const int units = a.R * a.parts;
  // items blockIdx.x, + gridDim.x, ...
  const long long i_begin = blockIdx.x;
  const long long i_step = gridDim.x;
  const int n_local = (int)((a.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const bool direct = a.n_chunks * a.parts == 1;
  // the filter chunks of two items: this one's, and the next one's in
  // flight (one TMA bulk copy, VEC 4) while this one's rows are read
  const bool prefetch = VEC == 4 && a.filtered;
  auto stage_filter = [&](int i) {   // one thread
    const long long item = i_begin + i * i_step;
    const long long s = item / a.n_chunks;
    const long long w0 = (item - s * a.n_chunks) * C;
    const unsigned long long fa = filter_of(s);
    const uint32_t bytes = fa != 0 ? (uint32_t)(min((long long)C, a.W - w0) * 4) : 0u;
    const uint32_t bar = smem_addr(&fbar[i & 1]);
    // the buffer's last reads (item i - 2) were generic; the copy is async
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, bytes);
    if (bytes != 0)
      bulk_copy(smem_addr(row_smem + (i & 1) * C),
                reinterpret_cast<const uint32_t*>(fa) + w0, bytes, bar);
  };

  // Staged form: lane 0 of each warp keeps its ring full.  The warp's
  // pieces, in order: per item, per unit of the warp whose row is present,
  // the unit's pieces.  (n_i, n_unit, n_piece) is the producer's position.
  uint32_t* ring = row_smem + (a.filtered ? 2 * C : 0) +
                   warp * kRowStages * kPiece;
  int n_i = 0, n_unit = warp, n_piece = 0;
  auto unit_addr = [&](int i, int u) -> unsigned long long {
    const long long s = (i_begin + i * i_step) / a.n_chunks;
    if (a.filtered && filter_of(s) == 0) return 0ull;
    return row_at(s, u / a.parts);
  };
  auto settle = [&]() {   // move the producer to a piece that exists
    while (n_i < n_local) {
      if (n_unit < units && unit_addr(n_i, n_unit) != 0) return;
      n_unit += kRowWarps;
      n_piece = 0;
      if (n_unit >= units) {
        ++n_i;
        n_unit = warp;
      }
    }
  };
  auto issue = [&](int st) {   // stage the producer's piece into slot st
    const long long item = i_begin + n_i * i_step;
    const long long s = item / a.n_chunks;
    const long long w0 = (item - s * a.n_chunks) * C;
    const long long n = min((long long)C, a.W - w0);
    const long long p0 = (long long)((n_unit % a.parts) * part_pieces + n_piece) * kPiece;
    const uint32_t bytes = (uint32_t)(max(0LL, min((long long)kPiece, n - p0)) * 4);
    const uint32_t bar = smem_addr(&full[warp][st]);
    mbar_expect_tx(bar, bytes);
    if (bytes != 0)
      bulk_copy(smem_addr(ring + st * kPiece),
                reinterpret_cast<const uint32_t*>(unit_addr(n_i, n_unit)) +
                    w0 + p0, bytes, bar);
    if (++n_piece == part_pieces) {
      n_piece = 0;
      n_unit += kRowWarps;
      if (n_unit >= units) {
        ++n_i;
        n_unit = warp;
      }
    }
    settle();
  };

  if (prefetch && tid == 0) {
    mbar_init(smem_addr(&fbar[0]), 1);
    mbar_init(smem_addr(&fbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    stage_filter(0);
  }
  if (STAGED && lane == 0) {
    for (int st = 0; st < kRowStages; ++st) mbar_init(smem_addr(&full[warp][st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    settle();
    for (int st = 0; st < kRowStages && n_i < n_local; ++st) issue(st);
  }

  // the addresses of each item's filter row and of the warp's first row,
  // loaded an item ahead
  auto first_addrs = [&](int i, unsigned long long& fa, unsigned long long& ra) {
    const long long s = (i_begin + i * i_step) / a.n_chunks;
    fa = a.filtered ? filter_of(s) : 0ull;
    ra = warp < units ? row_at(s, warp / a.parts) : 0ull;
  };
  unsigned long long fa_next = 0ull, ra_next = 0ull;
  if (n_local > 0) first_addrs(0, fa_next, ra_next);
  int k = 0;   // this warp's piece (staged form)
  for (int i = 0; i < n_local; ++i) {
    const long long item = i_begin + i * i_step;
    const long long s = item / a.n_chunks;
    const long long w0 = (item - s * a.n_chunks) * C;
    const int n = (int)min((long long)C, a.W - w0);   // words of this chunk
    const unsigned long long fa = fa_next, ra_first = ra_next;
    if (i + 1 < n_local) first_addrs(i + 1, fa_next, ra_next);
    uint32_t* fsm = row_smem + (i & 1) * C;
    if (a.filtered) {
      // every warp is done with item i - 1, whose buffer item i + 1 takes
      __syncthreads();
      if (prefetch) {
        if (tid == 0 && i + 1 < n_local) stage_filter(i + 1);
        mbar_wait(smem_addr(&fbar[i & 1]), (uint32_t)(i >> 1) & 1u);
      } else {   // the 4-byte path: the filter chunk with plain loads
        for (int g = tid; g < n; g += kRowThreads)
          fsm[g] = fa != 0 ? __ldg(reinterpret_cast<const uint32_t*>(fa) + w0 + g) : 0u;
        __syncthreads();
      }
    }
    const bool live = !a.filtered || fa != 0;
    for (int u = warp; u < units; u += kRowWarps) {
      const int r = u / a.parts;
      const unsigned long long ra =
          !live ? 0ull : u == warp ? ra_first : row_at(s, r);
      uint32_t pc = 0;
      if (ra != 0) {   // warp-uniform
        const int pb = (u % a.parts) * part_pieces;
#pragma unroll 2
        for (int p = pb; p < pb + part_pieces; ++p) {
          const int p0 = p * kPiece;
          const uint32_t* src;
          if constexpr (STAGED) {
            const int st = k % kRowStages;
            mbar_wait(smem_addr(&full[warp][st]), (uint32_t)(k / kRowStages) & 1u);
            src = ring + st * kPiece - p0;   // indexed by the chunk's word
          } else {
            src = reinterpret_cast<const uint32_t*>(ra) + w0;
          }
          Vec<VEC> x[kPieceGroups];
#pragma unroll
          for (int q = 0; q < kPieceGroups; ++q) {   // every load first
            const int g = p0 + (q * 32 + lane) * VEC;
            x[q] = splat<VEC>(0u);
            if (g < n) {
              if constexpr (STAGED) x[q] = load_words<VEC>(src + g, 0, false);
              else x[q] = global_words<VEC>(src + g);
            }
          }
#pragma unroll
          for (int q = 0; q < kPieceGroups; ++q) {
            const int g = p0 + (q * 32 + lane) * VEC;
            const Vec<VEC> f = a.filtered && g < n
                                   ? load_words<VEC>(fsm + g, 0, false)
                                   : splat<VEC>(0xFFFFFFFFu);
#pragma unroll
            for (int j = 0; j < VEC; ++j) pc += __popc(x[q].w[j] & f.w[j]);
          }
          if constexpr (STAGED) {
            __syncwarp();   // every lane is done with stage k % stages
            if (lane == 0 && n_i < n_local) {
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              issue(k % kRowStages);
            }
            __syncwarp();
            ++k;
          }
        }
      }
      pc = __reduce_add_sync(0xFFFFFFFFu, pc);
      if (lane == 0) {
        if (direct) out[s * a.R + r] = (long long)pc;
        else if (pc != 0u) red_add(acc + s * a.R + r, pc);
      }
    }
  }
  if (direct) return;
  // release this block's sums; the last block to finish (a ticket it
  // resets, kernel A's pattern) copies them out and zeroes them, so they
  // are zero again for the next launch on this stream
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned int prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(ticket) : "memory");
    last_block = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  const long long pairs = (long long)a.S * a.R;
  for (long long p = tid; p < pairs; p += kRowThreads) {
    out[p] = (long long)__ldcg(acc + p);
    acc[p] = 0u;
  }
  if (tid == 0) *ticket = 0u;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Same checks as ops/cuda_kernels.py validate().
bool valid_program(const uint32_t* instr, int n_instr, int result_reg,
                   int n_planes) {
  if (n_instr <= 0 || n_instr > kMaxInstr || n_planes < 1 ||
      n_planes > kMaxPlanes || result_reg < 0 || result_reg >= kNumRegs)
    return false;
  for (int k = 0; k < n_instr; ++k) {
    const uint32_t op = instr[k] & 0xFF, d = (instr[k] >> 8) & 0xFF;
    const uint32_t a = (instr[k] >> 16) & 0xFF, b = instr[k] >> 24;
    if (op > OP_BSI || d >= (uint32_t)kNumRegs) return false;
    if (op == OP_LOAD) {
      if (a >= (uint32_t)n_planes || b != 0) return false;
    } else if (op == OP_BSI) {
      if (k + 2 >= n_instr || a >= (uint32_t)kNumRegs || b != 0) return false;
      const uint32_t mask = instr[k + 1], info = instr[k + 2];
      const uint32_t first = info & 0xFF, depth = (info >> 8) & 0xFF;
      const uint32_t mode = (info >> 16) & 3;
      if ((info >> 20) != 0 || depth < 1 || depth > (uint32_t)kMaxDepth ||
          mode > MODE_GT || first + depth > (uint32_t)n_planes ||
          (depth < 32 && (mask >> depth) != 0))
        return false;
      k += 2;
    } else if (a >= (uint32_t)kNumRegs || b >= (uint32_t)kNumRegs) {
      return false;
    }
  }
  return true;
}

// The smallest register file (2, 4 or kNumRegs) that holds every register
// a valid program names.
int regs_needed(const uint32_t* instr, int n_instr, int result_reg) {
  uint32_t top = (uint32_t)result_reg;
  for (int k = 0; k < n_instr; ++k) {
    const uint32_t op = instr[k] & 0xFF, d = (instr[k] >> 8) & 0xFF;
    const uint32_t a = (instr[k] >> 16) & 0xFF, b = instr[k] >> 24;
    top = d > top ? d : top;
    if (op != OP_LOAD) top = a > top ? a : top;
    if (op != OP_LOAD && op != OP_BSI) top = b > top ? b : top;
    if (op == OP_BSI) k += 2;
  }
  return top < 2 ? 2 : top < 4 ? 4 : kNumRegs;
}

// The forms of kernel A: (staged, register file, words a thread a step).
using EvalKernel = decltype(&plan_eval_kernel<true, 2, 4>);
struct Form {
  EvalKernel kernel;
  bool staged;
  int regs, vec;
};
constexpr int kForms = 8;
const Form kFormTable[kForms] = {
    {plan_eval_kernel<true, 2, 8>, true, 2, 8},
    {plan_eval_kernel<true, 2, 4>, true, 2, 4},
    {plan_eval_kernel<true, 4, 8>, true, 4, 8},
    {plan_eval_kernel<true, 4, 4>, true, 4, 4},
    {plan_eval_kernel<true, kNumRegs, 4>, true, kNumRegs, 4},
    {plan_eval_kernel<false, 2, 1>, false, 2, 1},
    {plan_eval_kernel<false, 4, 1>, false, 4, 1},
    {plan_eval_kernel<false, kNumRegs, 1>, false, kNumRegs, 1},
};

// The form for a launch: the smallest register file the program needs, and
// 8 words a thread a step when a chunk is two steps of the block or more
// (half the dispatch per word), else 4.
int pick_form(bool staged, int regs, long long chunk) {
  const long long step = (long long)kEvalThreads * kVec;
  const int vec = !staged ? 1 : chunk >= 2 * step ? 8 : kVec;
  for (int f = 0; f < kForms; ++f) {
    const Form& x = kFormTable[f];
    if (x.staged == staged && x.regs == regs && x.vec <= vec) return f;
  }
  return -1;
}

// Per device: SMs and the resident blocks a SM of each form, from the
// occupancy calculator once the staged forms may use kStageBytes.
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
      const Form& x = kFormTable[f];
      if (x.staged &&
          ((e = cudaFuncSetAttribute(
                x.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                kStageBytes)) != cudaSuccess ||
           (e = cudaFuncSetAttribute(
                x.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess))
        return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d.blocks[f], x.kernel, kEvalThreads, x.staged ? kStageBytes : 0);
      if (e != cudaSuccess) return e;
      if (d.blocks[f] < 1) return cudaErrorInvalidConfiguration;
    }
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// Dynamic shared memory of B': two filter buffers of `chunk` words when
// filtered (chunk 0 otherwise), and each warp's TMA ring in the staged form.
size_t row_smem_bytes(int form, long long chunk) {
  return (size_t)(2 * chunk * 4) +
         (form == 2 && kRowsStaged ? (size_t)kRowWarps * kRowStages * 32 *
                                         kPieceGroups * 4 * 4
                                   : 0);
}

// Per device: SMs and the resident blocks a SM of each form of B' (VEC 4,
// VEC 1, VEC 4 staged) at the largest shared memory a launch asks for.
struct RowInfo {
  int sms = 0;
  int blocks[3] = {};
};
RowInfo g_row_devices[64];

cudaError_t row_info(RowInfo** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  RowInfo& d = g_row_devices[dev];
  if (d.sms == 0) {
    int sms = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    const void* forms[3] = {
        (const void*)row_counts_kernel<4, false>,
        (const void*)row_counts_kernel<1, false>,
        (const void*)row_counts_kernel<4, kRowsStaged>};
    const long long chunk_max[3] = {kRowChunkMax, kRowChunkMax / 4, kRowChunkMax};
    for (int f = 0; f < 3; ++f) {
      const size_t smem = row_smem_bytes(f, chunk_max[f]);
      if ((e = cudaFuncSetAttribute(forms[f],
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
        return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.blocks[f], forms[f],
                                                        kRowThreads, smem);
      if (e != cudaSuccess) return e;
      if (d.blocks[f] < 1) return cudaErrorInvalidConfiguration;
    }
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// The chunk: the largest power of two times 32 groups, at most
// kRowChunkMax words (VEC 4; a quarter of that for VEC 1), no larger than
// W needs, that gives every SM an item, or the warps plenty of rows.  Then
// the parts a row chunk splits into, up to one a warp: a block's warps read
// neighbouring pieces of one row at a time, which streamed faster on the
// H100 than a row a warp (PERF.md).
void row_plan(int S, int R, long long W, int vec, int sms, int* chunk,
              int* parts) {
  const long long lo = 32LL * vec, hi = vec == 4 ? kRowChunkMax : kRowChunkMax / 4;
  long long c = hi;
  while (c > lo && c / 2 >= W) c /= 2;
  auto items = [&](long long c) { return (long long)S * ((W + c - 1) / c); };
  while (c > lo && items(c) < sms && items(c) * R < 32LL * sms) c /= 2;
  const long long piece = 32LL * kPieceGroups * vec;
  const long long pieces = c > piece ? c / piece : 1;
  int p = 1;
  while (p * 2 <= kRowWarps && p * 2 <= pieces) p *= 2;
  *chunk = (int)c;
  *parts = p;
}

}  // namespace

extern "C" {

int fb_limits(int* max_instr, int* max_planes, int* num_regs, int* max_depth,
              int* chunk_quantum) {
  *max_instr = kMaxInstr;
  *max_planes = kMaxPlanes;
  *num_regs = kNumRegs;
  *max_depth = kMaxDepth;
  *chunk_quantum = kChunkQuantum;
  return 0;
}

// SMs, and resident blocks a SM of each of kernel A's kForms forms, in the
// order of kFormTable: staged 2x8, 2x4, 4x8, 4x4, 12x4 (registers x words
// a thread a step), then scalar with 2, 4 and 12 registers.
int fb_plan_eval_config(int* sms, int* blocks) {
  DeviceInfo* info = nullptr;
  const cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  *sms = info->sms;
  for (int f = 0; f < kForms; ++f) blocks[f] = info->blocks[f];
  return 0;
}

// Evaluate a lowered program over S shards of W words.  out_words ((S, W)
// int32, contiguous) and/or counts ((S,) int64) may be null.  With counts,
// partials is scratch of n_partials int64 (S * ceil(W / kChunkQuantum) is
// always enough; no zeroing) and ticket a uint32 that is 0 before the
// launch and is 0 again after it.  planes/strides/instr are host arrays
// copied into the launch.
int fb_plan_eval(const uint32_t* instr, int n_instr, int result_reg,
                 const void* const* planes, const long long* strides,
                 int n_planes, int S, long long W, void* out_words,
                 void* counts, void* partials, long long n_partials,
                 void* ticket, void* stream) {
  if (!valid_program(instr, n_instr, result_reg, n_planes) || S <= 0 ||
      W <= 0 || (counts != nullptr && (partials == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Program p = {};
  bool staged = (W % 4) == 0 && (out_words == nullptr || aligned16(out_words));
  for (int i = 0; i < n_planes; ++i) {
    p.plane[i] = static_cast<const int32_t*>(planes[i]);
    p.stride[i] = strides[i];
    staged = staged && aligned16(planes[i]) && (strides[i] % 4) == 0;
  }
  for (int i = 0; i < n_instr; ++i) p.instr[i] = instr[i];
  p.n_instr = n_instr;
  p.result = result_reg;
  p.n_planes = n_planes;
  const int nr = regs_needed(instr, n_instr, result_reg);

  DeviceInfo* info = nullptr;
  const cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;

  Tiling g = {};
  g.W = W;
  g.S = S;
  if (staged) {
    // the largest chunk, up to kChunkSteps steps of the block, that leaves
    // room for kMinStages tiles of every plane; then as many stages as fit
    const long long step = (long long)kEvalThreads * kVec * kChunkSteps;
    const long long w_round =
        (W + kChunkQuantum - 1) / kChunkQuantum * kChunkQuantum;
    long long c = kStageBytes / (kMinStages * 4LL * n_planes);
    c = c < step ? c : step;
    c -= c % kChunkQuantum;
    g.chunk = c < w_round ? c : w_round;
    if (g.chunk < kChunkQuantum) return (int)cudaErrorInvalidValue;
    const long long fit = kStageBytes / (4LL * n_planes * g.chunk);
    g.stages = (int)(fit < kMaxStages ? fit : kMaxStages);
  } else {
    g.chunk = kScalarChunk;
    g.stages = 0;
  }
  const int form = pick_form(staged, nr, g.chunk);
  if (form < 0) return (int)cudaErrorInvalidValue;
  g.per_shard = (W + g.chunk - 1) / g.chunk;
  g.n_tiles = g.per_shard * S;
  if (counts != nullptr && g.n_tiles > n_partials) return (int)cudaErrorInvalidValue;
  const long long slots = (long long)info->sms * info->blocks[form];
  g.per_block = (g.n_tiles + slots - 1) / slots;
  const unsigned grid = (unsigned)((g.n_tiles + g.per_block - 1) / g.per_block);
  int32_t* o = static_cast<int32_t*>(out_words);
  auto* c = static_cast<unsigned long long*>(counts);
  auto* part = static_cast<unsigned long long*>(partials);
  auto* tk = static_cast<unsigned int*>(ticket);
  const size_t smem = staged ? (size_t)g.stages * n_planes * g.chunk * 4 : 0;
  kFormTable[form].kernel<<<grid, kEvalThreads, smem, st>>>(p, g, o, c, part,
                                                            tk);
  return (int)cudaGetLastError();
}

// Kernel B' over an address table of S x R rows (and S filter rows when
// `filtered`): host_table when it has at most kInlineAddrs entries (it rides
// in the launch), else dev_table, the same entries on the device, or for a
// stacked tile `affine`: {base, shard step, row step, filter base, filter
// step} in bytes, every row present.  vec is 4
// when W % 4 == 0 and every address is 16-byte aligned, else 1.  out is
// (S, R) int64.  When fb_row_counts_plan says `summed`, acc is S * R
// uint32 and ticket a uint32, all 0 before the launch and 0 again after it.
int fb_row_counts(const unsigned long long* host_table, const void* dev_table,
                  const long long* affine, int S, int R, int filtered,
                  long long W, int vec, void* out, void* acc, void* ticket,
                  void* stream) {
  // a row's count (at most 32 W) must fit the kernel's 32-bit sums
  if (S <= 0 || R <= 0 || W <= 0 || W >= (1LL << 27) ||
      (vec != 4 && vec != 1) || (vec == 4 && W % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const long long entries = (long long)S * R + (filtered ? S : 0);
  if (affine == nullptr && dev_table == nullptr &&
      (host_table == nullptr || entries > kInlineAddrs))
    return (int)cudaErrorInvalidValue;
  RowInfo* info = nullptr;
  cudaError_t e = row_info(&info);
  if (e != cudaSuccess) return (int)e;
  RowArgs a;
  a.table = static_cast<const unsigned long long*>(dev_table);
  a.affine = affine != nullptr;
  a.base = a.f_base = 0;
  a.s_step = a.r_step = a.f_step = 0;
  if (a.affine) {
    a.base = (unsigned long long)affine[0];
    a.s_step = affine[1];
    a.r_step = affine[2];
    a.f_base = (unsigned long long)affine[3];
    a.f_step = affine[4];
  } else if (a.table == nullptr) {
    for (long long i = 0; i < entries; ++i) a.addrs[i] = host_table[i];
  }
  a.W = W;
  a.S = S;
  a.R = R;
  a.filtered = filtered ? 1 : 0;
  row_plan(S, R, W, vec, info->sms, &a.chunk, &a.parts);
  a.n_chunks = (int)((W + a.chunk - 1) / a.chunk);
  a.n_items = (long long)a.n_chunks * S;
  if (a.n_chunks * a.parts > 1 && (acc == nullptr || ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  const int form = vec == 4 ? (kRowsStaged ? 2 : 0) : 1;
  const long long slots = (long long)info->sms * info->blocks[form];
  // as many blocks as give each the same count of items, within the
  // resident slots
  const long long per_block = (a.n_items + slots - 1) / slots;
  const unsigned grid = (unsigned)((a.n_items + per_block - 1) / per_block);
  const size_t smem = row_smem_bytes(form, a.filtered ? a.chunk : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  auto* ac = static_cast<unsigned int*>(acc);
  auto* tk = static_cast<unsigned int*>(ticket);
  if (form == 0) row_counts_kernel<4, false><<<grid, kRowThreads, smem, st>>>(a, o, ac, tk);
  else if (form == 1) row_counts_kernel<1, false><<<grid, kRowThreads, smem, st>>>(a, o, ac, tk);
  else row_counts_kernel<4, kRowsStaged><<<grid, kRowThreads, smem, st>>>(a, o, ac, tk);
  return (int)cudaGetLastError();
}

// How B' cuts S shards of R rows of W words (fb_row_counts): the chunk,
// whether the counts are summed across units (then the launch needs the
// accumulator and the ticket), and how many table entries ride in the
// launch.
int fb_row_counts_plan(int S, int R, long long W, int vec, int* chunk,
                       int* summed, int* inline_addrs) {
  if (S <= 0 || R <= 0 || W <= 0 || (vec != 4 && vec != 1))
    return (int)cudaErrorInvalidValue;
  RowInfo* info = nullptr;
  const cudaError_t e = row_info(&info);
  if (e != cudaSuccess) return (int)e;
  int parts = 1;
  row_plan(S, R, W, vec, info->sms, chunk, &parts);
  *summed = (W + *chunk - 1) / *chunk * parts > 1;
  *inline_addrs = kInlineAddrs;
  return 0;
}

}  // extern "C"
