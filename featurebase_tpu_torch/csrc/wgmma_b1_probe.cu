// Does ptxas take the warpgroup form of the 1-bit AND-popcount product on
// sm_90a?  chip_smoke.py compiles this file beside csrc/group_kernels.cu and
// reports whether the build succeeded; nothing launches it.  Kernels E and F
// use the warp-level mma.sync m16n8k256 .b1 .and.popc, whose rate the
// tc_rate phase measures.

#include <stdint.h>

extern "C" __global__ void wgmma_b1_probe_kernel(int* out,
                                                 unsigned long long desc_a,
                                                 unsigned long long desc_b) {
  int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n8k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3}, %4, %5, p;\n"
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n}\n"
      : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
      : "l"(desc_a), "l"(desc_b), "r"(1));
  out[threadIdx.x] = d0 + d1 + d2 + d3;
}
