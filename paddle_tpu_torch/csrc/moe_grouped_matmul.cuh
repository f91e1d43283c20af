// The device-side tile scan shared by X1's kernels (moe_grouped_matmul.cu:
// skinny and CUDA-core tiled paths; moe_grouped_matmul_tc.cu: the tensor
// cores). A block of any of them owns one (expert, row tile) pair, found
// from the expert offsets on the device, so no count is read on the host
// and the grid comes from R and E alone.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxExperts = 1024;       // offsets staged in shared memory

struct Pair {
  int e, r0, r1;
};

// The block's (expert, row tile) pair for slot `slot`, tiles of `bm`
// rows in expert order: warp 0 scans the tile counts (each lane a run of
// experts, then a shuffle scan), and the lane whose run holds the slot
// writes the pair. False past the last pair (uniform over the block).
__device__ __forceinline__ bool find_pair(const int* __restrict__ offsets,
                                          int E, int bm, int slot,
                                          int* s_off, Pair* s_pair) {
  for (int i = threadIdx.x; i <= E; i += blockDim.x) s_off[i] = offsets[i];
  if (threadIdx.x == 0) s_pair->e = -1;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32;
    const int e0 = min(E, lane * per), e1 = min(E, e0 + per);
    int mine = 0;
    for (int e = e0; e < e1; ++e)
      mine += (s_off[e + 1] - s_off[e] + bm - 1) / bm;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (slot >= incl - mine && slot < incl) {
      int t = slot - (incl - mine);
      for (int e = e0; e < e1; ++e) {
        const int n = (s_off[e + 1] - s_off[e] + bm - 1) / bm;
        if (t < n) {
          s_pair->e = e;
          s_pair->r0 = s_off[e] + t * bm;
          s_pair->r1 = min(s_off[e + 1], s_pair->r0 + bm);
          break;
        }
        t -= n;
      }
    }
  }
  __syncthreads();
  return s_pair->e >= 0;
}

}  // namespace
