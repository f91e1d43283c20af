// Code types and the fp8 decode shared by the weight-only product's two
// sources: quant_matmul.cu (the skinny and CUDA-core paths) and
// quant_matmul_tc.cu (the tensor-core path).
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

// code types of the C entries (ops/hopper/quant_matmul.py names them)
enum Codes : int { kE4M3 = 1, kE5M2 = 2, kInt4 = 4, kInt8 = 8 };

inline bool valid_codes(int codes) {
  return codes == kInt4 || codes == kInt8 || codes == kE4M3 ||
         codes == kE5M2;
}

template <int C>
__host__ __device__ constexpr __nv_fp8_interpretation_t fp8_kind() {
  return C == kE4M3 ? __NV_E4M3 : __NV_E5M2;
}

// the four fp8 codes of a 4-byte word, byte c to f[c], exactly (every
// e4m3 and e5m2 value is a half)
template <int C>
__device__ __forceinline__ void fp8x4(uint32_t w, float (&f)[4]) {
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), fp8_kind<C>()));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), fp8_kind<C>()));
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// out = (sum over the K splits, in order) * scale, cast: the second pass
// of a product whose K was split across blocks (no atomics, so the
// result does not change from run to run)
template <typename T>
__global__ void qmm_combine_kernel(const float* __restrict__ part,
                                   const float* __restrict__ scale,
                                   T* __restrict__ out, int m, int n,
                                   int nsplit) {
  const int64_t total = static_cast<int64_t>(m) * n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < nsplit; ++s) v += part[s * total + i];
    out[i] = pt::from_f32<T>(v * scale[i % n]);
  }
}

// part: (nsplit, m, n) float32 partial sums
template <typename T>
cudaError_t combine(const float* part, const float* scale, void* out, int m,
                    int n, int nsplit, cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(m) * n;
  const int blocks = static_cast<int>(std::min<int64_t>((total + 255) / 256,
                                                        4096));
  qmm_combine_kernel<T><<<blocks, 256, 0, s>>>(part, scale,
                                               static_cast<T*>(out), m, n,
                                               nsplit);
  return cudaGetLastError();
}

}  // namespace
