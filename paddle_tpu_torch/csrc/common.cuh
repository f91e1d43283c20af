// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is reached through a plain C entry point (bound from
// Python with ctypes) that launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch is reported at the call.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

// dtype codes shared with paddle_tpu_torch/ops/_build.py
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T moved as one load or store (16 bytes when VEC is
// 16 / sizeof(T), the widest a thread can issue); a wider pack is
// aligned to 16 bytes and moves as several 16-byte loads.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

// Launch on the device the caller's tensors live on: this library links
// its own copy of the CUDA runtime, whose current device is tracked
// apart from PyTorch's.
inline cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// the smallest power of two >= n (host side: lanes per row, heads per
// chunk)
inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace pt
