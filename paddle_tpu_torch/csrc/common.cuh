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
// 16 / sizeof(T), the widest a thread can issue).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Elements of one K/V cache load: 16 bytes of bf16 or f32, 8 bytes of
// int8 (so an int8 row takes as many threads, and registers, as a bf16
// one).
template <typename KV>
struct KVVec;
template <>
struct KVVec<float> {
  static constexpr int n = 4;
};
template <>
struct KVVec<__nv_bfloat16> {
  static constexpr int n = 8;
};
template <>
struct KVVec<int8_t> {
  static constexpr int n = 8;
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace pt
