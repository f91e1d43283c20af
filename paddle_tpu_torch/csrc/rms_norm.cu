// RMSNorm forward and backward (dx) for Hopper (sm_90a).
//
// Forward replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py::
// _run_fwd (body _fwd_kernel): per row, y = x * rsqrt(mean(x^2) + eps) * w
// in float32, cast to x's dtype, and r = rsqrt(mean(x^2) + eps) in
// float32 when the caller asks for it (training keeps r for the
// backward).
//
// Backward replaces paddle_tpu/ops/pallas/rms_norm.py::_rms_bwd (body
// _dx_kernel): per row, dx = r*g*w - x*r^3*mean(g*w*x), cast to x's
// dtype. dw = sum over rows of g*x*r stays a plain reduction, as the JAX
// package leaves it to XLA.
//
// Bound: bytes. The forward reads a row once and writes it once; the
// backward reads x and g and writes dx (in bf16, 4*N and 6*N bytes for
// about 4*N and 6*N float operations), far below the ~295 operations per
// byte at which the card's arithmetic would become the limit. Design:
// one block per row; 16-byte vector loads and stores (8 bf16 or 4 f32
// per thread per access) when the row width allows, a scalar path for
// any other width; the row sum is reduced in registers, then across
// warps through shared memory. The second pass reads the row(s) again,
// but a row of a Llama-7B-width model (8 KB in bf16) is still in L1/L2
// by then, so device memory sees it once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? scratch[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// VEC: elements of x per access; 1 is the scalar path for a row width
// that is not a multiple of the 16-byte vector.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        T* __restrict__ out, float* __restrict__ r_out, int n,
                        float eps) {
  using P = pt::Pack<T, VEC>;
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * n);
  P* yr = reinterpret_cast<P*>(out + row * n);
  const int nvec = n / VEC;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = pt::to_f32(p.v[j]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss, scratch) / static_cast<float>(n) + eps);
  if (r_out != nullptr && threadIdx.x == 0) r_out[row] = r;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P p = xr[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = pt::from_f32<T>(pt::to_f32(p.v[j]) * r *
                               pt::to_f32(w[i * VEC + j]));
    yr[i] = o;
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, void* r, int rows,
                   int n, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  float* rp = static_cast<float*>(r);
  if (n % kVec == 0 && pt::aligned16(x) && pt::aligned16(out))
    rms_norm_fwd_kernel<T, W, kVec>
        <<<rows, kThreads, 0, stream>>>(xp, wp, op, rp, n, eps);
  else
    rms_norm_fwd_kernel<T, W, 1>
        <<<rows, kThreads, 0, stream>>>(xp, wp, op, rp, n, eps);
  return cudaGetLastError();
}

// dx = r*g*w - x*r^3*mean(g*w*x) per row (VEC as in the forward).
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kThreads)
    rms_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        const float* __restrict__ r, const T* __restrict__ g,
                        T* __restrict__ dx, int n) {
  using P = pt::Pack<T, VEC>;
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * n);
  const P* gr = reinterpret_cast<const P*>(g + row * n);
  P* dr = reinterpret_cast<P*>(dx + row * n);
  const int nvec = n / VEC;
  float s = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P px = xr[i], pg = gr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      s += pt::to_f32(pg.v[j]) * pt::to_f32(w[i * VEC + j]) *
           pt::to_f32(px.v[j]);
  }
  const float mean = block_sum(s, scratch) / static_cast<float>(n);
  const float rr = r[row];
  const float c = rr * rr * rr * mean;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P px = xr[i], pg = gr[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float gw = pt::to_f32(pg.v[j]) * pt::to_f32(w[i * VEC + j]);
      o.v[j] = pt::from_f32<T>(rr * gw - pt::to_f32(px.v[j]) * c);
    }
    dr[i] = o;
  }
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* w, const void* r,
                       const void* g, void* dx, int rows, int n,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const float* rp = static_cast<const float*>(r);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  if (n % kVec == 0 && pt::aligned16(x) && pt::aligned16(g) &&
      pt::aligned16(dx))
    rms_norm_bwd_kernel<T, W, kVec>
        <<<rows, kThreads, 0, stream>>>(xp, wp, rp, gp, dp, n);
  else
    rms_norm_bwd_kernel<T, W, 1>
        <<<rows, kThreads, 0, stream>>>(xp, wp, rp, gp, dp, n);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, n) contiguous, dtype x_dtype; w: (n,), dtype w_dtype
// (float32 or x's dtype); r: (rows,) float32, or null to skip it.
extern "C" int pt_rms_norm_fwd(int device, const void* x, const void* w,
                               void* out, void* r, int rows, int n, float eps,
                               int x_dtype, int w_dtype, void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (rows < 0 || n <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w_f32 = w_dtype == pt::kF32;
  if (x_dtype == pt::kF32 && w_f32)
    return launch<float, float>(x, w, out, r, rows, n, eps, s);
  if (x_dtype == pt::kBF16 && w_f32)
    return launch<__nv_bfloat16, float>(x, w, out, r, rows, n, eps, s);
  if (x_dtype == pt::kBF16 && w_dtype == pt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, r, rows, n, eps, s);
  return cudaErrorInvalidValue;
}

// x, g, dx: (rows, n) contiguous, dtype x_dtype; w: (n,), dtype w_dtype
// (float32 or x's dtype); r: (rows,) float32 from the forward.
extern "C" int pt_rms_norm_bwd(int device, const void* x, const void* w,
                               const void* r, const void* g, void* dx,
                               int rows, int n, int x_dtype, int w_dtype,
                               void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (rows < 0 || n <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w_f32 = w_dtype == pt::kF32;
  if (x_dtype == pt::kF32 && w_f32)
    return launch_bwd<float, float>(x, w, r, g, dx, rows, n, s);
  if (x_dtype == pt::kBF16 && w_f32)
    return launch_bwd<__nv_bfloat16, float>(x, w, r, g, dx, rows, n, s);
  if (x_dtype == pt::kBF16 && w_dtype == pt::kBF16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, r, g, dx, rows, n,
                                                    s);
  return cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
