// Softmax cross-entropy forward and backward for Hopper (sm_90a).
//
// Forward replaces the TPU kernel paddle_tpu/ops/pallas/softmax_xent.py::
// _run_fwd (body _fwd_kernel): per row of logits x (rows, V) and an int
// label, lse = log(sum(exp(x))) and loss = lse - x[label], both float32,
// in ONE online pass over the row (running max and rescaled sum), never
// materialising the softmax. A label outside [0, V) picks -1e30, as the
// TPU kernel's masked pick does.
//
// Backward replaces paddle_tpu/ops/pallas/softmax_xent.py::_xent_bwd
// (body _bwd_kernel): dx = (exp(x - lse) - onehot(label)) * g, in the
// logits' dtype.
//
// Bound: bytes. The forward reads each logit once (2 bytes in bf16 for
// one exp and a few float operations), the backward reads it and writes
// its gradient; at Llama's vocab (V = 32000) a row is 64 KB in bf16. The
// exp throughput (16 per clock per SM) stays under the memory rate.
// Design: one block per row; 16-byte vector loads (8 bf16 or 4 f32 per
// thread per access) when V and the row base allow, a scalar path for
// any other vocab (V = 32000 is no multiple of a power-of-two tile, but
// it is a multiple of the 8-wide vector, so no tail is left over);
// each thread keeps its own (max, sum) pair, merged across the warp by
// shuffles and across warps through shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// (m, l) <- the log-sum-exp state of the union of two element sets
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse_out,
                    int v) {
  using P = pt::Pack<T, VEC>;
  __shared__ float sm[32], sl[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * v;
  const P* xv = reinterpret_cast<const P*>(xr);
  float m = kNegInf, l = 0.f;
  for (int i = threadIdx.x; i < v / VEC; i += kThreads) {
    const P p = xv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = pt::to_f32(p.v[j]);
      if (f > m) {
        l = l * expf(m - f) + 1.f;
        m = f;
      } else {
        l += expf(f - m);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, l, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < (kThreads >> 5) ? sm[lane] : kNegInf;
    l = lane < (kThreads >> 5) ? sl[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      merge(m, l, __shfl_xor_sync(0xffffffffu, m, o),
            __shfl_xor_sync(0xffffffffu, l, o));
    if (lane == 0) {
      const float lse = m + logf(fmaxf(l, 1e-30f));
      const int64_t label = labels[row];
      const float picked =
          (label >= 0 && label < v) ? pt::to_f32(xr[label]) : kNegInf;
      loss[row] = lse - picked;
      lse_out[row] = lse;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ x,
                    const int64_t* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    T* __restrict__ dx, int v) {
  using P = pt::Pack<T, VEC>;
  const int64_t row = blockIdx.x;
  const P* xv = reinterpret_cast<const P*>(x + row * v);
  P* dv = reinterpret_cast<P*>(dx + row * v);
  const float l = lse[row], gg = g[row];
  const int64_t label = labels[row];
  for (int i = threadIdx.x; i < v / VEC; i += kThreads) {
    const P p = xv[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float hot = (static_cast<int64_t>(i) * VEC + j == label) ? 1.f : 0.f;
      o.v[j] = pt::from_f32<T>((expf(pt::to_f32(p.v[j]) - l) - hot) * gg);
    }
    dv[i] = o;
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const int64_t* labels, float* loss,
                       float* lse, int rows, int v, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  if (v % kVec == 0 && pt::aligned16(x))
    xent_fwd_kernel<T, kVec><<<rows, kThreads, 0, s>>>(xp, labels, loss, lse, v);
  else
    xent_fwd_kernel<T, 1><<<rows, kThreads, 0, s>>>(xp, labels, loss, lse, v);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const int64_t* labels, const float* lse,
                       const float* g, void* dx, int rows, int v,
                       cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* dp = static_cast<T*>(dx);
  if (v % kVec == 0 && pt::aligned16(x) && pt::aligned16(dx))
    xent_bwd_kernel<T, kVec><<<rows, kThreads, 0, s>>>(xp, labels, lse, g, dp,
                                                       v);
  else
    xent_bwd_kernel<T, 1><<<rows, kThreads, 0, s>>>(xp, labels, lse, g, dp, v);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, v) contiguous, dtype `dtype`; labels: (rows,) int64;
// loss, lse: (rows,) float32.
extern "C" int pt_softmax_xent_fwd(int device, const void* x,
                                   const void* labels, void* loss, void* lse,
                                   int rows, int v, int dtype, void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (rows < 0 || v <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int64_t* lp = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return launch_fwd<float>(x, lp, lo, ls, rows, v, s);
  if (dtype == pt::kBF16)
    return launch_fwd<__nv_bfloat16>(x, lp, lo, ls, rows, v, s);
  return cudaErrorInvalidValue;
}

// x, dx: (rows, v) contiguous, dtype `dtype`; labels: (rows,) int64;
// lse (from the forward), g: (rows,) float32.
extern "C" int pt_softmax_xent_bwd(int device, const void* x,
                                   const void* labels, const void* lse,
                                   const void* g, void* dx, int rows, int v,
                                   int dtype, void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (rows < 0 || v <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int64_t* lp = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return launch_bwd<float>(x, lp, ls, gp, dx, rows, v, s);
  if (dtype == pt::kBF16)
    return launch_bwd<__nv_bfloat16>(x, lp, ls, gp, dx, rows, v, s);
  return cudaErrorInvalidValue;
}
