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
// byte at which the card's arithmetic would become the limit.
//
// Forward, bf16 rows (rms_norm_fwd_rows; batches of 256 rows and more,
// prefill and training, N a multiple of 8 up to 8192, 16-byte aligned):
// a warp per row, the row held in registers (VPT 16-byte vectors a lane,
// 16 at N = 4096), read from memory once; the sum of squares reduced by
// warp shuffles alone; w converted to float32 and staged in shared
// memory once per block of 4 rows, its loads issued beside the rows'
// before one barrier. y = (x * r) * w in float32, as the plain version.
// On the card (H100, PERF.md) this beat a grid of 8-warp blocks walking
// many rows each, and a block per row below 256 rows.
//
// Every other forward (float32 rows, whose times already beat
// F.rms_norm; bf16 batches of fewer rows, decode's; bf16 rows that are
// wider, of a width that is not a multiple of 8, or not aligned) and the
// backward: one block per row;
// 16-byte vector loads and stores (8 bf16 or 4 f32 per thread per
// access) when the row width allows, a scalar path for any other width;
// the row sum is reduced in registers, then across warps through shared
// memory. The second pass reads the row(s) again, but a row of a
// Llama-7B-width model (8 KB in bf16) is still in L1/L2 by then, so
// device memory sees it once.

#include <type_traits>

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

constexpr int kRowThreads = 128;  // 4 warps: 4 rows a block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowMaxVec = 32;    // 16-byte vectors a lane at most
// fewer rows take a block each (rms_norm_fwd_kernel): a few rows spread
// over 8 warps each finish sooner than over one
constexpr int kFewRows = 256;

// The 8 bf16 of a 16-byte vector as float32, exactly.
__device__ __forceinline__ void bf16x8_f32(const uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xFFFF0000u);
  }
}

// bf16 rows of n = 8 * nvec elements, nvec <= 32 * VPT: warp j of block
// i normalises row 4 i + j, lane l holding its vectors l, l + 32, ...
template <typename W, int VPT>
__global__ void __launch_bounds__(kRowThreads, 1)
    rms_norm_fwd_rows(const __nv_bfloat16* __restrict__ x,
                      const W* __restrict__ w, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ r_out, int rows, int n, float eps) {
  extern __shared__ float4 s_w[];  // w in float32, 2 float4 a vector
  const int lane = threadIdx.x & 31;
  const int nvec = n / 8;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  // the row's loads first, then w's, every load before the first store
  uint4 v[VPT];
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * n);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = lane + k * 32;
    v[k] = row < rows && i < nvec ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);
  }
  constexpr int kWPer = (VPT * 32 + kRowThreads - 1) / kRowThreads;
  uint4 wv[kWPer][std::is_same<W, float>::value ? 2 : 1];
#pragma unroll
  for (int k = 0; k < kWPer; ++k) {
    const int i = threadIdx.x + k * kRowThreads;
    if (i < nvec) {
      const uint4* wp = reinterpret_cast<const uint4*>(w);
      if constexpr (std::is_same<W, float>::value) {
        wv[k][0] = __ldg(wp + 2 * i);
        wv[k][1] = __ldg(wp + 2 * i + 1);
      } else {
        wv[k][0] = __ldg(wp + i);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kWPer; ++k) {
    const int i = threadIdx.x + k * kRowThreads;
    if (i < nvec) {
      if constexpr (std::is_same<W, float>::value) {
        s_w[2 * i] = *reinterpret_cast<const float4*>(&wv[k][0]);
        s_w[2 * i + 1] = *reinterpret_cast<const float4*>(&wv[k][1]);
      } else {
        float f[8];
        bf16x8_f32(wv[k][0], f);
        s_w[2 * i] = make_float4(f[0], f[1], f[2], f[3]);
        s_w[2 * i + 1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
  __syncthreads();
  if (row >= rows) return;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    float f[8];
    bf16x8_f32(v[k], f);  // zeros past the row
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(n) + eps);
  if (r_out != nullptr && lane == 0) r_out[row] = r;
  uint4* yr = reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * n);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = lane + k * 32;
    if (i < nvec) {
      float f[8];
      bf16x8_f32(v[k], f);
      const float4 wa = s_w[2 * i], wb = s_w[2 * i + 1];
      const float wf[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            f[2 * j] * r * wf[2 * j], f[2 * j + 1] * r * wf[2 * j + 1]);
        o[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      yr[i] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The row kernel for vectors of a lane up to VPT: a block per 4 rows.
template <typename W, int VPT>
cudaError_t launch_rows(const void* x, const void* w, void* out, void* r,
                        int rows, int n, float eps, cudaStream_t stream) {
  rms_norm_fwd_rows<W, VPT>
      <<<(rows + kRowWarps - 1) / kRowWarps, kRowThreads,
         n / 8 * 2 * sizeof(float4), stream>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w),
          static_cast<__nv_bfloat16*>(out), static_cast<float*>(r), rows, n,
          eps);
  return cudaGetLastError();
}

template <typename W>
cudaError_t by_width(const void* x, const void* w, void* out, void* r,
                     int rows, int n, float eps, cudaStream_t stream) {
  const int per_lane = (n / 8 + 31) / 32;
  if (per_lane <= 1)
    return launch_rows<W, 1>(x, w, out, r, rows, n, eps, stream);
  if (per_lane <= 2)
    return launch_rows<W, 2>(x, w, out, r, rows, n, eps, stream);
  if (per_lane <= 4)
    return launch_rows<W, 4>(x, w, out, r, rows, n, eps, stream);
  if (per_lane <= 8)
    return launch_rows<W, 8>(x, w, out, r, rows, n, eps, stream);
  if (per_lane <= 12)
    return launch_rows<W, 12>(x, w, out, r, rows, n, eps, stream);
  if (per_lane <= 16)
    return launch_rows<W, 16>(x, w, out, r, rows, n, eps, stream);
  if (per_lane <= 24)
    return launch_rows<W, 24>(x, w, out, r, rows, n, eps, stream);
  return launch_rows<W, kRowMaxVec>(x, w, out, r, rows, n, eps, stream);
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, void* r, int rows,
                   int n, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (rows >= kFewRows && n % 8 == 0 && n <= 8 * 32 * kRowMaxVec &&
        pt::aligned16(x) && pt::aligned16(out) && pt::aligned16(w))
      return by_width<W>(x, w, out, r, rows, n, eps, stream);
  }
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

// Counting the kernels a call enqueues (ops/_build.py kernels_per_call):
// capture the stream, let the caller run the call, then end the capture
// and count the graph's kernel nodes.
extern "C" int pt_capture_begin(void* stream) {
  return cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                cudaStreamCaptureModeRelaxed);
}

extern "C" int pt_capture_kernels(void* stream, int* kernels) {
  cudaGraph_t graph = nullptr;
  cudaError_t e =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  if (e != cudaSuccess) return e;
  constexpr size_t kMaxNodes = 256;  // far more than one call enqueues
  cudaGraphNode_t nodes[kMaxNodes];
  size_t n = 0;
  e = cudaGraphGetNodes(graph, nullptr, &n);
  if (e == cudaSuccess && n > kMaxNodes) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = cudaGraphGetNodes(graph, nodes, &n);
  int count = 0;
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    count += type == cudaGraphNodeTypeKernel;
  }
  cudaGraphDestroy(graph);
  *kernels = count;
  return e;
}
