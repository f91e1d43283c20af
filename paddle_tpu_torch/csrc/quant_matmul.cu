// Weight-only quantized matrix product for Hopper (sm_90a): int8 codes
// (K10), packed int4 codes (K11) and fp8 codes (K10f8: e4m3 or e5m2), one
// template on the code type.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/quant_matmul.py::
// quant_matmul (pallas_call at :139; int8 codes, and fp8 codes, which its
// _kernel :85-110 casts to float32 in VMEM) and ::quant_matmul_int4
// (:175):
//
//   out[m, n] = (sum_k x[m, k] * code[k, n]) * scale[n]
//
// accumulated in float32 over the raw codes, the column scale applied
// to the accumulator, cast to x's dtype. int8 and fp8 codes are (K, N)
// row-major, one byte each; int4 codes are (ceil(K / 2), N) bytes holding two sign-extended 4-bit
// codes along K (row 2r in the low nibble, 2r + 1 in the high one). An
// odd K reads x as if padded with a zero column, as the TPU kernel pads.
//
// Bound: bytes at decode sizes. With M = 1..16 rows of x the product is
// a stream of the weight (K * N bytes for int8, half that for int4)
// against 2 * M operations per code. Design for M <= 16 (the skinny
// path): a warp reads 4 consecutive bytes per lane, 128 consecutive
// columns of one code row per load (for int4, 128 columns of two K
// rows), and issues the loads of 8 rows before it uses any; the 8 warps
// of a block take interleaved rows of the block's K slice, so a block
// owns a 128-column strip of one K slice and every byte of the weight is
// read once by one thread. x's slice is staged in
// shared memory as float32 and read by broadcast. N = 4096 gives only 32
// strips for 132 SMs, so the host splits K across blocks until about two
// blocks per SM are in flight; the warps of a block add their sums in
// shared memory in a fixed order, and the K splits are added by a second
// pass in a fixed order (no atomics: the result does not change from run
// to run). Any N and K: a column tail past N, or rows whose start is not
// 4-byte aligned, take scalar loads. Past the skinny path, bf16 x on
// aligned shapes takes the tensor cores (quant_matmul_tc.cu); float32 x
// (which TF32 would round) and unaligned shapes take the tiled path
// here: 64 x 64 output tiles, x and the dequantized codes staged in
// shared memory as float32, float32 FMAs on the CUDA cores. The wrapper
// picks the path (ops/hopper/quant_matmul.py: path()).
//
// fp8 codes (K10f8) move the bytes of int8 ones, so their bound is K10's.
// They are decoded in registers: the 4 bytes of a lane's load go two at
// a time through sm_89's e4m3x2 / e5m2x2 -> f16x2 conversion (one cvt
// per pair), then to float32, exactly (every e4m3 and e5m2 value is a
// half); the tiled path converts its staged bytes one at a time.

#include "common.cuh"
#include "quant_matmul.cuh"

namespace {

constexpr int kSkinnyThreads = 256;     // 8 warps
constexpr int kWarps = kSkinnyThreads / 32;
constexpr int kCols = 4;                // columns per lane
constexpr int kStrip = 32 * kCols;      // columns per block
constexpr int kStage = 256;             // K rows of x staged at a time
constexpr int kUnroll = 8;              // code rows a warp loads at once

// one code of an int8 or fp8 weight as float
template <int C>
__device__ __forceinline__ float code_f32(int8_t b) {
  if constexpr (C == kInt8) {
    return static_cast<float>(b);
  } else {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(b), fp8_kind<C>())));
  }
}

// the two codes of a byte: row 2r (low nibble), row 2r + 1 (high nibble)
__device__ __forceinline__ float lo4(int8_t b) {
  return static_cast<float>(static_cast<int8_t>(b << 4) >> 4);
}
__device__ __forceinline__ float hi4(int8_t b) {
  return static_cast<float>(b >> 4);
}

// x (m, k), codes (rows, n) with rows = k (int8, fp8) or ceil(k / 2)
// (int4).
// Grid: (column strips, K splits); each split owns code rows
// [split * rows_per_split, ...). One split writes out; several write
// float32 partial sums part[split][m][n] for the combine pass.
template <typename T, int C, int MT>
__global__ void __launch_bounds__(kSkinnyThreads) qmm_skinny_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out,
    float* __restrict__ part, int m, int k, int n, int rows,
    int rows_per_split) {
  constexpr int KPR = C == kInt4 ? 2 : 1;  // K rows per code row
  constexpr int kStageRows = kStage / KPR;
  __shared__ float xs[MT][kStage];
  __shared__ float red[MT][kStrip];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kStrip, split = blockIdx.y;
  const int col = n0 + lane * kCols;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  // 4-byte loads need every code row to start 4-byte aligned
  const bool vec = n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 3u) == 0 &&
                   col + kCols <= n;

  float acc[MT][kCols];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int s0 = r_begin; s0 < r_end; s0 += kStageRows) {
    const int s1 = min(r_end, s0 + kStageRows);
    const int k0 = s0 * KPR, span = (s1 - s0) * KPR;
    __syncthreads();  // the previous stage's reads are done
    for (int i = threadIdx.x; i < MT * span; i += kSkinnyThreads) {
      const int mm = i / span, kk = i % span;
      const int gk = k0 + kk;
      xs[mm][kk] = (mm < m && gk < k)
                       ? pt::to_f32(x[static_cast<int64_t>(mm) * k + gk])
                       : 0.f;
    }
    __syncthreads();
    if (col < n) {
      // kUnroll code rows per warp in flight before any is used
      for (int r0 = s0 + warp; r0 < s1; r0 += kWarps * kUnroll) {
        uint32_t word[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = r0 + u * kWarps;
          const int8_t* src = w + static_cast<int64_t>(r) * n + col;
          word[u] = 0;
          if (r < s1) {
            if (vec) {
              word[u] = *reinterpret_cast<const uint32_t*>(src);
            } else {
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                if (col + c < n)
                  word[u] |= static_cast<uint32_t>(static_cast<uint8_t>(
                                 src[c])) << (8 * c);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = r0 + u * kWarps;
          if (r >= s1) break;
          const int kk = (r - s0) * KPR;
          if constexpr (C == kE4M3 || C == kE5M2) {
            float f[kCols];
            fp8x4<C>(word[u], f);
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[i][c] += xs[i][kk] * f[c];
          } else {
#pragma unroll
            for (int i = 0; i < MT; ++i) {
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                const int8_t b = static_cast<int8_t>(word[u] >> (8 * c));
                if (C == kInt4)
                  acc[i][c] += xs[i][kk] * lo4(b) + xs[i][kk + 1] * hi4(b);
                else
                  acc[i][c] += xs[i][kk] * static_cast<float>(b);
              }
            }
          }
        }
      }
    }
  }

  // the warps add their sums in a fixed order
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          red[i][lane * kCols + c] =
              (wi == 0 ? 0.f : red[i][lane * kCols + c]) + acc[i][c];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < MT * kStrip; i += kSkinnyThreads) {
    const int mm = i / kStrip, gn = n0 + i % kStrip;
    if (mm >= m || gn >= n) continue;
    const float v = red[mm][i % kStrip];
    if (gridDim.y == 1)
      out[static_cast<int64_t>(mm) * n + gn] = pt::from_f32<T>(v * scale[gn]);
    else
      part[(static_cast<int64_t>(split) * m + mm) * n + gn] = v;
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 32;  // tiled path: tile and K step

// 256 threads, each a 4 x 4 grid of outputs (rows ty + 16 i, columns
// tx + 16 j) of a 64 x 64 tile; x staged transposed so both operands are
// read without bank conflicts.
template <typename T, int C>
__global__ void __launch_bounds__(256) qmm_tiled_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int m, int k,
    int n) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += 256) {
      const int mm = i / kBK, kk = i % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < m && gk < k)
                       ? pt::to_f32(x[static_cast<int64_t>(gm) * k + gk])
                       : 0.f;
    }
    if constexpr (C == kInt4) {
      // kBK / 2 code rows, each two K rows; k0 is even
      const int rows = (k + 1) / 2;
      for (int i = threadIdx.x; i < (kBK / 2) * kBN; i += 256) {
        const int rr = i / kBN, nn = i % kBN;
        const int gr = k0 / 2 + rr, gn = n0 + nn;
        const int8_t b =
            (gr < rows && gn < n) ? w[static_cast<int64_t>(gr) * n + gn] : 0;
        ws[2 * rr][nn] = lo4(b);
        ws[2 * rr + 1][nn] = hi4(b);
      }
    } else {
      for (int i = threadIdx.x; i < kBK * kBN; i += 256) {
        const int kk = i / kBN, nn = i % kBN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk][nn] = (gk < k && gn < n)
                         ? code_f32<C>(w[static_cast<int64_t>(gk) * n + gn])
                         : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n)
        out[static_cast<int64_t>(gm) * n + gn] =
            pt::from_f32<T>(acc[i][j] * scale[gn]);
    }
  }
}

struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* part;
  int m, k, n, rows, nsplit, rows_per_split;
};

template <typename T, int C, int MT>
cudaError_t skinny(const Args& a, cudaStream_t s) {
  const dim3 grid((a.n + kStrip - 1) / kStrip, a.nsplit);
  qmm_skinny_kernel<T, C, MT><<<grid, kSkinnyThreads, 0, s>>>(
      static_cast<const T*>(a.x), a.w, a.scale, static_cast<T*>(a.out),
      a.part, a.m, a.k, a.n, a.rows, a.rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  return combine<T>(a.part, a.scale, a.out, a.m, a.n, a.nsplit, s);
}

template <typename T, int C>
cudaError_t run(const Args& a, bool skinny_path, cudaStream_t s) {
  if (skinny_path) {
    if (a.m <= 1) return skinny<T, C, 1>(a, s);
    if (a.m <= 2) return skinny<T, C, 2>(a, s);
    if (a.m <= 4) return skinny<T, C, 4>(a, s);
    if (a.m <= 8) return skinny<T, C, 8>(a, s);
    return skinny<T, C, 16>(a, s);
  }
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  qmm_tiled_kernel<T, C><<<grid, 256, 0, s>>>(
      static_cast<const T*>(a.x), a.w, a.scale, static_cast<T*>(a.out), a.m,
      a.k, a.n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_codes(const Args& a, int codes, bool skinny_path,
                     cudaStream_t s) {
  switch (codes) {
    case kInt4:
      return run<T, kInt4>(a, skinny_path, s);
    case kInt8:
      return run<T, kInt8>(a, skinny_path, s);
    case kE4M3:
      return run<T, kE4M3>(a, skinny_path, s);
    default:
      return run<T, kE5M2>(a, skinny_path, s);
  }
}

}  // namespace

// x, out: (m, k) and (m, n) of `dtype`, contiguous; w: codes of one byte,
// (k, n) for `codes` 8 (int8), 1 (fp8 e4m3) or 2 (fp8 e5m2), or
// (ceil(k / 2), n) for 4 (packed int4); scale: (n,) float32. `skinny`
// 1 takes the skinny path (m <= 16), which splits the code rows in
// nsplit slices of rows_per_split rows (a multiple of 8), with part a
// float32 scratch of (nsplit, m, n) when nsplit > 1; `skinny` 0 takes
// the tiled path and ignores both.
extern "C" int pt_quant_matmul(int device, const void* x, const void* w,
                               const void* scale, void* out, void* part,
                               int m, int k, int n, int codes, int skinny,
                               int nsplit, int rows_per_split, int dtype,
                               void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (m < 0 || k < 0 || n < 0 || !valid_codes(codes) ||
      (skinny && m > 16))
    return cudaErrorInvalidValue;
  const int rows = codes == kInt4 ? (k + 1) / 2 : k;
  if (skinny && (nsplit < 1 || rows_per_split < 1 ||
                 static_cast<int64_t>(nsplit) * rows_per_split < rows ||
                 (nsplit > 1 && part == nullptr)))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const Args a{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
               out, static_cast<float*>(part), m, k, n, rows,
               skinny ? nsplit : 1, rows_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return by_codes<float>(a, codes, skinny, s);
  if (dtype == pt::kBF16)
    return by_codes<__nv_bfloat16>(a, codes, skinny, s);
  return cudaErrorInvalidValue;
}
