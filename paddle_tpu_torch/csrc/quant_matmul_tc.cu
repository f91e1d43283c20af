// The tensor-core path of the weight-only quantized product for Hopper
// (sm_90a): bf16 x against int8 codes (K10), packed int4 codes (K11) or
// fp8 codes (K10f8: e4m3 or e5m2), one template on the code type, for
// the rows past the skinny path (a prompt's prefill).
//
// Replaces, with quant_matmul.cu, the TPU kernels paddle_tpu/ops/pallas/
// quant_matmul.py::quant_matmul (pallas_call at :139; its _kernel
// :85-110) and ::quant_matmul_int4 (:175):
//
//   out[m, n] = bf16((sum_k x[m, k] * code[k, n]) * scale[n])
//
// The reference sums float32(x) * float32(code). Every code is exact in
// bf16 (int8 in +-127, int4 in [-8, 7], e4m3 and e5m2 have 3 and 2
// mantissa bits and exponents inside bf16's range), and the product of
// two bf16 values is exact in float32, so a bf16 wgmma with float32
// accumulation computes the reference's function; only the order of the
// sums changes. The scale is not folded into the codes (bf16(code *
// scale) would round): it multiplies the float32 accumulator in the
// epilogue. float32 x stays on the CUDA cores (quant_matmul.cu): TF32
// would round x.
//
// Bound: operations at a prefill's M (2 * M * K * N against a weight
// read once: 2048 rows make ~2000 operations per code byte, far past the
// card's ~295 per byte). Design:
//
// - A block owns a 128 x 128 output tile and walks K in steps of 64.
//   Two consumer warpgroups, 64 rows of x each, issue four
//   wgmma.m64n128k16 (bf16 in, float32 accumulators in registers) per
//   step, both operands read from shared memory through descriptors.
// - Each step's x tile (128 x 64 bf16, K-major as x already is) and code
//   tile (64 x 128 bytes; for int4, 32 code rows) are staged by 16-byte
//   cp.async (.cg, zero-filled past M, K and N), 3 stages in flight. The
//   x tile lands in the 128-byte swizzle the descriptor reads (16-byte
//   chunk c of row r at chunk c ^ (r % 8) of a 1024-byte-aligned atom).
// - Dequantize in shared memory: the block converts the arrived code
//   tile to a bf16 B tile (128 n-rows x 64 k, 16 KB), written K-major in
//   the same swizzle, into a second, double-buffered buffer. Step s's
//   wgmmas run while the block converts step s + 1's codes. A thread
//   converts a 4-column x 8-k block: 8 4-byte reads (4 for int4) from
//   the code tile, whose chunks are swizzled by k-group so the warp's
//   reads hit 32 banks, and 4 16-byte writes whose 8-lane phases hit 8
//   chunks. int8 and int4 decode through a float magic number (the code
//   plus a bias in the low mantissa bits, then one subtraction); fp8 by
//   the e4m3x2 / e5m2x2 -> f16x2 conversion. A float holding a code has
//   its low 16 bits zero, so its bf16 is its high half, exactly.
// - Grid: tiles N-strip-major (all M tiles of one 128-column strip
//   consecutive), so a strip's codes are read from device memory about
//   once and reused from L2; x stays in L2. 105 KB of shared memory:
//   two blocks per SM. Where the tiles do not fill the card (a short
//   prompt: M = 64 at 4096 x 4096 is 32 tiles for 132 SMs) the host
//   splits K across blocks, as the skinny path does, and a second pass
//   adds the float32 partial sums in a fixed order.
//
// What bounds it: each step of a tile moves ~80 KB through shared memory
// (wgmma reads 32 KB, the convert reads 8 KB and writes 16 KB, the copies
// write 24 KB), ~0.36 us at ~128 B per clock per SM against ~0.28 us of
// tensor-core time, so this design tops out near 60-75% of the bf16
// peak; at M = 2048 on an H100 SXM (700 W) it runs at 37-44% of it,
// 1.8-2x torch.matmul on the bf16 weight. The next step (ROADMAP D9a)
// feeds the converted codes to wgmma as register A fragments (out^T =
// dequant(codes)^T x^T), dropping the bf16 tile's round trip through
// shared memory.
//
// The wrapper (ops/hopper/quant_matmul.py: path()) sends here bf16 x with
// M past the skinny path, K % 8 == 0, N % 16 == 0 and 16-byte-aligned x,
// codes and out; the C entry refuses anything else.

#include "common.cuh"
#include "quant_matmul.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;   // tile and K step
constexpr int kStages = 3;
constexpr int kThreads = 256;                   // two warpgroups
constexpr int kXBytes = kBM * kBK * 2;          // x tile, bf16
constexpr int kCodeBytes = kBK * kBN;           // code tile (int4: half)
constexpr int kStageBytes = kXBytes + kCodeBytes;
constexpr int kBBytes = kBN * kBK * 2;          // dequantized B tile
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kBBytes + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes (generic proxy, cp.async) made
// visible to wgmma's operand reads (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: start address, leading offset 16 B (unused by this layout),
// stride 1024 B between 8-row groups, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 128 per warpgroup, float32) += A (64 x 16) * B (16 x 128), both
// bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// two floats that hold codes (low 16 bits zero) as one bf16x2, a low
__device__ __forceinline__ uint32_t bf16x2_of(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// byte j of u (an unsigned byte, the code plus a bias) placed in the low
// mantissa of 2^23: the float 2^23 + byte
template <int J>
__device__ __forceinline__ float magic(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + J));
}

// word[i]: the 4 columns' codes of code row i of the thread's k-group
// (8 rows k..k+7; for int4, 4 rows of two k each). out[j][p]: column j's
// bf16 pair (k + 2p, k + 2p + 1).
template <int C>
__device__ __forceinline__ void dequant(const uint32_t* word,
                                        uint32_t (&out)[4][4]) {
  if constexpr (C == kInt8) {
    uint32_t u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = word[i] ^ 0x80808080u;  // code+128
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      out[0][p] = bf16x2_of(magic<0>(u[2 * p]) - 8388736.f,
                            magic<0>(u[2 * p + 1]) - 8388736.f);
      out[1][p] = bf16x2_of(magic<1>(u[2 * p]) - 8388736.f,
                            magic<1>(u[2 * p + 1]) - 8388736.f);
      out[2][p] = bf16x2_of(magic<2>(u[2 * p]) - 8388736.f,
                            magic<2>(u[2 * p + 1]) - 8388736.f);
      out[3][p] = bf16x2_of(magic<3>(u[2 * p]) - 8388736.f,
                            magic<3>(u[2 * p + 1]) - 8388736.f);
    }
  } else if constexpr (C == kInt4) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t u = word[p] ^ 0x88888888u;     // each nibble code+8
      const uint32_t lo = u & 0x0F0F0F0Fu;          // row k + 2p
      const uint32_t hi = (u >> 4) & 0x0F0F0F0Fu;   // row k + 2p + 1
      out[0][p] = bf16x2_of(magic<0>(lo) - 8388616.f,
                            magic<0>(hi) - 8388616.f);
      out[1][p] = bf16x2_of(magic<1>(lo) - 8388616.f,
                            magic<1>(hi) - 8388616.f);
      out[2][p] = bf16x2_of(magic<2>(lo) - 8388616.f,
                            magic<2>(hi) - 8388616.f);
      out[3][p] = bf16x2_of(magic<3>(lo) - 8388616.f,
                            magic<3>(hi) - 8388616.f);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float a[4], b[4];
      fp8x4<C>(word[2 * p], a);
      fp8x4<C>(word[2 * p + 1], b);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j][p] = bf16x2_of(a[j], b[j]);
    }
  }
}

// Grid: (output tiles, K splits). Split z owns the steps [z * per,
// (z + 1) * per); one split writes out, several write float32 partial
// sums part[z][m][n] for the combine pass.
template <int C>
__global__ void __launch_bounds__(kThreads, 2) qmm_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int m, int k, int n, int per) {
  constexpr int KPR = C == kInt4 ? 2 : 1;    // K rows per code row
  constexpr int kRows = kBK / KPR;           // code rows per step
  constexpr int kGroupRows = 8 / KPR;        // code rows per 8-k group
  extern __shared__ uint8_t smem_raw[];
  // stages (x tile, then code tile) from a 1024-byte-aligned base, then
  // the two B tiles
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t btiles = base + kStages * kStageBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mtiles = (m + kBM - 1) / kBM;
  const int m0 = (blockIdx.x % mtiles) * kBM;
  const int n0 = (blockIdx.x / mtiles) * kBN;
  const int first = blockIdx.y * per;       // this split's first step
  const int steps = min((k + kBK - 1) / kBK - first, per);
  const int rows = k / KPR;                  // code rows (k % 8 == 0)

  // the split's step t's x and code tiles into stage s; always one
  // commit group
  auto load = [&](int t, int s) {
    if (t < steps) {
      const uint32_t xs = base + s * kStageBytes;
      const int k0 = (first + t) * kBK;
#pragma unroll
      for (int i = 0; i < kBM * 8 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx >> 3, c = idx & 7;
        const int gm = m0 + r, gk = k0 + c * 8;
        const bool ok = gm < m && gk < k;
        cp_async16(xs + r * 128 + ((c ^ (r & 7)) << 4),
                   ok ? x + static_cast<int64_t>(gm) * k + gk : x, ok);
      }
      const uint32_t cs = xs + kXBytes;
      const int r0 = (first + t) * kRows;
#pragma unroll
      for (int i = 0; i < kRows * 8 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx >> 3, c = idx & 7;
        const int gr = r0 + r, gn = n0 + c * 16;
        const bool ok = gr < rows && gn < n;
        cp_async16(cs + r * 128 + ((c ^ ((r / kGroupRows) & 7)) << 4),
                   ok ? w + static_cast<int64_t>(gr) * n + gn : w, ok);
      }
    }
    cp_async_commit();
  };

  // the thread's convert block: k-group kg (k 8kg..8kg+7 of the step),
  // columns nq..nq+3 (a warp: all 8 k-groups of 16 columns)
  const int kg = lane & 7, nq = 16 * warp + 4 * (lane >> 3);
  auto convert = [&](int s, int b) {
    const uint8_t* cs = sbase + s * kStageBytes + kXBytes;
    uint8_t* bt = sbase + kStages * kStageBytes + b * kBBytes;
    uint32_t word[kGroupRows];
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      const int r = kg * kGroupRows + i;
      word[i] = *reinterpret_cast<const uint32_t*>(
          cs + r * 128 + (((nq >> 4) ^ kg) << 4) + (nq & 15));
    }
    uint32_t v[4][4];
    dequant<C>(word, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = nq + j;
      *reinterpret_cast<uint4*>(bt + nn * 128 + ((kg ^ (nn & 7)) << 4)) =
          make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int wg = warp >> 2;                  // rows 64 wg .. 64 wg + 63

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s, s);
  if (steps > 0) {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    convert(0, 0);
    fence_async_smem();
  }
  for (int t = 0; t < steps; ++t) {
    // B tile t written by every thread; step t - 1's wgmmas done, so
    // its stage and B tile are free
    __syncthreads();
    load(t + kStages - 1, (t + kStages - 1) % kStages);
    const uint32_t xa = base + (t % kStages) * kStageBytes + wg * 64 * 128;
    const uint32_t bb = btiles + (t & 1) * kBBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128k16(acc, desc_sw128(xa + 32 * kk),
                       desc_sw128(bb + 32 * kk));
    wgmma_commit();
    if (t + 1 < steps) {
      // step t + 1's tiles arrived (this thread's copies), then everyone's
      cp_async_wait<kStages - 2>();
      fence_async_smem();
      __syncthreads();
      convert((t + 1) % kStages, (t + 1) & 1);
      fence_async_smem();
    }
    wgmma_wait_all();
    fence_acc(acc);
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows r and r + 8, columns c, c + 1 of each
  // 8-column block j; scale on the accumulator, then one rounding to
  // bf16 (or the float32 partial sums, which the combine pass scales)
  const int r = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  float* const slab = part + static_cast<int64_t>(blockIdx.y) * m * n;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane & 3);
    if (c >= n) continue;                    // n % 16 == 0: c + 1 < n too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= m) continue;
      const int64_t at = static_cast<int64_t>(rr) * n + c;
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      if (gridDim.y == 1)
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(a0 * scale[c], a1 * scale[c + 1]);
      else
        *reinterpret_cast<float2*>(slab + at) = make_float2(a0, a1);
    }
  }
}

template <int C>
cudaError_t launch_tc(const void* x, const void* w, const float* scale,
                      void* out, float* part, int m, int k, int n,
                      int nsplit, int per, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      qmm_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  const int64_t tiles = static_cast<int64_t>((m + kBM - 1) / kBM) *
                        ((n + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), nsplit);
  qmm_tc_kernel<C><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      scale, static_cast<__nv_bfloat16*>(out), part, m, k, n, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  return combine<__nv_bfloat16>(part, scale, out, m, n, nsplit, s);
}

}  // namespace

// x: (m, k) of `dtype`, which must be bf16; w: codes of one byte, (k, n)
// for `codes` 8 (int8), 1 (fp8 e4m3) or 2 (fp8 e5m2), or (k / 2, n) for
// 4 (packed int4); scale: (n,) float32; out: (m, n) bf16; all
// contiguous. Takes k % 8 == 0, n % 16 == 0 and x, w, out 16-byte
// aligned; refuses anything else. The K steps of 64 are split in nsplit
// slices of per steps (nsplit * per covers them, every slice holds one),
// with part a float32 scratch of (nsplit, m, n) when nsplit > 1.
extern "C" int pt_quant_matmul_tc(int device, const void* x, const void* w,
                                  const void* scale, void* out, void* part,
                                  int m, int k, int n, int codes, int nsplit,
                                  int per, int dtype, void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  const int steps = (k + kBK - 1) / kBK;
  if (dtype != pt::kBF16 || m < 0 || k < 0 || n < 0 || k % 8 || n % 16 ||
      !valid_codes(codes) || !pt::aligned16(x) || !pt::aligned16(w) ||
      !pt::aligned16(out) || nsplit < 1 || nsplit > 65535 || per < 1 ||
      static_cast<int64_t>(nsplit) * per < steps ||
      (nsplit > 1 && ((nsplit - 1) * per >= steps || part == nullptr)))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const float* sc = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (codes) {
    case kInt4:
      return launch_tc<kInt4>(x, w, sc, out, pp, m, k, n, nsplit, per, s);
    case kInt8:
      return launch_tc<kInt8>(x, w, sc, out, pp, m, k, n, nsplit, per, s);
    case kE4M3:
      return launch_tc<kE4M3>(x, w, sc, out, pp, m, k, n, nsplit, per, s);
    default:
      return launch_tc<kE5M2>(x, w, sc, out, pp, m, k, n, nsplit, per, s);
  }
}
