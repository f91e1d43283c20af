// The grouped expert product's weight gradient (X1's dW) for Hopper
// (sm_90a): the backward of the dropless MoE layer's expert GEMMs in the
// weights.
//
// Replaces the VJP of XLA's lax.ragged_dot in its weight (XLA supplies it
// to the JAX package at paddle_tpu/distributed/moe.py:104-106; no Pallas
// kernel):
//
//   dw[e, k, n] = sum_{offsets[e] <= r < offsets[e+1]} x[r, k] * dy[r, n]
//
// x (R, K) sorted by expert and dy (R, N), both bf16 or both float32;
// offsets (E + 1) int32 on the device, nondecreasing from 0 to R; float32
// sums; dw (E, K, N) in x's dtype. An expert with no rows gets a zero
// gradient, as jax.vjp of ragged_dot gives. Nothing is read on the host:
// the grid comes from E, K and N, and a block reads its expert's row range
// from the offsets itself, so a product is one launch whatever the
// routing.
//
// What bounds it. The reduction runs over each expert's rows, so unlike
// the forward the work of a block depends on the routing: a block per
// (expert, K tile, N tile) walks its expert's rows. At MoEConfig()'s
// training step (4 x 2048 tokens, top 6 of 64 experts: R = 49152, 2048 <->
// 1408) the 2 R K N operations (0.29 ms at an H100 SXM's 989 TFLOP/s
// bf16 peak, 700 W) come level with the bytes of x, dy and dw (0.20 ms at
// its 3.35 TB/s); at Mixtral-8x7B's widths (8 experts, 4096 <-> 14336)
// the operations take over. So bf16 runs on the tensor cores and the
// design keeps the operands streaming:
//
// - the tensor-core path (bf16, K and N multiples of 8, 16-byte-aligned
//   pointers) gives a block a 128 x 256 tile of dw[e]: two warpgroups of
//   64 K rows (wgmma's M) over a 256-column strip of N; each step stages
//   64 of the expert's rows of x (64 x 128, two 64-column d-blocks) and
//   of dy (64 x 256, four d-blocks) by 16-byte cp.async in the 128-byte
//   swizzle, in a ring of 4 stages loaded two steps ahead, as the
//   forward's tensor-core route does (moe_grouped_matmul_tc.cu). Both
//   operands lie row-major, so both are read MN-major, with wgmma's
//   transpose bits set: A = x^T's 64 x 16 slice is 16 rows of one
//   d-block, B = dy's 16 x 256 slice 16 rows of four. Rows past the
//   expert's end are zero-filled on load, so they add nothing;
// - the CUDA-core path (float32, which TF32 would round, and bf16 shapes
//   the tensor cores do not take) computes 64 x 64 tiles of dw[e] over
//   16-row steps of the expert's rows, x and dy staged in shared memory
//   as float32, 4 x 4 outputs a thread.
//
// Order: each output is one thread's (or one warpgroup's) float32 sum
// over the rows in a fixed order (no split, no atomics), so the result is
// bitwise repeatable. The block grid runs the K tiles of one expert side
// by side, so they share its dy strip through L2. A row split with a
// fixed-order combine would spread one expert's rows over more blocks; at
// the shapes above the (expert, K tile, N tile) blocks already fill the
// 132 SMs many times over.

#include "common.cuh"
#include "moe_grouped_matmul.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// -- the CUDA-core path ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileK = 64, kTileN = 64, kTileR = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_dw_tiled_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const int* __restrict__ offsets, T* __restrict__ dw,
                        int K, int N, int k_tiles) {
  __shared__ float xs[kTileR][kTileK + 4];    // rows x K columns
  __shared__ float ds[kTileR][kTileN + 4];    // rows x N columns
  const int e = blockIdx.x / k_tiles;
  const int kb = (blockIdx.x % k_tiles) * kTileK, nb = blockIdx.y * kTileN;
  const int a = offsets[e], b = offsets[e + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // loads: row tid / 16 of the step, 4 consecutive columns from
  // (tid % 16) * 4, of x and of dy
  const int lr = tid / 16, lc = (tid % 16) * 4;
  float xr[4], dr[4];
  auto load = [&](int r0) {
    const int r = r0 + lr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kb + lc + i, n = nb + lc + i;
      xr[i] = (r < b && k < K)
                  ? pt::to_f32(x[static_cast<size_t>(r) * K + k]) : 0.f;
      dr[i] = (r < b && n < N)
                  ? pt::to_f32(dy[static_cast<size_t>(r) * N + n]) : 0.f;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (a < b) load(a);
  for (int r0 = a; r0 < b; r0 += kTileR) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xs[lr][lc + i] = xr[i];
      ds[lr][lc + i] = dr[i];
    }
    __syncthreads();
    if (r0 + kTileR < b) load(r0 + kTileR);
#pragma unroll
    for (int rr = 0; rr < kTileR; ++rr) {
      float p[4], q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = xs[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = ds[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], q[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* __restrict__ out = dw + static_cast<size_t>(e) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = kb + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + tx + 16 * j;
      if (k < K && n < N)
        out[static_cast<size_t>(k) * N + n] = pt::from_f32<T>(acc[i][j]);
    }
  }
}

// -- the tensor-core path --------------------------------------------------

constexpr int kBM = 128;                     // dw rows (K): 64 a warpgroup
constexpr int kBN = 256;                     // dw columns (N)
constexpr int kBR = 64;                      // expert rows a step
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;          // steps loaded ahead
constexpr int kDBlock = kBR * 128;           // 64 columns of a staged tile
constexpr int kXBytes = (kBM / 64) * kDBlock;
constexpr int kDyBytes = (kBN / 64) * kDBlock;
constexpr int kStageBytes = kXBytes + kDyBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment

__global__ void __launch_bounds__(kThreads, 1)
    moe_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const int* __restrict__ offsets, bf16* __restrict__ dw,
                     int K, int N, int k_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kBM, n0 = blockIdx.y * kBN;
  const int a = offsets[e], b = offsets[e + 1];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup's first dw row and whether it has any, warp-uniform as
  // the compiler sees them (a branch around wgmma on a value it cannot
  // prove uniform serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int m0 = 64 * wg;
  const bool live = __shfl_sync(0xffffffffu, static_cast<int>(k0 + m0 < K),
                                0);
  const int steps = (b - a + kBR - 1) / kBR;

  // step t's rows of x (128 K columns) and dy (256 N columns) into stage
  // s, each row's 16-byte chunk c at chunk c ^ (row % 8) of its d-block;
  // always one commit group
  auto load = [&](int t, int s) {
    if (t < steps) {
      const uint32_t xs = base + s * kStageBytes;
      const int r0 = a + t * kBR;
#pragma unroll
      for (int i = 0; i < kBR * (kBM / 8) / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int rr = idx >> 4, c = idx & 15;
        const int gr = r0 + rr, gk = k0 + 8 * c;
        const bool ok = gr < b && gk < K;
        cp_async16(xs + (c >> 3) * kDBlock + rr * 128 +
                       (((c & 7) ^ (rr & 7)) << 4),
                   ok ? x + static_cast<int64_t>(gr) * K + gk : x, ok);
      }
      const uint32_t ds = xs + kXBytes;
#pragma unroll
      for (int i = 0; i < kBR * (kBN / 8) / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int rr = idx >> 5, c = idx & 31;
        const int gr = r0 + rr, gn = n0 + 8 * c;
        const bool ok = gr < b && gn < N;
        cp_async16(ds + (c >> 3) * kDBlock + rr * 128 +
                       (((c & 7) ^ (rr & 7)) << 4),
                   ok ? dy + static_cast<int64_t>(gr) * N + gn : dy, ok);
      }
    }
    cp_async_commit();
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) load(s, s);
  for (int t = 0; t < steps; ++t) {
    // step t's tiles: this thread's copies, then everyone's; every
    // warpgroup is past its wait for step t - 2's products, so that
    // step's stage is free for step t + kAhead
    cp_async_wait<kAhead - 1>();
    fence_async_smem();
    __syncthreads();
    load(t + kAhead, (t + kAhead) % kStages);
    if (live) {
      const uint32_t xs = base + (t % kStages) * kStageBytes;
      const uint32_t xa = xs + wg * kDBlock, db = xs + kXBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBR / 16; ++kk)
        wgmma_ss_m64n256k16<1, 1>(
            acc, desc_sw128_mn(xa + kk * 16 * 128, kDBlock),
            desc_sw128_mn(db + kk * 16 * 128, kDBlock));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
    }
  }
  if (live) {
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  if (!live) return;

  // epilogue: the thread holds dw rows m and m + 8 of the warpgroup's 64,
  // columns c and c + 1 of each 8-column block j (N % 8 == 0: c < N means
  // c + 1 < N); an expert with no rows stores zeros
  bf16* __restrict__ out = dw + static_cast<int64_t>(e) * K * N;
  const int m = k0 + m0 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane & 3);
    if (c >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = m + 8 * h;
      if (k >= K) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(k) * N +
                                         c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <typename T>
cudaError_t launch_tiled(const void* x, const void* dy, const void* offsets,
                         void* dw, int K, int N, int E, cudaStream_t stream) {
  const int k_tiles = (K + kTileK - 1) / kTileK;
  const dim3 grid(E * k_tiles, (N + kTileN - 1) / kTileN);
  moe_dw_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const int*>(offsets), static_cast<T*>(dw), K, N, k_tiles);
  return cudaGetLastError();
}

cudaError_t launch_tc(int device, const void* x, const void* dy,
                      const void* offsets, void* dw, int K, int N, int E,
                      cudaStream_t stream) {
  // the dynamic shared memory past 48 KB is allowed once per device
  static unsigned long long opted = 0;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(opted & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    opted |= bit;
  }
  const int k_tiles = (K + kBM - 1) / kBM;
  const dim3 grid(E * k_tiles, (N + kBN - 1) / kBN);
  moe_dw_tc_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const int*>(offsets), static_cast<bf16*>(dw), K, N,
      k_tiles);
  return cudaGetLastError();
}

}  // namespace

// x (R, K), dy (R, N), offsets (E + 1) int32, dw (E, K, N), contiguous;
// dtype a pt::DType of x and dy; tc 1 for the tensor-core path (bf16, K
// and N multiples of 8, x, dy and dw 16-byte aligned; refused otherwise),
// 0 for the CUDA-core tiles. Every expert's dw is written, zero where it
// has no rows, so R = 0 launches too; K = 0 or N = 0 launches nothing.
extern "C" int pt_moe_grouped_matmul_dw(int device, const void* x,
                                        const void* dy, const void* offsets,
                                        void* dw, int R, int K, int N, int E,
                                        int tc, int dtype, void* stream) {
  cudaError_t err = pt::set_device(device);
  if (err != cudaSuccess) return err;
  if (R < 0 || K < 0 || N < 0 || E < 1 || E > kMaxExperts)
    return cudaErrorInvalidValue;
  if (K == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != pt::kBF16 || K % 8 || N % 8 || !pt::aligned16(x) ||
        !pt::aligned16(dy) || !pt::aligned16(dw))
      return cudaErrorInvalidValue;
    return launch_tc(device, x, dy, offsets, dw, K, N, E, s);
  }
  if (dtype == pt::kBF16)
    return launch_tiled<__nv_bfloat16>(x, dy, offsets, dw, K, N, E, s);
  if (dtype == pt::kF32)
    return launch_tiled<float>(x, dy, offsets, dw, K, N, E, s);
  return cudaErrorInvalidValue;
}
