// The tensor-core route of the grouped expert product (X1) for Hopper
// (sm_90a): bf16 rows past the skinny path (R > E), which is a prompt's
// prefill, a speculative verify, and Mixtral's batch-8 decode (2 rows an
// expert).
//
// Replaces, with moe_grouped_matmul.cu, XLA's lax.ragged_dot at
// paddle_tpu/distributed/moe.py:104-106 (not a Pallas kernel):
//
//   y[r, n] = sum_k x[r, k] * w[e, k, n]  for offsets[e] <= r < offsets[e+1]
//
// x (R, K) bf16 sorted by expert, w (E, K, N) bf16, offsets (E + 1) int32
// on the device (0 .. R, nondecreasing); float32 sums in registers, one
// rounding to bf16 on the store; y (R, N) bf16. The wrapper
// (ops/hopper/moe_grouped_matmul.py: path()) sends here bf16 past the
// skinny bound with K % 8 == 0, N % 8 == 0 and 16-byte-aligned x and w;
// the C entry refuses anything else.
//
// With trans_w the same kernel computes the backward's dx = dy w[e]^T
// (the VJP of ragged_dot in x, which XLA supplies to the JAX package):
// w lies as the forward's weight, (E, N, K) in this kernel's names, and
// its tile is staged K-major as x's is (below), so no transposed copy of
// the expert weights is made (370 MB a weight a layer at MoEConfig()'s
// widths). The wrapper picks dx's route by the forward's rule.
//
// What bounds it. A 512-token prefill at top 6 over 64 experts puts ~48
// rows on each expert (R = 3072); Mixtral's top 2 over 8 puts ~128 (R =
// 1024). There 2 R K N operations take 0.3-0.4x of the time the experts'
// K x N weight slabs take to read once (0.1165 / 0.2917 ms at 3.35 TB/s),
// so the bound is the weight bytes. At batch 8 (R = 24576 / 8192) the
// operations come level with the bytes (64 experts: 0.143 ms of bf16
// peak against 0.161) or take over (Mixtral: 0.97 against 0.29). So the
// design
//
// - reads each expert's slab from device memory once: a block owns one
//   (expert, 128-row tile) pair and a 256-column strip, and the grid runs
//   N-strip-major (blockIdx.x over the tile slots, blockIdx.y over the
//   strips), so the tiles of an expert with more than 128 rows run side
//   by side and share the strip through L2;
// - keeps bytes in flight: 48 KB a K step (x 128 x 64, w 64 x 256),
//   staged by 16-byte cp.async in a ring of 4 stages (193 KB: one block
//   an SM), loads two steps ahead of the wgmmas, whose last group stays
//   in flight while the next step is issued;
// - wastes little of a tile on other experts' rows: a tile never
//   straddles two experts and is found by the device-side scan
//   (find_pair, moe_grouped_matmul.cuh) with 128 as the tile's rows; rows
//   past the expert's end are zero-filled on load (no device-memory
//   traffic) and skipped on store. Each warpgroup owns 64 of the tile's
//   rows (one m64) and all 256 columns (wgmma m64n256k16), and a
//   warpgroup with no rows issues no products, so the products waste at
//   most one m64's tail: a 48-row expert issues a quarter of one
//   warpgroup's products on zero rows, and its second warpgroup idles;
// - at batch 8 the two warpgroups share each staged w tile, which halves
//   the shared-memory writes a product needs against a 64-row tile with
//   the strip split across the warpgroups (a layout this route had first
//   and dropped: slower at batch 8 and Mixtral's batch 1, no faster at
//   the 64 experts' batch 1, on the card).
//
// Operands. x is K-major as it lies: a 128 x 64 tile is 128 rows of 128
// bytes in the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)),
// read through desc_sw128 from the warpgroup's first row. w[e] (K, N) is
// N-contiguous, so B is read MN-major with wgmma's transpose bit: the
// 64 x 256 tile lies as four 64-column d-blocks of 64 K rows x 128 bytes
// in the same swizzle (the image flash_attention_tc.cu stages V in), read
// through desc_sw128_mn with the d-block stride as the leading offset.
// With trans_w, w[e] is (N, K): the strip's 256 rows of 64 K columns lie
// as x's tile does (32 KB, K-major, 128-byte swizzle), read through
// desc_sw128 with the transpose bit clear.
//
// Order: each output is one warpgroup's float32 sum over K in a fixed
// order (no split-K, no atomics), so the result is bitwise repeatable.
// The grid comes from R, E and N only (ceil(R / 128) + min(E, R) tile
// slots, an upper bound on the pairs, times ceil(N / 256) strips), and
// nothing is read on the host: one launch a product, which a CUDA graph
// captures and replays after the routing changes.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3, PERF.md
// section 6): 64 experts, b1 prefill (3072, 2048 -> 1408) 0.1572 ms and
// (3072, 1408 -> 2048) 0.1577, against torch._grouped_mm 0.1572 /
// 0.1609, the CUDA-core tiles 1.1831 / 1.1685 and the byte bound 0.1165;
// Mixtral-8x7B (1024, 4096 -> 14336) 0.4112 and (1024, 14336 -> 4096)
// 0.4453, against 0.4982 / 0.4475, 7.1047 / 7.5495 and 0.2917; at b8
// (24576 / 8192 rows) 0.42-0.43 and 1.97-2.00 ms, 1.39-1.46x
// torch._grouped_mm and 2.0-2.7x the bound. What holds them there is
// not measured (no profiler of stalls on that machine); ROADMAP D18
// names the suspects: every thread's cp.async issue and the block's
// barrier on each K step, where a TMA producer warp would do neither.

#include "common.cuh"
#include "moe_grouped_matmul.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                     // tile rows: 64 a warpgroup
constexpr int kBN = 256;                     // strip columns
constexpr int kBK = 64;                      // K step: a 128-byte x row
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;          // steps loaded ahead
constexpr int kThreads = 256;                // two warpgroups
constexpr int kXBytes = kBM * kBK * 2;       // x tile
constexpr int kDBlock = kBK * 128;           // 64 columns of the w tile
constexpr int kWBytes = (kBN / 64) * kDBlock;
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment

template <bool kTransW>
__global__ void __launch_bounds__(kThreads, 1)
    moe_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int* __restrict__ offsets, bf16* __restrict__ y,
                  int K, int N, int E) {
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ Pair s_pair;
  extern __shared__ uint8_t smem_raw[];
  if (!find_pair(offsets, E, kBM, blockIdx.x, s_off, &s_pair)) return;
  const int r0 = s_pair.r0, rows = s_pair.r1 - s_pair.r0;
  const bf16* __restrict__ we = w + static_cast<int64_t>(s_pair.e) * K * N;
  const int n0 = blockIdx.y * kBN;
  // the stages from a 1024-byte-aligned base (the swizzle's atoms)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup's first row, and whether it has rows: warp-uniform as
  // the compiler sees them (a branch around wgmma on a value it cannot
  // prove uniform serializes the wgmmas)
  const int m0 = 64 * __shfl_sync(0xffffffffu, warp >> 2, 0);
  const bool live = __shfl_sync(0xffffffffu, static_cast<int>(m0 < rows),
                                0);
  const int steps = (K + kBK - 1) / kBK;

  // step t's x and w tiles into stage s; always one commit group
  auto load = [&](int t, int s) {
    if (t < steps) {
      const uint32_t xs = base + s * kStageBytes;
      const int k0 = t * kBK;
#pragma unroll
      for (int i = 0; i < kBM * 8 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx >> 3, c = idx & 7;
        const int gk = k0 + 8 * c;
        const bool ok = r < rows && gk < K;
        cp_async16(xs + r * 128 + ((c ^ (r & 7)) << 4),
                   ok ? x + static_cast<int64_t>(r0 + r) * K + gk : x, ok);
      }
      const uint32_t ws = xs + kXBytes;
      if constexpr (kTransW) {
        // w[e] is (N, K): the strip's 256 rows of 64 K columns, K-major
        // as the x tile lies (row n's chunk c at c ^ (n % 8)); 8 threads
        // take a row's 128 bytes
#pragma unroll
        for (int i = 0; i < kBN * 8 / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int n = idx >> 3, c = idx & 7;
          const int gn = n0 + n, gk = k0 + 8 * c;
          const bool ok = gn < N && gk < K;
          cp_async16(ws + n * 128 + ((c ^ (n & 7)) << 4),
                     ok ? we + static_cast<int64_t>(gn) * K + gk : w, ok);
        }
      } else {
        // a warp takes one K row's 32 chunks: 512 consecutive bytes
#pragma unroll
        for (int i = 0; i < kBK * (kBN / 8) / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int kr = idx >> 5, c = idx & 31;
          const int gk = k0 + kr, gn = n0 + 8 * c;
          const bool ok = gk < K && gn < N;
          cp_async16(ws + (c >> 3) * kDBlock + kr * 128 +
                         (((c & 7) ^ (kr & 7)) << 4),
                     ok ? we + static_cast<int64_t>(gk) * N + gn : w, ok);
        }
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
      const uint32_t xa = xs + m0 * 128, wb = xs + kXBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if constexpr (kTransW)
          wgmma_ss_m64n256k16<0, 0>(acc, desc_sw128(xa + 32 * kk),
                                    desc_sw128(wb + 32 * kk));
        else
          wgmma_ss_m64n256k16<0, 1>(
              acc, desc_sw128(xa + 32 * kk),
              desc_sw128_mn(wb + kk * 16 * 128, kDBlock));
      }
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

  // epilogue: the thread holds rows r and r + 8 of the warpgroup's 64,
  // columns c and c + 1 of each 8-column block j; rows past the expert's
  // end and columns past N are not stored (N % 8 == 0: c < N means
  // c + 1 < N)
  const int r = m0 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane & 3);
    if (c >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= rows) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          y + static_cast<int64_t>(r0 + rr) * N + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <bool kTransW>
cudaError_t launch_tc(int device, const void* x, const void* w,
                      const void* offsets, void* y, int R, int K, int N,
                      int E, cudaStream_t stream) {
  // the dynamic shared memory past 48 KB is allowed once per device
  static unsigned long long opted = 0;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(opted & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_tc_kernel<kTransW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    opted |= bit;
  }
  const dim3 grid((R + kBM - 1) / kBM + min(E, R), (N + kBN - 1) / kBN);
  moe_tc_kernel<kTransW><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(offsets), static_cast<bf16*>(y), K, N, E);
  return cudaGetLastError();
}

}  // namespace

// x (R, K), w (E, K, N) or, with trans_w, (E, N, K) (y = x w[e]^T: the
// backward's dx over the forward's weight as it lies), offsets (E + 1)
// int32, y (R, N), contiguous; dtype must be bf16, K and N multiples of
// 8, x, w and y 16-byte aligned; refuses anything else. R = 0 or N = 0
// launches nothing.
extern "C" int pt_moe_grouped_matmul_tc(int device, const void* x,
                                        const void* w, const void* offsets,
                                        void* y, int R, int K, int N, int E,
                                        int trans_w, int dtype,
                                        void* stream) {
  cudaError_t err = pt::set_device(device);
  if (err != cudaSuccess) return err;
  if (dtype != pt::kBF16 || R < 0 || K < 0 || N < 0 || K % 8 || N % 8 ||
      E < 1 || E > kMaxExperts || !pt::aligned16(x) || !pt::aligned16(w) ||
      !pt::aligned16(y))
    return cudaErrorInvalidValue;
  if (R == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans_w ? launch_tc<true>(device, x, w, offsets, y, R, K, N, E, s)
                 : launch_tc<false>(device, x, w, offsets, y, R, K, N, E, s);
}
