// Flash attention forward and backward on Hopper's tensor cores (sm_90a),
// bf16 inputs, head sizes that are multiples of 8 up to 128, in every
// mode: causal or not, a sliding window, segment ids.
//
// Replaces, for those inputs, the TPU kernels paddle_tpu/ops/pallas/
// flash_attention.py::_fwd (:121, pallas_call at :152; the forward, K5,
// with its window and segment modes K5w and K5s) and ::_bwd (:323; the dq
// pallas_call at :354 and the dk/dv one at :380; K6, K6w, K6s). float32,
// and bf16 past D = 128, stay on the CUDA-core kernels of
// flash_attention.cu; the wrapper's route rule (ops/hopper/
// flash_attention.py: path()) decides by dtype and D alone, and the C
// entries below refuse anything else. Layouts, masks and outputs are
// flash_attention.cu's: q (B, H, Sq, D), k and v (B, Hkv, Sk, D) with any
// (batch, head, sequence) strides and D contiguous, bottom-right causal
// masking, lse float32 (B, H, Sq), a query that sees no key returns 0.
//
// Bound: operations. At Llama shapes (S = 2048, D = 128, causal) the
// forward does 4*D operations per visible (query, key) pair and the
// backward 10*D (s again, dp, dv, dq, dk) against a few bytes per row:
// hundreds of operations per byte, far past the ~295 per byte at which
// the card's 989 TFLOP/s of bf16 tensor cores, not its 3.35 TB/s, are the
// limit.
//
// Design:
// - Every product is a wgmma (m64nNk16, bf16 in, float32 accumulators in
//   registers) by a warpgroup of 64 rows; a block is two consumer
//   warpgroups (256 threads) that share the tiles it stages.
// - Tiles are staged by 16-byte cp.async (zero-filled past the rows and
//   past D) into the 128-byte swizzle of wgmma.cuh, three stages: the
//   next two tiles load while the block computes on the current one,
//   with one __syncthreads per tile. The same shared-memory image of a
//   K, V, Q or dO tile serves as a K-major operand (S = Q K^T, dP =
//   dO V^T; its rows D-contiguous, as quant_matmul_tc.cu's x tiles) and
//   as an MN-major B operand through the descriptor's transpose (O +=
//   P V, dQ += dS K, dV += P^T dO, dK += dS^T Q), so no tile is copied
//   or transposed.
// - The masks and the online softmax (exp2 with the scale folded into
//   one FMA) work on the float32 accumulator fragments, whose row and
//   column follow from the wgmma accumulator layout (wgmma.cuh). P (and
//   in the backward dS) go from the accumulator straight into bf16
//   register-A fragments for the next product: a 16-column slice of the
//   accumulator is the A fragment of an m64k16 product once packed into
//   bf16x2. A masked pair gets p = 0; the per-element mask runs only on
//   the tiles the diagonal, the window's edge, the sequence end or
//   segment ids cut, the others skip it.
// - Work outside the mask is skipped by whole tiles, as in
//   flash_attention.cu (key_tiles / query_tiles; with segment ids, a tile
//   whose range of ids misses the block's is never loaded), per block
//   and per warpgroup.
// - Forward: one block per (128-query tile, head, batch), the longest
//   causal rows first; 64-key tiles. Backward: the dq pass (128 queries a
//   block, 64-key tiles; it also writes delta = sum_d(dout * out)) and
//   then the dk/dv pass (128 keys a block, 64-query tiles), two kernels
//   and no float atomics, so dq, dk and dv are the same bits on every
//   run. Under GQA a dk/dv block may own a slice of its kv head's query
//   heads instead of the whole group, so that the grid fills the card
//   (the host picks the slices): each slice's float32 partial dk / dv
//   goes to a scratch slab, and the block that arrives last at its key
//   tile (an integer counter the dq pass zeroes) adds the slices in
//   slice order and writes dk and dv.
// - Head sizes: tiles are 64 or 128 wide; D = 40 runs on the 64-wide
//   tile (1.6x its products), 80 and 96 on the 128-wide one (1.6x and
//   1.33x); Llama's 64 and 128 fill theirs.
//
// Numerics: P (forward) and P and dS (backward) are rounded to bf16
// before their products, as every tensor-core attention does; the sums
// of every product, the softmax, lse and delta are float32.
//
// Measured on an H100 SXM (700 W; chip_smoke.py, PERF.md): at B = 1,
// H = 32, S = 2048, D = 128, causal, the forward takes 0.163 ms, 0.21 of
// the bf16 peak (its operations bound 0.035 ms; 1.9x SDPA's time) and the
// backward 0.578 ms, 0.15 of the peak counted on the five products of
// the bound (it issues seven: the dq pass recomputes S and dP; 2.1x
// SDPA's time). What holds it there (no profiler that reads the SMs
// works on that card, so this is the design's own account): each
// warpgroup issues its products and then waits for them before the
// softmax, so the tensor cores idle while the exponentials run (no
// ping-pong between the two warpgroups, no producer warp: every thread
// issues copies); the two warpgroups meet at a __syncthreads per tile;
// one block per SM at D = 128 (the backward's accumulators take most of
// the registers, and the dk/dv pass spills 460 bytes).

#include <climits>
#include <math.h>

#include "common.cuh"
#include "flash_attention.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kStages = 3;      // tiles in flight: two ahead of the one in use
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// wgmma shapes by accumulator size: the score products (N = 64 rows of
// the other operand, both K-major) and the products into a D-wide
// accumulator (N = 64 or 128, B MN-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  wgmma_ss_m64n64k16(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  wgmma_rs_m64n64k16_tb(d, a, b);
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  wgmma_rs_m64n128k16_tb(d, a, b);
}

// this thread's place in its warpgroup's accumulators: d[4j + e] is row
// `row` (+ 8 for e >= 2) of the warpgroup's 64, column 8j + col (+ 1 for
// odd e)
struct Frag {
  int wg, row, col;
};
__device__ __forceinline__ Frag frag() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {warp >> 2, 16 * (warp & 3) + (lane >> 2), 2 * (lane & 3)};
}

// Rows [row0, row0 + ROWS) of a (limit x d) bf16 matrix (row stride
// `stride` elements, d contiguous, rows 16-byte aligned) into the
// swizzled DP-wide tile at shared address dst (d-block j of row r at dst
// + j * ROWS * 128 + r * 128); rows at or past `limit` and columns at or
// past d read as 0. Part of the caller's commit group.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int64_t stride, int row0,
                                          int limit, int d) {
  constexpr int kPerRow = DP / 8;   // 16-byte chunks of a row
  static_assert(ROWS * kPerRow % kThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < ROWS * kPerRow / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kPerRow, c = idx % kPerRow;
    const int gr = row0 + r;
    const bool ok = gr < limit && c * 8 < d;
    cp_async16(dst + (c >> 3) * (ROWS * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               ok ? src + gr * stride + c * 8 : src, ok);
  }
}

// vals[r0 .. r0 + n) (ids, lse or delta of the rows of a tile; 0 past
// `limit`) into shared dst, by threads [t0, t0 + n); part of the
// caller's commit group
__device__ __forceinline__ void load_row_vals(uint32_t dst, const void* vals,
                                              int r0, int n, int limit,
                                              int t0) {
  const int i = static_cast<int>(threadIdx.x) - t0;
  if (i >= 0 && i < n) {
    const bool ok = r0 + i < limit;
    cp_async4(dst + 4 * i,
              static_cast<const int*>(vals) + (ok ? r0 + i : 0), ok);
  }
}

// [lo, hi] of ids[r0 .. r0 + n) below `limit` (lo > hi for none), the
// same in every warp, so a block that skips a tile on it skips together
__device__ __forceinline__ void warp_range(const int* ids, int r0, int n,
                                           int limit, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    if (r0 + i < limit) {
      const int v = ids[r0 + i];
      lo = min(lo, v);
      hi = max(hi, v);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// K-major descriptor of k-step kk (16 columns) of a DP-wide tile of
// `rows` rows at shared address t, from row r0 (a multiple of 8)
__device__ __forceinline__ uint64_t kdesc(uint32_t t, int rows, int r0,
                                          int kk) {
  return desc_sw128(t + (kk >> 2) * (rows * 128) + r0 * 128 + (kk & 3) * 32);
}

// MN-major descriptor of k-step t (rows 16t .. 16t + 15) of a tile of
// `rows` rows at shared address base
__device__ __forceinline__ uint64_t mndesc(uint32_t base, int rows, int t) {
  return desc_sw128_mn(base + t * 16 * 128, rows * 128);
}

// accumulator columns 16t .. 16t + 15 as register-A fragment t
template <int N, int T>
__device__ __forceinline__ void pack_a(const float (&s)[N],
                                       uint32_t (&a)[T][4]) {
  static_assert(N == 8 * T, "one fragment per 16 columns");
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[t][i] = bf16x2_rn(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [r0, r0 + rows) of the query (or key) side against columns [c0,
// c0 + cols) of the other: true when no pair of the block needs the
// per-element mask (all inside the sequences, the causal diagonal and
// the window; no segment ids). q0 / k0 are the first query and key.
__device__ __forceinline__ bool unmasked(const Shape& sh, int q0, int nq,
                                         int k0, int nk) {
  const int off = sh.sk - sh.sq;
  return sh.qseg == nullptr && q0 + nq <= sh.sq && k0 + nk <= sh.sk &&
         (!sh.causal || q0 + off >= k0 + nk - 1) &&
         (sh.window == 0 || q0 + nq - 1 + off - k0 < sh.window);
}

// ---------------------------------------------------------------------------
// forward: one block per (128-query tile, head, batch)
// ---------------------------------------------------------------------------

template <int DP>
struct Fwd {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int kQBytes = BQ * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;      // one K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes;  // K, then V
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, const Strides st, const Shape sh) {
  using C = Fwd<DP>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_kid[kStages][BK];
  const uint32_t qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t stages = qs + C::kQBytes;

  const int nq = (sh.sq + BQ - 1) / BQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;  // longest first
  const int hk = h / (sh.heads / sh.kv_heads);
  const bf16* kb = k + st.off(kK, b, hk);
  const bf16* vb = v + st.off(kV, b, hk);
  const Frag f = frag();
  const int qw0 = q0 + 64 * f.wg;  // the warpgroup's first query
  const bool seg = sh.qseg != nullptr;
  const int* kids = seg ? sh.kseg + static_cast<int64_t>(b) * sh.sk : nullptr;

  load_tile<BQ, DP>(qs, q + st.off(kQ, b, h), st.seq(kQ), q0, sh.sq, sh.d);
  cp_async_commit();
  int qlo = 0, qhi = 0, qid[2] = {0, 0};
  if (seg) {
    const int* qids = sh.qseg + static_cast<int64_t>(b) * sh.sq;
    warp_range(qids, q0, BQ, sh.sq, qlo, qhi);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = qw0 + f.row + 8 * e;
      qid[e] = r < sh.sq ? qids[r] : 0;
    }
  }
  const TileRange kr = key_tiles(sh, q0, BQ, BK);   // the block's
  const TileRange kw = key_tiles(sh, qw0, 64, BK);  // the warpgroup's
  // the first key tile at or after t that some query of the block may see
  auto live = [&](int t) {
    for (; seg && t < kr.hi; ++t) {
      int lo, hi;
      warp_range(kids, t * BK, BK, sh.sk, lo, hi);
      if (hi >= qlo && lo <= qhi) break;
    }
    return t;
  };
  auto load = [&](int t, int s) {
    const uint32_t ks = stages + s * C::kStageBytes;
    load_tile<BK, DP>(ks, kb, st.seq(kK), t * BK, sh.sk, sh.d);
    load_tile<BK, DP>(ks + C::kKVBytes, vb, st.seq(kV), t * BK, sh.sk, sh.d);
    if (seg) load_row_vals(smem_addr(s_kid[s]), kids, t * BK, BK, sh.sk, 0);
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  const float ninf = -INFINITY;
  float m[2] = {ninf, ninf}, l[2] = {0.f, 0.f};
  const float sl2 = sh.scale * kLog2e;   // scores in log2 units

  // tiles t (stage n % 3) and t1 in flight; t2 loads once every thread
  // is past the tile before t, whose stage it takes
  int t = live(kr.lo);
  int t1 = t < kr.hi ? live(t + 1) : kr.hi;
  if (t < kr.hi) load(t, 0);
  cp_async_commit();
  if (t1 < kr.hi) load(t1, 1);
  cp_async_commit();
  for (int n = 0; t < kr.hi; ++n) {
    cp_async_wait<1>();  // the Q tile and tile t (this thread's copies)
    fence_async_smem();
    __syncthreads();     // ... and everyone's; tile n - 1 is consumed
    const int t2 = t1 < kr.hi ? live(t1 + 1) : kr.hi;
    if (t2 < kr.hi) load(t2, (n + 2) % kStages);
    cp_async_commit();
    const int k0 = t * BK;
    if (qw0 < sh.sq && t >= kw.lo && t < kw.hi) {
      const uint32_t ks = stages + (n % kStages) * C::kStageBytes;
      const uint32_t vs = ks + C::kKVBytes;
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(s, kdesc(qs, BQ, 64 * f.wg, kk), kdesc(ks, BK, 0, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (unmasked(sh, qw0, 64, k0, BK)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int qpos = qw0 + f.row + 8 * ((i >> 1) & 1);
          const int kc = 8 * (i >> 2) + f.col + (i & 1);
          const bool ok =
              visible(sh, qpos, k0 + kc) &&
              (!seg || qid[(i >> 1) & 1] == s_kid[n % kStages][kc]);
          s[i] = ok ? s[i] * sl2 : ninf;
        }
      }
      // online softmax over the two rows this thread holds
      float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = ninf;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * e], s[4 * j + 2 * e + 1]));
        const float mn = fmaxf(m[e], quad_max(mx));
        mu[e] = mn == ninf ? 0.f : mn;  // a row with no key yet: p = 0
        alpha[e] = exp2f(m[e] - mu[e]);
        m[e] = mn;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = exp2f(s[i] - mu[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
      uint32_t a[BK / 16][4];
      pack_a(s, a);
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_rs_tb(o, a[kt], mndesc(vs, BK, kt));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(a);
    }
    t = t1;
    t1 = t2;
  }
  cp_async_wait<0>();

  if (qw0 >= sh.sq) return;
  bf16* ob = out + st.off(kO, b, h);
  float* lb = lse + (static_cast<int64_t>(b) * sh.heads + h) * sh.sq;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float lt = quad_sum(l[e]);
    const int qpos = qw0 + f.row + 8 * e;
    if (qpos >= sh.sq) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + f.col;
      if (c < sh.d)
        *reinterpret_cast<__nv_bfloat162*>(ob + qpos * st.seq(kO) + c) =
            __floats2bfloat162_rn(o[4 * j + 2 * e] * inv,
                                  o[4 * j + 2 * e + 1] * inv);
    }
    if (f.col == 0) lb[qpos] = lt > 0.f ? m[e] * kLn2 + logf(lt) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (128-query tile, head, batch); also writes
// delta = sum_d(dout * out) for the dk/dv pass and zeroes its counters
// ---------------------------------------------------------------------------

template <int DP>
struct Dq {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int kQBytes = BQ * DP * 2;       // Q or dO tile
  static constexpr int kKVBytes = BK * DP * 2;      // K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes;  // K, then V
  static constexpr int kSmem = 2 * kQBytes + kStages * kStageBytes + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ out,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int* __restrict__ counters,
                    int ncounters, const Strides st, const Shape sh) {
  using C = Dq<DP>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_kid[kStages][BK];
  __shared__ float s_lse[BQ], s_delta[BQ];
  const uint32_t qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + C::kQBytes;
  const uint32_t stages = dos + C::kQBytes;

  {  // the dk/dv pass's arrival counters start at 0
    const int64_t nblk = static_cast<int64_t>(gridDim.x) * gridDim.y *
                         gridDim.z;
    const int64_t blk = blockIdx.x + gridDim.x * (blockIdx.y +
                                                  static_cast<int64_t>(
                                                      gridDim.y) *
                                                      blockIdx.z);
    for (int64_t i = blk * kThreads + threadIdx.x; i < ncounters;
         i += nblk * kThreads)
      counters[i] = 0;
  }

  const int nq = (sh.sq + BQ - 1) / BQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int hk = h / (sh.heads / sh.kv_heads);
  const bf16* kb = k + st.off(kK, b, hk);
  const bf16* vb = v + st.off(kV, b, hk);
  const bf16* dob = dout + st.off(kDO, b, h);
  const Frag f = frag();
  const int qw0 = q0 + 64 * f.wg;
  const bool seg = sh.qseg != nullptr;
  const int* kids = seg ? sh.kseg + static_cast<int64_t>(b) * sh.sk : nullptr;
  const int64_t row_base = (static_cast<int64_t>(b) * sh.heads + h) * sh.sq;

  load_tile<BQ, DP>(qs, q + st.off(kQ, b, h), st.seq(kQ), q0, sh.sq, sh.d);
  load_tile<BQ, DP>(dos, dob, st.seq(kDO), q0, sh.sq, sh.d);
  cp_async_commit();
  {  // delta and lse (in log2 units) of the tile's rows: a warp per row
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bf16* ob = out + st.off(kO, b, h);
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int qpos = q0 + r;
      float acc = 0.f;
      if (qpos < sh.sq)
        for (int c = 2 * lane; c < sh.d; c += 64) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  ob + qpos * st.seq(kO) + c));
          const float2 g = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  dob + qpos * st.seq(kDO) + c));
          acc += a.x * g.x + a.y * g.y;
        }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        s_delta[r] = acc;
        s_lse[r] = qpos < sh.sq ? lse[row_base + qpos] * kLog2e : 0.f;
        if (qpos < sh.sq) delta[row_base + qpos] = acc;
      }
    }
  }
  int qlo = 0, qhi = 0, qid[2] = {0, 0};
  if (seg) {
    const int* qids = sh.qseg + static_cast<int64_t>(b) * sh.sq;
    warp_range(qids, q0, BQ, sh.sq, qlo, qhi);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = qw0 + f.row + 8 * e;
      qid[e] = r < sh.sq ? qids[r] : 0;
    }
  }
  __syncthreads();
  float ls[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    ls[e] = s_lse[64 * f.wg + f.row + 8 * e];
    dl[e] = s_delta[64 * f.wg + f.row + 8 * e];
  }

  const TileRange kr = key_tiles(sh, q0, BQ, BK);
  const TileRange kw = key_tiles(sh, qw0, 64, BK);
  auto live = [&](int t) {
    for (; seg && t < kr.hi; ++t) {
      int lo, hi;
      warp_range(kids, t * BK, BK, sh.sk, lo, hi);
      if (hi >= qlo && lo <= qhi) break;
    }
    return t;
  };
  auto load = [&](int t, int s) {
    const uint32_t ks = stages + s * C::kStageBytes;
    load_tile<BK, DP>(ks, kb, st.seq(kK), t * BK, sh.sk, sh.d);
    load_tile<BK, DP>(ks + C::kKVBytes, vb, st.seq(kV), t * BK, sh.sk, sh.d);
    if (seg) load_row_vals(smem_addr(s_kid[s]), kids, t * BK, BK, sh.sk, 0);
  };

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const float sl2 = sh.scale * kLog2e;

  int t = live(kr.lo);   // as the forward's pipeline
  int t1 = t < kr.hi ? live(t + 1) : kr.hi;
  if (t < kr.hi) load(t, 0);
  cp_async_commit();
  if (t1 < kr.hi) load(t1, 1);
  cp_async_commit();
  for (int n = 0; t < kr.hi; ++n) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int t2 = t1 < kr.hi ? live(t1 + 1) : kr.hi;
    if (t2 < kr.hi) load(t2, (n + 2) % kStages);
    cp_async_commit();
    const int k0 = t * BK;
    if (qw0 < sh.sq && t >= kw.lo && t < kw.hi) {
      const uint32_t ks = stages + (n % kStages) * C::kStageBytes;
      const uint32_t vs = ks + C::kKVBytes;
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(s, kdesc(qs, BQ, 64 * f.wg, kk), kdesc(ks, BK, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(dp, kdesc(dos, BQ, 64 * f.wg, kk), kdesc(vs, BK, 0, kk),
                 kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const bool all = unmasked(sh, qw0, 64, k0, BK);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int e = (i >> 1) & 1;
        float p = exp2f(fmaf(s[i], sl2, -ls[e]));
        if (!all) {
          const int kc = 8 * (i >> 2) + f.col + (i & 1);
          const bool ok = visible(sh, qw0 + f.row + 8 * e, k0 + kc) &&
                          (!seg || qid[e] == s_kid[n % kStages][kc]);
          p = ok ? p : 0.f;
        }
        s[i] = p * (dp[i] - dl[e]);  // ds
      }
      uint32_t a[BK / 16][4];
      pack_a(s, a);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_rs_tb(acc, a[kt], mndesc(ks, BK, kt));  // dq += ds k
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(a);
    }
    t = t1;
    t1 = t2;
  }
  cp_async_wait<0>();

  if (qw0 >= sh.sq) return;
  bf16* db = dq + st.off(kDQ, b, h);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = qw0 + f.row + 8 * e;
    if (qpos >= sh.sq) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + f.col;
      if (c < sh.d)
        *reinterpret_cast<__nv_bfloat162*>(db + qpos * st.seq(kDQ) + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * e] * sh.scale,
                                  acc[4 * j + 2 * e + 1] * sh.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: one block per (128-key tile, slice of a kv head's
// query heads, batch), walking the slice's heads and their 64-query tiles
// ---------------------------------------------------------------------------

template <int DP>
struct Dkv {
  static constexpr int BK = 128, BQ = 64;
  static constexpr int kKVBytes = BK * DP * 2;      // K or V tile
  static constexpr int kQBytes = BQ * DP * 2;       // Q or dO tile
  static constexpr int kStageBytes = 2 * kQBytes;   // Q, then dO
  static constexpr int kSmem = 2 * kKVBytes + kStages * kStageBytes + 1024;
};

// Grid: (kv heads x slices, key tiles, batch). part: the float32 partial
// dk / dv of every (slice, key tile) when nslice > 1, in the thread's
// fragment order; counters: one per key tile, zeroed by the dq pass.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float4* __restrict__ part,
                     int* __restrict__ counters, int nslice, const Strides st,
                     const Shape sh) {
  using C = Dkv<DP>;
  constexpr int BK = C::BK, BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float s_lse[kStages][BQ], s_delta[kStages][BQ];
  __shared__ int s_qid[kStages][BQ];
  __shared__ int s_last;
  const uint32_t ks = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t vs = ks + C::kKVBytes;
  const uint32_t stages = vs + C::kKVBytes;

  const int slice = blockIdx.x % nslice, hk = blockIdx.x / nslice;
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * BK;  // the longest causal columns first
  const int group = sh.heads / sh.kv_heads, per = group / nslice;
  const int h0 = hk * group + slice * per;  // the slice's first head
  const Frag f = frag();
  const int kw0 = k0 + 64 * f.wg;  // the warpgroup's first key
  const bool seg = sh.qseg != nullptr;
  const int* qids = seg ? sh.qseg + static_cast<int64_t>(b) * sh.sq : nullptr;

  load_tile<BK, DP>(ks, k + st.off(kK, b, hk), st.seq(kK), k0, sh.sk, sh.d);
  load_tile<BK, DP>(vs, v + st.off(kV, b, hk), st.seq(kV), k0, sh.sk, sh.d);
  cp_async_commit();
  int klo = 0, khi = 0, kid[2] = {0, 0};
  if (seg) {
    const int* kids = sh.kseg + static_cast<int64_t>(b) * sh.sk;
    warp_range(kids, k0, BK, sh.sk, klo, khi);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = kw0 + f.row + 8 * e;
      kid[e] = r < sh.sk ? kids[r] : 0;
    }
  }
  const TileRange qr = query_tiles(sh, k0, BK, BQ);   // the block's
  const TileRange qw = query_tiles(sh, kw0, 64, BQ);  // the warpgroup's
  const int nqt = max(qr.hi - qr.lo, 0);
  const int items = per * nqt;  // (head of the slice, query tile) pairs
  auto live = [&](int n) {
    for (; seg && n < items; ++n) {
      int lo, hi;
      warp_range(qids, (qr.lo + n % nqt) * BQ, BQ, sh.sq, lo, hi);
      if (hi >= klo && lo <= khi) break;
    }
    return n;
  };
  auto load = [&](int n, int s) {
    const int h = h0 + n / nqt, q0 = (qr.lo + n % nqt) * BQ;
    const uint32_t qs = stages + s * C::kStageBytes;
    const int64_t rows = (static_cast<int64_t>(b) * sh.heads + h) * sh.sq;
    load_tile<BQ, DP>(qs, q + st.off(kQ, b, h), st.seq(kQ), q0, sh.sq, sh.d);
    load_tile<BQ, DP>(qs + C::kQBytes, dout + st.off(kDO, b, h),
                      st.seq(kDO), q0, sh.sq, sh.d);
    load_row_vals(smem_addr(s_lse[s]), lse + rows, q0, BQ, sh.sq, 0);
    load_row_vals(smem_addr(s_delta[s]), delta + rows, q0, BQ, sh.sq, BQ);
    if (seg) load_row_vals(smem_addr(s_qid[s]), qids, q0, BQ, sh.sq, 2 * BQ);
  };

  float ak[DP / 2], av[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) ak[i] = av[i] = 0.f;
  const float sl2 = sh.scale * kLog2e;

  int n = live(0);   // as the forward's pipeline, over items
  int n1 = n < items ? live(n + 1) : items;
  if (n < items) load(n, 0);
  cp_async_commit();
  if (n1 < items) load(n1, 1);
  cp_async_commit();
  for (int it = 0; n < items; ++it) {
    cp_async_wait<1>();  // the K and V tiles and item n
    fence_async_smem();
    __syncthreads();
    const int n2 = n1 < items ? live(n1 + 1) : items;
    if (n2 < items) load(n2, (it + 2) % kStages);
    cp_async_commit();
    const int iq = qr.lo + n % nqt, q0 = iq * BQ;
    if (kw0 < sh.sk && iq >= qw.lo && iq < qw.hi) {
      const int sb = it % kStages;
      const uint32_t qs = stages + sb * C::kStageBytes;
      const uint32_t dos = qs + C::kQBytes;
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)  // s^T = k q^T
        wgmma_ss(s, kdesc(ks, BK, 64 * f.wg, kk), kdesc(qs, BQ, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)  // dp^T = v dout^T
        wgmma_ss(dp, kdesc(vs, BK, 64 * f.wg, kk), kdesc(dos, BQ, 0, kk),
                 kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const bool all = unmasked(sh, q0, BQ, kw0, 64);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int e = (i >> 1) & 1;
        const int qc = 8 * (i >> 2) + f.col + (i & 1);  // query of the tile
        float p = exp2f(fmaf(s[i], sl2, -s_lse[sb][qc] * kLog2e));
        if (!all) {
          const bool ok = q0 + qc < sh.sq &&
                          visible(sh, q0 + qc, kw0 + f.row + 8 * e) &&
                          (!seg || s_qid[sb][qc] == kid[e]);
          p = ok ? p : 0.f;
        }
        dp[i] = p * (dp[i] - s_delta[sb][qc]);  // ds^T
        s[i] = p;                               // p^T
      }
      uint32_t ap[BQ / 16][4], ad[BQ / 16][4];
      pack_a(s, ap);
      pack_a(dp, ad);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt)  // dv += p^T dout
        wgmma_rs_tb(av, ap[kt], mndesc(dos, BQ, kt));
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt)  // dk += ds^T q
        wgmma_rs_tb(ak, ad[kt], mndesc(qs, BQ, kt));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(av);
      fence_regs(ak);
      fence_regs(ap);
      fence_regs(ad);
    }
    n = n1;
    n1 = n2;
  }
  cp_async_wait<0>();

  if (nslice > 1) {
    // this slice's partial sums out; the last block of the key tile to
    // arrive adds every slice's, in slice order
    const int64_t nbase = static_cast<int64_t>(gridDim.y) * sh.kv_heads *
                          gridDim.z;
    const int64_t base = (static_cast<int64_t>(b) * sh.kv_heads + hk) *
                             gridDim.y + blockIdx.y;
    auto slab = [&](int s, int i4) {
      return part + ((s * nbase + base) * (DP / 4) + i4) * kThreads +
             threadIdx.x;
    };
#pragma unroll
    for (int i4 = 0; i4 < DP / 8; ++i4) {
      *slab(slice, i4) = make_float4(ak[4 * i4], ak[4 * i4 + 1],
                                     ak[4 * i4 + 2], ak[4 * i4 + 3]);
      *slab(slice, DP / 8 + i4) = make_float4(av[4 * i4], av[4 * i4 + 1],
                                              av[4 * i4 + 2], av[4 * i4 + 3]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(counters + base, 1) == nslice - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the fixed order: slice 0, 1, ...; this block's own from registers
    auto add = [&](float (&acc)[DP / 2], int at) {
#pragma unroll
      for (int i4 = 0; i4 < DP / 8; ++i4) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < nslice; ++s) {
          const float4 x =
              s == slice ? make_float4(acc[4 * i4], acc[4 * i4 + 1],
                                       acc[4 * i4 + 2], acc[4 * i4 + 3])
                         : __ldcg(slab(s, at + i4));
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        acc[4 * i4] = sum.x;
        acc[4 * i4 + 1] = sum.y;
        acc[4 * i4 + 2] = sum.z;
        acc[4 * i4 + 3] = sum.w;
      }
    };
    add(ak, 0);
    add(av, DP / 8);
  }

  if (kw0 >= sh.sk) return;
  bf16* dkb = dk + st.off(kDK, b, hk);
  bf16* dvb = dv + st.off(kDV, b, hk);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kpos = kw0 + f.row + 8 * e;
    if (kpos >= sh.sk) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + f.col;
      if (c >= sh.d) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + kpos * st.seq(kDK) + c) =
          __floats2bfloat162_rn(ak[4 * j + 2 * e] * sh.scale,
                                ak[4 * j + 2 * e + 1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + kpos * st.seq(kDV) + c) =
          __floats2bfloat162_rn(av[4 * j + 2 * e], av[4 * j + 2 * e + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, const Strides& st, const Shape& sh,
                       int batch, cudaStream_t s) {
  using C = Fwd<DP>;
  cudaError_t e = allow_smem(flash_fwd_tc<DP>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(sh.heads, (sh.sq + C::BQ - 1) / C::BQ, batch);
  flash_fwd_tc<DP><<<grid, kThreads, C::kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, st, sh);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, void* part,
                       int* counters, int nslice, const Strides& st,
                       const Shape& sh, int batch, cudaStream_t s) {
  using Q = Dq<DP>;
  using KV = Dkv<DP>;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const int ktiles = (sh.sk + KV::BK - 1) / KV::BK;
  const int ncounters = nslice > 1 ? ktiles * sh.kv_heads * batch : 0;
  cudaError_t e = allow_smem(flash_bwd_dq_tc<DP>, Q::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid_dq(sh.heads, (sh.sq + Q::BQ - 1) / Q::BQ, batch);
  flash_bwd_dq_tc<DP><<<grid_dq, kThreads, Q::kSmem, s>>>(
      qp, kp, vp, static_cast<const bf16*>(out), dop, lse, delta,
      static_cast<bf16*>(dq), counters, ncounters, st, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dkv_tc<DP>, KV::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid_kv(sh.kv_heads * nslice, ktiles, batch);
  flash_bwd_dkv_tc<DP><<<grid_kv, kThreads, KV::kSmem, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float4*>(part), counters, nslice,
      st, sh);
  return cudaGetLastError();
}

// what the tensor-core kernels take: bf16, d a multiple of 8 up to 128,
// and grids whose y dimension (128-row tiles) fits
bool takes(const Shape& sh, int dtype) {
  return dtype == pt::kBF16 && sh.d % 8 == 0 && sh.d <= 128 &&
         (sh.sq + 127) / 128 <= 65535 && (sh.sk + 127) / 128 <= 65535;
}

}  // namespace

// The forward on the tensor cores: the arguments of pt_flash_attention_fwd
// (flash_attention.cu), for dtype bf16 and d a multiple of 8 up to 128
// only (anything else: cudaErrorInvalidValue).
extern "C" int pt_flash_attention_tc_fwd(
    int device, const void* q, const void* k, const void* v, void* out,
    void* lse, const void* qseg, const void* kseg, const long long* strides,
    int batch, int heads, int kv_heads, int sq, int sk, int d, float scale,
    int causal, int window, int dtype, void* stream) {
  const Shape sh{heads, kv_heads, sq, sk, d, scale, causal, window,
                 static_cast<const int*>(qseg), static_cast<const int*>(kseg)};
  Strides st;
  cudaError_t e = check_args(device, batch, sh, d, strides, 4, &st);
  if (e != cudaSuccess) return e;
  if (!takes(sh, dtype)) return cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return cudaSuccess;
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_fwd<64>(q, k, v, out, lp, st, sh, batch, s);
  return launch_fwd<128>(q, k, v, out, lp, st, sh, batch, s);
}

// The backward on the tensor cores, two launches on `stream`: dq (which
// also writes delta, (batch, heads, sq) float32 scratch), then dk and dv.
// The arguments of pt_flash_attention_bwd, and: nslice, the slices of
// each kv head's query heads the dk/dv pass spreads over its blocks (a
// divisor of heads / kv_heads); for nslice > 1, part, float32 scratch of
// nslice * batch * kv_heads * ceil(sk / 128) * 128 * 2 * d_tile floats
// (d_tile: 64 for d <= 64, else 128), and counters, int32 scratch of
// batch * kv_heads * ceil(sk / 128) (both unused, and may be null, for
// nslice = 1).
extern "C" int pt_flash_attention_tc_bwd(
    int device, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* part, void* counters, const void* qseg, const void* kseg,
    const long long* strides, int batch, int heads, int kv_heads, int sq,
    int sk, int d, float scale, int causal, int window, int nslice, int dtype,
    void* stream) {
  const Shape sh{heads, kv_heads, sq, sk, d, scale, causal, window,
                 static_cast<const int*>(qseg), static_cast<const int*>(kseg)};
  Strides st;
  cudaError_t e = check_args(device, batch, sh, d, strides, kNumTensors, &st);
  if (e != cudaSuccess) return e;
  if (!takes(sh, dtype) || nslice < 1 || (heads / kv_heads) % nslice ||
      (nslice > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || sk == 0) return cudaSuccess;
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_bwd<64>(q, k, v, out, dout, lp, dl, dq, dk, dv, part, cnt,
                          nslice, st, sh, batch, s);
  return launch_bwd<128>(q, k, v, out, dout, lp, dl, dq, dk, dv, part, cnt,
                         nslice, st, sh, batch, s);
}
