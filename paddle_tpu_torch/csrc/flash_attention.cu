// Flash attention forward and backward for Hopper (sm_90a) on the CUDA
// cores, in float32: the route of float32 inputs (whose products stay
// float32, as the plain version's) and of bf16 past head size 128 (the
// 256-wide tile: at D = 256 a tensor-core backward's two 64 x 256
// float32 accumulators would take every register). bf16 up to D = 128
// takes the tensor cores (flash_attention_tc.cu); the wrapper's route
// rule (ops/hopper/flash_attention.py: path()) picks, and the C entries
// here refuse bf16 at D <= 128 (no kernel of that type is built).
//
// Forward replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// ::_fwd (body _fwd_kernel); backward replaces ::_bwd (bodies
// _bwd_dq_kernel and _bwd_dkv_kernel). q (B, H, Sq, D), k and v
// (B, Hkv, Sk, D), any strides over (batch, head, sequence) with D
// contiguous; query head h reads kv head h / (H / Hkv). Causal masking is
// bottom-right (query i sees keys j <= i + Sk - Sq). The forward returns
// out (q's dtype) and lse = m + log(l) per query (float32); a query that
// sees no key returns 0. The backward takes delta = sum_d(dout * out) and
// p = exp(s - lse), and returns dq, dk, dv in the input dtypes, with dk
// and dv summed over each GQA group inside the kernel (one kv head per
// block walks the group's query heads; no atomics).
//
// Modes, each a kernel of its own in PERF.md's table, all in the same
// three kernels:
// - segment ids (K5s forward, K6s backward: the qseg / kseg operands of
//   _fwd and _bwd, (B, Sq) and (B, Sk) int32): a query also sees only the
//   keys of its own segment (packed sequences: flash_attn_unpadded,
//   block_multihead_attention's varlen prefill). Every masked pair gets
//   p = 0, as the TPU bodies force, so a query with no visible key in its
//   segment returns 0, gets dq = 0 and gives no gradient to any k or v.
// - a sliding window (K5w forward, K6w backward: the `window` mode of
//   _fwd and _bwd): a query also sees only the keys with
//   qpos + Sk - Sq - kpos < window (its last `window` positions, itself
//   included). Segments and a window compose.
//
// Bound: operations. At Llama shapes (S = 2048, D = 128) the forward does
// 4*S*S*D/2 causal float operations per head against 4*S*D*2 bytes of
// inputs and output: hundreds of operations per byte, far past the ~295
// at which the card's bf16 tensor cores (989 TFLOP/s) become the limit.
// A window of w keys cuts the work to about 4*S*w*D per head, a packed
// stream to the sum of its segments' causal work; both stay far past
// that line. Design (a first, simple version): every product runs on the
// CUDA cores in float32 (the float32 path differs from the plain version
// by summation order only), from 64-row tiles held in shared memory as
// float32 with an odd leading dimension (D + 1, 65), so that both a row
// walk and a column walk touch 32 banks. A 16 x 16 grid of threads gives
// each thread a strided (4 x RN) slice of every product; online softmax
// in float32 never materialises the S x S scores. Work outside the mask
// is skipped by whole tiles, before they are loaded: a query tile walks
// only the key tiles [lo, hi) its rows can see (the causal diagonal ends the
// range, the window's lower edge starts it, as _fwd_kernel's two block
// skips), and a key tile of the dk/dv pass only the query tiles whose
// rows reach it, so a query tile costs O(64 * window) and not
// O(64 * qpos). With segment ids, the block stages the ids of its rows
// and of each tile it visits in shared memory and skips the tile when
// the two ranges of ids do not meet, so a stream of sorted segments costs
// about the sum of its segments' causal work. The per-element masks
// (band, segments, causal) are applied inside the live tiles. This version
// is far from the float32 bound (register blocking of its own, ROADMAP
// D4's float32 path).
//
// Head sizes (fault E2 of ROADMAP.md): the TPU kernels take any D (the
// model's dispatch sends D % 8 == 0 to them). The kernels are compiled on
// tiles of width 64, 96, 128 or 256 and take every head size that is a
// multiple of 8 up to 256 on the narrowest tile that holds it (float32;
// bf16 here only on the 256-wide one): the tile's columns past D load as
// zeros, add nothing to a product, and are not written (D = 80 runs on
// 96-wide tiles, 1.2x its products; Llama's 64 and 128 fill their tiles).
// D = 256 holds one block per SM (its backward's dk/dv tiles take 206 KB
// of the 227 KB a block may have).

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "flash_attention.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid: ty = tid / 16, tx = tid % 16

__device__ __forceinline__ int tid_y() { return threadIdx.x >> 4; }
__device__ __forceinline__ int tid_x() { return threadIdx.x & 15; }

// Rows [row0, row0 + ROWS) of a (limit, dr) matrix with row stride
// `stride` into a ROWS x (D + 1) float tile, times `mul`; rows at or past
// `limit`, and the columns at or past dr (a head narrower than the tile),
// read as 0. 16-byte loads, neighbouring threads on neighbouring addresses.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0, int limit,
                                          float mul, int dr) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    float* d = dst + r * (D + 1) + c;
    const int gr = row0 + r;
    if (gr < limit && c < dr) {
      const pt::Pack<T, kVec> p =
          *reinterpret_cast<const pt::Pack<T, kVec>*>(src + gr * stride + c);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = pt::to_f32(p.v[j]) * mul;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = 0.f;
    }
  }
}

// c[ii][jj] += sum_k A(ty + 16 ii, k) * B(k, tx + 16 jj) over k < K, with
// A(i, k) = a[i * AI + k * AK] and B(k, j) = b[k * BK + j * BJ] in shared
// memory. In a warp, A is read at two rows (a broadcast) and B at 16
// consecutive j, which the odd leading dimensions spread over 16 banks.
template <int RM, int RN, int K, int AI, int AK, int BK, int BJ>
__device__ __forceinline__ void tile_mma(float (&c)[RM][RN],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b) {
  const int ty = tid_y(), tx = tid_x();
  const float* ap = a + ty * AI;
  const float* bp = b + tx * BJ;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = ap[(16 * i) * AI + k * AK];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = bp[k * BK + (16 * j) * BJ];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// max / sum over the 16 threads that share a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Segment ids of rows [r0, r0 + n) into shared `dst` (0 past `limit`);
// the caller synchronises before reading them.
__device__ __forceinline__ void stage_ids(int* dst, const int* ids, int r0,
                                          int n, int limit) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = r0 + i < limit ? ids[r0 + i] : 0;
}

// The range [lo, hi] of the staged ids of the rows below `limit` (empty,
// lo > hi, for none). Every thread computes the same range, so a block
// that skips a tile on it skips together.
__device__ __forceinline__ void id_range(const int* s, int r0, int n,
                                         int limit, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = 0; i < n && r0 + i < limit; ++i) {
    lo = min(lo, s[i]);
    hi = max(hi, s[i]);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (64-query tile, head, batch)
// ---------------------------------------------------------------------------

constexpr int kFwdBQ = 64, kFwdBK = 64;

template <int D>
constexpr size_t fwd_smem() {
  // q, k (reused for p), v tiles
  return sizeof(float) * (kFwdBQ + 2 * kFwdBK) * (D + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const Strides st,
                     const Shape sh) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK, LD = D + 1, LP = BK + 1;
  constexpr int RM = BQ / 16, RN = BK / 16, RD = D / 16;
  static_assert(BQ * LP <= BK * LD, "p must fit in the k tile");
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * LD;
  float* sp = sk;  // p reuses the k tile once the scores are in registers
  float* sv = sk + BK * LD;

  const int nq = (sh.sq + BQ - 1) / BQ;
  const int iq = nq - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (sh.heads / sh.kv_heads);
  const int q0 = iq * BQ;
  const int ty = tid_y(), tx = tid_x();
  const T* kb = k + st.off(kK, b, hk);
  const T* vb = v + st.off(kV, b, hk);

  load_tile<T, D, BQ>(sq, q + st.off(kQ, b, h), st.seq(kQ), q0, sh.sq,
                      sh.scale, sh.d);
  // segment ids of the tile's queries and of the current key tile, and
  // the range of the query ids (rows past sq take no part)
  __shared__ int s_qseg[BQ], s_kseg[BK];
  const bool seg = sh.qseg != nullptr;
  const int* ks = seg ? sh.kseg + static_cast<int64_t>(b) * sh.sk : nullptr;
  int qlo = 0, qhi = 0;
  if (seg) {
    stage_ids(s_qseg, sh.qseg + static_cast<int64_t>(b) * sh.sq, q0, BQ,
              sh.sq);
    __syncthreads();
    id_range(s_qseg, q0, BQ, sh.sq, qlo, qhi);
  }
  float o[RM][RD], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) o[i][j] = 0.f;
  }

  const TileRange kr = key_tiles(sh, q0, BQ, BK);
  for (int ik = kr.lo; ik < kr.hi; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's p, v and ids are consumed
    if (seg) {
      stage_ids(s_kseg, ks, k0, BK, sh.sk);
      __syncthreads();
      int klo, khi;
      id_range(s_kseg, k0, BK, sh.sk, klo, khi);
      // no key of the tile can share a query's segment
      if (khi < qlo || klo > qhi) continue;
    }
    load_tile<T, D, BK>(sk, kb, st.seq(kK), k0, sh.sk, 1.f, sh.d);
    load_tile<T, D, BK>(sv, vb, st.seq(kV), k0, sh.sk, 1.f, sh.d);
    __syncthreads();
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
    tile_mma<RM, RN, D, LD, 1, 1, LD>(s, sq, sk);  // (q * scale) k^T
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
      bool ok[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        ok[j] = visible(sh, qpos, k0 + tx + 16 * j) &&
                (!seg || s_qseg[ty + 16 * i] == s_kseg[tx + 16 * j]);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        // a masked key has probability 0, also in a row with no key yet
        const float p = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
      const float alpha = __expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) o[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading k
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        sp[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
    __syncthreads();
    tile_mma<RM, RD, BK, LP, 1, LD, 1>(o, sp, sv);  // o += p v
  }

  T* ob = out + st.off(kO, b, h);
  float* lb = lse + (static_cast<int64_t>(b) * sh.heads + h) * sh.sq;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sh.sq) continue;
    const float safe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / safe;
#pragma unroll
    for (int j = 0; j < RD; ++j)
      if (tx + 16 * j < sh.d)
        ob[qpos * st.seq(kO) + tx + 16 * j] = pt::from_f32<T>(o[i][j] * inv);
    if (tx == 0) lb[qpos] = m[i] + logf(safe);
  }
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (64-query tile, head, batch); also writes
// delta = sum_d(dout * out) for the dk/dv pass
// ---------------------------------------------------------------------------

constexpr int kDqBQ = 64, kDqBK = 32;

// floats of the v tile, which ds reuses: (BK, D + 1) or (BQ, BK + 1)
template <int D>
constexpr int dq_v_region() {
  return kDqBK * (D + 1) > kDqBQ * (kDqBK + 1) ? kDqBK * (D + 1)
                                               : kDqBQ * (kDqBK + 1);
}

template <int D>
constexpr size_t dq_smem() {
  // q, dout, k tiles and the v / ds region
  return sizeof(float) * ((2 * kDqBQ + kDqBK) * (D + 1) + dq_v_region<D>());
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq,
                        const Strides st, const Shape sh) {
  constexpr int BQ = kDqBQ, BK = kDqBK, LD = D + 1, LS = BK + 1;
  constexpr int RM = BQ / 16, RN = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  __shared__ float s_lse[BQ], s_delta[BQ];
  float* sq = smem;
  float* sdo = sq + BQ * LD;
  float* sk = sdo + BQ * LD;
  float* sv = sk + BK * LD;
  float* sds = sv;  // ds reuses the v tile once dp is in registers

  const int nq = (sh.sq + BQ - 1) / BQ;
  const int iq = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (sh.heads / sh.kv_heads);
  const int q0 = iq * BQ;
  const int ty = tid_y(), tx = tid_x();
  const T* kb = k + st.off(kK, b, hk);
  const T* vb = v + st.off(kV, b, hk);
  const int64_t row_base = (static_cast<int64_t>(b) * sh.heads + h) * sh.sq;

  // segment ids of the tile's queries and of the current key tile
  __shared__ int s_qseg[BQ], s_kseg[BK];
  const bool seg = sh.qseg != nullptr;
  const int* ks = seg ? sh.kseg + static_cast<int64_t>(b) * sh.sk : nullptr;
  if (seg)
    stage_ids(s_qseg, sh.qseg + static_cast<int64_t>(b) * sh.sq, q0, BQ,
              sh.sq);
  load_tile<T, D, BQ>(sq, q + st.off(kQ, b, h), st.seq(kQ), q0, sh.sq,
                      sh.scale, sh.d);
  load_tile<T, D, BQ>(sdo, dout + st.off(kDO, b, h), st.seq(kDO), q0, sh.sq,
                      1.f, sh.d);
  __syncthreads();
  int qlo = 0, qhi = 0;
  if (seg) id_range(s_qseg, q0, BQ, sh.sq, qlo, qhi);
  {  // delta and lse of the tile's rows: one warp per 8 rows
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* ob = out + st.off(kO, b, h);
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int qpos = q0 + r;
      float acc = 0.f;
      if (qpos < sh.sq)
        for (int d = lane; d < sh.d; d += 32)
          acc += sdo[r * LD + d] * pt::to_f32(ob[qpos * st.seq(kO) + d]);
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        s_delta[r] = acc;
        s_lse[r] = qpos < sh.sq ? lse[row_base + qpos] : 0.f;
        if (qpos < sh.sq) delta[row_base + qpos] = acc;
      }
    }
  }

  float acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  const TileRange kr = key_tiles(sh, q0, BQ, BK);
  for (int ik = kr.lo; ik < kr.hi; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's ds, k and ids are consumed
    if (seg) {
      stage_ids(s_kseg, ks, k0, BK, sh.sk);
      __syncthreads();
      int klo, khi;
      id_range(s_kseg, k0, BK, sh.sk, klo, khi);
      if (khi < qlo || klo > qhi) continue;
    }
    load_tile<T, D, BK>(sk, kb, st.seq(kK), k0, sh.sk, 1.f, sh.d);
    load_tile<T, D, BK>(sv, vb, st.seq(kV), k0, sh.sk, 1.f, sh.d);
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_mma<RM, RN, D, LD, 1, 1, LD>(s, sq, sk);    // (q * scale) k^T
    tile_mma<RM, RN, D, LD, 1, 1, LD>(dp, sdo, sv);  // dout v^T
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        // a masked pair has p = 0, also in a row whose lse is ~ -1e30
        const bool ok = visible(sh, q0 + r, k0 + tx + 16 * j) &&
                        (!seg || s_qseg[r] == s_kseg[tx + 16 * j]);
        const float p = ok ? __expf(s[i][j] - s_lse[r]) : 0.f;
        s[i][j] = p * (dp[i][j] - s_delta[r]);  // ds
      }
    }
    __syncthreads();  // every thread is done reading v
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        sds[(ty + 16 * i) * LS + tx + 16 * j] = s[i][j];
    __syncthreads();
    tile_mma<RM, RD, BK, LS, 1, LD, 1>(acc, sds, sk);  // dq += ds k
  }

  T* db = dq + st.off(kDQ, b, h);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sh.sq) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j)
      if (tx + 16 * j < sh.d)
        db[qpos * st.seq(kDQ) + tx + 16 * j] =
            pt::from_f32<T>(acc[i][j] * sh.scale);
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: one block per (64-key tile, kv head, batch), walking
// every query tile of every query head of its GQA group
// ---------------------------------------------------------------------------

constexpr int kKvBK = 64, kKvBQ = 32;

template <int D>
constexpr size_t dkv_smem() {
  // k, v, q, dout tiles and one (BQ, BK + 1) tile for p, then ds
  return sizeof(float) *
         ((2 * kKvBK + 2 * kKvBQ) * (D + 1) + kKvBQ * (kKvBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, const Strides st,
                         const Shape sh) {
  constexpr int BK = kKvBK, BQ = kKvBQ, LD = D + 1, LP = BK + 1;
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  __shared__ float s_lse[BQ], s_delta[BQ];
  float* sk = smem;
  float* sv = sk + BK * LD;
  float* sq = sv + BK * LD;
  float* sdo = sq + BQ * LD;
  float* sp = sdo + BQ * LD;  // p, then ds: (BQ, BK) with leading dim LP

  const int ik = blockIdx.x;  // the longest causal columns first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = sh.heads / sh.kv_heads;
  const int k0 = ik * BK;
  const int ty = tid_y(), tx = tid_x();
  // the query tiles whose rows see some key of this tile
  const TileRange qr = query_tiles(sh, k0, BK, BQ);
  // segment ids of the tile's keys and of the current query tile
  __shared__ int s_qseg[BQ], s_kseg[BK];
  const bool seg = sh.qseg != nullptr;
  const int* qs = seg ? sh.qseg + static_cast<int64_t>(b) * sh.sq : nullptr;
  if (seg)
    stage_ids(s_kseg, sh.kseg + static_cast<int64_t>(b) * sh.sk, k0, BK,
              sh.sk);

  load_tile<T, D, BK>(sk, k + st.off(kK, b, hk), st.seq(kK), k0, sh.sk, 1.f,
                      sh.d);
  load_tile<T, D, BK>(sv, v + st.off(kV, b, hk), st.seq(kV), k0, sh.sk, 1.f,
                      sh.d);
  __syncthreads();
  int klo = 0, khi = 0;
  if (seg) id_range(s_kseg, k0, BK, sh.sk, klo, khi);
  float ak[RK][RD], av[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) ak[i][j] = av[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + st.off(kQ, b, h);
    const T* dob = dout + st.off(kDO, b, h);
    const int64_t row_base = (static_cast<int64_t>(b) * sh.heads + h) * sh.sq;
    for (int iq = qr.lo; iq < qr.hi; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's q, dout, ds and ids are consumed
      if (seg) {
        stage_ids(s_qseg, qs, q0, BQ, sh.sq);
        __syncthreads();
        int qlo, qhi;
        id_range(s_qseg, q0, BQ, sh.sq, qlo, qhi);
        if (qhi < klo || qlo > khi) continue;
      }
      load_tile<T, D, BQ>(sq, qb, st.seq(kQ), q0, sh.sq, sh.scale, sh.d);
      load_tile<T, D, BQ>(sdo, dob, st.seq(kDO), q0, sh.sq, 1.f, sh.d);
      if (threadIdx.x < BQ) {
        const int qpos = q0 + threadIdx.x;
        s_lse[threadIdx.x] = qpos < sh.sq ? lse[row_base + qpos] : 0.f;
        s_delta[threadIdx.x] = qpos < sh.sq ? delta[row_base + qpos] : 0.f;
      }
      __syncthreads();
      float s[RQ][RK], dp[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_mma<RQ, RK, D, LD, 1, 1, LD>(s, sq, sk);    // (q * scale) k^T
      tile_mma<RQ, RK, D, LD, 1, 1, LD>(dp, sdo, sv);  // dout v^T
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const bool ok = qpos < sh.sq &&
                          visible(sh, qpos, k0 + tx + 16 * j) &&
                          (!seg || s_qseg[r] == s_kseg[tx + 16 * j]);
          const float p = ok ? __expf(s[i][j] - s_lse[r]) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - s_delta[r]);  // ds
          sp[r * LP + tx + 16 * j] = p;
        }
      }
      __syncthreads();
      tile_mma<RK, RD, BQ, 1, LP, LD, 1>(av, sp, sdo);  // dv += p^T dout
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j)
          sp[(ty + 16 * i) * LP + tx + 16 * j] = dp[i][j];
      __syncthreads();
      tile_mma<RK, RD, BQ, 1, LP, LD, 1>(ak, sp, sq);  // dk += ds^T (q*scale)
    }
  }

  T* dkb = dk + st.off(kDK, b, hk);
  T* dvb = dv + st.off(kDV, b, hk);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= sh.sk) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      if (tx + 16 * j >= sh.d) continue;
      dkb[kpos * st.seq(kDK) + tx + 16 * j] = pt::from_f32<T>(ak[i][j]);
      dvb[kpos * st.seq(kDV) + tx + 16 * j] = pt::from_f32<T>(av[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, const Strides& st, const Shape& sh,
                       int batch, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sh.sq + kFwdBQ - 1) / kFwdBQ, sh.heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, st, sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv,
                       const Strides& st, const Shape& sh, int batch,
                       cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  constexpr size_t smem_dq = dq_smem<D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem_dq);
  if (e != cudaSuccess) return e;
  const dim3 grid_dq((sh.sq + kDqBQ - 1) / kDqBQ, sh.heads, batch);
  flash_bwd_dq_kernel<T, D><<<grid_dq, kThreads, smem_dq, s>>>(
      qp, kp, vp, static_cast<const T*>(out), dop, lse, delta,
      static_cast<T*>(dq), st, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr size_t smem_kv = dkv_smem<D>();
  e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem_kv);
  if (e != cudaSuccess) return e;
  const dim3 grid_kv((sh.sk + kKvBK - 1) / kKvBK, sh.kv_heads, batch);
  flash_bwd_dkv_kernel<T, D><<<grid_kv, kThreads, smem_kv, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      st, sh);
  return cudaGetLastError();
}

// the tile width for head size d, or 0 when none is built here: float32
// on every tile, bf16 on the 256-wide one only (bf16 up to 128 takes the
// tensor cores, flash_attention_tc.cu)
template <typename T>
int tile_width(int d) {
  if (d <= 0 || d % 8 != 0 || d > 256) return 0;
  if (!std::is_same<T, float>::value) return d > 128 ? 256 : 0;
  return d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128 : 256;
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const Strides& st, const Shape& sh, int batch,
                cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (tile_width<T>(sh.d)) {
      case 64:
        return launch_fwd<T, 64>(q, k, v, out, lse, st, sh, batch, s);
      case 96:
        return launch_fwd<T, 96>(q, k, v, out, lse, st, sh, batch, s);
      case 128:
        return launch_fwd<T, 128>(q, k, v, out, lse, st, sh, batch, s);
    }
  }
  if (tile_width<T>(sh.d) == 256)
    return launch_fwd<T, 256>(q, k, v, out, lse, st, sh, batch, s);
  return cudaErrorNotSupported;
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, const Strides& st, const Shape& sh,
                int batch, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (tile_width<T>(sh.d)) {
      case 64:
        return launch_bwd<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 st, sh, batch, s);
      case 96:
        return launch_bwd<T, 96>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 st, sh, batch, s);
      case 128:
        return launch_bwd<T, 128>(q, k, v, out, dout, lse, delta, dq, dk,
                                  dv, st, sh, batch, s);
    }
  }
  if (tile_width<T>(sh.d) == 256)
    return launch_bwd<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, st,
                              sh, batch, s);
  return cudaErrorNotSupported;
}

}  // namespace

// q: (batch, heads, sq, d), k and v: (batch, kv_heads, sk, d) and out like
// q, all of dtype `dtype` with d contiguous and 16-byte aligned rows;
// `strides` holds the (batch, head, sequence) strides of q, k, v and out in
// elements. lse: (batch, heads, sq) float32, contiguous. d is a multiple
// of 8 up to 256 (else cudaErrorNotSupported).
// qseg, kseg: (batch, sq) and (batch, sk) int32 segment ids, contiguous,
// or both null. window: a query sees its last `window` positions (itself
// included); 0 for no window.
extern "C" int pt_flash_attention_fwd(int device, const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const void* qseg, const void* kseg,
                                      const long long* strides, int batch,
                                      int heads, int kv_heads, int sq, int sk,
                                      int d, float scale, int causal,
                                      int window, int dtype, void* stream) {
  const Shape sh{heads, kv_heads, sq, sk, d, scale, causal, window,
                 static_cast<const int*>(qseg), static_cast<const int*>(kseg)};
  Strides st;
  cudaError_t e = check_args(device, batch, sh, d, strides, 4, &st);
  if (e != cudaSuccess) return e;
  if (batch == 0 || sq == 0) return cudaSuccess;
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != pt::kF32 && dtype != pt::kBF16) return cudaErrorInvalidValue;
  if (dtype == pt::kF32)
    return fwd<float>(q, k, v, out, lp, st, sh, batch, s);
  return fwd<__nv_bfloat16>(q, k, v, out, lp, st, sh, batch, s);
}

// The backward, as two launches on `stream`: dq (which also writes delta,
// (batch, heads, sq) float32 scratch), then dk and dv. `strides` holds the
// (batch, head, sequence) strides of q, k, v, out, dout, dq, dk and dv;
// dq is shaped like q, dk and dv like k; lse comes from the forward, which
// took the same qseg, kseg and window.
extern "C" int pt_flash_attention_bwd(int device, const void* q, const void* k,
                                      const void* v, const void* out,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, const void* qseg,
                                      const void* kseg,
                                      const long long* strides, int batch,
                                      int heads, int kv_heads, int sq, int sk,
                                      int d, float scale, int causal,
                                      int window, int dtype, void* stream) {
  const Shape sh{heads, kv_heads, sq, sk, d, scale, causal, window,
                 static_cast<const int*>(qseg), static_cast<const int*>(kseg)};
  Strides st;
  cudaError_t e = check_args(device, batch, sh, d, strides, kNumTensors, &st);
  if (e != cudaSuccess) return e;
  if (batch == 0 || sq == 0 || sk == 0) return cudaSuccess;
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != pt::kF32 && dtype != pt::kBF16) return cudaErrorInvalidValue;
  if (dtype == pt::kF32)
    return bwd<float>(q, k, v, out, dout, lp, dl, dq, dk, dv, st, sh, batch,
                      s);
  return bwd<__nv_bfloat16>(q, k, v, out, dout, lp, dl, dq, dk, dv, st, sh,
                            batch, s);
}
