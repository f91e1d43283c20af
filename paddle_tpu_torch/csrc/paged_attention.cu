// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::paged_decode_attention
// (pallas_call in _run, body _body) in all three of its modes: bf16 or
// f32 pages of q's dtype (K8), and int8 pages (K8q) dequantized with
// either per-row scales (NB, Hkv, BS) f32 that ride with their page (the
// ServingEngine's QuantPagedKVCache) or global per-(kv head, dim) scales
// (Hkv, D) f32 (block_multihead_attention's static cache scales). For
// batch row b and query head h:
//
//   out[b, 0, h] = softmax(scale * q[b, 0, h] . K_b^T) V_b
//
// over the row's first context_lens[b] positions, where position p of
// the row lives in page block_tables[b, p / BS] at slot p % BS of the
// (NB, Hkv, BS, D) pools, and query head h reads kv head h / (Hq / Hkv).
// Page ids are clamped to [0, NB - 1] and context_lens to
// [0, MAXB * BS], as the TPU kernel does; positions past the count are
// masked, and a row with no valid position returns zeros. An int8 K or V
// element is multiplied by its scale (its row's, or its (head, dim)
// one) before the dot, as the TPU body does.
//
// Bound: bytes. Every valid K and V row is read once: ctx * Hkv * D * 2
// elements per batch row (one byte each for int8, plus a 4-byte scale
// per row and head in the per-row mode), against 4 * D float operations
// per query head per position, so even a GQA group of 8 stays far below
// the ~295 operations per byte where arithmetic would bound the card.
// Design: one block per (batch row, kv head), which loads its own
// block-table row. The G = Hq / Hkv query heads that share the kv head
// are held in registers and read each K/V row once, with 16-byte loads
// (8-byte for int8, so an int8 row takes as many threads as a bf16 one),
// so GQA costs no extra bytes. The block walks its context in tiles of
// 64 positions: scores into shared memory, an online-softmax update in
// float32 (one warp per head), then P.V accumulated in registers; the
// partial sums of the thread rows are added once at the end. The TPU
// kernel's dense head-match mask was a Mosaic constraint, not semantics,
// and is gone. Left for a later PR: split-K over the context (at batch 4
// and 32 kv heads there are fewer blocks than the card's 132 SMs) and
// cp.async or TMA prefetch of the next tile.
//
// Groups and head sizes (fault E2 of ROADMAP.md): the TPU kernel takes
// any group Hq % Hkv == 0 and any D % 8 == 0 (the model's dispatch). The
// kernel is compiled for G = 1, 2, 4 or 8 query heads per block; a kv
// head whose group is not one of those has its heads cut into chunks of
// the smallest of them that holds the group (8 for larger groups: a
// grid of (batch row, kv head x chunk) blocks, the last chunk's missing
// heads riding along with zero queries, unwritten). A row of D elements
// takes the smallest power of two of threads that holds its loads, the
// threads past D idle (D = 80 of bf16: 10 loads on 16 threads). A
// float32 row wider than 128 loads 8 elements (two 16-byte loads) per
// thread, so D up to 256 fits a warp in every dtype. The groups and
// widths of Llama's shapes run as before: one chunk, no idle thread.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // positions per tile: two per lane in the softmax
constexpr float kNegInf = -1e30f;

// how an element of the pools becomes a float: as it is, times its row's
// scale, or times its (kv head, dim) scale
enum ScaleMode : int { kNoScale = 0, kRowScale = 1, kHeadDimScale = 2 };

template <int SM>
__device__ __forceinline__ float dequant(float x, float row, float col) {
  if constexpr (SM == kRowScale) return x * row;
  if constexpr (SM == kHeadDimScale) return x * col;
  return x;
}

template <typename T, typename KV, int G, int SM, int VEC>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ tables,
    const int* __restrict__ lens, T* __restrict__ out, int hq, int hkv, int d,
    int nb, int bs, int maxb, float scale, int lpr, int nchunk) {
  using P = pt::Pack<KV, VEC>;
  extern __shared__ float smem[];
  float* s_p = smem;                // [G][kTile] scores, then probabilities
  float* s_alpha = s_p + G * kTile;  // [G] rescale for this tile
  float* s_m = s_alpha + G;          // [G] running max
  float* s_l = s_m + G;              // [G] running sum
  float* s_red = s_l + G;            // [rows][G][d] partial outputs

  const int b = blockIdx.x, kvh = blockIdx.y / nchunk;
  const int group = hq / hkv;
  const int g0 = (blockIdx.y % nchunk) * G;  // the chunk's first head
  const int gn = min(G, group - g0);         // heads written
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lpr threads per K/V row, a power of two; those past d hold nothing
  const int chunk = threadIdx.x % lpr;    // this thread's VEC-wide slice of d
  const int row = threadIdx.x / lpr;      // this thread's first row of a tile
  const int rows = kThreads / lpr;        // rows a tile pass covers
  const bool act = chunk * VEC < d;

  const int len = min(max(lens[b], 0), maxb * bs);
  const int* tbl = tables + static_cast<int64_t>(b) * maxb;
  const int64_t head_stride = static_cast<int64_t>(bs) * d;
  const int64_t page_stride = head_stride * hkv;
  const int64_t kv_off = kvh * head_stride + chunk * VEC;
  const int64_t q_off = (static_cast<int64_t>(b) * hq + kvh * group + g0) * d;

  float qr[G][VEC];
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qr[g][j] = act && g < gn
                     ? pt::to_f32(q[q_off + g * d + chunk * VEC + j]) * scale
                     : 0.f;
      acc[g][j] = 0.f;
    }
  }
  // (kv head, dim) scales of this thread's slice, or the per-row scales'
  // (page, head) offset
  float ks[VEC], vs[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ks[j] = SM == kHeadDimScale && act ? kscale[kvh * d + chunk * VEC + j]
                                       : 1.f;
    vs[j] = SM == kHeadDimScale && act ? vscale[kvh * d + chunk * VEC + j]
                                       : 1.f;
  }
  const int64_t srow_off = static_cast<int64_t>(kvh) * bs;
  if (threadIdx.x < G) {
    s_m[threadIdx.x] = kNegInf;
    s_l[threadIdx.x] = 0.f;
  }

  for (int t0 = 0; t0 < len; t0 += kTile) {
    // scores: the lpr threads of one row each dot their slice, then sum
    for (int r = row; r < kTile; r += rows) {
      const int pos = t0 + r;
      float sc[G];
      if (pos < len && act) {
        const int page = min(max(tbl[pos / bs], 0), nb - 1);
        const P k = *reinterpret_cast<const P*>(
            kc + page * page_stride + kv_off +
            static_cast<int64_t>(pos % bs) * d);
        const float krow =
            SM == kRowScale
                ? kscale[page * static_cast<int64_t>(hkv) * bs + srow_off +
                         pos % bs]
                : 1.f;
        float kf[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          kf[j] = dequant<SM>(pt::to_f32(k.v[j]), krow, ks[j]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) s += qr[g][j] * kf[j];
          sc[g] = s;
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = 0.f;
      }
      for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
      }
      if (chunk == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          s_p[g * kTile + r] = pos < len ? sc[g] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sp = s_p + g * kTile;
      const float s0 = sp[lane], s1 = sp[lane + 32];
      float mt = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = t0 + lane < len ? expf(s0 - m_new) : 0.f;
      const float p1 = t0 + lane + 32 < len ? expf(s1 - m_new) : 0.f;
      float ps = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      sp[lane] = p0;
      sp[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        s_alpha[g] = a;
        s_l[g] = s_l[g] * a + ps;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: rescale the running sums, then add this tile's rows
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = s_alpha[g];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] *= a;
    }
    for (int r = row; r < kTile; r += rows) {
      const int pos = t0 + r;
      if (pos >= len || !act) break;
      const int page = min(max(tbl[pos / bs], 0), nb - 1);
      const P v = *reinterpret_cast<const P*>(
          vc + page * page_stride + kv_off +
          static_cast<int64_t>(pos % bs) * d);
      const float vrow =
          SM == kRowScale
              ? vscale[page * static_cast<int64_t>(hkv) * bs + srow_off +
                       pos % bs]
              : 1.f;
      float vf[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        vf[j] = dequant<SM>(pt::to_f32(v.v[j]), vrow, vs[j]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = s_p[g * kTile + r];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] += p * vf[j];
      }
    }
    __syncthreads();  // the next tile overwrites s_p
  }

  // add the partial sums of the thread rows and normalise
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (act) s_red[(row * G + g) * d + chunk * VEC + j] = acc[g][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * d; i += kThreads) {
    const int g = i / d, c = i % d;
    float sum = 0.f;
    for (int k = 0; k < rows; ++k) sum += s_red[(k * G + g) * d + c];
    out[q_off + g * d + c] = pt::from_f32<T>(sum / fmaxf(s_l[g], 1e-30f));
  }
}

struct Args {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  const int *tables, *lens;
  void* out;
  int batch, hq, hkv, d, nb, bs, maxb;
  float scale;
};

template <typename T, typename KV, int G, int SM, int VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // a row is lpr = 1..32 threads wide, a power of two, so a warp holds
  // whole rows
  const int lpr = pt::pow2_at_least(a.d / VEC);
  if (lpr > 32) return cudaErrorNotSupported;
  const int group = a.hq / a.hkv;
  const int nchunk = (group + G - 1) / G;
  if (static_cast<int64_t>(a.hkv) * nchunk > 65535)
    return cudaErrorInvalidValue;
  const int rows = kThreads / lpr;
  const size_t smem = sizeof(float) * (G * kTile + 3 * G +
                                       static_cast<size_t>(rows) * G * a.d);
  paged_decode_kernel<T, KV, G, SM, VEC>
      <<<dim3(a.batch, a.hkv * nchunk), kThreads, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.kc),
          static_cast<const KV*>(a.vc), a.ks, a.vs, a.tables, a.lens,
          static_cast<T*>(a.out), a.hq, a.hkv, a.d, a.nb, a.bs, a.maxb,
          a.scale, lpr, nchunk);
  return cudaGetLastError();
}

// G: the smallest of 1, 2, 4, 8 that holds the group (8 for larger
// groups, in chunks); float32 rows wider than 128 load 8 elements per
// thread and take at most 4 heads per chunk (registers)
template <typename T, typename KV, int SM>
cudaError_t by_group(const Args& a, cudaStream_t s) {
  constexpr int kVec = pt::KVVec<KV>::n;
  const int group = a.hq / a.hkv;
  if (a.d > 256 || a.d % kVec != 0) return cudaErrorNotSupported;
  if (a.d > 32 * kVec) {
    if constexpr (kVec == 4) {
      if (a.d % 8) return cudaErrorNotSupported;
      if (group <= 1) return launch<T, KV, 1, SM, 8>(a, s);
      if (group <= 2) return launch<T, KV, 2, SM, 8>(a, s);
      return launch<T, KV, 4, SM, 8>(a, s);
    }
    return cudaErrorNotSupported;
  }
  if (group <= 1) return launch<T, KV, 1, SM, kVec>(a, s);
  if (group <= 2) return launch<T, KV, 2, SM, kVec>(a, s);
  if (group <= 4) return launch<T, KV, 4, SM, kVec>(a, s);
  return launch<T, KV, 8, SM, kVec>(a, s);
}

template <typename T>
cudaError_t by_mode(const Args& a, int mode, cudaStream_t s) {
  switch (mode) {
    case kNoScale:
      return by_group<T, T, kNoScale>(a, s);
    case kRowScale:
      return by_group<T, int8_t, kRowScale>(a, s);
    case kHeadDimScale:
      return by_group<T, int8_t, kHeadDimScale>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (batch, 1, hq, d) of `dtype`; kc, vc: (nb, hkv, bs, d) pools of
// `dtype` (scale_mode 0), or int8 with float32 scales kscale, vscale of
// shape (nb, hkv, bs) (scale_mode 1, per row) or (hkv, d) (scale_mode 2);
// all contiguous. tables: (batch, maxb) int32; lens: (batch,) int32.
// Any hq % hkv == 0; d a multiple of 8 (bf16, int8) or 4 (f32) up to 256
// (a float32 d above 128 a multiple of 8), else cudaErrorNotSupported.
extern "C" int pt_paged_decode_attention(
    int device, const void* q, const void* kc, const void* vc,
    const void* kscale, const void* vscale, const void* tables,
    const void* lens, void* out, int batch, int hq, int hkv, int d, int nb,
    int bs, int maxb, float scale, int dtype, int scale_mode, void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (batch < 0 || hkv <= 0 || hq % hkv != 0 || nb <= 0 || bs <= 0 ||
      maxb < 0 || hkv > 65535)
    return cudaErrorInvalidValue;
  if (scale_mode != kNoScale && (kscale == nullptr || vscale == nullptr))
    return cudaErrorInvalidValue;
  if (!pt::aligned16(kc) || !pt::aligned16(vc))
    return cudaErrorMisalignedAddress;
  if (batch == 0) return cudaSuccess;
  const Args a{q, kc, vc, static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(tables), static_cast<const int*>(lens),
               out, batch, hq, hkv, d, nb, bs, maxb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return by_mode<float>(a, scale_mode, s);
  if (dtype == pt::kBF16) return by_mode<__nv_bfloat16>(a, scale_mode, s);
  return cudaErrorInvalidValue;
}
