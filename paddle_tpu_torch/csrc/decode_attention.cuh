// The decode-attention kernel template shared by decode_attention.cu
// (head sizes 33..128, Llama's and Qwen2's rows) and
// decode_attention_any.cu (head sizes up to 32 and 129..256) over
// contiguous caches, and by paged_attention.cu / paged_attention_any.cu
// over the pages of a block table: one template, compiled for G = 1, 2,
// 4, 8 query heads per block, rows padded to DMAX = 16, 32, 64, 128 or
// 256 elements, and three address modes (Mode). See decode_attention.cu
// and paged_attention.cu for what it computes and why.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace pt_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // K/V tiles in the shared-memory ring
constexpr int kMaxSplits = 256;   // context splits of one (row, kv head)
constexpr float kNegInf = -1e30f;
// page ids of one split staged in shared memory (a split of at most
// MAX_SPLIT_TILES = 8 tiles of 64 positions spans at most 512 pages at a
// block size of 1, 257 at 2); a split that spans more reads the table
constexpr int kTblCap = 520;

// Where position p of a row lives, and how int8 codes are scaled:
// kContig, at p * pos_stride of a (batch, kv head) base of a contiguous
// cache, (Hkv, D) scales (K7, K9); kPaged, in page block_tables[b, p /
// bs] at slot p % bs of (NB, Hkv, bs, D) pools, (Hkv, D) scales or none
// (K8, K8q's head-dim mode); kPagedRows, the same pages with a float32
// scale per (page, kv head, slot) (K8q's row mode).
enum Mode : int { kContig = 0, kPaged = 1, kPagedRows = 2 };

// The shape of one instantiation: T queries, KV elements, G query heads
// per block, rows padded to DMAX elements (lanes past the head size hold
// nothing).
template <typename T, typename KV, int G, int DMAX, int MODE = kContig>
struct Geo {
  // float32 q takes the plain version's order of operations (see
  // decode_kernel), bf16 q the folded, online one
  static constexpr bool kRef = std::is_same<T, float>::value;
  static constexpr int kRowBytes = DMAX * static_cast<int>(sizeof(KV));
  // elements of a row one lane reads from shared memory: 16 bytes of
  // bf16 (8 bytes of int8) or float32; float32 rows past 128 take 8 (G
  // <= 4 there) so that a row fits a warp
  static constexpr int VEC = sizeof(KV) == 4 ? (DMAX > 128 ? 8 : 4) : 8;
  static constexpr int LPR = DMAX / VEC;      // lanes per row
  static constexpr int ROWS = kThreads / LPR;  // thread rows of a block
  // positions per tile: one K (and one V) tile is 2-8 KB (16-32 KB of
  // float32 at D 128 / 256)
  static constexpr int TILE = kRowBytes <= 128 ? 64 : 32;
  static constexpr int IT = TILE / ROWS;      // tile rows of each thread
  // rows a thread scores before its softmax update (IB * G scores live)
  static constexpr int IB = IT < 16 / G ? IT : (16 / G > 0 ? 16 / G : 1);
  static constexpr int kTileBytes = TILE * kRowBytes;
  // K tile, V tile, and in row-scale mode their rows' K and V scales
  static constexpr int kScaleBytes = MODE == kPagedRows ? 2 * TILE * 4 : 0;
  static constexpr int kStageBytes = 2 * kTileBytes + kScaleBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the partial sums added at the end: one per warp (the online path
  // adds a warp's thread rows by a butterfly first), one per thread row
  // in the plain version's order
  static constexpr int NR = kRef ? ROWS : kWarps;
  static constexpr int kRedBytes = NR * G * DMAX * 4;
  static constexpr int kSmem = kRingBytes > kRedBytes ? kRingBytes
                                                      : kRedBytes;
  static_assert(LPR >= 2 && LPR <= 32 && (LPR & (LPR - 1)) == 0, "lanes");
  static_assert(IT >= 1 && IT * ROWS == TILE && IT % IB == 0, "rows");
  static_assert(kRowBytes % 16 == 0, "rows of whole 16-byte copies");
  static_assert(2 * TILE <= kThreads, "a thread per row scale");
};

struct Args {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  const int *vlens, *starts;
  int vlen_all, start_all;
  void* out;
  float *part_acc, *part_ml;  // the splits' partial states (nsplit > 1)
  int* counters;              // one per (batch row, kv head, head chunk)
  int batch, s_len, hq, hkv, d, nsplit, chunk, nchunk;
  // element strides of a cache's (batch, kv head, position) axes
  int64_t b_stride, h_stride, pos_stride;
  float scale;
  int wide;  // rows take 16-byte copies (else 8-byte: int8 rows that are
             // not 16-byte aligned)
  // paged modes: the (batch, maxb) int32 block table, the pool's nb
  // pages of page_stride elements, bs positions a page (bs_shift its
  // log2, or -1); s_len is maxb * bs
  const int* tables;
  int maxb, nb, bs, bs_shift;
  int64_t page_stride;
};

// What the host needs to size a launch of one instantiation.
struct Plan {
  int blocks_per_sm, tile, stages, heads, nchunk, regs, local_bytes;
};

// 8 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// W 32-bit words of one lane's slice of a row, read as one shared-memory
// load (two for W = 8)
template <int W>
struct alignas(W * 4 < 16 ? W * 4 : 16) Words {
  uint32_t w[W];
};

// The VEC elements of a slice as float32, exactly: bf16 by a shift,
// int8 codes by a float magic number (2^23 + code + 128, minus
// 2^23 + 128).
template <typename KV, int VEC>
__device__ __forceinline__ void load_f32(const KV* p, float (&f)[VEC]) {
  constexpr int W = VEC * static_cast<int>(sizeof(KV)) / 4;
  const Words<W> x = *reinterpret_cast<const Words<W>*>(p);
  if constexpr (std::is_same<KV, float>::value) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = __uint_as_float(x.w[j]);
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      f[2 * k] = __uint_as_float(x.w[k] << 16);
      f[2 * k + 1] = __uint_as_float(x.w[k] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t u = x.w[k] ^ 0x80808080u;  // each byte code + 128
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * k + j] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) -
            8388736.f;
    }
  }
}

// Sums x[0..N) over the lanes of a row group (lanes that differ in the
// bits below 2 O), every lane ending with every sum, bit for bit the
// same: a reduce-scatter (each level halves the values a lane holds)
// down to one value, then an all-gather on the way back up; 2 (N - 1)
// shuffles for N values over as many lanes, where a butterfly on each
// value takes N log2(lanes).
template <int N0, int N, int O>
__device__ __forceinline__ void row_sum(float (&x)[N0], int lane) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool hi = lane & O;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = hi ? x[k] : x[k + H];
        const float keep = hi ? x[k + H] : x[k];
        x[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      row_sum<N0, H, O / 2>(x, lane);
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float mine = x[k];
        const float other = __shfl_xor_sync(0xffffffffu, mine, O);
        x[k] = hi ? other : mine;
        x[k + H] = hi ? mine : other;
      }
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], O);
      row_sum<N0, 1, O / 2>(x, lane);
    }
  }
}

// A probability from a score: bf16 queries keep their scores in log2
// units (log2 e folded into q), so it is one exp2 on the special-function
// unit (2 ulp); float32 queries keep the plain version's natural units
// and expf.
template <bool kRef>
__device__ __forceinline__ float ex(float x) {
  if constexpr (kRef)
    return expf(x);
  else
    return exp2f(x);
}

// One block per (context split, kv head x head chunk, batch row): the
// chunk's G query heads (gn of them real) against the split's slice of
// the row's window. Thread t owns VEC columns (slice t % LPR) of the
// rows t / LPR + k * ROWS of every tile and keeps its own running max,
// sum and output slice over them (an online softmax per thread row);
// the block merges its thread rows at the end, and the last split to
// finish merges the splits.
//
// float32 q (kRef) takes the plain version's order of operations
// instead: natural units and expf, each int8 code times its scale
// before the dot and the sum, and a first pass over the split's K tiles
// for its max, so that each probability is exp(s - max) once and nothing
// is rescaled. A tile's probabilities are summed pairwise (position i
// with i + 32 of a 64-position tile, then a butterfly), the tiles in
// order, and the thread rows' output sums in row order. A float32
// model that quantizes the
// rows this output produced (an int8 cache) is the one caller whose
// result hangs on these last bits.
//
// The paged modes differ only in where a tile's rows come from: the
// split's page ids are staged in shared memory once (clamped to the
// pool), and each copy's address is its page's plus its slot's. In row-
// scale mode each tile's K and V row scales ride in the ring beside it:
// bf16 q folds K's into the row's score and V's into its probability,
// float32 q multiplies each code by its scale before the dot, as the
// plain version does.
template <typename T, typename KV, int G, int DMAX, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(const Args a) {
  using GG = Geo<T, KV, G, DMAX, MODE>;
  constexpr int VEC = GG::VEC, LPR = GG::LPR, ROWS = GG::ROWS;
  constexpr int TILE = GG::TILE, IT = GG::IT, IB = GG::IB, NR = GG::NR;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr bool kRef = GG::kRef;
  constexpr bool kPage = MODE != kContig;
  constexpr bool kRows = MODE == kPagedRows;  // a scale per row
  static_assert(!kRows || kQuant, "row scales go with int8 pages");
  constexpr bool kColScale = kQuant && !kRows;  // (Hkv, D) scales
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_mw[kWarps][G];  // each warp's max per head
  __shared__ float s_lw[kWarps][G];  // each warp's sum per head
  // kRef: two tiles' probabilities [buffer][head][tile row], the sum of
  // one read while the next is written
  __shared__ float s_p[kRef ? 2 : 1][kRef ? G * TILE : 1];
  __shared__ float s_ps[G];  // kRef: the sum of the probabilities per head
  __shared__ int s_last;
  __shared__ int s_tbl[kPage ? kTblCap : 1];  // the split's page ids

  const T* q = static_cast<const T*>(a.q);
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / a.nchunk;
  const int group = a.hq / a.hkv;
  const int g0 = (blockIdx.y % a.nchunk) * G;  // first head of the chunk
  const int gn = min(G, group - g0);           // heads written
  const int D = a.d;
  const int nsplit = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ci = threadIdx.x % LPR;   // this thread's VEC-wide slice
  const int row = threadIdx.x / LPR;  // this thread's first tile row
  const bool act = ci * VEC < D;      // the slice lies in the row

  // the window [start, end) clipped to the cache, then to this split
  const int end = min(a.vlens ? a.vlens[b] : a.vlen_all, a.s_len);
  const int start = min(max(a.starts ? a.starts[b] : a.start_all, 0),
                        a.s_len);
  const int lo = max(start, split * a.chunk);
  const int hi = min(end, (split + 1) * a.chunk);
  const int ntiles = hi > lo ? (hi - lo + TILE - 1) / TILE : 0;

  const int64_t kv0 = (kPage ? 0 : b * a.b_stride) + kvh * a.h_stride;
  const KV* kbase = static_cast<const KV*>(a.kc) + kv0;
  const KV* vbase = static_cast<const KV*>(a.vc) + kv0;
  const int64_t head0 = static_cast<int64_t>(b) * a.hq + kvh * group + g0;

  // paged: the table entry of position p, and the pages [p0, p0 + np)
  // of the split's positions, staged once where they fit (else each
  // copy reads its entry from the table)
  const int* trow =
      kPage ? a.tables + static_cast<int64_t>(b) * a.maxb : nullptr;
  auto page_index = [&](int p) {
    return a.bs_shift >= 0 ? p >> a.bs_shift : p / a.bs;
  };
  const int p0 = kPage && ntiles > 0 ? page_index(lo) : 0;
  const int np = kPage && ntiles > 0 ? page_index(hi - 1) - p0 + 1 : 0;
  const bool staged = np <= kTblCap;
  auto page_at = [&](int pi) -> int64_t {
    const int id = staged ? s_tbl[pi - p0]
                          : min(max(__ldg(trow + pi), 0), a.nb - 1);
    return id;
  };
  // the element offset of position p's row from the base
  auto row_off = [&](int p) -> int64_t {
    if constexpr (kPage) {
      const int pi = page_index(p);
      return page_at(pi) * a.page_stride +
             static_cast<int64_t>(p - pi * a.bs) * a.pos_stride;
    } else {
      return p * a.pos_stride;
    }
  };

  // tile t of the split into ring stage t % kStages: K rows, then (with
  // with_v) V rows, DMAX elements apart; positions past the slice and
  // columns past the head size are zero-filled. One commit group per
  // call.
  auto issue = [&](int t, bool with_v) {
    if (t < ntiles) {
      const int t0 = lo + t * TILE;
      const uint32_t sk = smem_addr(smem + (t % kStages) * GG::kStageBytes);
      const uint32_t sv = sk + GG::kTileBytes;
      if (a.wide) {
        constexpr int CPR = GG::kRowBytes / 16;  // copies of a padded row
        const int cpr = D * static_cast<int>(sizeof(KV)) / 16;
#pragma unroll
        for (int k = 0; k < (TILE * CPR + kThreads - 1) / kThreads; ++k) {
          const int i = threadIdx.x + k * kThreads;
          if ((TILE * CPR) % kThreads == 0 || i < TILE * CPR) {
            const int r = i / CPR, c = i % CPR;
            const bool full = t0 + r < hi && c < cpr;
            const int64_t off =
                full ? row_off(t0 + r) + c * (16 / sizeof(KV)) : 0;
            cp_async16(sk + i * 16, kbase + off, full);
            if (with_v) cp_async16(sv + i * 16, vbase + off, full);
          }
        }
      } else {
        constexpr int CPR = GG::kRowBytes / 8;
        const int cpr = D * static_cast<int>(sizeof(KV)) / 8;
#pragma unroll
        for (int k = 0; k < (TILE * CPR + kThreads - 1) / kThreads; ++k) {
          const int i = threadIdx.x + k * kThreads;
          if ((TILE * CPR) % kThreads == 0 || i < TILE * CPR) {
            const int r = i / CPR, c = i % CPR;
            const bool full = t0 + r < hi && c < cpr;
            const int64_t off =
                full ? row_off(t0 + r) + c * (8 / sizeof(KV)) : 0;
            cp_async8(sk + i * 8, kbase + off, full);
            if (with_v) cp_async8(sv + i * 8, vbase + off, full);
          }
        }
      }
      if constexpr (kRows) {
        // thread i < TILE: tile row i's K scale; TILE + i: its V scale
        const int i = threadIdx.x, r = i % TILE;
        if (i < (with_v ? 2 : 1) * TILE) {
          const bool full = t0 + r < hi;
          int64_t off = 0;
          if (full) {
            const int p = t0 + r, pi = page_index(p);
            off = (page_at(pi) * a.hkv + kvh) * a.bs + (p - pi * a.bs);
          }
          cp_async4(sv + GG::kTileBytes + i * 4,
                    (i < TILE ? a.ks : a.vs) + off, full);
        }
      }
    }
    cp_async_commit();
  };

  // paged: the table entries are loaded beside q, and staged before the
  // first copy
  constexpr int kTblPer = kPage ? (kTblCap + kThreads - 1) / kThreads : 1;
  int ent[kTblPer];
#pragma unroll
  for (int k = 0; k < kTblPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    ent[k] = kPage && staged && i < np ? __ldg(trow + p0 + i) : 0;
  }
  if constexpr (!kPage) {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t, !kRef);
  }

  // q * scale (* log2 e: scores in log2 units), and for bf16 q times the
  // K scale of each column in int8 mode, so a code needs no multiply of
  // its own; float32 q keeps the scales of its columns beside it
  const float qscale = a.scale * (kRef ? 1.f : 1.4426950408889634f);
  float qr[G][VEC], ksr[VEC], vsr[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = ci * VEC + j;
    const float ks = kColScale && act ? a.ks[kvh * D + c] : 1.f;
    ksr[j] = ks;
    vsr[j] = kColScale && kRef && act ? a.vs[kvh * D + c] : 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
      qr[g][j] = act && g < gn
                     ? pt::to_f32(q[(head0 + g) * D + c]) * qscale *
                           (kRef ? 1.f : ks)
                     : 0.f;
  }
  float acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }
  if constexpr (kPage) {
#pragma unroll
    for (int k = 0; k < kTblPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (staged && i < np) s_tbl[i] = min(max(ent[k], 0), a.nb - 1);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t, !kRef);
  }

  // the scores of IB rows (from row i0 of the thread's rows) of the K
  // tile at sk: the LPR lanes of a row each dot their slice, then sum
  // them (every lane of the row holds every score)
  auto scores = [&](const KV* sk, int i0, float (&sc)[IB * G]) {
    // row-scale mode: the tile's K row scales lie past its V tile
    const float* srow = reinterpret_cast<const float*>(
        reinterpret_cast<const unsigned char*>(sk) + 2 * GG::kTileBytes);
#pragma unroll
    for (int i = 0; i < IB; ++i) {
      float kf[VEC];
      if (act) {
        load_f32<KV, VEC>(sk + (row + (i0 + i) * ROWS) * DMAX + ci * VEC,
                          kf);
        if constexpr (kColScale && kRef) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) kf[j] *= ksr[j];
        } else if constexpr (kRows && kRef) {
          const float s = srow[row + (i0 + i) * ROWS];
#pragma unroll
          for (int j = 0; j < VEC; ++j) kf[j] *= s;
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) s = fmaf(qr[g][j], kf[j], s);
        sc[i * G + g] = s;
      }
    }
    row_sum<IB * G, IB * G, LPR / 2>(sc, lane);
    if constexpr (kRows && !kRef) {
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const float s = srow[row + (i0 + i) * ROWS];
#pragma unroll
        for (int g = 0; g < G; ++g) sc[i * G + g] *= s;
      }
    }
  };
  // the block's max of m per head into mb: a warp butterfly over its
  // thread rows, then the warps in order
  auto block_max = [&](float (&mb)[G]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mw = m[g];
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
      if (lane == 0) s_mw[warp][g] = mw;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mb[g] = s_mw[0][g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mb[g] = fmaxf(mb[g], s_mw[w][g]);
    }
  };

  // kRef: the sum per head of one tile's probabilities sp, by halves,
  // then a butterfly over the warp that owns head g (g % kWarps), added
  // to s_ps[g] by its lane 0
  if constexpr (kRef) {
    if (threadIdx.x < G) s_ps[threadIdx.x] = 0.f;  // read after a barrier
  }
  auto tile_sum = [&](const float* sp) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g % kWarps == warp) {
        float v = sp[g * TILE + lane];
        if constexpr (TILE == 64) v += sp[g * TILE + lane + 32];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) s_ps[g] += v;
      }
    }
  };

  if constexpr (kRef) {
    // a first pass over the K tiles finds the split's max per head
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(t + kStages - 1, false);
      const KV* sk = reinterpret_cast<const KV*>(
          smem + (t % kStages) * GG::kStageBytes);
      const int t0 = lo + t * TILE;
#pragma unroll
      for (int i0 = 0; i0 < IT; i0 += IB) {
        float sc[IB * G];
        scores(sk, i0, sc);
#pragma unroll
        for (int i = 0; i < IB; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (t0 + row + (i0 + i) * ROWS < hi)
              m[g] = fmaxf(m[g], sc[i * G + g]);
      }
    }
    cp_async_wait<0>();
    float mb[G];
    block_max(mb);  // its barrier also frees the ring
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = mb[g];
    __syncthreads();  // s_mw is read
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t, true);
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t
    __syncthreads();  // everyone's; and stage (t - 1) % kStages is read
    issue(t + kStages - 1, true);
    if constexpr (kRef) {
      if (t > 0) tile_sum(s_p[(t - 1) & 1]);  // written before the barrier
    }
    const KV* sk = reinterpret_cast<const KV*>(
        smem + (t % kStages) * GG::kStageBytes);
    const KV* sv = sk + TILE * DMAX;
    const int t0 = lo + t * TILE;
#pragma unroll
    for (int i0 = 0; i0 < IT; i0 += IB) {
      float sc[IB * G];  // [row][head]
      scores(sk, i0, sc);
      // this thread row's online softmax over the IB rows
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int i = 0; i < IB; ++i) {
          const bool in = t0 + row + (i0 + i) * ROWS < hi;
          sc[i * G + g] = in ? sc[i * G + g] : kNegInf;
          mx = fmaxf(mx, sc[i * G + g]);
        }
        const float alpha = ex<kRef>(m[g] - mx);
        m[g] = mx;
        float ps = 0.f;
#pragma unroll
        for (int i = 0; i < IB; ++i) {
          const bool in = t0 + row + (i0 + i) * ROWS < hi;
          sc[i * G + g] = in ? ex<kRef>(sc[i * G + g] - mx) : 0.f;
          ps += sc[i * G + g];
        }
        l[g] = l[g] * alpha + ps;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] *= alpha;
      }
      if constexpr (kRef) {
        if (ci == 0) {
#pragma unroll
          for (int i = 0; i < IB; ++i)
#pragma unroll
            for (int g = 0; g < G; ++g)
              s_p[t & 1][g * TILE + row + (i0 + i) * ROWS] = sc[i * G + g];
        }
      }
      // P.V over the same rows (zero-filled past the slice)
      if (act) {
        const float* svs = reinterpret_cast<const float*>(
                               reinterpret_cast<const unsigned char*>(sk) +
                               2 * GG::kTileBytes) +
                           TILE;  // row-scale mode: the V row scales
#pragma unroll
        for (int i = 0; i < IB; ++i) {
          float vf[VEC];
          load_f32<KV, VEC>(sv + (row + (i0 + i) * ROWS) * DMAX + ci * VEC,
                            vf);
          float vrow = 1.f;
          if constexpr (kRows) vrow = svs[row + (i0 + i) * ROWS];
          if constexpr (kColScale && kRef) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) vf[j] *= vsr[j];
          } else if constexpr (kRows && kRef) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) vf[j] *= vrow;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p =
                kRows && !kRef ? sc[i * G + g] * vrow : sc[i * G + g];
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[g][j] = fmaf(p, vf[j], acc[g][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // merge the thread rows: the block's max per head (warp butterfly,
  // then the warps in order), each row's state rescaled to it (kRef: by
  // 1) and summed in order through shared memory, which the ring no
  // longer needs: online, a warp's rows by a butterfly first and then
  // the warps; kRef, the thread rows one by one, the sum of the
  // probabilities from the tiles' sums
  float mb[G];
  block_max(mb);  // its barrier also shows the last tile's s_p
  if constexpr (kRef) {
    if (ntiles > 0) tile_sum(s_p[(ntiles - 1) & 1]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float f = ex<kRef>(m[g] - mb[g]);
    l[g] *= f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] *= f;
    if constexpr (!kRef) {
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem);  // [NR][G][DMAX]
  if ((kRef || lane < LPR) && act) {
    const int slot = kRef ? row : warp;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        red[(slot * G + g) * DMAX + ci * VEC + j] = acc[g][j];
  }
  if (lane == 0) {
    // kRef: warp g % kWarps holds head g's sum, the others add 0
#pragma unroll
    for (int g = 0; g < G; ++g)
      s_lw[warp][g] = kRef ? (g % kWarps == warp ? s_ps[g] : 0.f) : l[g];
  }
  __syncthreads();

  // the block's unnormalised output per head, the V scale applied; one
  // split normalises and writes it, several write their partial state
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D, c = i % D;
    float sum = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NR; ++w) sum += red[(w * G + g) * DMAX + c];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) den += s_lw[w][g];
    if (kColScale && !kRef) sum *= a.vs[kvh * D + c];
    if (nsplit == 1)
      out[(head0 + g) * D + c] = pt::from_f32<T>(sum / fmaxf(den, 1e-30f));
    else
      a.part_acc[((head0 + g) * nsplit + split) * D + c] = sum;
  }
  if (nsplit == 1) return;
  if (threadIdx.x < gn) {
    float mb = s_mw[0][threadIdx.x], den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mb = fmaxf(mb, s_mw[w][threadIdx.x]);
      den += s_lw[w][threadIdx.x];
    }
    float* ml = a.part_ml + ((head0 + threadIdx.x) * nsplit + split) * 2;
    ml[0] = mb;
    ml[1] = den;
  }

  // a ticket on the (row, kv head, chunk) counter: the last split to
  // arrive combines every split's state in split order (the same bits
  // whichever block is last), then resets the counter for the next
  // launch on the stream
  __threadfence();
  __syncthreads();
  int* counter = a.counters + static_cast<int64_t>(b) * gridDim.y +
                 blockIdx.y;
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // one pass over the splits in split order, an online softmax over
  // their states: four columns a thread, eight splits' loads in flight
  const int D4 = D / 4;
  for (int i = threadIdx.x; i < gn * D4; i += kThreads) {
    const int g = i / D4, c4 = i % D4;
    const float4* pa = reinterpret_cast<const float4*>(
                           a.part_acc + (head0 + g) * nsplit * D) +
                       c4;
    const float2* ml =
        reinterpret_cast<const float2*>(a.part_ml) + (head0 + g) * nsplit;
    float m = kNegInf, l = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](float2 st, float4 x) {
      const float mn = fmaxf(m, st.x);
      const float f = ex<kRef>(m - mn), w = ex<kRef>(st.x - mn);
      m = mn;
      l = fmaf(l, f, st.y * w);
      sum.x = fmaf(sum.x, f, x.x * w);
      sum.y = fmaf(sum.y, f, x.y * w);
      sum.z = fmaf(sum.z, f, x.z * w);
      sum.w = fmaf(sum.w, f, x.w * w);
    };
    int s = 0;
    for (; s + 8 <= nsplit; s += 8) {
      float2 st[8];
      float4 x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        st[k] = __ldcg(ml + s + k);
        x[k] = __ldcg(pa + (s + k) * D4);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) add(st[k], x[k]);
    }
    for (; s < nsplit; ++s) add(__ldcg(ml + s), __ldcg(pa + s * D4));
    T* o = out + (head0 + g) * D + 4 * c4;
    const float den = fmaxf(l, 1e-30f);
    o[0] = pt::from_f32<T>(sum.x / den);
    o[1] = pt::from_f32<T>(sum.y / den);
    o[2] = pt::from_f32<T>(sum.z / den);
    o[3] = pt::from_f32<T>(sum.w / den);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// Launch (a != nullptr) or describe (plan != nullptr) the instantiation
// for G heads per block over rows of DMAX, with nchunk chunks of G heads
// per kv head. The kernel's dynamic shared memory is allowed once per
// device (48 KB with the static arrays beside it needs the opt-in too).
template <typename T, typename KV, int G, int DMAX, int MODE>
cudaError_t run(int device, const Args* a, Plan* plan, int nchunk,
                cudaStream_t stream) {
  using GG = Geo<T, KV, G, DMAX, MODE>;
  const auto kern = decode_kernel<T, KV, G, DMAX, MODE>;
  static unsigned long long opted = 0;  // a bit per device
  const unsigned long long bit = 1ull << (device & 63);
  if (!(opted & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GG::kSmem);
    if (e != cudaSuccess) return e;
    opted |= bit;
  }
  if (plan != nullptr) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                      GG::kSmem);
    if (e != cudaSuccess) return e;
    *plan = Plan{n, GG::TILE, kStages, G, nchunk, fa.numRegs,
                 static_cast<int>(fa.localSizeBytes)};
    return cudaSuccess;
  }
  if (static_cast<int64_t>(a->hkv) * nchunk > 65535)
    return cudaErrorInvalidValue;
  Args k = *a;
  k.nchunk = nchunk;
  kern<<<dim3(a->nsplit, a->hkv * nchunk, a->batch), kThreads, GG::kSmem,
         stream>>>(k);
  return cudaGetLastError();
}

// The instantiation for g heads per block over rows of DMAX, by the
// caller's dtype (q's; kv_int8: int8 caches) and mode. Row scales go
// with int8 caches only; rows past 128 take at most 4 heads per block.
template <int MODE, typename T, typename KV, int DMAX>
cudaError_t by_heads(int device, int g, int nchunk, const Args* a,
                     Plan* plan, cudaStream_t s) {
  switch (g) {
    case 1:
      return run<T, KV, 1, DMAX, MODE>(device, a, plan, nchunk, s);
    case 2:
      if constexpr (MODE != kContig && DMAX > 128 &&
                    std::is_same<KV, float>::value)
        return cudaErrorInvalidValue;  // shape_of takes g = 4 (spills)
      else
        return run<T, KV, 2, DMAX, MODE>(device, a, plan, nchunk, s);
    case 4:
      return run<T, KV, 4, DMAX, MODE>(device, a, plan, nchunk, s);
    default:
      if constexpr (DMAX <= 128)
        return run<T, KV, 8, DMAX, MODE>(device, a, plan, nchunk, s);
      return cudaErrorInvalidValue;
  }
}

template <int MODE, int DMAX>
cudaError_t by_dtype(int device, int dtype, int kv_int8, int g, int nchunk,
                     const Args* a, Plan* plan, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if constexpr (MODE == kPagedRows) {
    if (!kv_int8) return cudaErrorInvalidValue;
    return dtype == pt::kF32
               ? by_heads<MODE, float, int8_t, DMAX>(device, g, nchunk, a,
                                                     plan, s)
               : by_heads<MODE, bf16, int8_t, DMAX>(device, g, nchunk, a,
                                                    plan, s);
  } else {
    if (dtype == pt::kF32)
      return kv_int8 ? by_heads<MODE, float, int8_t, DMAX>(device, g, nchunk,
                                                           a, plan, s)
                     : by_heads<MODE, float, float, DMAX>(device, g, nchunk,
                                                          a, plan, s);
    return kv_int8 ? by_heads<MODE, bf16, int8_t, DMAX>(device, g, nchunk, a,
                                                        plan, s)
                   : by_heads<MODE, bf16, bf16, DMAX>(device, g, nchunk, a,
                                                      plan, s);
  }
}

// The padded row and the head chunks of a shape: cudaErrorNotSupported
// for a head size that is not built, cudaErrorInvalidValue for a bad
// dtype or group. A kv head's group is cut into chunks of g = 1, 2, 4 or
// 8 query heads (the smallest power of two that holds it, at most 8, at
// most 4 for rows past 128). Paged float32 pools past 128 take no g = 2
// (that instantiation spills: a group of 2 rides in a chunk of 4).
struct Shape {
  int dmax, g, nchunk;
};

inline cudaError_t shape_of(int dtype, int kv_int8, int hq, int hkv, int d,
                            Shape* sh, bool paged = false) {
  if (dtype != pt::kF32 && dtype != pt::kBF16) return cudaErrorInvalidValue;
  if (hkv <= 0 || hq <= 0 || hq % hkv != 0 || d <= 0)
    return cudaErrorInvalidValue;
  const bool f32_rows = dtype == pt::kF32 && !kv_int8;
  const int vec = f32_rows ? (d > 128 ? 8 : 4) : 8;
  if (d > 256 || d % vec) return cudaErrorNotSupported;
  sh->dmax = pt::pow2_at_least(d < 16 ? 16 : d);
  const int group = hq / hkv;
  const int cap = sh->dmax > 128 ? 4 : 8;
  sh->g = group >= cap ? cap : pt::pow2_at_least(group);
  if (paged && f32_rows && sh->dmax > 128 && sh->g == 2) sh->g = 4;
  sh->nchunk = (group + sh->g - 1) / sh->g;
  return cudaSuccess;
}

// contiguous caches, rows padded to 16, 32 or 256 elements
// (decode_attention_any.cu); dtype and kv_int8 as the C entry takes
// them, g the heads per block
cudaError_t select_any(int device, int dtype, int kv_int8, int dmax, int g,
                       int nchunk, const Args* a, Plan* plan,
                       cudaStream_t s);

// The paged instantiations over rows of DMAX (mode kPaged or
// kPagedRows), each DMAX instantiated in one source:
// paged_attention.cu 128, paged_attention_64_256.cu 64 and 256,
// paged_attention_any.cu 16 and 32, so that nvcc builds them in
// parallel.
template <int DMAX>
cudaError_t select_paged(int device, int mode, int dtype, int kv_int8, int g,
                         int nchunk, const Args* a, Plan* plan,
                         cudaStream_t s) {
  if (mode == kPagedRows)
    return by_dtype<kPagedRows, DMAX>(device, dtype, kv_int8, g, nchunk, a,
                                      plan, s);
  return by_dtype<kPaged, DMAX>(device, dtype, kv_int8, g, nchunk, a, plan,
                                s);
}

}  // namespace pt_decode
