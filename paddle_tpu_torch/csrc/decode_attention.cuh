// The decode-attention kernel template shared by decode_attention.cu
// (the GQA groups 1, 2, 4, 8 at head sizes whose row is a power of two of
// loads: Llama's shapes) and decode_attention_any.cu (every other group
// and head size). See decode_attention.cu for what it computes and why.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace pt_decode {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // positions per tile: two per lane in the softmax
constexpr int kBatch = 4;   // rows a thread of the general path loads at once
constexpr float kNegInf = -1e30f;

// One block per (context split, kv head [x group chunk], batch row).
//
// G query heads per block, LPR threads per K/V row (a power of two, so a
// warp holds whole rows), VEC elements per thread and row.
// kGen = false: the block's G heads are the kv head's whole group and
// the head size is exactly LPR * VEC, all fixed at compile time.
// kGen = true (any group, any head size that is a multiple of VEC): the
// kv head's `group_run` query heads are cut into `nchunk` chunks of G
// (the last chunk's missing heads ride along with zero queries and are
// not written), lanes past the head size `d_run` hold nothing, and each
// thread loads its K and V rows kBatch at a time, so a wide row or a
// large group stays inside the registers.
template <typename T, typename KV, int G, int LPR, bool kGen, int VEC>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ vlens,
    const int* __restrict__ starts, int vlen_all, int start_all,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int s_len, int hq, int chunk,
    int64_t b_stride, int64_t h_stride, int64_t pos_stride, float scale,
    int d_run, int group_run, int nchunk) {
  constexpr int DMAX = LPR * VEC;          // a row's width in the block
  constexpr int ROWS = kThreads / LPR;     // tile rows one pass covers
  constexpr int IT = kTile / ROWS;         // tile rows of each thread
  constexpr int IB = kGen && IT > kBatch ? kBatch : IT;  // rows per load batch
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  using P = pt::Pack<KV, VEC>;
  __shared__ float s_p[G * kTile];         // scores, then probabilities
  __shared__ float s_alpha[G];             // rescale for this tile
  __shared__ float s_m[G];                 // running max
  __shared__ float s_l[G];                 // running sum
  __shared__ float s_red[ROWS * G * DMAX];  // partial outputs of the rows

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = kGen ? blockIdx.y / nchunk : blockIdx.y;
  const int g0 = kGen ? (blockIdx.y % nchunk) * G : 0;  // first head here
  const int group = kGen ? group_run : G;
  const int gn = kGen ? min(G, group - g0) : G;         // heads written
  const int D = kGen ? d_run : DMAX;                    // head size
  const int nsplit = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk_i = threadIdx.x % LPR;   // this thread's VEC-wide slice
  const int row = threadIdx.x / LPR;       // this thread's first tile row
  const bool act = !kGen || chunk_i * VEC < D;  // the slice lies in the row

  // the window [start, end) clipped to the cache, then to this split
  const int end = min(vlens ? vlens[b] : vlen_all, s_len);
  const int start = min(max(starts ? starts[b] : start_all, 0), s_len);
  const int lo = max(start, split * chunk);
  const int hi = min(end, (split + 1) * chunk);

  const int64_t kv_off = b * b_stride + kvh * h_stride + chunk_i * VEC;
  const int64_t head0 = static_cast<int64_t>(b) * hq + kvh * group + g0;
  const int64_t q_off = head0 * D;

  float qr[G][VEC];
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qr[g][j] = act && g < gn
                     ? pt::to_f32(q[q_off + g * D + chunk_i * VEC + j]) * scale
                     : 0.f;
      acc[g][j] = 0.f;
    }
  }
  float ks[VEC], vs[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ks[j] = kQuant && act ? kscale[kvh * D + chunk_i * VEC + j] : 1.f;
    vs[j] = kQuant && act ? vscale[kvh * D + chunk_i * VEC + j] : 1.f;
  }
  if (threadIdx.x < G) {
    s_m[threadIdx.x] = kNegInf;
    s_l[threadIdx.x] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    // this thread's rows of K, IB loads issued before any is used (all IT
    // at once on the fixed path)
#pragma unroll
    for (int i0 = 0; i0 < IT; i0 += IB) {
      P kb[IB];
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const int pos = t0 + row + (i0 + i) * ROWS;
        if (pos < hi && act)
          kb[i] = *reinterpret_cast<const P*>(kc + kv_off + pos * pos_stride);
      }
      // scores: the LPR threads of one row each dot their slice, then sum
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const int pos = t0 + row + (i0 + i) * ROWS;
        float sc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = 0.f;
        if (pos < hi && act) {
          float kf[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            kf[j] = kQuant ? pt::to_f32(kb[i].v[j]) * ks[j]
                           : pt::to_f32(kb[i].v[j]);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < VEC; ++j) sc[g] += qr[g][j] * kf[j];
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
        }
        if (chunk_i == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            s_p[g * kTile + row + (i0 + i) * ROWS] =
                pos < hi ? sc[g] : kNegInf;
        }
      }
    }
    // fixed path: V's rows go in flight while the softmax runs (the
    // general path loads them batch by batch in the P.V loop)
    P vb[IT];
    if constexpr (!kGen) {
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int pos = t0 + row + i * ROWS;
        if (pos < hi)
          vb[i] = *reinterpret_cast<const P*>(vc + kv_off + pos * pos_stride);
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
      const float p0 = t0 + lane < hi ? expf(s0 - m_new) : 0.f;
      const float p1 = t0 + lane + 32 < hi ? expf(s1 - m_new) : 0.f;
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
#pragma unroll
    for (int i0 = 0; i0 < IT; i0 += IB) {
      if constexpr (kGen) {
#pragma unroll
        for (int i = 0; i < IB; ++i) {
          const int pos = t0 + row + (i0 + i) * ROWS;
          if (pos < hi && act)
            vb[i] = *reinterpret_cast<const P*>(vc + kv_off +
                                                pos * pos_stride);
        }
      }
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const int r = row + (i0 + i) * ROWS;
        if (t0 + r < hi && act) {
          const P& v = vb[kGen ? i : i0 + i];
          float vf[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            vf[j] = kQuant ? pt::to_f32(v.v[j]) * vs[j] : pt::to_f32(v.v[j]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = s_p[g * kTile + r];
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[g][j] += p * vf[j];
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites s_p
  }

  // add the partial sums of the thread rows; one split normalises and
  // writes the output, several write their partial state for the combine
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      s_red[(row * G + g) * DMAX + chunk_i * VEC + j] = acc[g][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D, c = i % D;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < ROWS; ++k) sum += s_red[(k * G + g) * DMAX + c];
    if (nsplit == 1)
      out[q_off + g * D + c] = pt::from_f32<T>(sum / fmaxf(s_l[g], 1e-30f));
    else
      part_acc[((head0 + g) * nsplit + split) * D + c] = sum;
  }
  if (nsplit > 1 && threadIdx.x < gn) {
    float* ml = part_ml + ((head0 + threadIdx.x) * nsplit + split) * 2;
    ml[0] = s_m[threadIdx.x];
    ml[1] = s_l[threadIdx.x];
  }
}

// Combine the splits of one (batch row, query head): rescale each split's
// sums to the common max, add, normalise. Empty splits carry max -1e30
// and sum 0, so they add nothing; an empty window gives 0.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int nsplit,
                                      int d) {
  const int64_t head = blockIdx.x;
  const float* ml = part_ml + head * nsplit * 2;
  float m = kNegInf;
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < nsplit; ++i) l += expf(ml[2 * i] - m) * ml[2 * i + 1];
  const float denom = fmaxf(l, 1e-30f);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < nsplit; ++i)
      acc += expf(ml[2 * i] - m) * part_acc[(head * nsplit + i) * d + c];
    out[head * d + c] = pt::from_f32<T>(acc / denom);
  }
}

struct Args {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  const int *vlens, *starts;
  int vlen_all, start_all;
  void* out;
  float *part_acc, *part_ml;
  int batch, s_len, hq, hkv, d, nsplit, chunk;
  // element strides of a cache's (batch, kv head, position) axes
  int64_t b_stride, h_stride, pos_stride;
  float scale;
};

// nchunk chunks of G query heads per kv head (1 on the fixed path)
template <typename T, typename KV, int G, int LPR, bool kGen, int VEC>
cudaError_t launch(const Args& a, int nchunk, cudaStream_t stream) {
  if (static_cast<int64_t>(a.hkv) * nchunk > 65535)
    return cudaErrorInvalidValue;
  decode_kernel<T, KV, G, LPR, kGen, VEC>
      <<<dim3(a.nsplit, a.hkv * nchunk, a.batch), kThreads, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.kc),
          static_cast<const KV*>(a.vc), a.ks, a.vs, a.vlens, a.starts,
          a.vlen_all, a.start_all, static_cast<T*>(a.out), a.part_acc,
          a.part_ml, a.s_len, a.hq, a.chunk, a.b_stride, a.h_stride,
          a.pos_stride, a.scale, a.d, a.hq / a.hkv, nchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  decode_combine_kernel<T><<<a.batch * a.hq, 128, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.nsplit, a.d);
  return cudaGetLastError();
}

// The general path (decode_attention_any.cu): any group hq / hkv and any
// head size d that is a multiple of the load width (8 elements of bf16
// or int8, 4 of float32) up to 256; cudaErrorNotSupported for the rest.
// dtype and kv_int8 as the C entry takes them.
cudaError_t dispatch_any(const Args& a, int dtype, int kv_int8,
                         cudaStream_t s);

}  // namespace pt_decode
