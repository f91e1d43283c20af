// Single-token decode attention over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/decode_attention.py::decode_attention
// (pallas_call at :220; bodies _decode_kernel :40 and _decode_kernel_q8
// :47), in both of its modes: bf16 / f32 caches, and int8 caches
// dequantized with per-(kv head, dim) f32 scales. For batch row b and
// query head h:
//
//   out[b, 0, h] = softmax(scale * q[b, 0, h] . K_b^T) V_b
//
// over the row's window [start[b], min(valid_len[b], S)) of the
// (B, S, Hkv, D) caches, where query head h reads kv head h / (Hq / Hkv).
// start is clipped to [0, S]; positions outside the window contribute
// nothing, and a row whose window is empty returns 0 (acc / max(l, 1e-30)
// as the TPU kernel does). In int8 mode every loaded K and V element is
// multiplied by its head's scale before the dot, as the TPU body does.
//
// Bound: bytes. Each K and V row of the window is read once (2 * D
// elements per kv head and position) against 4 * D float operations per
// query head and position: far below the ~295 operations per byte where
// arithmetic would bound the card, even for a GQA group of 8. Design:
// one block per (context split, kv head, batch row), which walks its
// slice of the window itself, where the TPU kernel ran a sequential grid
// over cache blocks with the softmax state in VMEM. The G = Hq / Hkv
// query heads of the kv head sit in registers and read each K/V row
// once, with 16-byte loads along D (8-byte for int8), so GQA costs no
// extra bytes; the TPU kernel's dense head-match mask over a
// (Hq, bs * Hkv) score matrix was a Mosaic constraint and is gone. Tiles
// of 64 positions: scores into shared memory, an online-softmax update
// in float32 (one warp per head), P.V accumulated in registers. Each
// thread issues the loads of all its K rows of a tile before it uses
// any, and those of its V rows before the softmax, so a warp keeps
// several rows in flight (the kernel is compiled for each head size,
// which fixes the rows per thread). A block walks its tiles one after
// another, so one block per (batch row, kv head) would leave the memory
// idle (at batch 1 with 32 kv heads, 32 blocks for 132 SMs): the host
// splits the context across blocks (flash-decoding) until about 8
// blocks sit on each SM. Each split writes its (max, sum, unnormalised
// output) and a second pass combines them; a single split normalises
// and writes the output itself.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // positions per tile: two per lane in the softmax
constexpr float kNegInf = -1e30f;

// elements of one K/V load: 16 bytes of bf16 or f32, 8 bytes of int8 (so
// an int8 row takes as many threads, and registers, as a bf16 one)
template <typename KV>
struct KVVec;
template <>
struct KVVec<float> {
  static constexpr int n = 4;
};
template <>
struct KVVec<__nv_bfloat16> {
  static constexpr int n = 8;
};
template <>
struct KVVec<int8_t> {
  static constexpr int n = 8;
};

__device__ __forceinline__ float kv_f32(float v) { return v; }
__device__ __forceinline__ float kv_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float kv_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T, typename KV, int G, int LPR>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ vlens,
    const int* __restrict__ starts, int vlen_all, int start_all,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int s_len, int hq, int hkv, int chunk,
    float scale) {
  constexpr int VEC = KVVec<KV>::n;
  constexpr int D = LPR * VEC;            // head size: LPR loads per row
  constexpr int ROWS = kThreads / LPR;    // tile rows one pass covers
  constexpr int IT = kTile / ROWS;        // tile rows of each thread
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  using P = pt::Pack<KV, VEC>;
  __shared__ float s_p[G * kTile];        // scores, then probabilities
  __shared__ float s_alpha[G];            // rescale for this tile
  __shared__ float s_m[G];                // running max
  __shared__ float s_l[G];                // running sum
  __shared__ float s_red[ROWS * G * D];   // partial outputs of the rows

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk_i = threadIdx.x % LPR;  // this thread's VEC-wide slice
  const int row = threadIdx.x / LPR;      // this thread's first tile row

  // the window [start, end) clipped to the cache, then to this split
  const int end = min(vlens ? vlens[b] : vlen_all, s_len);
  const int start = min(max(starts ? starts[b] : start_all, 0), s_len);
  const int lo = max(start, split * chunk);
  const int hi = min(end, (split + 1) * chunk);

  const int64_t pos_stride = static_cast<int64_t>(hkv) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * s_len * pos_stride +
                         static_cast<int64_t>(kvh) * D + chunk_i * VEC;
  const int64_t q_off = (static_cast<int64_t>(b) * hq + kvh * G) * D;

  float qr[G][VEC];
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qr[g][j] = pt::to_f32(q[q_off + g * D + chunk_i * VEC + j]) * scale;
      acc[g][j] = 0.f;
    }
  }
  float ks[VEC], vs[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ks[j] = kQuant ? kscale[kvh * D + chunk_i * VEC + j] : 1.f;
    vs[j] = kQuant ? vscale[kvh * D + chunk_i * VEC + j] : 1.f;
  }
  if (threadIdx.x < G) {
    s_m[threadIdx.x] = kNegInf;
    s_l[threadIdx.x] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    // this thread's IT rows of K, all loads issued before any is used
    P kb[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int pos = t0 + row + i * ROWS;
      if (pos < hi)
        kb[i] = *reinterpret_cast<const P*>(kc + kv_off + pos * pos_stride);
    }
    // scores: the LPR threads of one row each dot their slice, then sum
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int pos = t0 + row + i * ROWS;
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = 0.f;
      if (pos < hi) {
        float kf[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          kf[j] = kQuant ? kv_f32(kb[i].v[j]) * ks[j] : kv_f32(kb[i].v[j]);
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
          s_p[g * kTile + row + i * ROWS] = pos < hi ? sc[g] : kNegInf;
      }
    }
    // V's rows go in flight while the softmax runs
    P vb[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int pos = t0 + row + i * ROWS;
      if (pos < hi)
        vb[i] = *reinterpret_cast<const P*>(vc + kv_off + pos * pos_stride);
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
    for (int i = 0; i < IT; ++i) {
      const int r = row + i * ROWS;
      if (t0 + r < hi) {
        float vf[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          vf[j] = kQuant ? kv_f32(vb[i].v[j]) * vs[j] : kv_f32(vb[i].v[j]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = s_p[g * kTile + r];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[g][j] += p * vf[j];
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
      s_red[(row * G + g) * D + chunk_i * VEC + j] = acc[g][j];
  }
  __syncthreads();
  const int64_t head0 = static_cast<int64_t>(b) * hq + kvh * G;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, c = i % D;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < ROWS; ++k) sum += s_red[(k * G + g) * D + c];
    if (nsplit == 1)
      out[q_off + g * D + c] = pt::from_f32<T>(sum / fmaxf(s_l[g], 1e-30f));
    else
      part_acc[((head0 + g) * nsplit + split) * D + c] = sum;
  }
  if (nsplit > 1 && threadIdx.x < G) {
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
  float scale;
};

template <typename T, typename KV, int G, int LPR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  decode_kernel<T, KV, G, LPR>
      <<<dim3(a.nsplit, a.hkv, a.batch), kThreads, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.kc),
          static_cast<const KV*>(a.vc), a.ks, a.vs, a.vlens, a.starts,
          a.vlen_all, a.start_all, static_cast<T*>(a.out), a.part_acc,
          a.part_ml, a.s_len, a.hq, a.hkv, a.chunk, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  decode_combine_kernel<T><<<a.batch * a.hq, 128, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.nsplit, a.d);
  return cudaGetLastError();
}

// a row of D elements is LPR = D / VEC loads, a power of two of at least
// 2, so a warp holds whole rows; D is at most 128 (wider rows would
// spill the registers that hold a tile's rows)
template <typename T, typename KV, int G>
cudaError_t by_width(const Args& a, cudaStream_t s) {
  constexpr int kVec = KVVec<KV>::n;
  if (a.d % kVec != 0 || a.d > 128) return cudaErrorInvalidValue;
  switch (a.d / kVec) {
    case 2:
      return launch<T, KV, G, 2>(a, s);
    case 4:
      return launch<T, KV, G, 4>(a, s);
    case 8:
      return launch<T, KV, G, 8>(a, s);
    case 16:
      return launch<T, KV, G, 16>(a, s);
    case 32:
      if constexpr (32 * kVec <= 128) return launch<T, KV, G, 32>(a, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  switch (a.hq / a.hkv) {
    case 1:
      return by_width<T, KV, 1>(a, s);
    case 2:
      return by_width<T, KV, 2>(a, s);
    case 4:
      return by_width<T, KV, 4>(a, s);
    case 8:
      return by_width<T, KV, 8>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (batch, 1, hq, d) of `dtype`; kc, vc: (batch, s_len, hkv, d) of
// `dtype`, or int8 with kv_int8 set and kscale, vscale (hkv, d) f32; all
// contiguous. vlens / starts: (batch,) int32, or null to use vlen_all /
// start_all for every row. With nsplit > 1, part_acc (batch, hq, nsplit,
// d) and part_ml (batch, hq, nsplit, 2) are float32 scratch; split i
// covers positions [i * chunk, (i + 1) * chunk). hq / hkv must be 1, 2, 4
// or 8.
extern "C" int pt_decode_attention(
    int device, const void* q, const void* kc, const void* vc,
    const void* kscale, const void* vscale, const void* vlens,
    const void* starts, int vlen_all, int start_all, void* out,
    void* part_acc, void* part_ml, int batch, int s_len, int hq, int hkv,
    int d, int nsplit, int chunk, float scale, int dtype, int kv_int8,
    void* stream) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (batch < 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0 || nsplit < 1 ||
      chunk < 1 || hkv > 65535 || batch > 65535 ||
      static_cast<int64_t>(nsplit) * chunk < s_len)
    return cudaErrorInvalidValue;
  if (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr))
    return cudaErrorInvalidValue;
  if (kv_int8 && (kscale == nullptr || vscale == nullptr))
    return cudaErrorInvalidValue;
  if (!pt::aligned16(kc) || !pt::aligned16(vc)) return cudaErrorMisalignedAddress;
  if (batch == 0) return cudaSuccess;
  const Args a{q,
               kc,
               vc,
               static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(vlens),
               static_cast<const int*>(starts),
               vlen_all,
               start_all,
               out,
               static_cast<float*>(part_acc),
               static_cast<float*>(part_ml),
               batch,
               s_len,
               hq,
               hkv,
               d,
               nsplit,
               chunk,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return kv_int8 ? dispatch<float, int8_t>(a, s) : dispatch<float, float>(a, s);
  if (dtype == pt::kBF16)
    return kv_int8 ? dispatch<__nv_bfloat16, int8_t>(a, s)
                   : dispatch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}
