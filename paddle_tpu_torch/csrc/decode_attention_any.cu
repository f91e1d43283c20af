// The general build of the decode-attention kernel (decode_attention.cuh)
// for every GQA group and head size that decode_attention.cu does not
// compile with fixed sizes: Qwen2's groups of 7 (28 / 4 heads) and 6,
// Llama-3.2-3B's 3, head sizes of 80, 96 or 256, and so on. A source of
// its own, so nvcc builds it beside the fixed one in parallel.
//
// The kv head's query heads go in chunks of GC = 1, 2, 4 or 8 (the
// smallest power of two that holds the group, 8 for larger groups), a
// row on LPR lanes (the smallest power of two that holds its loads, the
// lanes past D idle). A float32 row wider than 128 loads 8 elements per
// lane; its chunks hold at most 4 heads so the queries and sums of a
// thread stay inside its registers.

#include "decode_attention.cuh"

namespace pt_decode {
namespace {

template <typename T, typename KV, int G, int VEC>
cudaError_t by_lanes(const Args& a, int lpr, int nchunk, cudaStream_t s) {
  switch (lpr) {
    case 2:
      return launch<T, KV, G, 2, true, VEC>(a, nchunk, s);
    case 4:
      return launch<T, KV, G, 4, true, VEC>(a, nchunk, s);
    case 8:
      return launch<T, KV, G, 8, true, VEC>(a, nchunk, s);
    case 16:
      return launch<T, KV, G, 16, true, VEC>(a, nchunk, s);
    case 32:
      return launch<T, KV, G, 32, true, VEC>(a, nchunk, s);
    default:
      return cudaErrorNotSupported;
  }
}

// 16-byte (8-byte for int8) loads, rows of 2..32 lanes
template <typename T, typename KV>
cudaError_t narrow(const Args& a, cudaStream_t s) {
  constexpr int kVec = pt::KVVec<KV>::n;
  const int lpr = pt::pow2_at_least(a.d / kVec < 2 ? 2 : a.d / kVec);
  const int group = a.hq / a.hkv;
  const int gc = group >= 8 ? 8 : pt::pow2_at_least(group);
  const int nchunk = (group + gc - 1) / gc;
  switch (gc) {
    case 1:
      return by_lanes<T, KV, 1, kVec>(a, lpr, nchunk, s);
    case 2:
      return by_lanes<T, KV, 2, kVec>(a, lpr, nchunk, s);
    case 4:
      return by_lanes<T, KV, 4, kVec>(a, lpr, nchunk, s);
    default:
      return by_lanes<T, KV, 8, kVec>(a, lpr, nchunk, s);
  }
}

// float32 rows of 136..256 elements: 8 per lane (two 16-byte loads) on
// 32 lanes, at most 4 query heads per chunk
cudaError_t wide_f32(const Args& a, cudaStream_t s) {
  const int group = a.hq / a.hkv;
  const int gc = group >= 4 ? 4 : pt::pow2_at_least(group);
  const int nchunk = (group + gc - 1) / gc;
  switch (gc) {
    case 1:
      return launch<float, float, 1, 32, true, 8>(a, nchunk, s);
    case 2:
      return launch<float, float, 2, 32, true, 8>(a, nchunk, s);
    default:
      return launch<float, float, 4, 32, true, 8>(a, nchunk, s);
  }
}

}  // namespace

cudaError_t dispatch_any(const Args& a, int dtype, int kv_int8,
                         cudaStream_t s) {
  if (a.d > 256) return cudaErrorNotSupported;
  if (dtype == pt::kBF16) {
    if (a.d % 8) return cudaErrorNotSupported;
    return kv_int8 ? narrow<__nv_bfloat16, int8_t>(a, s)
                   : narrow<__nv_bfloat16, __nv_bfloat16>(a, s);
  }
  if (dtype != pt::kF32) return cudaErrorInvalidValue;
  if (kv_int8)
    return a.d % 8 ? cudaErrorNotSupported : narrow<float, int8_t>(a, s);
  if (a.d <= 128)
    return a.d % 4 ? cudaErrorNotSupported : narrow<float, float>(a, s);
  return a.d % 8 ? cudaErrorNotSupported : wide_f32(a, s);
}

}  // namespace pt_decode
