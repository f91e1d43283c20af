// The decode-attention kernel (decode_attention.cuh) for the rows that
// decode_attention.cu does not compile: head sizes up to 32 (rows
// padded to 16 or 32 elements) and 129..256 (padded to 256, Gemma's 256
// among them; at most 4 query heads per block there, so a thread's
// queries and sums stay inside its registers). A source of its own, so
// nvcc builds it beside the other in parallel.

#include "decode_attention.cuh"

namespace pt_decode {
namespace {

template <typename T, typename KV, int DMAX>
cudaError_t by_heads(int device, int g, int nchunk, const Args* a,
                     Plan* plan, cudaStream_t s) {
  switch (g) {
    case 1:
      return run<T, KV, 1, DMAX>(device, a, plan, nchunk, s);
    case 2:
      return run<T, KV, 2, DMAX>(device, a, plan, nchunk, s);
    case 4:
      return run<T, KV, 4, DMAX>(device, a, plan, nchunk, s);
    default:
      if constexpr (DMAX <= 128)
        return run<T, KV, 8, DMAX>(device, a, plan, nchunk, s);
      return cudaErrorInvalidValue;
  }
}

template <int DMAX>
cudaError_t by_dtype(int device, int dtype, int kv_int8, int g, int nchunk,
                     const Args* a, Plan* plan, cudaStream_t s) {
  if (dtype == pt::kF32)
    return kv_int8 ? by_heads<float, int8_t, DMAX>(device, g, nchunk, a,
                                                   plan, s)
                   : by_heads<float, float, DMAX>(device, g, nchunk, a,
                                                  plan, s);
  return kv_int8 ? by_heads<__nv_bfloat16, int8_t, DMAX>(device, g, nchunk,
                                                         a, plan, s)
                 : by_heads<__nv_bfloat16, __nv_bfloat16, DMAX>(
                       device, g, nchunk, a, plan, s);
}

}  // namespace

cudaError_t select_any(int device, int dtype, int kv_int8, int dmax, int g,
                       int nchunk, const Args* a, Plan* plan,
                       cudaStream_t s) {
  switch (dmax) {
    case 16:
      return by_dtype<16>(device, dtype, kv_int8, g, nchunk, a, plan, s);
    case 32:
      return by_dtype<32>(device, dtype, kv_int8, g, nchunk, a, plan, s);
    case 256:
      return by_dtype<256>(device, dtype, kv_int8, g, nchunk, a, plan, s);
    default:
      return cudaErrorNotSupported;
  }
}

}  // namespace pt_decode
