// The decode-attention kernel (decode_attention.cuh) for the rows that
// decode_attention.cu does not compile: head sizes up to 32 (rows
// padded to 16 or 32 elements) and 129..256 (padded to 256, Gemma's 256
// among them; at most 4 query heads per block there, so a thread's
// queries and sums stay inside its registers). A source of its own, so
// nvcc builds it beside the other in parallel.

#include "decode_attention.cuh"

namespace pt_decode {

cudaError_t select_any(int device, int dtype, int kv_int8, int dmax, int g,
                       int nchunk, const Args* a, Plan* plan,
                       cudaStream_t s) {
  switch (dmax) {
    case 16:
      return by_dtype<kContig, 16>(device, dtype, kv_int8, g, nchunk, a,
                                   plan, s);
    case 32:
      return by_dtype<kContig, 32>(device, dtype, kv_int8, g, nchunk, a,
                                   plan, s);
    case 256:
      return by_dtype<kContig, 256>(device, dtype, kv_int8, g, nchunk, a,
                                    plan, s);
    default:
      return cudaErrorNotSupported;
  }
}

}  // namespace pt_decode
