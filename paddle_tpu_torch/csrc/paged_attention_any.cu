// The paged decode-attention instantiations (decode_attention.cuh, modes
// kPaged and kPagedRows) over rows padded to 16 and 32 elements (head
// sizes up to 32). A source of its own, so nvcc builds it beside the
// others in parallel.

#include "decode_attention.cuh"

namespace pt_decode {

template cudaError_t select_paged<16>(int, int, int, int, int, int,
                                      const Args*, Plan*, cudaStream_t);
template cudaError_t select_paged<32>(int, int, int, int, int, int,
                                      const Args*, Plan*, cudaStream_t);

}  // namespace pt_decode
