// The paged decode-attention instantiations (decode_attention.cuh, modes
// kPaged and kPagedRows) over rows padded to 64 elements (head sizes
// 33..64) and 256 (129..256, at most 4 query heads per block). A source
// of its own, so nvcc builds it beside the others in parallel.

#include "decode_attention.cuh"

namespace pt_decode {

template cudaError_t select_paged<64>(int, int, int, int, int, int,
                                      const Args*, Plan*, cudaStream_t);
template cudaError_t select_paged<256>(int, int, int, int, int, int,
                                       const Args*, Plan*, cudaStream_t);

}  // namespace pt_decode
