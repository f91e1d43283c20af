// The paged decode-attention instantiation (decode_attention.cuh) over
// rows padded to 128 elements in mode kPagedRows (int8 pages with
// per-row scales): a source of its own beside paged_attention_128.cu.

#include "decode_attention.cuh"

namespace pt_decode {

template cudaError_t by_dtype<kPagedRows, 128>(int, int, int, int, int,
                                               const Args*, Plan*,
                                               cudaStream_t);

}  // namespace pt_decode
