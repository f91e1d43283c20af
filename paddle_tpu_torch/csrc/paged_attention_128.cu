// The paged decode-attention instantiation (decode_attention.cuh) over
// rows padded to 128 elements (head sizes 65..128, Llama's and Qwen2's)
// in mode kPaged. The longest compile of the paged sizes: its mode
// kPagedRows is compiled in paged_attention_128_rows.cu, so the two
// build in nvcc processes of their own beside the others.

#include "decode_attention.cuh"

namespace pt_decode {

extern template cudaError_t by_dtype<kPagedRows, 128>(
    int, int, int, int, int, const Args*, Plan*, cudaStream_t);
template cudaError_t select_paged<128>(int, int, int, int, int, int,
                                       const Args*, Plan*, cudaStream_t);

}  // namespace pt_decode
