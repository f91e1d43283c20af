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
// The same kernel also replaces
// paddle_tpu/ops/pallas/paged_attention.py::decode_attention_headmajor
// (pallas_call in _run; bodies _kernel_hm and _kernel_hm_q8), the decode
// step of masked_multihead_attention over (B, Hkv, S, D) caches: the
// caller passes the strides of that layout and each row's count as its
// valid length (start 0). The TPU kernel walks every S-block and masks
// those past the count; here a split past the count reads nothing. In
// this layout one head's positions are contiguous, so a warp's rows are
// one run of memory.
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
//
// Groups and head sizes (fault E2 of ROADMAP.md): the TPU kernel takes
// any group Hq % Hkv == 0 and any D. The kernel template
// (decode_attention.cuh) is compiled here for the groups 1, 2, 4, 8 at
// head sizes whose row is a power of two of loads up to 128 (Llama's
// shapes, with every size fixed at compile time). Every other group and
// head size takes the general build of the same template
// (decode_attention_any.cu, its own nvcc process): the kv head's group
// is cut into chunks of 1, 2, 4 or 8 query heads (group 7 is one chunk
// of 8 with one idle head, group 12 two chunks of 8: a chunk past the
// first reads its K/V rows again, mostly from L2), a row is padded to a
// power of two of lanes with the lanes past D idle (D = 80 of bf16 is 10
// loads on 16 lanes), and a thread loads its rows 4 at a time so a
// wide row or a large group stays inside the registers. Float32 caches
// with D above 128 load 8 elements (two 16-byte loads) per lane, so D
// up to 256 fits a warp in every dtype.

#include "decode_attention.cuh"

namespace pt_decode {
namespace {

// a row of D elements is LPR = D / VEC loads, a power of two of at least
// 2, so a warp holds whole rows; D is at most 128 (wider rows take the
// general path)
template <typename T, typename KV, int G>
cudaError_t by_width(const Args& a, cudaStream_t s) {
  constexpr int kVec = pt::KVVec<KV>::n;
  switch (a.d / kVec) {
    case 2:
      return launch<T, KV, G, 2, false, kVec>(a, 1, s);
    case 4:
      return launch<T, KV, G, 4, false, kVec>(a, 1, s);
    case 8:
      return launch<T, KV, G, 8, false, kVec>(a, 1, s);
    case 16:
      return launch<T, KV, G, 16, false, kVec>(a, 1, s);
    case 32:
      if constexpr (32 * kVec <= 128)
        return launch<T, KV, G, 32, false, kVec>(a, 1, s);
      return cudaErrorNotSupported;
    default:
      return cudaErrorNotSupported;
  }
}

// the fixed path's shapes: a group of 1, 2, 4 or 8 and D / VEC a power
// of two from 2 up to D = 128
template <typename KV>
bool fixed_shape(const Args& a) {
  constexpr int kVec = pt::KVVec<KV>::n;
  const int g = a.hq / a.hkv, n = a.d / kVec;
  return (g == 1 || g == 2 || g == 4 || g == 8) && a.d % kVec == 0 &&
         a.d <= 128 && n >= 2 && (n & (n - 1)) == 0;
}

template <typename T, typename KV>
cudaError_t dispatch(const Args& a, int dtype, int kv_int8, cudaStream_t s) {
  if (!fixed_shape<KV>(a)) return dispatch_any(a, dtype, kv_int8, s);
  switch (a.hq / a.hkv) {
    case 1:
      return by_width<T, KV, 1>(a, s);
    case 2:
      return by_width<T, KV, 2>(a, s);
    case 4:
      return by_width<T, KV, 4>(a, s);
    default:
      return by_width<T, KV, 8>(a, s);
  }
}

}  // namespace
}  // namespace pt_decode

// q, out: (batch, 1, hq, d) of `dtype`, contiguous; kc, vc: caches of
// `dtype` with 16-byte aligned rows, or int8 (8-byte aligned rows) with
// kv_int8 set and kscale, vscale (hkv, d) f32 contiguous, whose
// element (b, p, h, :) lies at b * b_stride + h *
// h_stride + p * pos_stride with d contiguous: (batch, s_len, hkv, d)
// for decode_attention, (batch, hkv, s_len, d) for the head-major layout
// of decode_attention_headmajor. vlens / starts: (batch,) int32, or null
// to use vlen_all / start_all for every row. With nsplit > 1, part_acc
// (batch, hq, nsplit, d) and part_ml (batch, hq, nsplit, 2) are float32
// scratch; split i covers positions [i * chunk, (i + 1) * chunk).
// Any hq % hkv == 0; d a multiple of 8 (bf16, int8) or 4 (f32) up to
// 256, else cudaErrorNotSupported.
extern "C" int pt_decode_attention(
    int device, const void* q, const void* kc, const void* vc,
    const void* kscale, const void* vscale, const void* vlens,
    const void* starts, int vlen_all, int start_all, void* out,
    void* part_acc, void* part_ml, int batch, int s_len, int hq, int hkv,
    int d, long long b_stride, long long h_stride, long long pos_stride,
    int nsplit, int chunk, float scale, int dtype, int kv_int8,
    void* stream) {
  using namespace pt_decode;
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (batch < 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0 || nsplit < 1 ||
      chunk < 1 || hkv > 65535 || batch > 65535 || d <= 0 ||
      static_cast<int64_t>(nsplit) * chunk < s_len)
    return cudaErrorInvalidValue;
  if (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr))
    return cudaErrorInvalidValue;
  if (kv_int8 && (kscale == nullptr || vscale == nullptr))
    return cudaErrorInvalidValue;
  // int8 rows load 8 bytes at a time, the others 16
  const uintptr_t misalign = kv_int8 ? 7u : 15u;
  if ((reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) &
      misalign)
    return cudaErrorMisalignedAddress;
  if (batch == 0) return cudaSuccess;
  const Args a{q, kc, vc, static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(vlens),
               static_cast<const int*>(starts), vlen_all, start_all, out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               batch, s_len, hq, hkv, d, nsplit, chunk, b_stride, h_stride,
               pos_stride, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return kv_int8 ? dispatch<float, int8_t>(a, dtype, 1, s)
                   : dispatch<float, float>(a, dtype, 0, s);
  if (dtype == pt::kBF16)
    return kv_int8 ? dispatch<__nv_bfloat16, int8_t>(a, dtype, 1, s)
                   : dispatch<__nv_bfloat16, __nv_bfloat16>(a, dtype, 0, s);
  return cudaErrorInvalidValue;
}
