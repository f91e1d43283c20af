// Single-token decode attention over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/decode_attention.py::decode_attention
// (pallas_call at :220; bodies _decode_kernel :42 and _decode_kernel_q8
// :49), in both of its modes: bf16 / f32 caches, and int8 caches
// dequantized with per-(kv head, dim) f32 scales. For batch row b and
// query head h:
//
//   out[b, 0, h] = softmax(scale * q[b, 0, h] . K_b^T) V_b
//
// over the row's window [start[b], min(valid_len[b], S)) of the
// (B, S, Hkv, D) caches, where query head h reads kv head h / (Hq / Hkv).
// start is clipped to [0, S]; positions outside the window contribute
// nothing, and a row whose window is empty returns 0 (acc / max(l, 1e-30)
// as the TPU kernel does).
//
// The same kernel also replaces
// paddle_tpu/ops/pallas/paged_attention.py::decode_attention_headmajor
// (pallas_call in _run :122; bodies _kernel_hm :110 and _kernel_hm_q8
// :115), the decode step of masked_multihead_attention over (B, Hkv, S,
// D) caches: the caller passes the strides of that layout and each row's
// count as its valid length (start 0). The TPU kernel walks every
// S-block and masks those past the count; here a split past the count
// reads nothing.
//
// Bound: bytes. Each K and V row of the window is read once (2 D
// elements per kv head and position) against 4 D float operations per
// query head and position: at a GQA group of 8 under 8 operations per
// byte of int8, against the ~20 the CUDA cores do per byte the memory
// delivers. So the design keeps the memory busy from the first
// microsecond to the last and spends nothing it does not need:
//
// - Grid: one block of 128 threads per (context split, kv head x chunk
//   of G query heads, batch row). The host splits the context so that
//   the blocks fill one wave of the card and no more: the blocks per SM
//   that really fit this instantiation come from the occupancy
//   calculator (pt_decode_attention_plan), and each split gets at least
//   kStages tiles where the cache is long enough, and at most 8 (then
//   more waves): a row whose window covers the cache must spread over
//   enough blocks when the other rows' windows are short. The split
//   depends on the cache's length S and the shapes, never on valid_len
//   or start, so one launch per geometry can be captured in a CUDA
//   graph; blocks whose slice lies outside the window read nothing.
// - K/V tiles go through a ring of kStages = 3 stages in shared memory,
//   filled by 16-byte cp.async copies that work for any stride (8-byte
//   copies for int8 rows that are not 16-byte aligned): tiles t + 1 and
//   t + 2 are in flight while tile t is scored and accumulated, so the
//   bytes in flight are not bounded by registers. A tile is 4-8 KB of K
//   and as much of V (64 positions of rows up to 128 bytes, else 32),
//   so a bf16 block at D = 128 takes 48 KB and four fit on an SM.
// - Each thread owns a VEC-wide column slice of a few tile rows and
//   keeps its own online softmax (max, sum, output slice) over them:
//   scores are float32 FMAs, summed over the row's lanes by a
//   reduce-scatter and an all-gather (2 (n - 1) shuffles for n scores
//   where a butterfly on each takes n log2(lanes)), in log2 units (log2 e
//   folded into q) so a probability is one exp2; a tile needs one
//   barrier (the ring's) and no shared score matrix. The G query heads
//   of the kv head sit in registers, so GQA reads each K/V row once. The
//   thread rows merge at the end (warp butterfly, then the four warps in
//   order).
// - int8 under a bf16 q (the serving path): q is multiplied by scale and
//   the K scale once per block, and the V scale goes onto the block's
//   sums once, so a code costs a byte permute and a subtract (the float
//   magic number 2^23 + code + 128), exactly, and nothing else. A
//   float32 q keeps the plain version's order of operations: each code
//   times its scale, natural units and expf, and a first pass over the
//   split's K tiles for its max, so that each probability is exp(s -
//   max) once and nothing is rescaled (K is read twice: float32 is the
//   reference's mode, not the serving path); a tile's probabilities are
//   summed pairwise (halves, then a butterfly) and the thread rows'
//   output sums in row order. A float32 model that quantizes rows this
//   kernel's output produced (an int8 cache) is the one caller whose
//   result hangs on those last bits. The
//   results differ from the plain version by float32 reassociation (and
//   exp2's 2 ulp) only: within 2e-4 relative of a float32 output, and
//   one bf16 rounding step of a bf16 one.
// - One launch per call. Each split writes its float32 (max, sum,
//   unnormalised output), takes a ticket on an int32 counter of its
//   (row, kv head, chunk), and the last split to arrive combines every
//   split in one pass, an online softmax over their states in split
//   order (the output is the same bits from run to run), and resets the
//   counter to 0. The host keeps one zeroed counter buffer per (device,
//   stream): launches on one stream run in order, so they share it, and
//   launches on two streams never do. A buffer that is outgrown is kept,
//   never freed, so a CUDA graph captured with it replays safely (graphs
//   captured on one stream share its buffer: replay them on one stream).
//   An unsplit call normalises and writes the output directly.
//
// Groups and head sizes: the TPU kernel takes any group Hq % Hkv == 0
// and any D. Here a kv head's group is cut into chunks of G = 1, 2, 4 or
// 8 query heads (the smallest power of two that holds it, at most 8, at
// most 4 for rows past 128; group 7 is one chunk of 8 with an idle head,
// group 12 two chunks of 8 that both read the K/V rows), and a row is
// padded to DMAX = 16, 32, 64, 128 or 256 elements with the lanes past D
// idle. D must be a multiple of 8 (bf16, int8) or 4 (f32; of 8 past
// 128) up to 256. This file compiles DMAX 64 and 128 (head sizes
// 33..128, Llama's, Mistral's and Qwen2's rows) and holds the C
// entries; decode_attention_any.cu the rest, in an nvcc process of its
// own.

#include "decode_attention.cuh"

namespace pt_decode {
namespace {

// The instantiation for a shape: cudaErrorNotSupported for a head size
// that is not built, cudaErrorInvalidValue for a bad dtype or group.
cudaError_t select(int device, int dtype, int kv_int8, int hq, int hkv,
                   int d, const Args* a, Plan* plan, cudaStream_t s) {
  Shape sh;
  const cudaError_t e = shape_of(dtype, kv_int8, hq, hkv, d, &sh);
  if (e != cudaSuccess) return e;
  if (sh.dmax == 128)
    return by_dtype<kContig, 128>(device, dtype, kv_int8, sh.g, sh.nchunk,
                                  a, plan, s);
  if (sh.dmax == 64)
    return by_dtype<kContig, 64>(device, dtype, kv_int8, sh.g, sh.nchunk, a,
                                 plan, s);
  return select_any(device, dtype, kv_int8, sh.dmax, sh.g, sh.nchunk, a,
                    plan, s);
}

}  // namespace
}  // namespace pt_decode

// The launch geometry of a shape (see pt_decode_attention): out[0..6] =
// blocks of the instantiation that fit on an SM, positions per tile,
// ring stages, query heads per block, head chunks per kv head, and the
// kernel's registers per thread and local (spilled) bytes.
extern "C" int pt_decode_attention_plan(int device, int dtype, int kv_int8,
                                        int hq, int hkv, int d, int* out) {
  using namespace pt_decode;
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  Plan p{};
  e = select(device, dtype, kv_int8, hq, hkv, d, nullptr, &p, nullptr);
  if (e != cudaSuccess) return e;
  const int v[7] = {p.blocks_per_sm, p.tile, p.stages, p.heads, p.nchunk,
                    p.regs, p.local_bytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
}

// q, out: (batch, 1, hq, d) of `dtype`, contiguous; kc, vc: caches of
// `dtype` with 16-byte aligned rows, or int8 (8-byte aligned rows) with
// kv_int8 set and kscale, vscale (hkv, d) f32 contiguous, whose element
// (b, p, h, :) lies at b * b_stride + h * h_stride + p * pos_stride with
// d contiguous: (batch, s_len, hkv, d) for decode_attention, (batch, hkv,
// s_len, d) for the head-major layout of decode_attention_headmajor.
// vlens / starts: (batch,) int32, or null to use vlen_all / start_all
// for every row. Split i covers positions [i * chunk, (i + 1) * chunk);
// with nsplit > 1, part_acc (batch, hq, nsplit, d) and part_ml (batch,
// hq, nsplit, 2) are float32 scratch and counters holds batch * hkv *
// nchunk int32 zeros (nchunk from pt_decode_attention_plan), which the
// launch leaves zero. Any hq % hkv == 0; d a multiple of 8 (bf16, int8)
// or 4 (f32; of 8 past 128) up to 256, else cudaErrorNotSupported.
extern "C" int pt_decode_attention(
    int device, const void* q, const void* kc, const void* vc,
    const void* kscale, const void* vscale, const void* vlens,
    const void* starts, int vlen_all, int start_all, void* out,
    void* part_acc, void* part_ml, void* counters, int batch, int s_len,
    int hq, int hkv, int d, long long b_stride, long long h_stride,
    long long pos_stride, int nsplit, int chunk, float scale, int dtype,
    int kv_int8, void* stream) {
  using namespace pt_decode;
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (batch < 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0 || nsplit < 1 ||
      nsplit > kMaxSplits || chunk < 1 || hkv > 65535 || batch > 65535 ||
      d <= 0 || static_cast<int64_t>(nsplit) * chunk < s_len)
    return cudaErrorInvalidValue;
  if (nsplit > 1 &&
      (part_acc == nullptr || part_ml == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  if (kv_int8 && (kscale == nullptr || vscale == nullptr))
    return cudaErrorInvalidValue;
  // int8 rows take 8-byte copies, or 16-byte ones where the rows allow;
  // the others 16-byte copies
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc);
  if (ptrs & (kv_int8 ? 7u : 15u)) return cudaErrorMisalignedAddress;
  const uintptr_t rows = static_cast<uintptr_t>(b_stride | h_stride |
                                                pos_stride | d);
  const int wide = !kv_int8 || ((ptrs | rows) & 15u) == 0;
  if (batch == 0) return cudaSuccess;
  const Args a{q, kc, vc, static_cast<const float*>(kscale),
         static_cast<const float*>(vscale), static_cast<const int*>(vlens),
         static_cast<const int*>(starts), vlen_all, start_all, out,
         static_cast<float*>(part_acc), static_cast<float*>(part_ml),
         static_cast<int*>(counters), batch, s_len, hq, hkv, d, nsplit,
         chunk, 0, b_stride, h_stride, pos_stride, scale, wide,
         nullptr, 0, 0, 0, -1, 0};
  return select(device, dtype, kv_int8, hq, hkv, d, &a, nullptr,
                static_cast<cudaStream_t>(stream));
}
