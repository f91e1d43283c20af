// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py::paged_decode_attention
// (pallas_call in _run, body _body) in all three of its modes: bf16 or
// f32 pages of q's dtype (K8), and int8 pages (K8q) dequantized with
// either per-row scales (NB, Hkv, BS) f32 that ride with their page (the
// ServingEngine's QuantPagedKVCache) or global per-(kv head, dim) scales
// (Hkv, D) f32 (block_multihead_attention's static cache scales). For
// batch row b and query head h:
//
//   out[b, 0, h] = softmax(scale * q[b, 0, h] . K_b^T) V_b
//
// over the row's first context_lens[b] positions, where position p of
// the row lives in page block_tables[b, p / BS] at slot p % BS of the
// (NB, Hkv, BS, D) pools, and query head h reads kv head h / (Hq / Hkv).
// Page ids are clamped to [0, NB - 1] and context_lens to
// [0, MAXB * BS], as the TPU kernel does; positions past the count are
// masked, and a row with no valid position returns zeros. An int8 K or V
// element times its scale enters the dot in float32.
//
// Bound: bytes. Every valid K and V row is read once: ctx * Hkv * D * 2
// elements per batch row (one byte each for int8, plus a 4-byte scale
// per row and head in the per-row mode), against 4 * D float operations
// per query head per position, so even a GQA group of 8 stays far below
// the ~295 operations per byte where arithmetic would bound the card.
//
// Design: the decode-attention template of decode_attention.cuh (K7's:
// one launch per call, blocks over (context split, kv head x head chunk,
// batch row) that fill one wave, K/V tiles through a 3-stage cp.async
// ring, a softmax per thread row, the last split to finish combining the
// splits in split order) with a page-table loader in place of K7's
// strided rows:
//
// - The "cache length" is the table width MAXB * BS, and the context
//   split is taken from it alone (the host's splits()), never from the
//   counts, so one launch per geometry can be captured in a CUDA graph;
//   a split past its row's count reads nothing and still takes its
//   ticket.
// - Each block stages its split's page ids (at most 8 tiles of 64
//   positions: 33 pages at BS = 16, 9 at 64, 512 at BS = 1), clamped to
//   the pool, in shared memory once, beside its q loads; a copy's address
//   is then its page's offset plus its slot's, in int64. A tile of 32 or
//   64 positions may cross pages; any BS >= 1 works (a shift where BS is
//   a power of two). A split that spans more than kTblCap pages (a table
//   wider than 65536 positions) reads its entries from the table.
// - Per-row int8 scales (mode kPagedRows) ride in the ring beside their
//   tile, one 4-byte cp.async per position and tensor. A bf16 q folds
//   the K row scale into the row's score and the V row scale into its
//   probability, so a code needs no multiply of its own; a float32 q
//   multiplies each code by its scale before the dot, as the plain
//   version does. (Hkv, D) scales take K7's int8 path unchanged.
// - int8 rows that are not 16-byte aligned (D = 40) take 8-byte copies.
//
// The paged instantiations are compiled in paged_attention_<rows>.cu,
// one padded row size each (16, 32, 64, 128 and 256; 128, Llama's and
// Qwen2's, in two: paged_attention_128_rows.cu holds its row-scale
// mode), each in an nvcc process of its own beside decode_attention*.cu:
// bf16 / float32 q, pages of q's dtype or int8 with either scale mode,
// G = 1, 2, 4, 8 query heads per block (4 past 128). This source holds
// the C entry and the dispatch alone.

#include "decode_attention.cuh"

namespace pt_decode {

// compiled in paged_attention_<rows>.cu
extern template cudaError_t select_paged<16>(int, int, int, int, int, int,
                                             const Args*, Plan*,
                                             cudaStream_t);
extern template cudaError_t select_paged<32>(int, int, int, int, int, int,
                                             const Args*, Plan*,
                                             cudaStream_t);
extern template cudaError_t select_paged<64>(int, int, int, int, int, int,
                                             const Args*, Plan*,
                                             cudaStream_t);
extern template cudaError_t select_paged<128>(int, int, int, int, int, int,
                                              const Args*, Plan*,
                                              cudaStream_t);
extern template cudaError_t select_paged<256>(int, int, int, int, int, int,
                                              const Args*, Plan*,
                                              cudaStream_t);

namespace {

// scale modes of the C entry (ops/hopper/paged_attention.py)
enum ScaleMode : int { kNoScale = 0, kRowScale = 1, kHeadDimScale = 2 };

cudaError_t select(int device, int dtype, int scale_mode, int hq, int hkv,
                   int d, const Args* a, Plan* plan, cudaStream_t s) {
  if (scale_mode < kNoScale || scale_mode > kHeadDimScale)
    return cudaErrorInvalidValue;
  const int kv_int8 = scale_mode != kNoScale;
  Shape sh;
  const cudaError_t e = shape_of(dtype, kv_int8, hq, hkv, d, &sh, true);
  if (e != cudaSuccess) return e;
  const int mode = scale_mode == kRowScale ? kPagedRows : kPaged;
  switch (sh.dmax) {
    case 16:
      return select_paged<16>(device, mode, dtype, kv_int8, sh.g, sh.nchunk,
                              a, plan, s);
    case 32:
      return select_paged<32>(device, mode, dtype, kv_int8, sh.g, sh.nchunk,
                              a, plan, s);
    case 64:
      return select_paged<64>(device, mode, dtype, kv_int8, sh.g, sh.nchunk,
                              a, plan, s);
    case 128:
      return select_paged<128>(device, mode, dtype, kv_int8, sh.g,
                               sh.nchunk, a, plan, s);
    case 256:
      return select_paged<256>(device, mode, dtype, kv_int8, sh.g,
                               sh.nchunk, a, plan, s);
    default:
      return cudaErrorNotSupported;
  }
}

}  // namespace
}  // namespace pt_decode

// The launch geometry of a paged shape, as pt_decode_attention_plan
// gives K7's: out[0..6] = blocks of the instantiation that fit on an
// SM, positions per tile, ring stages, query heads per block, head
// chunks per kv head, registers per thread, local (spilled) bytes.
extern "C" int pt_paged_decode_attention_plan(int device, int dtype,
                                              int scale_mode, int hq,
                                              int hkv, int d, int* out) {
  using namespace pt_decode;
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  Plan p{};
  e = select(device, dtype, scale_mode, hq, hkv, d, nullptr, &p, nullptr);
  if (e != cudaSuccess) return e;
  const int v[7] = {p.blocks_per_sm, p.tile, p.stages, p.heads, p.nchunk,
                    p.regs, p.local_bytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
}

// q, out: (batch, 1, hq, d) of `dtype`; kc, vc: (nb, hkv, bs, d) pools of
// `dtype` (scale_mode 0), or int8 with float32 scales kscale, vscale of
// shape (nb, hkv, bs) (scale_mode 1, per row) or (hkv, d) (scale_mode 2);
// all contiguous. tables: (batch, maxb) int32; lens: (batch,) int32.
// Split i covers positions [i * chunk, (i + 1) * chunk) of the table's
// maxb * bs; with nsplit > 1, part_acc (batch, hq, nsplit, d) and part_ml
// (batch, hq, nsplit, 2) are float32 scratch and counters holds batch *
// hkv * nchunk int32 zeros (nchunk from pt_paged_decode_attention_plan),
// which the launch leaves zero. Any hq % hkv == 0; d a multiple of 8
// (bf16, int8) or 4 (f32; of 8 past 128) up to 256, else
// cudaErrorNotSupported.
extern "C" int pt_paged_decode_attention(
    int device, const void* q, const void* kc, const void* vc,
    const void* kscale, const void* vscale, const void* tables,
    const void* lens, void* out, void* part_acc, void* part_ml,
    void* counters, int batch, int hq, int hkv, int d, int nb, int bs,
    int maxb, int nsplit, int chunk, float scale, int dtype, int scale_mode,
    void* stream) {
  using namespace pt_decode;
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  const int64_t s_len = static_cast<int64_t>(maxb) * bs;
  if (batch < 0 || hkv <= 0 || hq % hkv != 0 || nb <= 0 || bs <= 0 ||
      maxb <= 0 || s_len > 0x7fffffff || hkv > 65535 || batch > 65535 ||
      d <= 0 || nsplit < 1 || nsplit > kMaxSplits || chunk < 1 ||
      static_cast<int64_t>(nsplit) * chunk < s_len)
    return cudaErrorInvalidValue;
  if (nsplit > 1 &&
      (part_acc == nullptr || part_ml == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  const int kv_int8 = scale_mode != kNoScale;
  if (kv_int8 && (kscale == nullptr || vscale == nullptr))
    return cudaErrorInvalidValue;
  // as K7: int8 rows take 8-byte copies, or 16-byte ones where the rows
  // allow; the others 16-byte copies
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc);
  if (ptrs & (kv_int8 ? 7u : 15u)) return cudaErrorMisalignedAddress;
  const int64_t h_stride = static_cast<int64_t>(bs) * d;
  const int64_t page_stride = h_stride * hkv;
  const uintptr_t rows = static_cast<uintptr_t>(page_stride | h_stride | d);
  const int wide = !kv_int8 || ((ptrs | rows) & 15u) == 0;
  if (batch == 0) return cudaSuccess;
  const int shift = (bs & (bs - 1)) == 0 ? __builtin_ctz(bs) : -1;
  const Args a{q, kc, vc, static_cast<const float*>(kscale),
         static_cast<const float*>(vscale), static_cast<const int*>(lens),
         nullptr, 0, 0, out, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<int*>(counters), batch,
         static_cast<int>(s_len), hq, hkv, d, nsplit, chunk, 0, 0, h_stride,
         d, scale, wide, static_cast<const int*>(tables), maxb, nb, bs,
         shift, page_stride};
  return select(device, dtype, scale_mode, hq, hkv, d, &a, nullptr,
                static_cast<cudaStream_t>(stream));
}
