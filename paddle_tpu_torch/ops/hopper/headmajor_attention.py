"""Single-token decode attention over a head-major contiguous cache: the
hand-written Hopper kernel and its plain version.

The kernel replaces the TPU kernel
`paddle_tpu/ops/pallas/paged_attention.py::decode_attention_headmajor`
(K9 of PERF.md), the decode step of `masked_multihead_attention` and
`FusedMultiTransformer` over (B, Hkv, S, D) caches, in all of its modes:
bf16 / f32 caches of q's dtype, and int8 caches with per-(kv head, dim)
float32 scales `k_scale` / `v_scale` of shape (Hkv, D). A head-major
cache is K7's (B, S, Hkv, D) cache read through other strides, so both
functions here hand the transposed views to K7's code
(`ops/hopper/decode_attention.py`, `csrc/decode_attention.cu`):
`decode_attention_headmajor` launches the kernel on CUDA tensors and
counts under `decode_attention_headmajor`;
`decode_attention_headmajor_plain` computes the same function with plain
PyTorch ops.

Semantics shared by both: q (B, 1, Hq, D) attends the first
min(context_lens[b], S) positions of its row, query head h reading kv
head h // (Hq / Hkv); scores are (q * scale) . k in float32, an int8
element is multiplied by its scale before the dot, and a row whose count
is 0 (or less) returns 0. The output has q's dtype.
"""
from __future__ import annotations

from . import decode_attention as _decode


def decode_attention_headmajor_plain(q, k_cache, v_cache, context_lens,
                                     scale=None, k_scale=None, v_scale=None):
    """q (B, 1, Hq, D); caches (B, Hkv, S, D) of q's dtype, or int8 with
    k_scale / v_scale (Hkv, D) float32; context_lens: an int or (B,) int
    tensor. Returns (B, 1, Hq, D) in q's dtype."""
    return _decode.decode_attention_plain(
        q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), context_lens,
        scale, k_scale, v_scale)


def decode_attention_headmajor(q, k_cache, v_cache, context_lens,
                               scale=None, k_scale=None, v_scale=None):
    """The CUDA kernel (same arguments as the plain version); raises on
    what it does not take, as `decode_attention.decode_attention`
    does."""
    return _decode.launch(q, k_cache.transpose(1, 2),
                          v_cache.transpose(1, 2), context_lens, scale,
                          k_scale, v_scale, None,
                          'decode_attention_headmajor')
