"""Importable flash-attention module path (counterpart of
paddle_tpu/nn/functional/flash_attention.py): scripts do
``from paddle.nn.functional.flash_attention import flash_attention``.
"""
from __future__ import annotations

from .attention import (_varlen_segment_ids,  # noqa: F401
                        flash_attn_qkvpacked, flash_attn_varlen_qkvpacked,
                        scaled_dot_product_attention)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, *, training=True):
    """(B, S, H, D) inputs -> (out, None), through
    `scaled_dot_product_attention` (the flash op for >= 128 queries)."""
    if return_softmax:
        raise NotImplementedError(
            'flash_attention(return_softmax=True) is not ported yet')
    out = scaled_dot_product_attention(
        query, key, value, dropout_p=dropout if training else 0.0,
        is_causal=causal)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, *,
                        training=True):
    """Packed varlen attention: (total_tokens, H, D) inputs, sequences
    delimited by `cu_seqlens_q` / `cu_seqlens_k` -> (out (total_q, H,
    D), None). The stream is one row whose boundaries are segment ids
    (block-diagonal attention within each sequence): the flash op's
    segment mode (K5s forward, K6s backward) at 128 tokens or more."""
    if return_softmax:
        raise NotImplementedError(
            'flash_attn_unpadded(return_softmax=True) is not ported yet')
    out = scaled_dot_product_attention(
        query[None], key[None], value[None],
        dropout_p=dropout if training else 0.0, is_causal=causal,
        scale=scale,
        segment_ids=_varlen_segment_ids(query.shape[0], cu_seqlens_q,
                                       query.device),
        kv_segment_ids=_varlen_segment_ids(key.shape[0], cu_seqlens_k,
                                          key.device))
    return out[0], None
