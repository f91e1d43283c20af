"""Importable flash-attention module path (counterpart of
paddle_tpu/nn/functional/flash_attention.py): scripts do
``from paddle.nn.functional.flash_attention import flash_attention``.
"""
from __future__ import annotations

from .attention import scaled_dot_product_attention


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
