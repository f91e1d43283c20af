"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

Layout (batch, seq, num_heads, head_dim), as in the JAX package. The
masked attention here is plain PyTorch in float32, the counterpart of
the JAX package's `_sdpa_reference`: it is what serving's admission
prefill runs there too (a mask is passed, so no kernel is involved).
The unmasked causal case that the JAX package sends to its flash
kernel (K5 of PERF.md) is not ported yet and raises on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False, scale=None):
    """softmax(scale * q k^T + mask) v. Causal masks are bottom-right
    aligned (tril with k = Sk - Sq); a bool `attn_mask` keeps True
    positions (masked logits become -1e30), a float one is added to the
    logits. GQA: kv heads are repeated to the query heads."""
    B, Sq, H, D = query.shape
    Sk = key.shape[1]
    if (query.device.type == 'cuda' and attn_mask is None and D % 8 == 0
            and Sq >= 128):
        raise NotImplementedError(
            'unmasked attention over >= 128 queries runs the flash '
            'attention kernel (K5), which is not ported yet (training '
            'slice); serve through inference.ServingEngine')
    scale = scale or 1.0 / math.sqrt(D)
    if key.shape[2] != H:
        rep = H // key.shape[2]
        key = key.repeat_interleave(rep, dim=2)
        value = value.repeat_interleave(rep, dim=2)
    logits = torch.einsum('bqhd,bkhd->bhqk', query.float() * scale,
                          key.float())
    if is_causal:
        causal = torch.ones(Sq, Sk, dtype=torch.bool,
                            device=query.device).tril(Sk - Sq)
        logits = torch.where(causal, logits, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, NEG_INF)
        else:
            logits = logits + attn_mask.float()
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', p, value.float())
    return out.to(query.dtype)
