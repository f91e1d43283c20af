"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

Layout (batch, seq, num_heads, head_dim), as in the JAX package. The
dispatch rule is the JAX package's: no mask, no dropout, head_dim % 8 ==
0 and at least 128 queries take the flash-attention op (`ops.
flash_attention`: kernels K5/K6 on the card, their plain versions on the
CPU); anything else takes the plain masked attention here, in float32,
the counterpart of the JAX package's `_sdpa_reference` (serving's
admission prefill passes a mask, so it runs this path). Segment ids
(packed sequences) and a sliding window ride either path: the flash op's
segment (K5s / K6s) and window (K5w / K6w) modes, or a block-diagonal
mask and a band here; a query row without a key of its segment returns
0 as the kernels' do.

The packed entry points (`flash_attn_qkvpacked`,
`flash_attn_varlen_qkvpacked`) are the JAX package's: a varlen stream
becomes ONE row whose sequence boundaries are segment ids.
"""
from __future__ import annotations

import math

import torch

from ... import ops

NEG_INF = -1e30


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 segment_ids=None, kv_segment_ids=None,
                                 window_size=None):
    """softmax(scale * q k^T + mask) v. Causal masks are bottom-right
    aligned (tril with k = Sk - Sq); a bool `attn_mask` keeps True
    positions (masked logits become -1e30), a float one is added to the
    logits. GQA: kv heads are repeated to the query heads.

    segment_ids (B, Sq) and kv_segment_ids (B, Sk; needed when Sq != Sk,
    else segment_ids) int: attention is block-diagonal within equal ids,
    composed with the causal mask and `attn_mask`; a query whose segment
    has no key returns 0.

    window_size: causal sliding-window attention (each query sees only
    its last `window_size` keys, itself included); requires
    is_causal=True. On the masked path the band folds into the mask."""
    if dropout_p:
        raise NotImplementedError('attention dropout is not ported yet')
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError('kv_segment_ids requires segment_ids')
    if segment_ids is not None and kv_segment_ids is None:
        if query.shape[1] != key.shape[1]:
            raise ValueError(
                'segment_ids with Sq != Sk requires kv_segment_ids')
        kv_segment_ids = segment_ids
    if window_size is not None and not is_causal:
        raise ValueError('window_size requires is_causal=True')
    B, Sq, H, D = query.shape
    Sk = key.shape[1]
    if attn_mask is None and D % 8 == 0 and Sq >= 128:
        return ops.flash_attention(query, key, value, causal=is_causal,
                                   scale=scale, segment_ids=segment_ids,
                                   kv_segment_ids=kv_segment_ids,
                                   window_size=window_size)
    if window_size is not None:
        # the band folds into the mask (the causal half is is_causal's)
        back = (torch.arange(Sq, device=query.device)[:, None] + (Sk - Sq)
                - torch.arange(Sk, device=query.device)[None, :])
        band = (back < int(window_size))[None, None]
        if attn_mask is None:
            attn_mask = band
        elif attn_mask.dtype == torch.bool:
            attn_mask = attn_mask & band
        else:
            attn_mask = torch.where(band, attn_mask.float(), NEG_INF)
    seg_mask = None
    if segment_ids is not None:
        seg_mask = (segment_ids[:, :, None]
                    == kv_segment_ids[:, None, :])[:, None]
        if attn_mask is None:
            attn_mask = seg_mask
        elif attn_mask.dtype == torch.bool:
            attn_mask = attn_mask & seg_mask
        else:
            # an additive float mask: masked-out pairs get -1e30
            attn_mask = torch.where(seg_mask, attn_mask.float(), NEG_INF)
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
    out = torch.einsum('bhqk,bkhd->bqhd', p, value.float()).to(query.dtype)
    if seg_mask is not None:
        # a query whose segment has no key: 0, not the mean of v
        row_valid = seg_mask[:, 0].any(-1)                  # (B, Sq)
        out = torch.where(row_valid[:, :, None, None], out, 0.0)
    return out


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, *, training=True):
    """Packed-QKV attention: qkv (B, S, 3, H, D) -> (out (B, S, H, D),
    None), through `scaled_dot_product_attention`."""
    if return_softmax:
        raise NotImplementedError(
            'flash_attn_qkvpacked(return_softmax=True) is not ported yet')
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = scaled_dot_product_attention(
        q, k, v, dropout_p=dropout if training else 0.0, is_causal=causal)
    return out, None


def _varlen_segment_ids(total, cu_seqlens, device):
    """(1, total) int32 segment ids of a packed stream: token i belongs to
    the sequence j whose [cu_seqlens[j], cu_seqlens[j + 1]) holds it
    (tokens past the last boundary get the id len(cu_seqlens) - 1)."""
    cu = torch.as_tensor(cu_seqlens, device=device).to(torch.int64)
    pos = torch.arange(total, device=device)
    return (torch.searchsorted(cu, pos, right=True) - 1).to(
        torch.int32)[None]


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False, *, training=True):
    """Varlen packed attention: qkv (total_tokens, 3, H, D), sequences
    delimited by `cu_seqlens_q` -> (out (total_tokens, H, D), None). The
    stream is one row whose boundaries are segment ids: the flash op's
    segment mode (K5s / K6s) at 128 tokens or more."""
    if return_softmax:
        raise NotImplementedError('flash_attn_varlen_qkvpacked(return_'
                                  'softmax=True) is not ported yet')
    q, k, v = qkv[None, :, 0], qkv[None, :, 1], qkv[None, :, 2]
    seg = _varlen_segment_ids(qkv.shape[0], cu_seqlens_q, qkv.device)
    out = scaled_dot_product_attention(
        q, k, v, dropout_p=dropout if training else 0.0, is_causal=causal,
        scale=scale, segment_ids=seg)
    return out[0], None
