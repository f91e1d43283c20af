"""Paged single-token decode attention: the hand-written Hopper kernel
and its plain version.

The kernel (`csrc/paged_attention.cu`) replaces the TPU kernel
`paddle_tpu/ops/pallas/paged_attention.py::paged_decode_attention` in
its unquantized mode (bf16 / f32 pages). `paged_decode_attention`
launches it on CUDA tensors; `paged_decode_attention_plain` computes the
same function with plain PyTorch ops.

Semantics shared by both: page ids are clamped to [0, NB - 1] (so -1
and out-of-range table entries are safe), context_lens is clamped to
[0, MAXB * BS], positions at or past the count are masked, and a row
whose count is 0 returns zeros.
"""
from __future__ import annotations

import math

import torch

from .. import _build

NEG_INF = -1e30
GROUPS = (1, 2, 4, 8)   # query heads per kv head the kernel is built for


def _check_shapes(q, key_cache, value_cache, block_tables, context_lens,
                  k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            'paged_decode_attention: int8 pages with k_scale/v_scale are '
            'not ported yet (the int8-KV slice); pass bf16 or f32 pages')
    B, Sq, Hq, D = q.shape
    if Sq != 1:
        raise ValueError(f'paged decode is single-token (Sq=1), got {Sq}')
    NB, Hkv, BS, Dk = key_cache.shape
    if value_cache.shape != key_cache.shape or Dk != D:
        raise ValueError(
            f'paged_decode_attention: pools {tuple(key_cache.shape)} / '
            f'{tuple(value_cache.shape)} do not match q {tuple(q.shape)}')
    if Hq % Hkv:
        raise ValueError(
            f'query heads ({Hq}) must be a multiple of kv heads ({Hkv})')
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f'block_tables must be ({B}, MAXB), got '
                         f'{tuple(block_tables.shape)}')
    if context_lens.shape != (B,):
        raise ValueError(f'context_lens must be ({B},), got '
                         f'{tuple(context_lens.shape)}')
    return B, Hq, D, NB, Hkv, BS, block_tables.shape[1]


def paged_decode_attention_plain(q, key_cache, value_cache, block_tables,
                                 context_lens, scale=None, k_scale=None,
                                 v_scale=None):
    """q (B, 1, Hq, D); pools (NB, Hkv, BS, D); block_tables (B, MAXB)
    int; context_lens (B,) int. Returns (B, 1, Hq, D) in q's dtype."""
    B, Hq, D, NB, Hkv, BS, maxb = _check_shapes(
        q, key_cache, value_cache, block_tables, context_lens, k_scale,
        v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tbl = block_tables.long().clamp(0, NB - 1)
    counts = context_lens.long().clamp(0, maxb * BS)

    def gather(pool):                      # -> (B, MAXB*BS, Hq, D) f32
        g = pool[tbl].float().transpose(2, 3).reshape(B, maxb * BS, Hkv, D)
        return g.repeat_interleave(Hq // Hkv, dim=2)

    s = torch.einsum('bhd,bshd->bhs', q[:, 0].float() * scale,
                     gather(key_cache))
    valid = (torch.arange(maxb * BS, device=q.device)[None, None, :]
             < counts[:, None, None])
    m = torch.where(valid, s, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    out = torch.einsum('bhs,bshd->bhd', p, gather(value_cache))
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out[:, None].to(q.dtype)


def paged_decode_attention(q, key_cache, value_cache, block_tables,
                           context_lens, scale=None, k_scale=None,
                           v_scale=None):
    """The CUDA kernel (same arguments as the plain version). Raises on
    what it does not take: non-CUDA or mixed devices, pools of another
    dtype than q, non-contiguous inputs, a GQA group outside 1/2/4/8, or
    a head size whose row is not 2..32 16-byte vectors wide."""
    B, Hq, D, NB, Hkv, BS, maxb = _check_shapes(
        q, key_cache, value_cache, block_tables, context_lens, k_scale,
        v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    tensors = (q, key_cache, value_cache, block_tables, context_lens)
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError('paged_decode_attention kernel: every input must '
                         f'be on one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if key_cache.dtype != q.dtype or value_cache.dtype != q.dtype:
        raise TypeError(
            f'paged_decode_attention kernel: pools ({key_cache.dtype}, '
            f'{value_cache.dtype}) must have q\'s dtype {q.dtype}')
    if (block_tables.dtype != torch.int32
            or context_lens.dtype != torch.int32):
        raise TypeError('paged_decode_attention kernel: block_tables and '
                        'context_lens must be int32')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('paged_decode_attention kernel: inputs must be '
                         'contiguous')
    vec = 16 // q.element_size()
    lpr = D // vec
    if Hq // Hkv not in GROUPS or D % vec or lpr not in (2, 4, 8, 16, 32):
        raise ValueError(
            f'paged_decode_attention kernel: needs Hq/Hkv in {GROUPS} '
            f'and D a multiple of {vec} between {2 * vec} and {32 * vec} '
            f'with D/{vec} a power of two; got Hq={Hq}, Hkv={Hkv}, D={D}')
    code = _build.dtype_code(q, 'paged_decode_attention')
    out = torch.empty_like(q)
    lib = _build.load()
    err = lib.pt_paged_decode_attention(
        dev.index, q.data_ptr(), key_cache.data_ptr(),
        value_cache.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, NB, BS, maxb,
        float(scale), code, _build.stream_ptr(q))
    _build.check(err, 'paged_decode_attention')
    _build.LAUNCHES['paged_decode_attention'] += 1
    return out
