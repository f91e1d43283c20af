"""Paged single-token decode attention: the hand-written Hopper kernel
and its plain version.

The kernel (`csrc/paged_attention.cu`, on the decode-attention template
of `csrc/decode_attention.cuh` with a page-table loader) replaces the
TPU kernel `paddle_tpu/ops/pallas/paged_attention.py::
paged_decode_attention` in all three of its modes: bf16 / f32 pages of
q's dtype (K8 of PERF.md), and int8 pages (K8q) with float32 scales
`k_scale` / `v_scale`, either per row, (NB, Hkv, BS) pools that ride
with their pages (the ServingEngine's `QuantPagedKVCache`), or global
per-(kv head, dim), (Hkv, D) (`block_multihead_attention`'s static cache
scales). `paged_decode_attention` launches it on CUDA tensors (one CUDA
kernel per call, counted under `paged_decode_attention`, or
`paged_decode_attention_int8` for int8 pages);
`paged_decode_attention_plain` computes the same function with plain
PyTorch ops.

Semantics shared by both: page ids are clamped to [0, NB - 1] (so -1
and out-of-range table entries are safe), context_lens is clamped to
[0, MAXB * BS], positions at or past the count are masked, a row whose
count is 0 returns zeros, and an int8 element is multiplied by its
scale in float32 before the dot.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import decode_attention as _decode

NEG_INF = -1e30
# page ids one block stages in shared memory (the kernel's kTblCap): a
# split of at most 8 tiles of 64 positions spans at most 512 pages (at
# BS = 1); a wider split reads its entries from the table instead
TABLE_PAGES = 520
# scale modes of the C entry (csrc/paged_attention.cu)
NO_SCALE, ROW_SCALE, HEAD_DIM_SCALE = 0, 1, 2


def _check_shapes(q, key_cache, value_cache, block_tables, context_lens,
                  k_scale, v_scale):
    """Shapes, and the scale mode the pools and scales make."""
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
    int8 = key_cache.dtype == torch.int8 or value_cache.dtype == torch.int8
    if (k_scale is None) != (v_scale is None):
        raise ValueError('paged_decode_attention: pass both k_scale and '
                         'v_scale or neither')
    if k_scale is None:
        if int8:
            raise ValueError('paged_decode_attention: int8 pages need '
                             'k_scale and v_scale')
        mode = NO_SCALE
    else:
        if key_cache.dtype != torch.int8 or value_cache.dtype != torch.int8:
            raise TypeError('paged_decode_attention: k_scale / v_scale go '
                            'with int8 pages')
        if k_scale.shape != v_scale.shape:
            raise ValueError('paged_decode_attention: k_scale and v_scale '
                             'shapes differ')
        if tuple(k_scale.shape) == (NB, Hkv, BS):
            mode = ROW_SCALE
        elif tuple(k_scale.shape) == (Hkv, D):
            mode = HEAD_DIM_SCALE
        else:
            raise ValueError(
                f'paged_decode_attention: scales must be per row '
                f'({NB}, {Hkv}, {BS}) or per (kv head, dim) ({Hkv}, {D}), '
                f'got {tuple(k_scale.shape)}')
    return B, Hq, D, NB, Hkv, BS, block_tables.shape[1], mode


def paged_decode_attention_plain(q, key_cache, value_cache, block_tables,
                                 context_lens, scale=None, k_scale=None,
                                 v_scale=None):
    """q (B, 1, Hq, D); pools (NB, Hkv, BS, D) of q's dtype, or int8 with
    k_scale / v_scale float32 of (NB, Hkv, BS) or (Hkv, D); block_tables
    (B, MAXB) int; context_lens (B,) int. Returns (B, 1, Hq, D) in q's
    dtype."""
    B, Hq, D, NB, Hkv, BS, maxb, mode = _check_shapes(
        q, key_cache, value_cache, block_tables, context_lens, k_scale,
        v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tbl = block_tables.long().clamp(0, NB - 1)
    counts = context_lens.long().clamp(0, maxb * BS)

    def gather(pool, s):                   # -> (B, MAXB*BS, Hq, D) f32
        g = pool[tbl].float()              # (B, MAXB, Hkv, BS, D)
        if mode == ROW_SCALE:
            g = g * s[tbl].float()[..., None]
        elif mode == HEAD_DIM_SCALE:
            g = g * s.float()[:, None, :]
        g = g.transpose(2, 3).reshape(B, maxb * BS, Hkv, D)
        return g.repeat_interleave(Hq // Hkv, dim=2)

    s = torch.einsum('bhd,bshd->bhs', q[:, 0].float() * scale,
                     gather(key_cache, k_scale))
    valid = (torch.arange(maxb * BS, device=q.device)[None, None, :]
             < counts[:, None, None])
    m = torch.where(valid, s, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    out = torch.einsum('bhs,bshd->bhd', p, gather(value_cache, v_scale))
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out[:, None].to(q.dtype)


@functools.lru_cache(maxsize=None)
def plan(index, code, mode, Hq, Hkv, D):
    """The launch geometry of a paged shape on CUDA device `index`
    (`decode_attention.Plan`; asked of the library once per shape; raises
    for a head size that is not built). `mode`: the scale mode."""
    out = (ctypes.c_int * 7)()
    err = _build.load().pt_paged_decode_attention_plan(index, code, mode, Hq,
                                                       Hkv, D, out)
    _build.check(err, 'paged_decode_attention')
    return _decode.Plan(*out)


def split_plan(B, Hkv, MAXB, BS, pl, sms):
    """(nsplit, chunk) of a launch: K7's context split
    (`decode_attention.splits`) over the table width MAXB * BS, the
    blocks' units the kv heads times the plan's head chunks. It depends
    on the shapes only, never on context_lens, so the launch can be
    captured in a CUDA graph; splits past a row's count read nothing."""
    return _decode.splits(B, Hkv * pl.nchunk, MAXB * BS, pl.tile,
                          pl.blocks_per_sm, sms, pl.stages)


def paged_decode_attention(q, key_cache, value_cache, block_tables,
                           context_lens, scale=None, k_scale=None,
                           v_scale=None):
    """The CUDA kernel (same arguments as the plain version). Raises on
    what it does not take: non-CUDA or mixed devices, float pools of
    another dtype than q, scales that are not float32, non-contiguous
    inputs; NotImplementedError for a head size that is not built
    (multiples of 8 for bf16 and int8 pages, of 4 for float32, up to
    256, as `decode_attention.check_built`). Every GQA group is
    built."""
    B, Hq, D, NB, Hkv, BS, maxb, mode = _check_shapes(
        q, key_cache, value_cache, block_tables, context_lens, k_scale,
        v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    tensors = [q, key_cache, value_cache, block_tables, context_lens]
    if mode != NO_SCALE:
        tensors += [k_scale, v_scale]
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError('paged_decode_attention kernel: every input must '
                         f'be on one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if mode == NO_SCALE and (key_cache.dtype != q.dtype
                             or value_cache.dtype != q.dtype):
        raise TypeError(
            f'paged_decode_attention kernel: pools ({key_cache.dtype}, '
            f'{value_cache.dtype}) must have q\'s dtype {q.dtype} or be '
            f'int8 with scales')
    if mode != NO_SCALE and (k_scale.dtype != torch.float32
                             or v_scale.dtype != torch.float32):
        raise TypeError('paged_decode_attention kernel: scales must be '
                        'float32')
    if (block_tables.dtype != torch.int32
            or context_lens.dtype != torch.int32):
        raise TypeError('paged_decode_attention kernel: block_tables and '
                        'context_lens must be int32')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('paged_decode_attention kernel: inputs must be '
                         'contiguous')
    _decode.check_built('paged_decode_attention', key_cache.dtype, D)
    code = _build.dtype_code(q, 'paged_decode_attention')
    out = torch.empty_like(q)
    if maxb == 0:               # no position: every row is empty
        return out.zero_()
    pl = plan(dev.index, code, mode, Hq, Hkv, D)
    nsplit, chunk = split_plan(B, Hkv, maxb, BS, pl,
                               _build.sm_count(dev.index))
    stream = _build.stream_ptr(q)
    part_acc = part_ml = counters = None     # the splits' partial states
    if nsplit > 1:
        part_acc = torch.empty(B, Hq, nsplit, D, dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty(B, Hq, nsplit, 2, dtype=torch.float32,
                              device=dev)
        counters = _decode._counters(dev, stream, B * Hkv * pl.nchunk)
    lib = _build.load()
    err = lib.pt_paged_decode_attention(
        dev.index, q.data_ptr(), key_cache.data_ptr(),
        value_cache.data_ptr(), k_scale.data_ptr() if mode else 0,
        v_scale.data_ptr() if mode else 0, block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(),
        0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(),
        0 if counters is None else counters.data_ptr(), B, Hq, Hkv, D, NB,
        BS, maxb, nsplit, chunk, float(scale), code, mode, stream)
    key = 'paged_decode_attention_int8' if mode else 'paged_decode_attention'
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    return out
