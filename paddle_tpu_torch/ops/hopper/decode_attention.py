"""Single-token decode attention over a contiguous KV cache: the
hand-written Hopper kernel and its plain version.

The kernel (`csrc/decode_attention.cu`) replaces the TPU kernel
`paddle_tpu/ops/pallas/decode_attention.py::decode_attention` in both of
its modes: bf16 / f32 caches of q's dtype, and int8 caches with
per-(kv head, dim) float32 scales `k_scale` / `v_scale` of shape
(Hkv, D). `decode_attention` launches it on CUDA tensors;
`decode_attention_plain` computes the same function with plain PyTorch
ops.

Semantics shared by both: q (B, 1, Hq, D) attends the window
[start, min(valid_len, S)) of its row of the (B, S, Hkv, D) caches,
query head h reading kv head h // (Hq / Hkv); `valid_len` and `start`
are ints or (B,) int tensors (start None is 0), start is clipped to
[0, S], scores are (q * scale) . k in float32, and a row whose window is
empty returns 0. The output has q's dtype.
"""
from __future__ import annotations

import functools
import math

import torch

from .. import _build

NEG_INF = -1e30
GROUPS = (1, 2, 4, 8)   # query heads per kv head the kernel is built for
TILE = 64               # positions per tile in the kernel
MIN_SPLIT = 64          # fewest positions a context split is given
BLOCKS_PER_SM = 8       # blocks the context splits aim to put on an SM


def _check_shapes(q, k_cache, v_cache, k_scale, v_scale):
    B, Sq, Hq, D = q.shape
    if Sq != 1:
        raise ValueError(f'decode_attention is single-token (Sq=1), got {Sq}')
    Bk, S, Hkv, Dk = k_cache.shape
    if (v_cache.shape != k_cache.shape or Bk != B or Dk != D):
        raise ValueError(
            f'decode_attention: caches {tuple(k_cache.shape)} / '
            f'{tuple(v_cache.shape)} do not match q {tuple(q.shape)}')
    if Hq % Hkv:
        raise ValueError(
            f'query heads ({Hq}) must be a multiple of kv heads ({Hkv})')
    if (k_scale is None) != (v_scale is None):
        raise ValueError('decode_attention: pass both k_scale and v_scale '
                         'or neither')
    if k_scale is not None:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError('decode_attention: k_scale / v_scale go with '
                            'int8 caches')
        for s in (k_scale, v_scale):
            if tuple(s.shape) != (Hkv, D):
                raise ValueError(f'decode_attention: scales must be '
                                 f'({Hkv}, {D}), got {tuple(s.shape)}')
    elif k_cache.dtype == torch.int8:
        raise ValueError('decode_attention: int8 caches need k_scale and '
                         'v_scale')
    return B, S, Hq, Hkv, D


def _per_row(x, B, device):
    """An int or a scalar / (B,) int tensor, as (B,) int64 on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(-1).expand(B)
    return torch.full((B,), int(x), dtype=torch.int64, device=device)


def decode_attention_plain(q, k_cache, v_cache, valid_len, scale=None,
                           k_scale=None, v_scale=None, start=None):
    """q (B, 1, Hq, D); caches (B, S, Hkv, D) of q's dtype, or int8 with
    k_scale / v_scale (Hkv, D) float32; valid_len, start: ints or (B,)
    int tensors. Returns (B, 1, Hq, D) in q's dtype."""
    B, S, Hq, Hkv, D = _check_shapes(q, k_cache, v_cache, k_scale, v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    end = _per_row(valid_len, B, q.device).clamp(max=S)
    st = _per_row(0 if start is None else start, B, q.device).clamp(0, S)
    pos = torch.arange(S, device=q.device)
    keep = (pos[None] < end[:, None]) & (pos[None] >= st[:, None])  # (B, S)

    def load(cache, s):                    # -> (B, S, Hq, D) f32
        c = cache.float()
        if s is not None:
            c = c * s.float()[None, None]
        c = torch.where(keep[:, :, None, None], c, 0.0)
        return c.repeat_interleave(Hq // Hkv, dim=2)

    s = torch.einsum('bhd,bshd->bhs', q[:, 0].float() * scale,
                     load(k_cache, k_scale))
    s = torch.where(keep[:, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep[:, None], torch.exp(s - m), 0.0)
    out = torch.einsum('bhs,bshd->bhd', p, load(v_cache, v_scale))
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out[:, None].to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(B, Hkv, S, sms):
    """(nsplit, chunk): the context split so that the (split, kv head,
    batch row) blocks put about BLOCKS_PER_SM blocks on each SM (a block
    walks its positions one tile after another, so the card needs many
    blocks in flight to keep its memory busy). Each split but the last
    holds `chunk` positions, a multiple of the kernel's tile."""
    n = -(-BLOCKS_PER_SM * sms // (B * Hkv))
    n = max(1, min(n, -(-S // MIN_SPLIT)))
    chunk = -(-(-(-S // n)) // TILE) * TILE
    return -(-S // chunk), chunk


def _row_arg(x, B, dev, what):
    """(pointer, scalar, tensor) for the kernel: a (B,) int32 tensor's
    pointer (the tensor is returned to keep it alive over the launch), or
    0 and the value of an int."""
    if x is None:
        return 0, 0, None
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f'decode_attention kernel: {what} must be on '
                             f'{dev}, got {x.device}')
        t = x.to(torch.int32).reshape(-1).expand(B).contiguous()
        return t.data_ptr(), 0, t
    return 0, int(x), None


def decode_attention(q, k_cache, v_cache, valid_len, scale=None,
                     k_scale=None, v_scale=None, start=None):
    """The CUDA kernel (same arguments as the plain version). Raises on
    what it does not take: non-CUDA or mixed devices, caches of another
    dtype than q (other than int8 with scales), non-contiguous inputs, a
    GQA group outside 1/2/4/8, or a head size above 128 or whose row is
    not a power of two of 16-byte loads (8-byte for int8)."""
    B, S, Hq, Hkv, D = _check_shapes(q, k_cache, v_cache, k_scale, v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    quant = k_scale is not None
    tensors = [q, k_cache, v_cache] + ([k_scale, v_scale] if quant else [])
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError('decode_attention kernel: every input must be on '
                         f'one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if not quant and (k_cache.dtype != q.dtype or v_cache.dtype != q.dtype):
        raise TypeError(
            f'decode_attention kernel: caches ({k_cache.dtype}, '
            f'{v_cache.dtype}) must have q\'s dtype {q.dtype} or be int8 '
            f'with scales')
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError('decode_attention kernel: scales must be float32')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('decode_attention kernel: inputs must be '
                         'contiguous')
    vec = 4 if k_cache.dtype == torch.float32 else 8
    if (Hq // Hkv not in GROUPS or D % vec or D > 128
            or D // vec not in (2, 4, 8, 16, 32)):
        raise ValueError(
            f'decode_attention kernel: needs Hq/Hkv in {GROUPS} and D a '
            f'multiple of {vec} between {2 * vec} and 128 with D/{vec} a '
            f'power of two; got Hq={Hq}, Hkv={Hkv}, D={D}')
    code = _build.dtype_code(q, 'decode_attention')
    vl_ptr, vl_all, vl_keep = _row_arg(valid_len, B, dev, 'valid_len')
    st_ptr, st_all, st_keep = _row_arg(start, B, dev, 'start')
    nsplit, chunk = splits(B, Hkv, S, _sm_count(dev.index))
    out = torch.empty_like(q)
    part_acc = part_ml = None     # the splits' partial states
    if nsplit > 1:
        part_acc = torch.empty(B, Hq, nsplit, D, dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty(B, Hq, nsplit, 2, dtype=torch.float32,
                              device=dev)
    lib = _build.load()
    err = lib.pt_decode_attention(
        dev.index, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else 0,
        v_scale.data_ptr() if quant else 0, vl_ptr, st_ptr, vl_all, st_all,
        out.data_ptr(), 0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(), B, S, Hq, Hkv, D,
        nsplit, chunk, float(scale), code, int(quant), _build.stream_ptr(q))
    _build.check(err, 'decode_attention')
    _build.LAUNCHES['decode_attention'] += 1
    return out
