"""Single-token decode attention over a contiguous KV cache: the
hand-written Hopper kernel and its plain version.

The kernel (`csrc/decode_attention.cu`) replaces the TPU kernel
`paddle_tpu/ops/pallas/decode_attention.py::decode_attention` in both of
its modes: bf16 / f32 caches of q's dtype, and int8 caches with
per-(kv head, dim) float32 scales `k_scale` / `v_scale` of shape
(Hkv, D). `decode_attention` launches it on CUDA tensors;
`decode_attention_plain` computes the same function with plain PyTorch
ops. The kernel reads the caches through their strides, so
`ops/hopper/headmajor_attention.py` launches it over (B, Hkv, S, D)
caches as transposed views (kernel K9).

Semantics shared by both: q (B, 1, Hq, D) attends the window
[start, min(valid_len, S)) of its row of the (B, S, Hkv, D) caches,
query head h reading kv head h // (Hq / Hkv); `valid_len` and `start`
are ints or (B,) int tensors (start None is 0), start is clipped to
[0, S], scores are (q * scale) . k in float32, and a row whose window is
empty returns 0. The output has q's dtype.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from .. import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256      # widest head the kernel is built for
STAGES = 3              # K/V tiles in the kernel's shared-memory ring
MAX_SPLITS = 256        # context splits of one (row, kv head) at most
MAX_SPLIT_TILES = 8     # tiles of one split at most

# The launch geometry of one shape (`pt_decode_attention_plan`): blocks
# of its instantiation that fit on an SM, positions per tile, ring
# stages, query heads per block, head chunks per kv head, registers per
# thread and spilled bytes.
Plan = collections.namedtuple('Plan', 'blocks_per_sm tile stages heads '
                                      'nchunk regs local_bytes')


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


def check_built(kernel, cache_dtype, D):
    """Raise NotImplementedError for a head size the kernel is not
    built for. Every GQA group is built; D must be a multiple of the
    load width (4 elements of a float32 cache, 8 of bf16 or int8) up to
    MAX_HEAD_DIM, and a float32 row wider than 128 a multiple of 8."""
    vec = 4 if cache_dtype == torch.float32 else 8
    if D % vec or D > MAX_HEAD_DIM or (vec == 4 and D > 128 and D % 8):
        raise NotImplementedError(
            f'{kernel} kernel: head_dim {D} is not built for '
            f'{cache_dtype} caches (built: multiples of {vec} up to '
            f'{MAX_HEAD_DIM}' + (', above 128 multiples of 8)'
                                 if vec == 4 else ')'))


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



def splits(B, units, S, tile, blocks_per_sm, sms, stages=STAGES):
    """(nsplit, chunk): the context split of the (split, unit, batch row)
    blocks, `units` = kv heads x head chunks. The blocks fill one wave of
    the card (`blocks_per_sm`: the blocks of the instantiation that fit
    on an SM), each split given at least `stages` tiles (so its ring
    fills) where S allows; where that leaves SMs without a block, splits
    of down to one tile give each SM one. A split holds at most
    MAX_SPLIT_TILES tiles, more waves if need be: the windows are not
    known here, and a row whose window covers the cache must spread over
    enough blocks when the other rows' windows are short. At most
    MAX_SPLITS. Split i holds positions [i * chunk, (i + 1) * chunk),
    chunk a multiple of `tile`; the last holds the rest. It depends on S
    and the shapes only, never on the windows, so one launch per
    geometry can be captured."""
    per = max(1, B * units)
    n = min(blocks_per_sm * sms // per, S // (stages * tile))
    n = max(n, min(sms // per, S // tile), -(-S // (MAX_SPLIT_TILES * tile)),
            1)
    n = min(n, MAX_SPLITS)
    chunk = -(-(-(-S // n)) // tile) * tile
    return -(-S // chunk), chunk


@functools.lru_cache(maxsize=None)
def plan(index, code, quant, Hq, Hkv, D):
    """The launch geometry of a shape on CUDA device `index` (asked of the
    library once per shape; raises for a head size that is not built)."""
    out = (ctypes.c_int * 7)()
    err = _build.load().pt_decode_attention_plan(index, code, int(quant), Hq,
                                                 Hkv, D, out)
    _build.check(err, 'decode_attention')
    return Plan(*out)


_COUNTERS = {}   # (device index, stream) -> zeroed int32 counters
_OUTGROWN = []   # buffers replaced by larger ones, never freed


def _counters(dev, stream, n):
    """A zeroed int32 counter buffer of at least n for launches on
    `stream` (a pointer) of `dev`. Each launch leaves its counters at 0,
    and launches on one stream run in order, so they share the buffer;
    another stream has its own. A buffer that is outgrown is kept alive,
    since a CUDA graph captured with it holds its address."""
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


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
    dtype than q (other than int8 with scales), a q or scales that are
    not contiguous, or caches whose head dim is not contiguous or whose
    rows are not 16-byte aligned (8-byte for int8); NotImplementedError
    for a head size that is not built (`check_built`). Every GQA group
    is built."""
    return launch(q, k_cache, v_cache, valid_len, scale, k_scale, v_scale,
                  start, 'decode_attention')


def launch(q, k_cache, v_cache, valid_len, scale, k_scale, v_scale, start,
           kernel):
    """Launch the kernel over (B, S, Hkv, D) cache views of any strides
    with D contiguous, counting the launch under `kernel`: one CUDA
    kernel per call, whose last split to finish combines the splits."""
    B, S, Hq, Hkv, D = _check_shapes(q, k_cache, v_cache, k_scale, v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    quant = k_scale is not None
    tensors = [q, k_cache, v_cache] + ([k_scale, v_scale] if quant else [])
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{kernel} kernel: every input must be on one CUDA '
                         f'device, got {[str(t.device) for t in tensors]}')
    if not quant and (k_cache.dtype != q.dtype or v_cache.dtype != q.dtype):
        raise TypeError(
            f'{kernel} kernel: caches ({k_cache.dtype}, {v_cache.dtype}) '
            f'must have q\'s dtype {q.dtype} or be int8 with scales')
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError(f'{kernel} kernel: scales must be float32')
    dense = [q] + ([k_scale, v_scale] if quant else [])
    item = k_cache.element_size()
    align = 8 if quant else 16        # the bytes of one K/V copy
    if (not all(t.is_contiguous() for t in dense)
            or k_cache.stride() != v_cache.stride()
            or k_cache.stride(-1) != 1
            or any(st * item % align for st in k_cache.stride()[:3])):
        raise ValueError(f'{kernel} kernel: q and the scales must be '
                         f'contiguous, and the caches share strides with '
                         f'D contiguous and {align}-byte aligned rows')
    check_built(kernel, k_cache.dtype, D)
    code = _build.dtype_code(q, kernel)
    vl_ptr, vl_all, vl_keep = _row_arg(valid_len, B, dev, 'valid_len')
    st_ptr, st_all, st_keep = _row_arg(start, B, dev, 'start')
    pl = plan(dev.index, code, quant, Hq, Hkv, D)
    nsplit, chunk = splits(B, Hkv * pl.nchunk, S, pl.tile, pl.blocks_per_sm,
                           _build.sm_count(dev.index), pl.stages)
    stream = _build.stream_ptr(q)
    out = torch.empty_like(q)
    part_acc = part_ml = counters = None     # the splits' partial states
    if nsplit > 1:
        part_acc = torch.empty(B, Hq, nsplit, D, dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty(B, Hq, nsplit, 2, dtype=torch.float32,
                              device=dev)
        counters = _counters(dev, stream, B * Hkv * pl.nchunk)
    b_stride, pos_stride, h_stride = k_cache.stride()[:3]
    lib = _build.load()
    err = lib.pt_decode_attention(
        dev.index, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else 0,
        v_scale.data_ptr() if quant else 0, vl_ptr, st_ptr, vl_all, st_all,
        out.data_ptr(), 0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(),
        0 if counters is None else counters.data_ptr(), B, S, Hq, Hkv, D,
        b_stride, h_stride, pos_stride, nsplit, chunk, float(scale), code,
        int(quant), stream)
    _build.check(err, kernel)
    _build.LAUNCHES[kernel] += 1
    return out
