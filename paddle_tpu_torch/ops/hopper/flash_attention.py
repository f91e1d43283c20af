"""Flash attention forward and backward: the hand-written Hopper kernels,
their plain versions, and the autograd Function that picks between them.

The kernels replace the TPU kernels
`paddle_tpu/ops/pallas/flash_attention.py::_fwd` (`flash_attention_fwd`)
and `::_bwd` (`flash_attention_bwd`, two launches: dq, then dk and dv);
`flash_attention_fwd_plain` and `flash_attention_bwd_plain` write out the
same math in float32 with plain PyTorch ops. Two routes, one rule
(`path`): bf16 with a head size up to 128 runs on the tensor cores
(`csrc/flash_attention_tc.cu`: wgmma over bf16 tiles, P and dS rounded
to bf16 before their products), float32 and bf16 past 128 on the CUDA
cores (`csrc/flash_attention.cu`, float32 products);
`FLASH_PATH_LAUNCHES` counts the launches of each route.

Layout (B, H, S, D), as the JAX package's kernels take it: q (B, H, Sq,
D), k and v (B, Hkv, Sk, D), query head h reading kv head h // (H / Hkv).
The kernels take any strides over (batch, head, sequence) with D
contiguous, so the (B, S, H, D) tensors of the model pass as transposed
views without a copy, and they return views of (B, S, H, D) buffers.
Causal masking is bottom-right (query i sees keys j <= i + Sk - Sq); a
query that sees no key returns 0.

Two modes of the TPU kernels, each a kernel of its own in PERF.md's
table and counted under its own `LAUNCHES` key:
- segment ids (K5s forward, K6s backward; the `qseg` / `kseg` operands of
  the TPU `_fwd` / `_bwd`): (B, Sq) and (B, Sk) int32, a query seeing
  only keys of its own segment, combined with the other masks; counted
  under `flash_attention_fwd_seg` / `flash_attention_bwd_seg`;
- a sliding window (K5w forward, K6w backward; their `window` mode): a
  query sees only its last `window` positions, itself included
  (q + Sk - Sq - k < window); counted under `flash_attention_fwd_window`
  / `flash_attention_bwd_window`. A call with both counts as `_seg`.
Every masked pair has probability 0, so a query with no visible key
returns 0, has dq = 0 and gives no gradient to any key or value.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256      # head widths built: multiples of 8 up to this
TC_MAX_HEAD_DIM = 128   # ... of which bf16 runs on the tensor cores
TC_KEYS = 128           # keys per block of the tensor cores' dk/dv pass

# launches per route, beside `_build.LAUNCHES`' per-kernel counts: each
# wrapper call adds its launches (forward 1, backward 2) to the route it
# took
FLASH_PATH_LAUNCHES = {'tensor_core': 0, 'cuda_core': 0}


def path(dtype, D):
    """The route of a flash attention call over head size D:

    - 'tensor_core': bf16 with D a multiple of 8 up to TC_MAX_HEAD_DIM
      (wgmma over bf16 tiles of 64 or 128 columns; P and dS are rounded
      to bf16 before their products, the sums are float32);
    - 'cuda_core': the rest, float32 (its products stay float32) and bf16
      past TC_MAX_HEAD_DIM (the backward's two 64 x 256 float32
      accumulators would take every register of a warpgroup).

    `check_built` refuses what neither route takes."""
    if dtype == torch.bfloat16 and D % 8 == 0 and 0 < D <= TC_MAX_HEAD_DIM:
        return 'tensor_core'
    return 'cuda_core'


def dkv_slices(B, Hkv, Sk, group, sms):
    """Slices of each kv head's `group` query heads that the tensor-core
    dk/dv pass spreads over its blocks (one block per SM): 1 when its (B
    x Hkv x key tiles) blocks fill the card's `sms` SMs once, else the
    least divisor of the group that gives two blocks per SM (the whole
    group when none does). Slicing costs a float32 round trip of the
    partial sums through memory, which loses where the unsliced grid
    already fills a wave (PERF.md's sweep). The slices are added in a
    fixed order, so the result does not depend on the blocks' order of
    arrival."""
    blocks = B * Hkv * -(-Sk // TC_KEYS)
    if blocks >= sms:
        return 1
    for n in range(2, group + 1):
        if group % n == 0 and blocks * n >= 2 * sms:
            return n
    return group


def _visible(Sq, Sk, causal, device, qseg=None, kseg=None, window=None):
    """Which keys each query sees: (Sq, Sk) bool (bottom-right causal,
    the window's band), or (B, 1, Sq, Sk) with segment ids (B, Sq) /
    (B, Sk)."""
    back = (torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
            - torch.arange(Sk, device=device)[None, :])
    ok = (back >= 0 if causal
          else torch.ones(Sq, Sk, dtype=torch.bool, device=device))
    if window is not None:
        ok = ok & (back < window)
    if qseg is not None:
        ok = ok & (qseg[:, :, None] == kseg[:, None, :])[:, None]
    return ok


def _expand_kv(t, group):
    return t.float().repeat_interleave(group, dim=1) if group > 1 \
        else t.float()


def _check_segments(q, k, qseg, kseg):
    if (qseg is None) != (kseg is None):
        raise ValueError('flash attention: pass both segment id arrays or '
                         'neither')
    if qseg is not None and (tuple(qseg.shape) != (q.shape[0], q.shape[2])
                             or tuple(kseg.shape) != (k.shape[0],
                                                      k.shape[2])):
        raise ValueError(
            f'flash attention: segment ids must be (B, Sq) and (B, Sk), '
            f'got {tuple(qseg.shape)} and {tuple(kseg.shape)}')


def _check_window(window):
    if window is not None and int(window) < 1:
        raise ValueError(f'flash attention: window must be >= 1, got '
                         f'{window}')


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None, qseg=None,
                              kseg=None, window=None):
    """(out, lse): out (B, H, Sq, D) in q's dtype, lse (B, H, Sq)
    float32 (the JAX package's `_fwd` in float32); with segment ids
    qseg (B, Sq) / kseg (B, Sk), a query attends only keys of its own
    segment; with a `window`, only its last `window` positions."""
    _check_segments(q, k, qseg, kseg)
    _check_window(window)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    group = H // k.shape[1]
    s = torch.einsum('bhqd,bhkd->bhqk', q.float() * scale,
                     _expand_kv(k, group))
    ok = _visible(Sq, Sk, causal, q.device, qseg, kseg, window)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum('bhqk,bhkd->bhqd', p, _expand_kv(v, group)) / safe
    return out.to(q.dtype), (m + torch.log(safe))[..., 0]


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              scale=None, qseg=None, kseg=None, window=None):
    """(dq, dk, dv) in the inputs' dtypes (the JAX package's `_bwd` in
    float32): delta = sum_d(do * out), p = exp(s - lse) on the visible
    pairs and 0 elsewhere, ds = p * (dp - delta); dk and dv summed over
    each GQA group. Segment ids and `window` as the forward took them."""
    _check_segments(q, k, qseg, kseg)
    _check_window(window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    group = H // Hkv
    qf, dof = q.float(), do.float()
    kf, vf = _expand_kv(k, group), _expand_kv(v, group)
    delta = (dof * out.float()).sum(-1)
    s = torch.einsum('bhqd,bhkd->bhqk', qf * scale, kf)
    ok = _visible(Sq, Sk, causal, q.device, qseg, kseg, window)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum('bhqk,bhqd->bhkd', p, dof)
    ds = p * (torch.einsum('bhqd,bhkd->bhqk', dof, vf) - delta[..., None])
    dq = scale * torch.einsum('bhqk,bhkd->bhqd', ds, kf)
    dk = scale * torch.einsum('bhqk,bhqd->bhkd', ds, qf)
    if group > 1:
        dk = dk.reshape(B, Hkv, group, Sk, D).sum(2)
        dv = dv.reshape(B, Hkv, group, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_view(t, vec):
    """`t` if the kernel can read it in place (D contiguous, 16-byte
    aligned rows), else a contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _bhsd_buffer(B, H, S, D, like):
    """A (B, H, S, D) view of a contiguous (B, S, H, D) buffer: the
    layout the model consumes next, with no copy."""
    return torch.empty(B, S, H, D, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def check_built(kernel, D):
    """Raise NotImplementedError for a head size the kernels are not
    built for (multiples of 8 up to MAX_HEAD_DIM are)."""
    if D % 8 or not 0 < D <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f'{kernel} kernel: head_dim {D} is not built (built: '
            f'multiples of 8 up to {MAX_HEAD_DIM})')


def _check(kernel, q, k, v, *more):
    _build.require_cuda(q, kernel)
    code = _build.dtype_code(q, kernel)
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or v.shape != k.shape:
        raise ValueError(f'{kernel} kernel: q (B, H, Sq, D) and k, v (B, '
                         f'Hkv, Sk, D), got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    if H % k.shape[1]:
        raise ValueError(f'{kernel} kernel: query heads ({H}) must be a '
                         f'multiple of kv heads ({k.shape[1]})')
    check_built(kernel, D)
    for t in (k, v, *more):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f'{kernel} kernel: every tensor must be '
                             f'{q.dtype} on {q.device}')
    vec = 16 // q.element_size()
    return code, [_kernel_view(t, vec) for t in (q, k, v, *more)]


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _kernel_modes(kernel, q, k, qseg, kseg, window):
    """The segment ids as the kernels take them (int32 on q's device,
    contiguous, or None), the window as an int (0 for none: a window
    past every key is the same mask, so it is capped at Sk), and the
    launch-count suffix of the mode."""
    _check_segments(q, k, qseg, kseg)
    _check_window(window)
    if qseg is not None:
        if (qseg.dtype != torch.int32 or kseg.dtype != torch.int32
                or qseg.device != q.device or kseg.device != q.device):
            raise TypeError(f'{kernel} kernel: segment ids must be int32 '
                            f'on {q.device}')
        qseg, kseg = qseg.contiguous(), kseg.contiguous()
    w = 0 if window is None else min(int(window), max(k.shape[2], 1))
    suffix = '_seg' if qseg is not None else '_window' if w else ''
    return qseg, kseg, w, suffix


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def flash_attention_fwd(q, k, v, causal=False, scale=None, qseg=None,
                        kseg=None, window=None):
    """The forward kernel on the card -> (out, lse) as the plain
    version returns them; out is a (B, H, Sq, D) view of a contiguous
    (B, Sq, H, D) buffer. Segment ids must be int32 on the card."""
    code, (q, k, v) = _check('flash_attention_fwd', q, k, v)
    qseg, kseg, w, suffix = _kernel_modes('flash_attention_fwd', q, k, qseg,
                                          kseg, window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = _bhsd_buffer(B, H, Sq, D, q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out)
    route = path(q.dtype, D)
    lib = _build.load()
    entry = (lib.pt_flash_attention_tc_fwd if route == 'tensor_core'
             else lib.pt_flash_attention_fwd)
    err = entry(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), _ptr(qseg), _ptr(kseg),
                strides, B, H, Hkv, Sq, Sk, D, float(scale),
                int(bool(causal)), w, code, _build.stream_ptr(q))
    key = 'flash_attention_fwd' + suffix
    _build.check(err, f'{key} ({route})')
    _build.LAUNCHES[key] += 1
    FLASH_PATH_LAUNCHES[route] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None,
                        qseg=None, kseg=None, window=None, slices=None):
    """The backward kernels on the card (dq, then dk and dv) -> (dq, dk,
    dv) as the plain version returns them, as views of (B, S, H, D)
    buffers. Segment ids and `window` as the forward took them.
    `slices` sets the tensor-core dk/dv pass's slices of each GQA group
    (a divisor of H / Hkv) in place of `dkv_slices`' choice, for timing
    the two against each other; the result is the same either way but
    for the order of its float32 sums."""
    code, (q, k, v, out, do) = _check('flash_attention_bwd', q, k, v, out,
                                      do)
    qseg, kseg, w, suffix = _kernel_modes('flash_attention_bwd', q, k, qseg,
                                          kseg, window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError('flash_attention_bwd kernel: lse must be the '
                         'forward\'s (B, H, Sq) float32 output')
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    lse = lse.contiguous()
    dq = _bhsd_buffer(B, H, Sq, D, q)
    dk = _bhsd_buffer(B, Hkv, Sk, D, k)
    dv = _bhsd_buffer(B, Hkv, Sk, D, v)
    if Sq == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out, do, dq, dk, dv)
    route = path(q.dtype, D)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    shape = (B, H, Hkv, Sq, Sk, D, float(scale), int(bool(causal)), w)
    lib = _build.load()
    if route == 'tensor_core':
        group = H // Hkv
        n = (dkv_slices(B, Hkv, Sk, group, _build.sm_count(q.device.index))
             if slices is None else int(slices))
        if n < 1 or group % n:
            raise ValueError(f'flash_attention_bwd kernel: slices must '
                             f'divide the GQA group {group}, got {slices}')
        part = counters = None
        if n > 1:
            blocks = B * Hkv * -(-Sk // TC_KEYS)
            width = 64 if D <= 64 else 128
            part = torch.empty(n * blocks * TC_KEYS * 2 * width,
                               dtype=torch.float32, device=q.device)
            counters = torch.empty(blocks, dtype=torch.int32,
                                   device=q.device)
        err = lib.pt_flash_attention_tc_bwd(
            q.device.index, *ptrs, _ptr(part), _ptr(counters), _ptr(qseg),
            _ptr(kseg), strides, *shape, n, code, _build.stream_ptr(q))
    else:
        err = lib.pt_flash_attention_bwd(
            q.device.index, *ptrs, _ptr(qseg), _ptr(kseg), strides, *shape,
            code, _build.stream_ptr(q))
    key = 'flash_attention_bwd' + suffix
    _build.check(err, f'{key} ({route})')
    _build.LAUNCHES[key] += 2
    FLASH_PATH_LAUNCHES[route] += 2
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention over (B, H, S, D) tensors with its backward: the kernels
    on a CUDA tensor, the plain versions on a CPU one (the counterpart of
    the JAX package's `_flash` / `_flash_seg` custom VJPs), in any mode:
    causal or not, segment ids (qseg, kseg int32, no gradient) and a
    window. The kernel functions are looked up in this module at call
    time, so a harness can swap in the plain ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, qseg=None, kseg=None,
                window=None):
        fwd = (flash_attention_fwd if _build.on_card(q, 'flash_attention')
               else flash_attention_fwd_plain)
        out, lse = fwd(q, k, v, causal, scale, qseg, kseg, window)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
        bwd = (flash_attention_bwd if _build.on_card(q, 'flash_attention')
               else flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale, qseg,
                         kseg, ctx.window)
        return dq, dk, dv, None, None, None, None, None
