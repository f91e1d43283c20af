"""RMSNorm forward: the hand-written Hopper kernel and its plain version.

The kernel (`csrc/rms_norm.cu`) replaces the TPU kernel
`paddle_tpu/ops/pallas/rms_norm.py::_run_fwd`. `rms_norm` launches it on
CUDA tensors; `rms_norm_plain` computes the same function with plain
PyTorch ops (the CPU path, and the yardstick the kernel is held to).
"""
from __future__ import annotations

import torch

from .. import _build


def rms_norm_plain(x, weight=None, epsilon=1e-6, return_r=False):
    """y = x * rsqrt(mean(x^2) + eps) * w in float32, cast to x's dtype;
    with `return_r`, also r = rsqrt(mean(x^2) + eps) per row (float32,
    shape x.shape[:-1] + (1,))."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
    out = xf * r
    if weight is not None:
        out = out * weight.float()
    out = out.to(x.dtype)
    return (out, r) if return_r else out


def rms_norm(x, weight=None, epsilon=1e-6, return_r=False):
    """The CUDA kernel over x (..., N) on the card; raises on what it does
    not take (device, dtype, layout). Weight: (N,), float32 or x's dtype
    (None means ones)."""
    if x.device.type != 'cuda':
        raise ValueError(f'rms_norm kernel: x must be on a CUDA device, '
                         f'got {x.device}')
    N = x.shape[-1]
    if weight is None:
        weight = torch.ones(N, dtype=x.dtype, device=x.device)
    if weight.shape != (N,) or weight.device != x.device:
        raise ValueError(f'rms_norm kernel: weight must be ({N},) on '
                         f'{x.device}, got {tuple(weight.shape)} on '
                         f'{weight.device}')
    if weight.dtype not in (torch.float32, x.dtype):
        raise TypeError(f'rms_norm kernel: weight dtype {weight.dtype} must '
                        f'be float32 or x\'s dtype {x.dtype}')
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError('rms_norm kernel: x and weight must be contiguous')
    x_code = _build.dtype_code(x, 'rms_norm')
    w_code = _build.dtype_code(weight, 'rms_norm')
    x2 = x.reshape(-1, N)
    out = torch.empty_like(x2)
    r = (torch.empty((x2.shape[0], 1), dtype=torch.float32, device=x.device)
         if return_r else None)
    lib = _build.load()
    err = lib.pt_rms_norm_fwd(
        x.device.index, x2.data_ptr(), weight.data_ptr(), out.data_ptr(),
        r.data_ptr() if r is not None else None, x2.shape[0], N,
        float(epsilon), x_code, w_code, _build.stream_ptr(x))
    _build.check(err, 'rms_norm')
    _build.LAUNCHES['rms_norm'] += 1
    out = out.reshape(x.shape)
    if return_r:
        return out, r.reshape(x.shape[:-1] + (1,))
    return out
