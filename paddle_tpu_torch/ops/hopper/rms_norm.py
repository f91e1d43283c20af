"""RMSNorm forward and backward: the hand-written Hopper kernels, their
plain versions, and the autograd Function that picks between them.

The kernels (`csrc/rms_norm.cu`) replace the TPU kernels
`paddle_tpu/ops/pallas/rms_norm.py::_run_fwd` (`rms_norm`) and
`::_rms_bwd` (`rms_norm_bwd`, dx only); `rms_norm_plain` and
`rms_norm_bwd_plain` compute the same functions with plain PyTorch ops
(the CPU path, and the yardstick the kernels are held to). dw, a
reduction over rows, is plain PyTorch on both paths (`rms_norm_dweight`),
as the JAX package leaves it to XLA.
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


def rms_norm_bwd_plain(x, weight, r, g):
    """dx = r*g*w - x*r^3*mean(g*w*x) over the last axis, in float32,
    cast to x's dtype (the JAX package's `_dx_kernel`). r: float32,
    x.shape[:-1] + (1,)."""
    xf = x.float()
    gw = g.float() * weight.float()
    mean = (gw * xf).mean(-1, keepdim=True)
    return (r * gw - xf * (r * r * r) * mean).to(x.dtype)


def rms_norm_dweight(x, r, g, dtype):
    """dw = sum over rows of g * x * r, in float32, cast to `dtype`."""
    n = x.shape[-1]
    return (g.float() * x.float() * r).reshape(-1, n).sum(0).to(dtype)


def _check(x, weight, kernel):
    _build.require_cuda(x, kernel)
    N = x.shape[-1]
    if weight.shape != (N,) or weight.device != x.device:
        raise ValueError(f'{kernel} kernel: weight must be ({N},) on '
                         f'{x.device}, got {tuple(weight.shape)} on '
                         f'{weight.device}')
    if weight.dtype not in (torch.float32, x.dtype):
        raise TypeError(f'{kernel} kernel: weight dtype {weight.dtype} must '
                        f'be float32 or x\'s dtype {x.dtype}')
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f'{kernel} kernel: x and weight must be contiguous')
    return (_build.dtype_code(x, kernel), _build.dtype_code(weight, kernel),
            x.reshape(-1, N))


def rms_norm(x, weight=None, epsilon=1e-6, return_r=False):
    """The forward kernel over x (..., N) on the card; raises on what it
    does not take (device, dtype, layout). Weight: (N,), float32 or x's
    dtype (None means ones)."""
    if weight is None:
        weight = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    x_code, w_code, x2 = _check(x, weight, 'rms_norm')
    out = torch.empty_like(x2)
    r = (torch.empty((x2.shape[0], 1), dtype=torch.float32, device=x.device)
         if return_r else None)
    lib = _build.load()
    err = lib.pt_rms_norm_fwd(
        x.device.index, x2.data_ptr(), weight.data_ptr(), out.data_ptr(),
        r.data_ptr() if r is not None else None, x2.shape[0], x2.shape[1],
        float(epsilon), x_code, w_code, _build.stream_ptr(x))
    _build.check(err, 'rms_norm')
    _build.LAUNCHES['rms_norm'] += 1
    out = out.reshape(x.shape)
    if return_r:
        return out, r.reshape(x.shape[:-1] + (1,))
    return out


def rms_norm_bwd(x, weight, r, g):
    """The dx kernel on the card: x, g (..., N) contiguous in x's dtype,
    weight (N,), r (float32, x.shape[:-1] + (1,)) from the forward."""
    x_code, w_code, x2 = _check(x, weight, 'rms_norm_bwd')
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f'rms_norm_bwd kernel: g must be a contiguous '
                         f'{x.dtype} tensor of shape {tuple(x.shape)}')
    if (r.dtype != torch.float32 or r.numel() != x2.shape[0]
            or not r.is_contiguous()):
        raise ValueError('rms_norm_bwd kernel: r must be the forward\'s '
                         'contiguous float32 row scale')
    dx = torch.empty_like(x2)
    lib = _build.load()
    err = lib.pt_rms_norm_bwd(
        x.device.index, x2.data_ptr(), weight.data_ptr(), r.data_ptr(),
        g.data_ptr(), dx.data_ptr(), x2.shape[0], x2.shape[1], x_code,
        w_code, _build.stream_ptr(x))
    _build.check(err, 'rms_norm_bwd')
    _build.LAUNCHES['rms_norm_bwd'] += 1
    return dx.reshape(x.shape)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with its backward: the kernels on a CUDA tensor, the plain
    versions on a CPU one (the counterpart of the JAX package's
    `_rms_norm2d` custom VJP). The kernel functions are looked up in this
    module at call time, so a harness can swap in the plain ones."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        x = x.contiguous()
        fwd = (rms_norm if _build.on_card(x, 'rms_norm')
               else rms_norm_plain)
        out, r = fwd(x, weight, epsilon, return_r=True)
        ctx.save_for_backward(x, weight, r)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, r = ctx.saved_tensors
        g = g.contiguous()
        bwd = (rms_norm_bwd if _build.on_card(x, 'rms_norm_bwd')
               else rms_norm_bwd_plain)
        dx = bwd(x, weight, r, g) if ctx.needs_input_grad[0] else None
        dw = (rms_norm_dweight(x, r, g, weight.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None
