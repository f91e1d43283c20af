"""Softmax cross-entropy forward and backward: the hand-written Hopper
kernels, their plain versions, and the autograd Function that picks
between them.

The kernels (`csrc/softmax_xent.cu`) replace the TPU kernels
`paddle_tpu/ops/pallas/softmax_xent.py::_run_fwd` (`softmax_xent_fwd`)
and `::_xent_bwd` (`softmax_xent_bwd`); `softmax_xent_fwd_plain` and
`softmax_xent_bwd_plain` compute the same functions with plain PyTorch
ops. A label outside [0, V) picks -1e30 (so its loss is huge), as the
TPU kernel's masked pick does.
"""
from __future__ import annotations

import torch

from .. import _build

NEG_INF = -1e30


def softmax_xent_fwd_plain(logits, labels):
    """logits (R, V), labels (R,) int -> (loss, lse), both (R,) float32:
    lse = log(sum(exp(x))), loss = lse - x[label]."""
    xf = logits.float()
    V = xf.shape[-1]
    m = xf.amax(-1, keepdim=True)
    lse = m[:, 0] + torch.log(torch.exp(xf - m).sum(-1).clamp_min(1e-30))
    valid = (labels >= 0) & (labels < V)
    picked = xf.gather(1, labels.long().clamp(0, V - 1)[:, None])[:, 0]
    return lse - torch.where(valid, picked, NEG_INF), lse


def softmax_xent_bwd_plain(logits, labels, lse, g):
    """dx = (exp(x - lse) - onehot(label)) * g, in the logits' dtype;
    lse and g: (R,) float32."""
    xf = logits.float()
    cols = torch.arange(xf.shape[-1], device=xf.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    return ((torch.exp(xf - lse[:, None]) - onehot)
            * g.float()[:, None]).to(logits.dtype)


def _check(logits, labels, kernel):
    _build.require_cuda(logits, kernel)
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f'{kernel} kernel: logits (R, V) and labels (R,), '
                         f'got {tuple(logits.shape)} and '
                         f'{tuple(labels.shape)}')
    if not logits.is_contiguous():
        raise ValueError(f'{kernel} kernel: logits must be contiguous')
    if labels.device != logits.device or labels.dtype != torch.int64:
        raise ValueError(f'{kernel} kernel: labels must be int64 on '
                         f'{logits.device}')
    return _build.dtype_code(logits, kernel), labels.contiguous()


def softmax_xent_fwd(logits, labels):
    """The forward kernel on the card: logits (R, V) bf16 or float32,
    labels (R,) int64 -> (loss, lse), (R,) float32 each."""
    code, labels = _check(logits, labels, 'softmax_xent_fwd')
    R, V = logits.shape
    loss = torch.empty(R, dtype=torch.float32, device=logits.device)
    lse = torch.empty(R, dtype=torch.float32, device=logits.device)
    lib = _build.load()
    err = lib.pt_softmax_xent_fwd(
        logits.device.index, logits.data_ptr(), labels.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), R, V, code,
        _build.stream_ptr(logits))
    _build.check(err, 'softmax_xent_fwd')
    _build.LAUNCHES['softmax_xent_fwd'] += 1
    return loss, lse


def softmax_xent_bwd(logits, labels, lse, g):
    """The backward kernel on the card: dx (R, V) in the logits' dtype."""
    code, labels = _check(logits, labels, 'softmax_xent_bwd')
    R, V = logits.shape
    for name, t in (('lse', lse), ('g', g)):
        if t.shape != (R,) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f'softmax_xent_bwd kernel: {name} must be a '
                             f'contiguous ({R},) float32 tensor')
    dx = torch.empty_like(logits)
    lib = _build.load()
    err = lib.pt_softmax_xent_bwd(
        logits.device.index, logits.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dx.data_ptr(), R, V, code,
        _build.stream_ptr(logits))
    _build.check(err, 'softmax_xent_bwd')
    _build.LAUNCHES['softmax_xent_bwd'] += 1
    return dx


class SoftmaxXentFn(torch.autograd.Function):
    """Per-row nll of logits (R, V) against labels (R,), with its
    backward: the kernels on a CUDA tensor, the plain versions on a CPU
    one (the counterpart of the JAX package's `_xent2d` custom VJP). The
    kernel functions are looked up in this module at call time, so a
    harness can swap in the plain ones."""

    @staticmethod
    def forward(ctx, logits, labels):
        logits = logits.contiguous()
        labels = labels.long()
        fwd = (softmax_xent_fwd if _build.on_card(logits, 'softmax_xent')
               else softmax_xent_fwd_plain)
        loss, lse = fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        bwd = (softmax_xent_bwd if _build.on_card(logits, 'softmax_xent')
               else softmax_xent_bwd_plain)
        return bwd(logits, labels, lse, g.float().contiguous()), None
