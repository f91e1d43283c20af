"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py): plain PyTorch, statistics in float32
whatever the input dtype. The fused RMSNorm kernel is
`paddle_tpu_torch.ops`; the JAX package has no Pallas layer norm, so
`layer_norm` is PyTorch's own."""
from __future__ import annotations

import torch

from ...ops.hopper.rms_norm import rms_norm_plain


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis (Llama family)."""
    return rms_norm_plain(x, weight, epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` axes: (x - mean) /
    sqrt(var + eps) * w + b, computed in float32 and cast to x's
    dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    out = torch.nn.functional.layer_norm(
        x.float(), tuple(normalized_shape),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)
