"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py): plain PyTorch, statistics in float32
whatever the input dtype. The fused kernel is `paddle_tpu_torch.ops`."""
from __future__ import annotations

from ...ops.hopper.rms_norm import rms_norm_plain


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis (Llama family)."""
    return rms_norm_plain(x, weight, epsilon)
