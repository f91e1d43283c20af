"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch

from ... import ops


class RMSNorm(torch.nn.Module):
    """RMSNorm over the trailing `normalized_shape` axis, through the
    fused kernels on the card (forward and backward). The weight is
    float32 and starts at ones, as in the JAX package (whatever the
    model's dtype)."""

    def __init__(self, normalized_shape, epsilon=1e-6, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(
            torch.ones(self.normalized_shape, dtype=torch.float32,
                       device=device))

    def forward(self, x):
        # looked up on the module at call time: a harness may swap in the
        # plain version to hold the kernel path against it
        return ops.rms_norm(x, self.weight, self.epsilon)
