"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py). A clip
object maps a {name: gradient} dict to a clipped one; attach it to an
optimizer with `grad_clip=`, which applies it first in every update."""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / global norm), the norm
    taken in float32 over all of them. The scale stays on the device:
    clipping reads nothing back to the host."""

    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        gs = [g for g in grads.values() if g is not None]
        if not gs:
            return dict(grads)
        gn = torch.stack([g.float().square().sum() for g in gs]).sum().sqrt()
        scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        return {n: None if g is None else (g * scale).to(g.dtype)
                for n, g in grads.items()}


__all__ = ['ClipGradByGlobalNorm']
