"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py):
only the fused softmax cross-entropy is ported so far."""
from __future__ import annotations

from ...ops import softmax_cross_entropy

__all__ = ['softmax_cross_entropy']
