"""paddle_tpu_torch.incubate.nn (counterpart of paddle_tpu.incubate.nn):
the fused-inference decoder stack and its functional ops."""
from . import functional
from .layer import FusedMultiTransformer

__all__ = ['FusedMultiTransformer', 'functional']
