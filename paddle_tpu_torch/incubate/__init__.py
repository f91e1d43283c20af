"""paddle_tpu_torch.incubate (counterpart of paddle_tpu.incubate): of
its surfaces, the port so far has the fused-inference ops of
`incubate.nn` (masked_multihead_attention, block_multihead_attention,
fused_multi_transformer and FusedMultiTransformer)."""
from . import nn

__all__ = ['nn']
