from .flash_attention import (flash_attention, flash_attn_qkvpacked,
                              flash_attn_unpadded,
                              flash_attn_varlen_qkvpacked)
from .attention import scaled_dot_product_attention
from .loss import softmax_cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ['flash_attention', 'flash_attn_qkvpacked', 'flash_attn_unpadded',
           'flash_attn_varlen_qkvpacked', 'layer_norm', 'rms_norm',
           'scaled_dot_product_attention', 'softmax_cross_entropy']
