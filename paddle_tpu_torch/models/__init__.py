from .generation import (GenerationMixin, PagedKVCache, QuantKVCache,
                         QuantPagedKVCache, RowQuantKVCache,
                         calibrate_kv_scale, default_positions,
                         dequantize_kv_row, filter_logits, quantize_kv_row,
                         quantize_kv_rows)
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny

__all__ = ['GenerationMixin', 'LlamaConfig', 'LlamaForCausalLM',
           'PagedKVCache', 'QuantKVCache', 'QuantPagedKVCache',
           'RowQuantKVCache', 'calibrate_kv_scale', 'default_positions',
           'dequantize_kv_row', 'filter_logits', 'llama_7b', 'llama_tiny',
           'quantize_kv_row', 'quantize_kv_rows']
