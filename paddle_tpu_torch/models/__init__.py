from .generation import (GenerationMixin, PagedKVCache, QuantKVCache,
                         calibrate_kv_scale, default_positions,
                         filter_logits, quantize_kv_rows)
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny

__all__ = ['GenerationMixin', 'LlamaConfig', 'LlamaForCausalLM',
           'PagedKVCache', 'QuantKVCache', 'calibrate_kv_scale',
           'default_positions', 'filter_logits', 'llama_7b', 'llama_tiny',
           'quantize_kv_rows']
