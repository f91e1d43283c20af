from .generation import (GenerationMixin, PagedKVCache, QuantKVCache,
                         QuantPagedKVCache, RowQuantKVCache,
                         calibrate_kv_scale, default_positions,
                         dequantize_kv_row, filter_logits, quantize_kv_row,
                         quantize_kv_rows)
from .convert import (from_hf_llama, from_hf_llama_pretrained,
                      from_hf_qwen2, from_hf_qwen2_pretrained,
                      hf_llama_config, hf_qwen2_config)
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny

__all__ = ['GenerationMixin', 'LlamaConfig', 'LlamaForCausalLM',
           'PagedKVCache', 'QuantKVCache', 'QuantPagedKVCache',
           'RowQuantKVCache', 'calibrate_kv_scale', 'default_positions',
           'dequantize_kv_row', 'filter_logits', 'from_hf_llama',
           'from_hf_llama_pretrained', 'from_hf_qwen2',
           'from_hf_qwen2_pretrained', 'hf_llama_config', 'hf_qwen2_config',
           'llama_7b', 'llama_tiny', 'quantize_kv_row', 'quantize_kv_rows']
