from .generation import (GenerationMixin, PagedKVCache, QuantKVCache,
                         QuantPagedKVCache, RowQuantKVCache,
                         calibrate_kv_scale, default_positions,
                         dequantize_kv_row, filter_logits,
                         filter_logits_batched, quantize_kv_row,
                         quantize_kv_rows)
from .convert import (from_hf_llama, from_hf_llama_pretrained,
                      from_hf_mixtral, from_hf_mixtral_pretrained,
                      from_hf_qwen2, from_hf_qwen2_pretrained,
                      hf_llama_config, hf_mixtral_config, hf_qwen2_config)
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny
from .moe_lm import MoEConfig, MoEForCausalLM, moe_tiny

__all__ = ['GenerationMixin', 'LlamaConfig', 'LlamaForCausalLM',
           'MoEConfig', 'MoEForCausalLM', 'PagedKVCache', 'QuantKVCache',
           'QuantPagedKVCache', 'RowQuantKVCache', 'calibrate_kv_scale',
           'default_positions', 'dequantize_kv_row', 'filter_logits',
           'filter_logits_batched', 'from_hf_llama',
           'from_hf_llama_pretrained', 'from_hf_mixtral',
           'from_hf_mixtral_pretrained', 'from_hf_qwen2',
           'from_hf_qwen2_pretrained', 'hf_llama_config',
           'hf_mixtral_config', 'hf_qwen2_config', 'llama_7b', 'llama_tiny',
           'moe_tiny', 'quantize_kv_row', 'quantize_kv_rows']
