from .generation import GenerationMixin, PagedKVCache, default_positions
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny

__all__ = ['GenerationMixin', 'LlamaConfig', 'LlamaForCausalLM',
           'PagedKVCache', 'default_positions', 'llama_7b', 'llama_tiny']
