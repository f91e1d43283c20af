"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package `paddle_tpu` stays beside it as the reference; this
package never imports JAX or anything of `paddle_tpu`. Plain tensor
code is PyTorch; every TPU kernel on a ported path is a kernel written
by hand for Hopper (`ops/`, sources in `csrc/`). Entry points run on the
card unless the caller passes `device='cpu'`.

Ported so far: Llama-family models (`models.llama.LlamaForCausalLM`)
served through paged continuous batching (`inference.ServingEngine`),
generating over contiguous KV caches (`generate`,
`inference.DecodeEngine`; bf16 or int8 caches, int8 / int4 weights via
`quantize_weights`), and trained (`training.TrainEngine` with the
`optimizer` package).
"""
from .device import resolve_device

__version__ = '0.1.0'

__all__ = ['resolve_device']
