"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package `paddle_tpu` stays beside it as the reference; this
package never imports JAX or anything of `paddle_tpu`. Plain tensor
code is PyTorch; every TPU kernel on a ported path is a kernel written
by hand for Hopper (`ops/`, sources in `csrc/`). Entry points run on the
card unless the caller passes `device='cpu'`.

This slice serves Llama-family models through paged continuous
batching: `models.llama.LlamaForCausalLM` and
`inference.ServingEngine`.
"""
from .device import resolve_device

__version__ = '0.1.0'

__all__ = ['resolve_device']
