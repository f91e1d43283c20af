"""HuggingFace Llama / Qwen2 configurations and state dicts to the port's
`LlamaForCausalLM` (counterpart of paddle_tpu/models/convert.py's Llama
and Qwen2 converters).

`hf_llama_config` / `hf_qwen2_config` map a transformers config (a
plain dict, as `config.json` reads, or an object with attributes) onto
`LlamaConfig`, with the JAX package's guards: only plain, 'llama3' and
'yarn' rope scaling, and a SwiGLU activation. `from_hf_llama` /
`from_hf_qwen2` build the model from a state dict of HF names (torch
tensors or numpy arrays), transposing every projection: HF's Linear
weights are (out, in) applied as x W^T, the port's are (in, out) applied
as x W.

The `*_pretrained` loaders need transformers and checkpoint files, which
the port does not depend on: they raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ..device import torch_dtype
from .llama import LlamaConfig, LlamaForCausalLM


def _getter(hf_config):
    if isinstance(hf_config, dict):
        return hf_config.get
    return lambda k, d=None: getattr(hf_config, k, d)


def _has(hf_config, key):
    if isinstance(hf_config, dict):
        return key in hf_config
    return hasattr(hf_config, key)


def hf_llama_config(hf_config) -> LlamaConfig:
    """Map a transformers LlamaConfig (dict or object) onto ours."""
    get = _getter(hf_config)
    scaling = get('rope_scaling')
    kind = (scaling.get('rope_type', scaling.get('type', 'default'))
            if isinstance(scaling, dict) else None)
    if scaling and (not isinstance(scaling, dict)
                    or kind not in (None, 'default', 'llama3', 'yarn')):
        raise ValueError(
            f'rope_scaling={scaling!r} is not supported by this converter '
            f"(plain rope_theta RoPE, rope_type='llama3', or 'yarn' only): "
            f'converting would give wrong logits at long positions')
    if scaling and kind == 'llama3':
        missing = [k for k in ('factor', 'low_freq_factor',
                               'high_freq_factor',
                               'original_max_position_embeddings')
                   if k not in scaling]
        if missing:
            raise ValueError(
                f"rope_scaling rope_type='llama3' is missing required keys "
                f'{missing}: refusing rather than guessing defaults')
    if scaling and kind == 'yarn' and 'factor' not in scaling:
        raise ValueError("rope_scaling rope_type='yarn' is missing 'factor': "
                         'refusing rather than guessing')
    act = get('hidden_act', 'silu')
    if act not in ('silu', 'swish'):
        raise ValueError(
            f'hidden_act={act!r} unsupported: the model hardcodes SwiGLU')
    return LlamaConfig(
        vocab_size=get('vocab_size'),
        hidden_size=get('hidden_size'),
        intermediate_size=get('intermediate_size'),
        num_hidden_layers=get('num_hidden_layers'),
        num_attention_heads=get('num_attention_heads'),
        num_key_value_heads=(get('num_key_value_heads')
                             or get('num_attention_heads')),
        max_position_embeddings=get('max_position_embeddings', 4096),
        rms_norm_eps=get('rms_norm_eps', 1e-5),
        rope_theta=get('rope_theta', 10000.0),
        rope_scaling=dict(scaling) if scaling else None,
        tie_word_embeddings=bool(get('tie_word_embeddings', False)),
        attention_bias=bool(get('attention_bias', False)),
        # Mistral-style: a sliding_window with no gating flag (Qwen2's
        # use_sliding_window is read by hf_qwen2_config)
        sliding_window=(get('sliding_window')
                        if get('use_sliding_window', True) else None),
    )


def hf_qwen2_config(hf_config) -> LlamaConfig:
    """Map a transformers Qwen2Config onto LlamaConfig: the Llama mapping
    (with its guards) plus qkv biases and Qwen2's defaults. A window
    applies only with use_sliding_window, on the layers at or past
    max_window_layers; an absent sliding_window means 4096, an explicit
    null none (as transformers reads them)."""
    get = _getter(hf_config)
    cfg = hf_llama_config(hf_config)
    if get('use_sliding_window', False):
        sliding = ((get('sliding_window') or None)
                   if _has(hf_config, 'sliding_window') else 4096)
    else:
        sliding = None
    return dataclasses.replace(
        cfg,
        max_position_embeddings=get('max_position_embeddings', 32768),
        rms_norm_eps=get('rms_norm_eps', 1e-6),
        rope_theta=get('rope_theta', 1e6),
        attention_bias=True,
        sliding_window=sliding,
        max_window_layers=(get('max_window_layers', 28) or 0
                           if sliding is not None else 0),
    )


def _tensor(value):
    """A state-dict value (torch tensor or array) as a CPU tensor; torch
    bf16 reads as float32, as the JAX converter reads it."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        return t.float() if t.dtype == torch.bfloat16 else t
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def from_hf_llama(state_dict, config, dtype=None, device=None):
    """Build a LlamaForCausalLM from a HuggingFace Llama state dict (HF
    names, `model.layers.N...`). `dtype` casts every weight (default:
    as given); `device` as `LlamaForCausalLM` takes it (None is the
    card). Raises on a weight left unconverted."""
    sd = dict(state_dict)
    model = LlamaForCausalLM(config, device=device)
    dev = model.device
    cast = torch_dtype(dtype) if dtype is not None else None

    def assign(module, name, value, transpose=False):
        t = _tensor(value)
        if transpose:
            t = t.T
        if cast is not None:
            t = t.to(cast)
        setattr(module, name, torch.nn.Parameter(
            t.contiguous().to(dev), requires_grad=True))

    m = model.model
    assign(m, 'embed_tokens', sd.pop('model.embed_tokens.weight'))
    for i, layer in enumerate(m.layers):
        p = f'model.layers.{i}.'
        attn = layer.self_attn
        for w in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
            assign(attn, w, sd.pop(p + f'self_attn.{w}.weight'),
                   transpose=True)
        if config.attention_bias:          # Qwen2-style qkv biases
            for w in ('q', 'k', 'v'):
                assign(attn, f'{w}_bias',
                       sd.pop(p + f'self_attn.{w}_proj.bias'))
        for w in ('gate_proj', 'up_proj', 'down_proj'):
            assign(layer.mlp, w, sd.pop(p + f'mlp.{w}.weight'),
                   transpose=True)
        assign(layer.input_layernorm, 'weight',
               sd.pop(p + 'input_layernorm.weight'))
        assign(layer.post_attention_layernorm, 'weight',
               sd.pop(p + 'post_attention_layernorm.weight'))
    assign(m.norm, 'weight', sd.pop('model.norm.weight'))
    if config.tie_word_embeddings:
        sd.pop('lm_head.weight', None)
    else:
        assign(model, 'lm_head', sd.pop('lm_head.weight'), transpose=True)
    leftovers = [k for k in sd
                 if not re.search(r'rotary_emb|inv_freq|position_ids', k)]
    if leftovers:
        raise ValueError(f'unconverted HF weights: {leftovers[:8]}')
    return model


def from_hf_qwen2(state_dict, config, dtype=None, device=None):
    """Build a LlamaForCausalLM from a HuggingFace Qwen2 state dict: the
    Llama mapping, which takes the qkv biases when
    `config.attention_bias` is set."""
    return from_hf_llama(state_dict, config, dtype=dtype, device=device)


def _needs_transformers(name):
    raise NotImplementedError(
        f'{name} loads a transformers model or checkpoint files, which the '
        f'port does not depend on: read the state dict and config.json '
        f'yourself and call from_hf_llama / from_hf_qwen2 with '
        f'hf_llama_config / hf_qwen2_config')


def from_hf_llama_pretrained(model_or_path, dtype=None):
    """Not ported (needs transformers): raises NotImplementedError."""
    _needs_transformers('from_hf_llama_pretrained')


def from_hf_qwen2_pretrained(model_or_path, dtype=None):
    """Not ported (needs transformers): raises NotImplementedError."""
    _needs_transformers('from_hf_qwen2_pretrained')


__all__ = ['from_hf_llama', 'from_hf_llama_pretrained', 'from_hf_qwen2',
           'from_hf_qwen2_pretrained', 'hf_llama_config', 'hf_qwen2_config']
