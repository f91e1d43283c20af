"""HuggingFace Llama / Qwen2 / Mixtral configurations and state dicts to
the port's `LlamaForCausalLM` and `MoEForCausalLM` (counterpart of
paddle_tpu/models/convert.py's Llama, Qwen2 and Mixtral converters).

`hf_llama_config` / `hf_qwen2_config` map a transformers config (a
plain dict, as `config.json` reads, or an object with attributes) onto
`LlamaConfig`, with the JAX package's guards: only plain, 'llama3' and
'yarn' rope scaling, and a SwiGLU activation. `from_hf_llama` /
`from_hf_qwen2` build the model from a state dict of HF names (torch
tensors or numpy arrays), transposing every projection: HF's Linear
weights are (out, in) applied as x W^T, the port's are (in, out) applied
as x W. `hf_mixtral_config` / `from_hf_mixtral` map Mixtral onto
`MoEConfig` / `MoEForCausalLM` (dropless routing forced, each expert's
w1 / w3 / w2 transposed and the experts stacked).

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
from .moe_lm import MoEConfig, MoEForCausalLM


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


def _make_assign(dev, dtype):
    """Parameter assignment shared by the converters: a state-dict value
    as a CPU tensor, transposed if asked, cast to `dtype` when given,
    moved to `dev`."""
    cast = torch_dtype(dtype) if dtype is not None else None

    def assign(module, name, value, transpose=False):
        t = _tensor(value)
        if transpose:
            t = t.T
        if cast is not None:
            t = t.to(cast)
        setattr(module, name, torch.nn.Parameter(
            t.contiguous().to(dev), requires_grad=True))

    return assign


def _check_leftovers(sd):
    leftovers = [k for k in sd
                 if not re.search(r'rotary_emb|inv_freq|position_ids', k)]
    if leftovers:
        raise ValueError(f'unconverted HF weights: {leftovers[:8]}')


def from_hf_llama(state_dict, config, dtype=None, device=None):
    """Build a LlamaForCausalLM from a HuggingFace Llama state dict (HF
    names, `model.layers.N...`). `dtype` casts every weight (default:
    as given); `device` as `LlamaForCausalLM` takes it (None is the
    card). Raises on a weight left unconverted."""
    sd = dict(state_dict)
    model = LlamaForCausalLM(config, device=device)
    assign = _make_assign(model.device, dtype)

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
    _check_leftovers(sd)
    return model


def from_hf_qwen2(state_dict, config, dtype=None, device=None):
    """Build a LlamaForCausalLM from a HuggingFace Qwen2 state dict: the
    Llama mapping, which takes the qkv biases when
    `config.attention_bias` is set."""
    return from_hf_llama(state_dict, config, dtype=dtype, device=device)


def hf_mixtral_config(hf_config) -> MoEConfig:
    """Map a transformers MixtralConfig (dict or object) onto MoEConfig:
    Llama attention plus top-k routed SwiGLU experts, no shared experts.
    `dispatch_mode='ragged'` (dropless) is forced: the GShard capacity
    dispatch drops tokens, which would silently diverge from the HF
    reference. Refuses a non-SiLU activation, a sliding window and tied
    embeddings, as the JAX package does."""
    get = _getter(hf_config)
    act = get('hidden_act', 'silu')
    if act not in ('silu', 'swish'):
        raise ValueError(
            f'hidden_act={act!r} unsupported: the experts hardcode SwiGLU')
    if get('sliding_window') not in (None, 0):
        raise ValueError(
            f"sliding_window={get('sliding_window')!r} unsupported: "
            f'attention here is full-causal — converting would give '
            f'silently wrong logits past the window')
    if get('tie_word_embeddings', False):
        raise ValueError(
            'tie_word_embeddings=True unsupported: MoEForCausalLM has a '
            'separate lm_head (and tied checkpoints omit lm_head.weight)')
    return MoEConfig(
        vocab_size=get('vocab_size'),
        hidden_size=get('hidden_size'),
        intermediate_size=get('intermediate_size'),
        num_hidden_layers=get('num_hidden_layers'),
        num_attention_heads=get('num_attention_heads'),
        num_key_value_heads=(get('num_key_value_heads')
                             or get('num_attention_heads')),
        num_experts=get('num_local_experts'),
        num_shared_experts=0,
        top_k=get('num_experts_per_tok', 2),
        max_position_embeddings=get('max_position_embeddings', 4096),
        rms_norm_eps=get('rms_norm_eps', 1e-5),
        rope_theta=get('rope_theta', 1e6),
        aux_loss_weight=get('router_aux_loss_coef', 0.001),
        dispatch_mode='ragged',
    )


def from_hf_mixtral(state_dict, config, dtype=None, device=None):
    """Build a MoEForCausalLM from a HuggingFace Mixtral state dict. HF
    softmaxes all router logits, takes the top k and renormalises over
    them, as `distributed.moe._topk_gates` does. HF's per-expert Linears
    w1 / w3 / w2 are (out, in); the port's batched (E, in, out) w_gate /
    w_up / w_down take each expert transposed, stacked. `dtype` casts
    every weight (default: as given); `device` as `MoEForCausalLM`
    takes it (None is the card). Raises on a weight left unconverted."""
    sd = dict(state_dict)
    model = MoEForCausalLM(config, device=device,
                           dtype='float32' if dtype is None else dtype)
    assign = _make_assign(model.device, dtype)
    assign(model, 'embed_tokens', sd.pop('model.embed_tokens.weight'))
    for i, layer in enumerate(model.layers):
        p = f'model.layers.{i}.'
        attn = layer.self_attn
        for w in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
            assign(attn, w, sd.pop(p + f'self_attn.{w}.weight'),
                   transpose=True)
        moe = layer.moe
        assign(moe, 'gate', sd.pop(p + 'block_sparse_moe.gate.weight'),
               transpose=True)
        for hf, ours in (('w1', 'w_gate'), ('w3', 'w_up'), ('w2', 'w_down')):
            assign(moe.experts, ours, torch.stack([
                _tensor(sd.pop(p + f'block_sparse_moe.experts.{e}.{hf}'
                               f'.weight')).T
                for e in range(config.num_experts)]))
        assign(layer.input_layernorm, 'weight',
               sd.pop(p + 'input_layernorm.weight'))
        assign(layer.post_attention_layernorm, 'weight',
               sd.pop(p + 'post_attention_layernorm.weight'))
    assign(model.norm, 'weight', sd.pop('model.norm.weight'))
    assign(model, 'lm_head', sd.pop('lm_head.weight'), transpose=True)
    _check_leftovers(sd)
    return model


def _needs_transformers(name):
    raise NotImplementedError(
        f'{name} loads a transformers model or checkpoint files, which the '
        f'port does not depend on: read the state dict and config.json '
        f'yourself and call from_hf_llama / from_hf_qwen2 / '
        f'from_hf_mixtral with hf_llama_config / hf_qwen2_config / '
        f'hf_mixtral_config')


def from_hf_llama_pretrained(model_or_path, dtype=None):
    """Not ported (needs transformers): raises NotImplementedError."""
    _needs_transformers('from_hf_llama_pretrained')


def from_hf_qwen2_pretrained(model_or_path, dtype=None):
    """Not ported (needs transformers): raises NotImplementedError."""
    _needs_transformers('from_hf_qwen2_pretrained')


def from_hf_mixtral_pretrained(model_or_path, dtype=None):
    """Not ported (needs transformers): raises NotImplementedError."""
    _needs_transformers('from_hf_mixtral_pretrained')


__all__ = ['from_hf_llama', 'from_hf_llama_pretrained', 'from_hf_mixtral',
           'from_hf_mixtral_pretrained', 'from_hf_qwen2',
           'from_hf_qwen2_pretrained', 'hf_llama_config',
           'hf_mixtral_config', 'hf_qwen2_config']
