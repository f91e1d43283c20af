"""MoE language model (counterpart of paddle_tpu/models/moe_lm.py): a
Llama-style decoder whose MLPs are `distributed.moe.MoELayer`s, top-k
routed SwiGLU experts plus shared experts (DeepSeek-MoE style; with no
shared experts and top-2 of 8, Mixtral: `models.convert.from_hf_mixtral`).

Attention is the port's `LlamaAttention` (RoPE, GQA, the decode-attention
kernel K7 on every one-token step), the norms run K1, and every cached
forward routes dropless: the expert products run the grouped kernel X1
(`ops.moe_grouped_matmul`) with no host read. The uncached forward
follows `config.dispatch_mode` ('auto' is the GShard dense dispatch,
which drops routings past an expert's capacity, as in the JAX package).
The model generates through `GenerationMixin.generate` (greedy, sampled,
eos, left-padded `attention_mask`, `kv_cache_int8`),
`inference.DecodeEngine` and speculative decoding (`generate_speculative`
as target, draft or both), and trains dropless or dense: `loss` (the
float32 NLL plus `aux_loss_weight` times the layers' aux loss) under
`training.TrainEngine`, X1's backward on its dx and dW kernels. It has
no `block_tables`, so
`ServingEngine` refuses it, as the JAX engine does. Quantized expert
weights are not ported (ROADMAP B4): `quantize_weights(8)` raises
(`quantization.quantize_matmul_weights`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device, torch_dtype
from ..distributed.moe import MoELayer
from ..nn import RMSNorm
from .generation import GenerationMixin, default_positions
from .llama import LlamaAttention, LlamaConfig, _normal, rope_cos_sin


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 1408      # per expert
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 64
    num_shared_experts: int = 2
    top_k: int = 6
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    # 'auto' | 'dense' (GShard capacity dispatch) | 'ragged' (dropless,
    # the grouped product X1; what HF-Mixtral logit parity needs)
    dispatch_mode: str = 'auto'

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def attn_config(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range,
        )


def moe_tiny(**kw):
    """Tiny config for tests."""
    defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, num_experts=4,
                    num_shared_experts=1, top_k=2, max_position_embeddings=128)
    defaults.update(kw)
    return MoEConfig(**defaults)


class MoEDecoderLayer(torch.nn.Module):
    def __init__(self, config: MoEConfig, dtype, device, generator):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps,
                                       device=device)
        self.self_attn = LlamaAttention(config.attn_config(), dtype, device,
                                        generator)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=config.rms_norm_eps,
                                                device=device)
        self.moe = MoELayer(
            hidden=config.hidden_size, intermediate=config.intermediate_size,
            num_experts=config.num_experts, top_k=config.top_k,
            capacity_factor=config.capacity_factor,
            num_shared_experts=config.num_shared_experts, return_aux=True,
            dispatch_mode=config.dispatch_mode, dtype=dtype, device=device,
            generator=generator)

    def forward(self, x, cos, sin, cache=None, cache_index=None,
                kv_write_pos=None, kvalid=None, kv_start=None):
        attn_out, cache = self.self_attn(
            self.input_layernorm(x), cos, sin, cache, cache_index,
            kv_write_pos, None, kvalid, kv_start)
        x = x + attn_out
        # a cached forward routes dropless: a capacity computed from a
        # one-token call would drop colliding tokens
        moe_out, aux = self.moe(self.post_attention_layernorm(x),
                                dropless=cache is not None)
        return x + moe_out, aux, cache


class MoEForCausalLM(GenerationMixin, torch.nn.Module):
    """Embedding, MoE decoder layers, final norm and an untied LM head,
    under the JAX package's parameter names (`embed_tokens`,
    `layers.{i}.self_attn.*`, `layers.{i}.moe.gate`,
    `layers.{i}.moe.experts.w_*`, `layers.{i}.moe.shared.w_*`, the
    `layers.{i}.moe.aux_loss` buffer, `norm.weight`, `lm_head`).

    `device=None` is the current CUDA device and raises when there is
    none; device='cpu' runs the kernels' plain versions. `dtype`
    ('float32', 'bfloat16' or a torch dtype; MoEConfig has no dtype
    field) is the weights' dtype: they are drawn from a torch.Generator
    seeded with `seed` directly in it on the device (normal(0,
    initializer_range) embedding, attention and head; normal(0, 0.02)
    experts and router, as in the JAX package). The norms' weights and
    the router stay float32."""

    no_quantize = ('embed_tokens',)

    def __init__(self, config: MoEConfig, device=None, seed=0,
                 dtype='float32'):
        super().__init__()
        device = resolve_device(device)
        dt = torch_dtype(dtype)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        self.config = config
        std = config.initializer_range
        self.embed_tokens = _normal((config.vocab_size, config.hidden_size),
                                    std, dt, device, generator)
        self.layers = torch.nn.ModuleList(
            [MoEDecoderLayer(config, dt, device, generator)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=device)
        self.lm_head = _normal((config.hidden_size, config.vocab_size), std,
                               dt, device, generator)

    @property
    def device(self):
        return self.embed_tokens.device

    def cache_dtype(self):
        return self.embed_tokens.dtype

    def forward(self, input_ids, positions=None, caches=None,
                cache_index=None, kv_write_pos=None, kvalid=None,
                kv_start=None):
        """(logits, total aux loss) without caches; (logits, caches) with
        them (the cached-forward contract of `GenerationMixin`, left-padded
        batches and per-row write offsets included; see
        `models.llama.cached_attention`)."""
        B, S = input_ids.shape
        if positions is None:
            positions = default_positions(B, S, cache_index, kv_write_pos,
                                          device=input_ids.device)
        x = torch.nn.functional.embedding(input_ids.long(), self.embed_tokens)
        cos, sin = rope_cos_sin(positions, self.config.head_dim,
                                self.config.rope_theta)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            x, aux, cache = layer(x, cos, sin,
                                  caches[i] if caches is not None else None,
                                  cache_index, kv_write_pos, kvalid, kv_start)
            aux_total = aux_total + aux
            if new_caches is not None:
                new_caches.append(cache)
        logits = self.norm(x) @ self.lm_head
        if caches is not None:
            return logits, new_caches
        return logits, aux_total

    def loss(self, input_ids, labels=None):
        """Mean next-token negative log-likelihood (log-softmax in
        float32) plus aux_loss_weight times the layers' aux loss. Without
        `labels`, input_ids (B, S + 1) splits into inputs [:, :-1] and
        labels [:, 1:]."""
        if labels is None:
            labels = input_ids[:, 1:]
            input_ids = input_ids[:, :-1]
        logits, aux = self(input_ids)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None]).mean()
        return nll + self.config.aux_loss_weight * aux


__all__ = ['MoEConfig', 'MoEDecoderLayer', 'MoEForCausalLM', 'moe_tiny']
