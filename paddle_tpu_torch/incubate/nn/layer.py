"""Fused inference layers (counterpart of
paddle_tpu/incubate/nn/layer.py): `FusedMultiTransformer`, the
serving-side decoder stack over the functional ops of
`incubate.nn.functional`."""
from __future__ import annotations

import math

import torch

from ...device import resolve_device, torch_dtype
from . import functional as FF


class _P(torch.nn.Module):
    """One layer's parameter, named `w` (the JAX package's per-layer
    holder, so `ln_scales.0.w` here is `ln_scales.L0.w` there)."""

    def __init__(self, t):
        super().__init__()
        self.w = torch.nn.Parameter(t)


def _xavier_normal(shape, dtype, device, generator):
    """XavierNormal with the JAX package's fans: (fan_in, fan_out) =
    shape for a matrix; for more axes the last two times the product of
    the others."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32, device=device).normal_(
        0.0, std, generator=generator).to(dtype)


class FusedMultiTransformer(torch.nn.Module):
    """N pre- or post-LayerNorm self-attention + FFN layers with
    per-layer contiguous KV caches ((2, B, H, max_seq, D), from
    `gen_cache`), prefill (flash attention at 128 tokens or more, caches
    written) and `time_step` single-token decode
    (`incubate.nn.functional.masked_multihead_attention`: the head-major
    decode kernel, K9).

    Parameters in the JAX package's layout and names: `ln_scales.<i>.w`
    (E,), `ln_biases`, `qkv_weights.<i>.w` (3, H, D, E), `qkv_biases`
    (3E,), `linear_weights` (E, E), `linear_biases`, `ffn_ln_scales`,
    `ffn_ln_biases`, `ffn1_weights` (E, dim_feedforward), `ffn1_biases`,
    `ffn2_weights` (dim_feedforward, E), `ffn2_biases`; weights drawn
    XavierNormal from a torch.Generator seeded with `seed` on `device`
    (None: the current CUDA device, raising without one), norms at ones,
    biases at zero, all in `dtype`. Load the JAX package's weights with
    `framework.io.load_jax_state`. Inference only: dropout with p > 0 in
    training raises."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation='gelu',
                 normalize_before=True, num_layers=-1, nranks=1,
                 trans_qkvw=True, ring_id=-1, name=None, epsilon=1e-5,
                 device=None, dtype='float32', seed=0):
        super().__init__()
        if num_layers < 1:
            raise ValueError('num_layers must be >= 1 (attr-list '
                             'construction is not supported; pass '
                             'num_layers explicitly)')
        if not trans_qkvw:
            raise NotImplementedError(
                'trans_qkvw=False (untransposed qkv weights) unsupported')
        if activation not in FF.ACTIVATIONS:
            raise ValueError(
                f'activation must be one of {list(FF.ACTIVATIONS)}')
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.num_layers = num_layers
        device = resolve_device(device)
        dtype = torch_dtype(dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        H, D, E, F = num_heads, self.head_dim, embed_dim, dim_feedforward

        def plist(make):
            return torch.nn.ModuleList([_P(make())
                                        for _ in range(num_layers)])

        def ones(n):
            return torch.ones(n, dtype=dtype, device=device)

        def zeros(n):
            return torch.zeros(n, dtype=dtype, device=device)

        def xavier(*shape):
            return _xavier_normal(shape, dtype, device, gen)

        self.ln_scales = plist(lambda: ones(E))
        self.ln_biases = plist(lambda: zeros(E))
        self.qkv_weights = plist(lambda: xavier(3, H, D, E))
        self.qkv_biases = plist(lambda: zeros(3 * E))
        self.linear_weights = plist(lambda: xavier(E, E))
        self.linear_biases = plist(lambda: zeros(E))
        self.ffn_ln_scales = plist(lambda: ones(E))
        self.ffn_ln_biases = plist(lambda: zeros(E))
        self.ffn1_weights = plist(lambda: xavier(E, F))
        self.ffn1_biases = plist(lambda: zeros(F))
        self.ffn2_weights = plist(lambda: xavier(F, E))
        self.ffn2_biases = plist(lambda: zeros(E))

    @property
    def device(self):
        return self.ln_scales[0].w.device

    def gen_cache(self, batch_size, max_seq_len, dtype=torch.float32):
        """Per-layer (2, B, H, max_seq, D) zero caches on the layer's
        device (the reference's cache_kvs layout)."""
        shape = (2, batch_size, self.num_heads, max_seq_len, self.head_dim)
        return [torch.zeros(shape, dtype=dtype, device=self.device)
                for _ in range(self.num_layers)]

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, beam_offset=None,
                seq_lens=None, time_step=None):
        """Prefill (time_step None: causal attention over src (B, S, E),
        or `attn_mask`; caches written at [0, S)) or one decode step
        (time_step, src (B, 1, E)). Returns the output, or (output,
        caches) with caches (updated in place)."""
        if pre_caches is not None or beam_offset is not None:
            raise NotImplementedError(
                'pre_caches / beam_offset belong to the reference CUDA '
                'serving pipeline and are not supported')
        if rotary_embs is not None:
            raise NotImplementedError(
                'rotary_embs: rotate q/k outside or use the Llama family '
                'models for RoPE serving')
        if time_step is not None and src.shape[1] != 1:
            raise ValueError('time_step decode expects a single token '
                             f'per row, got seq {src.shape[1]}')

        def ws(plist):
            return [p.w for p in plist]

        return FF.fused_multi_transformer(
            src, ws(self.ln_scales), ws(self.ln_biases),
            ws(self.qkv_weights), ws(self.qkv_biases),
            ws(self.linear_weights), ws(self.linear_biases),
            ws(self.ffn_ln_scales), ws(self.ffn_ln_biases),
            ws(self.ffn1_weights), ws(self.ffn1_biases),
            ws(self.ffn2_weights), ws(self.ffn2_biases),
            pre_layer_norm=self.normalize_before, epsilon=self.epsilon,
            cache_kvs=caches, seq_lens=seq_lens, time_step=time_step,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            activation=self.activation, training=self.training,
            norm_type='layernorm')
