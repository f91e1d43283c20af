"""Llama family decoder LM (counterpart of paddle_tpu/models/llama.py).

RMSNorm pre-norm, rotary position embedding (rotate-half form, with
the llama3 and yarn frequency scalings), SwiGLU MLP, grouped-query
attention, tied or untied LM head. Parameter names and layouts are the
JAX package's, so one state dict carries across (see
`framework.io.load_jax_state`): projections are raw (in, out)
parameters applied as `x @ W`, the embedding table is (vocab, hidden).

The model serves through `inference.ServingEngine`: admission prefill,
and the chunked / prefix-hit continuation at per-row write offsets
(`kv_write_pos`), run over a contiguous cache with plain masked
attention (as the JAX package does), and every decode step runs the
paged-attention kernel over the engine's page pools (bf16 / float32
pages, or int8 pages with per-row scales:
`ServingEngine(kv_cache_dtype='int8')`). It trains through
`LlamaForCausalLM.loss`
(`training.TrainEngine`): the uncached forward runs the flash-attention
kernels for >= 128 tokens, every RMSNorm and the loss run their fused
kernels, forward and backward. It generates through
`GenerationMixin.generate` and `inference.DecodeEngine` over contiguous
caches (bf16 / float32, or int8 `QuantKVCache`): every single-token step
runs the decode-attention kernel. `quantize_weights(8 or 4)` gives a
model whose projections run the weight-only int8 / int4 kernels.
Sliding-window models (`sliding_window`, on the layers at or past
`max_window_layers`: Mistral- and Qwen2-style) train through the flash
kernels' window mode and decode through the decode-attention kernel
with the window as a later start; the serving engine refuses them, as
the JAX one does. Configurations the port does not run (sequence
parallelism, remat, tensor parallelism) raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch

from .. import ops
from ..device import resolve_device, torch_dtype
from ..nn import RMSNorm
from ..nn import functional as F
from .generation import (GenerationMixin, PagedKVCache, QuantKVCache,
                         QuantPagedKVCache, RowQuantKVCache,
                         calibrate_kv_scale, default_positions,
                         dequantize_kv_row, quantize_kv_row, quantize_kv_rows)


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32          # < num_attention_heads -> GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # optional dict, e.g. {'rope_type': 'llama3', 'factor': 8.0, ...};
    # None = plain RoPE
    rope_scaling: typing.Optional[dict] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False           # qkv biases (Qwen2-style)
    initializer_range: float = 0.02
    dtype: str = 'float32'                 # parameter dtype; compute follows
    remat: bool = False
    remat_policy: str = 'dots'
    sequence_parallel: bool = False
    sp_mode: str = 'ring'
    sliding_window: typing.Optional[int] = None
    max_window_layers: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_7b() -> LlamaConfig:
    """Llama-2-7B (the repo's headline shape)."""
    return LlamaConfig()


def llama_tiny(vocab_size=256, hidden_size=64, layers=2, heads=4, kv_heads=2,
               intermediate_size=128, max_pos=128) -> LlamaConfig:
    """Tiny config for tests."""
    return LlamaConfig(
        vocab_size=vocab_size, hidden_size=hidden_size,
        intermediate_size=intermediate_size, num_hidden_layers=layers,
        num_attention_heads=heads, num_key_value_heads=kv_heads,
        max_position_embeddings=max_pos,
    )


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def _llama3_scaled_inv_freq(inv_freq, scaling):
    """Llama-3.x rope scaling: long wavelengths slowed by `factor`, short
    ones kept, a smooth ramp between the cutoffs."""
    factor = scaling['factor']
    low = scaling.get('low_freq_factor', 1.0)
    high = scaling.get('high_freq_factor', 4.0)
    orig = scaling.get('original_max_position_embeddings', 8192)
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (orig / wavelen - low) / (high - low)
    interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(wavelen < orig / high, inv_freq,
                       torch.where(wavelen > orig / low, inv_freq / factor,
                                   interp))


def _yarn_scaled_inv_freq(inv_freq, scaling, head_dim, theta):
    """YaRN rope scaling: interpolated and extrapolated frequencies
    blended by a linear ramp between the beta_fast/beta_slow correction
    dims. Returns (inv_freq, attention_factor)."""
    factor = scaling['factor']
    beta_fast = scaling.get('beta_fast', 32.0)
    beta_slow = scaling.get('beta_slow', 1.0)
    orig = scaling.get('original_max_position_embeddings') or 4096

    def get_mscale(scale, mscale=1.0):
        if scale <= 1:
            return 1.0
        return 0.1 * mscale * math.log(scale) + 1.0

    attention_factor = scaling.get('attention_factor')
    if attention_factor is None:
        mscale = scaling.get('mscale')
        mscale_all_dim = scaling.get('mscale_all_dim')
        if mscale and mscale_all_dim:
            attention_factor = float(get_mscale(factor, mscale)
                                     / get_mscale(factor, mscale_all_dim))
        else:
            attention_factor = get_mscale(factor)

    def correction_dim(num_rotations):
        return (head_dim * math.log(orig / (num_rotations * 2 * math.pi))
                ) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), head_dim - 1)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32,
                          device=inv_freq.device) - low)
            / max(high - low, 0.001)).clamp(0.0, 1.0)
    extrapolation_factor = 1.0 - ramp
    inv_freq = (inv_freq / factor * (1 - extrapolation_factor)
                + inv_freq * extrapolation_factor)
    return inv_freq, float(attention_factor)


def rope_cos_sin(positions, head_dim, theta=10000.0, dtype=torch.float32,
                 rope_scaling=None):
    """cos/sin tables for integer `positions`, shape (..., head_dim // 2).
    rope_scaling: 'llama3' or 'yarn' (whose attention factor scales
    cos/sin); other types are rejected."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=positions.device)
                                / head_dim))
    att = 1.0
    if rope_scaling:
        rt = rope_scaling.get('rope_type', rope_scaling.get('type'))
        if rt == 'llama3':
            inv_freq = _llama3_scaled_inv_freq(inv_freq, rope_scaling)
        elif rt == 'yarn':
            inv_freq, att = _yarn_scaled_inv_freq(inv_freq, rope_scaling,
                                                  head_dim, theta)
        elif rt not in (None, 'default'):
            raise ValueError(f'unsupported rope_scaling type {rt!r}')
    angles = positions[..., None].float() * inv_freq
    return ((torch.cos(angles) * att).to(dtype),
            (torch.sin(angles) * att).to(dtype))


def apply_rotary(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D/2). Rotate-half form, computed
    in float32."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Cached attention
# ---------------------------------------------------------------------------

def cached_attention(q, k, v, cache, cache_index, kv_write_pos=None,
                     block_tables=None, kvalid=None, kv_start=None,
                     window=None):
    """KV-cached attention step: write the S new K/V rows into the cache,
    then attend over it. Returns (out (B, S, H, D), cache); caches are
    updated in place.

    A contiguous cache of (B, max_len, Hkv, D) — a (k, v) pair, or a
    `QuantKVCache` of int8 codes with per-(head, dim) scales — takes the
    rows at `cache_index`. `kvalid` (B, max_len) 0/1 marks the cache rows
    that may be attended at all (left-padded batches put 0 on the pad
    rows); `kv_start` (B,) says the caller's valid rows are exactly the
    window [kv_start, now]. The dispatch rule is the JAX package's: a
    single-token step with head_dim % 8 == 0 and either no kvalid or a
    kv_start runs the decode-attention kernel (K7) over the window
    [kv_start, cache_index + 1); anything else (prefill, a holed mask)
    takes the plain masked attention, which dequantizes a whole int8
    cache first. An int8 cache calibrates its scales on the index-0
    multi-token prefill only and quantizes every later row against them.
    `window` (int) is sliding-window attention over the cache: only the
    last `window` positions are attended; on the kernel path it is a
    later per-row start (`ops.dispatch_decode_attention`), on the masked
    path a band in the mask.

    A `RowQuantKVCache` (the serving engine's temporary cache over int8
    pools) stores each new row as int8 codes with its own scale
    (`quantize_kv_row`) and attends the whole cache dequantized through
    the plain masked path, as the JAX package does.

    `kv_write_pos` (B,) over a contiguous cache gives every row its own
    write offset (the serving engine's chunked and prefix-hit prefill):
    row b's S new rows land at columns kv_write_pos[b] + i, and row b's
    query i attends the columns <= kv_write_pos[b] + i. A column past
    the cache lands on its last one (the serving engine's chunk gives
    its cache one throwaway last column for its pad columns). A
    RowQuantKVCache writes the rows' scales at the same columns; a
    QuantKVCache never recalibrates under it. A single-token step takes
    the decode-attention kernel with per-row lengths kv_write_pos + 1
    (same rule as above).

    A PagedKVCache or QuantPagedKVCache takes `kv_write_pos` (B,) and
    `block_tables` (B, MAXB) and runs the paged-attention kernel (see
    `_paged_cached_attention`).
    """
    if isinstance(cache, (PagedKVCache, QuantPagedKVCache)):
        if kvalid is not None or kv_start is not None:
            raise NotImplementedError(
                'kvalid / kv_start over a PagedKVCache are not ported yet')
        if window is not None:
            raise NotImplementedError(
                'sliding windows over a PagedKVCache are not ported yet '
                '(sliding-window models decode over contiguous caches)')
        return _paged_cached_attention(q, k, v, cache, kv_write_pos,
                                       block_tables)
    B, S, H, D = q.shape
    if kv_write_pos is not None:
        wp = kv_write_pos.reshape(-1).to(torch.int64).expand(B)
        rows = torch.arange(B, device=q.device)[:, None]
        # a column past the cache lands on its last one (the JAX
        # package's scatter drops it; on the card an index past the end
        # is a device assert)
        wcols = (wp[:, None] + torch.arange(S, device=q.device)[None, :]) \
            .clamp(max=cache[0].shape[1] - 1)
        at = (rows, wcols)
    else:
        at = (slice(None), slice(cache_index, cache_index + S))
    rowquant = isinstance(cache, RowQuantKVCache)
    quant = isinstance(cache, QuantKVCache)
    if rowquant:
        kq, vq, ks, vs = cache
        kq[at], ks[at] = quantize_kv_row(k)
        vq[at], vs[at] = quantize_kv_row(v)
        ck = dequantize_kv_row(kq, ks, q.dtype)
        cv = dequantize_kv_row(vq, vs, q.dtype)
        kscale = vscale = None
    elif quant:
        ck, cv, kscale, vscale = cache
        if S > 1 and kv_write_pos is None and int(cache_index) == 0:
            # calibrate on the index-0 prefill only: a later chunk must
            # not reinterpret the int8 rows already written
            kscale.copy_(calibrate_kv_scale(k))
            vscale.copy_(calibrate_kv_scale(v))
        ck[at] = quantize_kv_rows(k, kscale)
        cv[at] = quantize_kv_rows(v, vscale)
    else:
        ck, cv = cache
        kscale = vscale = None
        ck[at] = k.to(ck.dtype)
        cv[at] = v.to(cv.dtype)
    if (S == 1 and D % 8 == 0 and not rowquant
            and (kvalid is None or kv_start is not None)):
        valid = (wp + 1 if kv_write_pos is not None
                 else int(cache_index) + 1)
        out = ops.dispatch_decode_attention(
            q, ck, cv, valid, start=kv_start, window=window,
            k_scale=kscale, v_scale=vscale)
        return out, cache
    # valid keys: position <= the query's position, and kvalid / kv_start
    max_len = ck.shape[1]
    kpos = torch.arange(max_len, device=q.device)
    # query positions as (B or 1, 1, S, 1): per row under kv_write_pos
    qpos = (wcols if kv_write_pos is not None else
            cache_index + torch.arange(S, device=q.device)[None])
    qpos = qpos[:, None, :, None]
    mask = kpos <= qpos
    if kvalid is not None:
        mask = mask & (kvalid[:, None, None, :] > 0)
    if kv_start is not None:
        st = kv_start.reshape(-1)
        mask = mask & (kpos[None, :] >= st[:, None])[:, None, None, :]
    if window is not None:
        mask = mask & (qpos - kpos < window)
    if quant:
        ck = (ck.float() * kscale[None, None]).to(q.dtype)
        cv = (cv.float() * vscale[None, None]).to(q.dtype)
    # a bf16 cache under a float32 model attends in the model's dtype
    out = F.scaled_dot_product_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                         attn_mask=mask)
    return out, cache


def _paged_cached_attention(q, k, v, cache, kv_write_pos, block_tables):
    """Single-token decode over a PagedKVCache: scatter each row's new
    K/V into page block_tables[b, wp // BS] slot wp % BS (wp =
    kv_write_pos[b]), then attend over the row's first wp + 1 positions
    with the paged-attention kernel. Over a QuantPagedKVCache the new row
    is quantized against its own absmax (`quantize_kv_row`, the rule the
    serving prefill applies too) and its codes and scale are written;
    the kernel then reads the int8 pages with their per-row scales. The
    dispatch rule is the JAX package's: the kernel for head_dim % 8 ==
    0 (any GQA group), the masked path over the gathered pages
    otherwise."""
    B, S, H, D = q.shape
    if S != 1:
        raise NotImplementedError(
            'PagedKVCache is decode-only (S == 1): prefill writes whole '
            'prompts into pages through the serving engine')
    if kv_write_pos is None or block_tables is None:
        raise ValueError(
            'PagedKVCache needs kv_write_pos (per-row write positions) '
            'and block_tables (per-row page ids)')
    quant = isinstance(cache, QuantPagedKVCache)
    kp, vp = cache[0], cache[1]
    BS = kp.shape[2]
    maxb = block_tables.shape[1]
    wp = kv_write_pos.reshape(-1).expand(B)
    rows = torch.arange(B, device=q.device)
    # a frozen row can sit one position past its last page: clamp the
    # column (such rows are parked on the scratch page by the engine)
    page = block_tables[rows, torch.clamp(wp // BS, max=maxb - 1)].long()
    slot = (wp % BS).long()
    if quant:
        kss, vss = cache.ks, cache.vs
        kp[page, :, slot, :], kss[page, :, slot] = quantize_kv_row(k[:, 0])
        vp[page, :, slot, :], vss[page, :, slot] = quantize_kv_row(v[:, 0])
    else:
        kss = vss = None
        kp[page, :, slot, :] = k[:, 0].to(kp.dtype)
        vp[page, :, slot, :] = v[:, 0].to(vp.dtype)
    counts = (wp + 1).to(torch.int32)
    if D % 8 == 0:
        out = ops.paged_decode_attention(q, kp, vp, block_tables, counts,
                                         k_scale=kss, v_scale=vss)
        return out, cache
    # other head sizes take the JAX package's masked path: the row's
    # pages gathered into a contiguous cache, masked by its count
    tbl = block_tables.long()
    gk, gv = kp[tbl], vp[tbl]                # (B, MAXB, Hkv, BS, D)
    if quant:
        gk = dequantize_kv_row(gk, kss[tbl], q.dtype)
        gv = dequantize_kv_row(gv, vss[tbl], q.dtype)
    Hkv = kp.shape[1]
    ck = gk.transpose(2, 3).reshape(B, maxb * BS, Hkv, D)
    cv = gv.transpose(2, 3).reshape(B, maxb * BS, Hkv, D)
    mask = (torch.arange(maxb * BS, device=q.device)[None, :]
            < counts[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q, ck, cv, attn_mask=mask), cache


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _normal(shape, std, dtype, device, generator):
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device)
                              .normal_(0.0, std, generator=generator))


class LlamaAttention(torch.nn.Module):
    """GQA attention with RoPE; (in, out) projection matrices. A
    sliding window applies on the layers at or past
    `config.max_window_layers` (Qwen2's rule; Mistral's 0 windows every
    layer)."""

    def __init__(self, config: LlamaConfig, dtype, device, generator,
                 layer_idx=0):
        super().__init__()
        self.sliding_window = (
            config.sliding_window
            if (config.sliding_window is not None
                and layer_idx >= config.max_window_layers) else None)
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        h, d, std = config.hidden_size, self.head_dim, \
            config.initializer_range

        def proj(n_in, n_out):
            return _normal((n_in, n_out), std, dtype, device, generator)

        self.q_proj = proj(h, self.num_heads * d)
        self.k_proj = proj(h, self.num_kv_heads * d)
        self.v_proj = proj(h, self.num_kv_heads * d)
        self.o_proj = proj(self.num_heads * d, h)
        if config.attention_bias:
            def zeros(n):
                return torch.nn.Parameter(
                    torch.zeros(n, dtype=dtype, device=device))

            self.q_bias = zeros(self.num_heads * d)
            self.k_bias = zeros(self.num_kv_heads * d)
            self.v_bias = zeros(self.num_kv_heads * d)
        else:
            self.q_bias = self.k_bias = self.v_bias = None

    def forward(self, x, cos, sin, cache=None, cache_index=None,
                kv_write_pos=None, block_tables=None, kvalid=None,
                kv_start=None):
        """x: (B, S, hidden); cos/sin: (B, S, head_dim // 2). Returns
        (out, cache): uncached (cache None) is causal attention over x
        (banded by the layer's sliding window), masked by `kvalid`
        (B, >= S) 0/1 when it is given."""
        B, S, _ = x.shape
        q, k, v = x @ self.q_proj, x @ self.k_proj, x @ self.v_proj
        if self.q_bias is not None:
            q, k, v = q + self.q_bias, k + self.k_bias, v + self.v_bias
        q = apply_rotary(q.reshape(B, S, self.num_heads, self.head_dim),
                         cos, sin)
        k = apply_rotary(k.reshape(B, S, self.num_kv_heads, self.head_dim),
                         cos, sin)
        v = v.reshape(B, S, self.num_kv_heads, self.head_dim)
        win = self.sliding_window
        if cache is None and kvalid is None:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 window_size=win)
        elif cache is None:
            # pad rows of a left-padded batch are never attended; the
            # window's band folds into the same mask
            pos = torch.arange(S, device=x.device)
            back = pos[:, None] - pos[None, :]
            keep = back >= 0 if win is None else (back >= 0) & (back < win)
            mask = keep[None, None] & (kvalid[:, :S] > 0)[:, None, None, :]
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        else:
            out, cache = cached_attention(q, k, v, cache, cache_index,
                                          kv_write_pos, block_tables,
                                          kvalid, kv_start, win)
        return out.reshape(B, S, self.num_heads * self.head_dim) \
            @ self.o_proj, cache


class LlamaMLP(torch.nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, dtype, device, generator):
        super().__init__()
        h, m, std = (config.hidden_size, config.intermediate_size,
                     config.initializer_range)
        self.gate_proj = _normal((h, m), std, dtype, device, generator)
        self.up_proj = _normal((h, m), std, dtype, device, generator)
        self.down_proj = _normal((m, h), std, dtype, device, generator)

    def forward(self, x):
        return (torch.nn.functional.silu(x @ self.gate_proj)
                * (x @ self.up_proj)) @ self.down_proj


class LlamaDecoderLayer(torch.nn.Module):
    def __init__(self, config: LlamaConfig, dtype, device, generator,
                 layer_idx=0):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps,
                                       device=device)
        self.self_attn = LlamaAttention(config, dtype, device, generator,
                                        layer_idx)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=config.rms_norm_eps,
                                                device=device)
        self.mlp = LlamaMLP(config, dtype, device, generator)

    def forward(self, x, cos, sin, cache=None, cache_index=None,
                kv_write_pos=None, block_tables=None, kvalid=None,
                kv_start=None):
        attn_out, cache = self.self_attn(
            self.input_layernorm(x), cos, sin, cache, cache_index,
            kv_write_pos, block_tables, kvalid, kv_start)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache


class LlamaModel(torch.nn.Module):
    """Embedding + decoder stack + final norm."""

    # the vocab table is gathered (and served transposed when tied):
    # exempt from weight-only quantization
    no_quantize = ('embed_tokens',)

    def __init__(self, config: LlamaConfig, dtype, device, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = _normal((config.vocab_size, config.hidden_size),
                                    config.initializer_range, dtype, device,
                                    generator)
        self.layers = torch.nn.ModuleList(
            [LlamaDecoderLayer(config, dtype, device, generator, i)
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=device)
        rs = config.rope_scaling
        if (rs and rs.get('rope_type', rs.get('type')) == 'yarn'
                and rs.get('original_max_position_embeddings') is None):
            # transformers falls back to max_position_embeddings for the
            # yarn correction ramp
            rs = dict(rs, original_max_position_embeddings=config
                      .max_position_embeddings)
        self.rope_scaling = rs

    def forward(self, input_ids, positions=None, caches=None,
                cache_index=None, kv_write_pos=None, block_tables=None,
                kvalid=None, kv_start=None):
        B, S = input_ids.shape
        if positions is None:
            positions = default_positions(B, S, cache_index, kv_write_pos,
                                          device=input_ids.device)
        x = torch.nn.functional.embedding(input_ids.long(), self.embed_tokens)
        cos, sin = rope_cos_sin(positions, self.config.head_dim,
                                self.config.rope_theta,
                                rope_scaling=self.rope_scaling)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            x, cache = layer(x, cos, sin,
                             caches[i] if caches is not None else None,
                             cache_index, kv_write_pos, block_tables,
                             kvalid, kv_start)
            if new_caches is not None:
                new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(GenerationMixin, torch.nn.Module):
    """LM head on top of LlamaModel.

    `device=None` is the current CUDA device and raises when there is
    none; pass device='cpu' to run on the CPU (the kernels' plain
    versions). Weights are drawn from a torch.Generator seeded with
    `seed` on that device (normal(0, initializer_range) projections and
    embedding, ones for the norms), in the config's dtype; load trained
    or JAX-package weights with `framework.io.load_jax_state`."""

    def __init__(self, config: LlamaConfig, device=None, seed=0):
        super().__init__()
        for knob, why in (('sequence_parallel', 'sequence parallelism'),
                          ('remat', 'remat (activation recomputation)')):
            if getattr(config, knob):
                raise NotImplementedError(
                    f'{why} is not ported yet (config.{knob}='
                    f'{getattr(config, knob)!r})')
        device = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        self.config = config
        self.model = LlamaModel(config, dtype, device, generator)
        self.lm_head = (None if config.tie_word_embeddings else _normal(
            (config.hidden_size, config.vocab_size),
            config.initializer_range, dtype, device, generator))

    @property
    def device(self):
        return self.model.embed_tokens.device

    def cache_dtype(self):
        return self.model.embed_tokens.dtype

    def logits(self, hidden):
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.T
        return hidden @ self.lm_head

    def forward(self, input_ids, positions=None, caches=None,
                cache_index=None, kv_write_pos=None, block_tables=None,
                kvalid=None, kv_start=None):
        """Logits (B, S, vocab); with `caches`, (logits, caches).
        `kvalid` (B, max_len) 0/1 and `kv_start` (B,) mark the attendable
        cache rows of a left-padded batch (see `cached_attention`)."""
        hidden, new_caches = self.model(input_ids, positions, caches,
                                        cache_index, kv_write_pos,
                                        block_tables, kvalid, kv_start)
        logits = self.logits(hidden)
        if caches is None:
            return logits
        return logits, new_caches

    def loss(self, input_ids, labels=None):
        """Mean next-token cross-entropy through the fused loss kernels.
        Without `labels`, input_ids (B, S + 1) is split into inputs
        [:, :-1] and labels [:, 1:]."""
        if labels is None:
            labels = input_ids[:, 1:]
            input_ids = input_ids[:, :-1]
        logits = self(input_ids)
        return ops.softmax_cross_entropy(logits, labels).mean()
