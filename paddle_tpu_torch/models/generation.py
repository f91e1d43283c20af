"""KV caches and autoregressive generation (counterpart of
paddle_tpu/models/generation.py).

The port updates caches IN PLACE (the JAX package returns new arrays):
a cached forward writes its new K/V rows (and, for an int8 cache, its
calibrated scales) into the given tensors and returns the same tensors,
so a Llama-7B-width cache is never copied.

`GenerationMixin.generate` is the JAX package's greedy / sampled decode
written as a Python loop under `torch.no_grad()`: prefill once over a
preallocated contiguous cache, then one single-token forward per new
token (the decode-attention kernel K7 on the card). Its random stream
comes from a `torch.Generator`: the same seed gives the same tokens
within the port, never the JAX package's threefry stream.
"""
from __future__ import annotations

import inspect
import typing

import numpy as np
import torch


def filter_logits(logits, top_k=0, top_p=1.0):
    """top-k, then nucleus (top-p) filtering of temperature-scaled logits:
    dropped entries become -inf. top_k <= 0 keeps all, top_k > V clamps
    to V; top_p = 1.0 keeps all."""
    V = logits.shape[-1]
    if top_k > 0:
        top_k = min(int(top_k), V)
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float('-inf'), logits)
    if top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, [-1])
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp(max=V - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float('-inf'), logits)
    return logits


def filter_logits_batched(logits, top_k, top_p):
    """Per-row `filter_logits` over (B, V) logits: top_k (B,) int and
    top_p (B,) float tensors on the logits' device, so one batch mixes
    greedy, top-k and nucleus rows. A row's top_k <= 0 keeps all and
    top_k > V clamps to V; a row's top_p == 1.0 keeps all (masked, not
    computed away: the cumulative sum's rounding must not drop a token
    of a keep-all row)."""
    V = logits.shape[-1]
    tk = top_k.to(device=logits.device, dtype=torch.int64)
    kth = torch.gather(torch.sort(logits, dim=-1).values, -1,
                       (V - tk.clamp(1, V))[:, None])
    logits = torch.where((tk > 0)[:, None] & (logits < kth), float('-inf'),
                         logits)
    tp = top_p.to(device=logits.device, dtype=torch.float32)
    sorted_desc = torch.flip(torch.sort(logits, dim=-1).values, [-1])
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < tp[:, None]).sum(-1, keepdim=True).clamp(max=V - 1)
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
    return torch.where((tp < 1.0)[:, None] & (logits < cutoff),
                       float('-inf'), logits)


def default_positions(batch, seq, cache_index=None, kv_write_pos=None,
                      device=None):
    """Token positions (batch, seq): per-row offsets when kv_write_pos
    (B,) is given, else the uniform base cache_index (0 when None)."""
    ar = torch.arange(seq, dtype=torch.int64, device=device)
    if kv_write_pos is not None:
        wp = kv_write_pos.reshape(-1).to(torch.int64)
        positions = wp[:, None] + ar[None, :]
    else:
        positions = (0 if cache_index is None else int(cache_index)) + ar[None]
    return positions.expand(batch, seq)


class QuantKVCache(typing.NamedTuple):
    """One layer's int8 contiguous KV cache: K/V codes (B, max_len, Hkv, D)
    int8 with per-(kv head, dim) float32 scales (Hkv, D), calibrated on
    the index-0 multi-token prefill and held over decode. Halves the
    cache stream of a decode step."""

    kq: torch.Tensor
    vq: torch.Tensor
    kscale: torch.Tensor
    vscale: torch.Tensor


class QuantPagedKVCache(typing.NamedTuple):
    """One layer's int8 paged KV pools (the ServingEngine's
    `kv_cache_dtype='int8'`): K/V codes (num_blocks, Hkv, block_size, D)
    int8, and each written row's float32 scale at (page, head, slot) in
    (num_blocks, Hkv, block_size) pools, computed from that row alone
    (`quantize_kv_row`). A row's bytes are then a pure function of its
    values, whenever and wherever it is written, so a re-prefill after
    preemption reproduces the pages bit for bit. Decode steps read them
    with the paged-attention kernel's per-row mode (K8q)."""

    kp: torch.Tensor
    vp: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor


class RowQuantKVCache(typing.NamedTuple):
    """One layer's contiguous int8 KV cache with per-row scales: codes
    (B, max_len, Hkv, D) int8, scales (B, max_len, Hkv) float32. The
    temporary cache of the serving engine's admission prefill over int8
    pools: rows written here quantize with the pools' per-row rule, and
    attention reads them dequantized, so the prefill sees exactly the
    values a paged decode step will."""

    kq: torch.Tensor
    vq: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor


class PagedKVCache(typing.NamedTuple):
    """One layer's paged KV pools for continuous-batching serving: K and V
    as (num_blocks, Hkv, block_size, D) pages shared by every in-flight
    request; per-request block tables map a sequence's logical block j to
    a page id. Page 0 is the reserved scratch page (inactive rows write
    there), so allocators hand out ids >= 1."""

    kp: torch.Tensor
    vp: torch.Tensor


def quantize_kv_rows(x, scale):
    """Symmetric int8 codes of new K/V rows (B, S, Hkv, D) against
    per-(head, dim) scales; rows past the calibrated range saturate."""
    q = torch.round(x.float() / scale[None, None])
    return torch.clamp(q, -127, 127).to(torch.int8)


def calibrate_kv_scale(x, margin=1.0):
    """Per-(kv head, dim) absmax scales (Hkv, D) from prefill rows
    (B, S, Hkv, D)."""
    amax = x.float().abs().amax(dim=(0, 1))
    return torch.clamp(amax * margin, min=1e-6) / 127.0


def quantize_kv_row(x):
    """Per-row symmetric int8 codes of K/V rows (..., Hkv, D): each
    (row, head) quantizes against its own absmax. Returns (codes int8
    (..., Hkv, D), scales float32 (..., Hkv)). Rounding is half to even
    (`torch.round`, as `jnp.round`), so a float32 row gives the JAX
    package's codes and scales bit for bit."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_row(q, scale, dtype):
    """Inverse of `quantize_kv_row`: codes times their per-row scales, in
    float32, cast to `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)


def _generator(rng_key, device):
    """A torch.Generator on `device`: `rng_key` itself, or one seeded
    with it (None is seed 0)."""
    if isinstance(rng_key, torch.Generator):
        return rng_key
    return torch.Generator(device=device).manual_seed(
        0 if rng_key is None else int(rng_key))


def sample_tokens(logits, temperature, top_k, top_p, generator):
    """Greedy (temperature 0: argmax) or a draw from
    softmax(filter_logits(logits / temperature)) per row."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(
        filter_logits(logits.float() / temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class GenerationMixin:
    """Caches and generation for a causal LM with a `config` (hidden size,
    heads, kv heads, layers) whose parameters live on one device, and a
    cached forward `self(ids, caches=..., cache_index=...) -> (logits,
    caches)`."""

    def quantize_weights(self, bits=8):
        """Weight-only quantization for serving: a new model whose 2-D
        floating projections are `nn.quant.QuantizedWeight`s (int8, or
        packed int4), served by kernels K10 / K11. Lookup tables
        (`no_quantize`, e.g. `embed_tokens`) stay; a tied head served off
        the embedding stays full precision. The original is untouched."""
        from ..quantization import quantize_matmul_weights

        return quantize_matmul_weights(self, bits=bits, min_features=1)

    def cache_dtype(self):
        """Dtype of the KV cache (the embedding table's)."""
        raise NotImplementedError

    def _kv_shape(self):
        cfg = self.config
        head_dim = getattr(cfg, 'head_dim', None) or (
            cfg.hidden_size // cfg.num_attention_heads)
        kv_heads = (getattr(cfg, 'num_key_value_heads', None)
                    or cfg.num_attention_heads)
        return kv_heads, head_dim

    def _cache_dtype(self, dtype, paged):
        dtype = dtype or self.cache_dtype()
        if dtype not in (torch.bfloat16, torch.float32) and not (
                paged and dtype == torch.int8):
            if paged:
                raise NotImplementedError(
                    f'paged KV pool dtype {dtype}: the pools are bf16, '
                    f'float32 or int8')
            raise NotImplementedError(
                f'KV cache dtype {dtype}: an int8 contiguous cache is '
                f'init_cache(..., quantized=True)')
        return dtype

    def init_cache(self, batch_size, max_len, dtype=None, quantized=False):
        """Per-layer contiguous caches of (B, max_len, kv_heads, head_dim)
        zeros on the model's device: (k, v) pairs, or with
        quantized=True `QuantKVCache`s (int8 codes, zero scales that the
        first multi-token prefill calibrates)."""
        kv_heads, head_dim = self._kv_shape()
        shape = (int(batch_size), int(max_len), kv_heads, head_dim)
        dev = self.device
        if quantized:
            def z(shape, dt):
                return torch.zeros(shape, dtype=dt, device=dev)

            return [QuantKVCache(z(shape, torch.int8), z(shape, torch.int8),
                                 z((kv_heads, head_dim), torch.float32),
                                 z((kv_heads, head_dim), torch.float32))
                    for _ in range(self.config.num_hidden_layers)]
        dtype = self._cache_dtype(dtype, paged=False)
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in range(self.config.num_hidden_layers)]

    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        """Per-layer pools of (num_blocks, kv_heads, block_size, head_dim)
        zero pages on the model's device: PagedKVCache for bf16 / float32
        pages, QuantPagedKVCache for int8 ones (with float32 per-row
        scale pools of (num_blocks, kv_heads, block_size)). Page 0 is the
        reserved scratch page, so a usable pool needs num_blocks >= 2."""
        kv_heads, head_dim = self._kv_shape()
        dtype = self._cache_dtype(dtype, paged=True)
        shape = (int(num_blocks), kv_heads, int(block_size), head_dim)
        dev = self.device

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        if dtype == torch.int8:
            return [QuantPagedKVCache(z(shape, dtype), z(shape, dtype),
                                      z(shape[:3], torch.float32),
                                      z(shape[:3], torch.float32))
                    for _ in range(self.config.num_hidden_layers)]
        return [PagedKVCache(z(shape, dtype), z(shape, dtype))
                for _ in range(self.config.num_hidden_layers)]

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0, top_k=0,
                 top_p=1.0, rng_key=None, eos_token_id=None, num_beams=1,
                 length_penalty=0.0, attention_mask=None,
                 kv_cache_int8=False):
        """Greedy (temperature 0) or sampled decode; returns (B, S +
        max_new_tokens) ids, the prompt first. `rng_key` is a
        torch.Generator or an int seed (None: seed 0). With
        `eos_token_id`, a finished row emits eos from then on.
        `attention_mask` (B, S) 0/1 marks LEFT-padded prompts of unequal
        length: positions count each row's real tokens and pad rows are
        never attended. kv_cache_int8=True decodes over an int8 cache
        (`QuantKVCache`) whose scales calibrate on the prompt, so the
        prompt needs two tokens or more."""
        ids = torch.as_tensor(input_ids, device=self.device)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask,
                                             device=self.device)
            # an all-ones mask (equal-length batches) is no mask
            if bool(attention_mask.all()):
                attention_mask = None
        if attention_mask is not None:
            if 'kvalid' not in inspect.signature(self.forward).parameters:
                raise NotImplementedError(
                    f'{type(self).__name__} does not support attention_mask '
                    f'generation (cached forward lacks positions/kvalid)')
        if num_beams > 1:
            raise NotImplementedError(
                'beam search (num_beams > 1) is not ported yet (ROADMAP B1)')
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self._generate_sample(
                    ids, max_new_tokens, temperature, top_k, top_p, rng_key,
                    eos_token_id, attention_mask, kv_cache_int8)
        finally:
            self.train(was_training)

    def _generate_sample(self, input_ids, max_new_tokens, temperature, top_k,
                         top_p, rng_key, eos_token_id, attention_mask,
                         kv_cache_int8):
        B, S = input_ids.shape
        if kv_cache_int8 and S < 2:
            raise ValueError(
                'kv_cache_int8 needs a multi-token prompt: the per-head '
                'scales calibrate on the prefill rows')
        dev = input_ids.device
        caches = self.init_cache(B, S + max_new_tokens,
                                 quantized=kv_cache_int8)
        gen = _generator(rng_key, dev)
        extra = {}
        if attention_mask is not None:
            am = attention_mask.to(torch.int32)
            # pad rows clip to position 0; they are masked out anyway
            prompt_pos = torch.clamp(torch.cumsum(am, dim=1) - 1, min=0)
            real_len = am.sum(dim=1).to(torch.int32)
            kvalid = torch.cat(
                [am, torch.ones(B, max_new_tokens, dtype=torch.int32,
                                device=dev)], dim=1)
            extra = dict(positions=prompt_pos, kvalid=kvalid)
            # a left-padded mask is the window [S - real_len, now]: with
            # kv_start the decode steps keep the decode-attention kernel.
            # A right-padded or holed mask keeps the masked path.
            amn = am.cpu().numpy()
            rl = amn.sum(axis=1)
            left_contig = bool((amn == (np.arange(S)[None, :]
                                        >= (S - rl)[:, None])).all())
            if (left_contig and 'kv_start'
                    in inspect.signature(self.forward).parameters):
                extra['kv_start'] = (S - real_len).to(torch.int32)

        logits, caches = self(input_ids, caches=caches, cache_index=0,
                              **extra)
        last = logits[:, -1, :]
        out = torch.empty(B, max_new_tokens, dtype=input_ids.dtype,
                          device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(max_new_tokens):
            tok = sample_tokens(last, temperature, top_k, top_p,
                                gen).to(input_ids.dtype)
            if eos_token_id is not None:
                # finished rows emit eos from then on
                tok = torch.where(finished, torch.full_like(
                    tok, eos_token_id), tok)
                finished = finished | (tok == eos_token_id)
            out[:, i] = tok
            if i == max_new_tokens - 1:
                break                      # the last token needs no forward
            step_extra = {}
            if attention_mask is not None:
                # rope position = real tokens so far; the cache index
                # stays uniform
                step_extra = dict(positions=(real_len + i)[:, None],
                                  kvalid=kvalid)
                if 'kv_start' in extra:
                    step_extra['kv_start'] = extra['kv_start']
            logits, caches = self(tok[:, None], caches=caches,
                                  cache_index=S + i, **step_extra)
            last = logits[:, -1, :]
        return torch.cat([input_ids, out], dim=1)
