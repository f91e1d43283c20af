"""KV caches for cached forwards (counterpart of the parts of
paddle_tpu/models/generation.py that paged serving uses).

The port updates caches IN PLACE (the JAX package returns new arrays):
a cached forward writes its new K/V rows into the given tensors and
returns the same tensors, so a Llama-7B-width page pool is never
copied.
"""
from __future__ import annotations

import typing

import torch


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


class PagedKVCache(typing.NamedTuple):
    """One layer's paged KV pools for continuous-batching serving: K and V
    as (num_blocks, Hkv, block_size, D) pages shared by every in-flight
    request; per-request block tables map a sequence's logical block j to
    a page id. Page 0 is the reserved scratch page (inactive rows write
    there), so allocators hand out ids >= 1."""

    kp: torch.Tensor
    vp: torch.Tensor


class GenerationMixin:
    """Cache construction for a causal LM with a `config` (hidden size,
    heads, kv heads, layers) whose parameters live on one device."""

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

    def _cache_dtype(self, dtype):
        dtype = dtype or self.cache_dtype()
        if dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(
                f'KV cache dtype {dtype} is not ported yet (int8 caches '
                f'come with the int8-KV slice)')
        return dtype

    def init_cache(self, batch_size, max_len, dtype=None):
        """Per-layer contiguous (k, v) zero pairs of
        (B, max_len, kv_heads, head_dim) on the model's device."""
        kv_heads, head_dim = self._kv_shape()
        dtype = self._cache_dtype(dtype)
        shape = (int(batch_size), int(max_len), kv_heads, head_dim)
        dev = self.device
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in range(self.config.num_hidden_layers)]

    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        """Per-layer PagedKVCache pools of (num_blocks, kv_heads,
        block_size, head_dim) zero pages on the model's device. Page 0 is
        the reserved scratch page, so a usable pool needs
        num_blocks >= 2."""
        kv_heads, head_dim = self._kv_shape()
        dtype = self._cache_dtype(dtype)
        shape = (int(num_blocks), kv_heads, int(block_size), head_dim)
        dev = self.device
        return [PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                             torch.zeros(shape, dtype=dtype, device=dev))
                for _ in range(self.config.num_hidden_layers)]
