"""Kernel entry points of the port (counterpart of paddle_tpu/ops).

A tensor on a CUDA device launches the hand-written Hopper kernel
(`ops/hopper/`, built from `csrc/`), which either runs or raises; a
tensor on the CPU takes the kernel's plain version. There is no flag and
no fallback from a failed kernel to the plain version.

`LAUNCHES` counts launches per kernel (each wrapper adds one where it
launches), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from ._build import LAUNCHES
from .hopper import paged_attention as _paged
from .hopper import rms_norm as _rms


def _on_card(x, kernel):
    if x.device.type == 'cuda':
        return True
    if x.device.type == 'cpu':
        return False
    raise ValueError(f'{kernel}: no kernel for device {x.device}')


def rms_norm(x, weight=None, epsilon=1e-6, return_r=False):
    """Fused RMSNorm forward (kernel K1 of PERF.md)."""
    if _on_card(x, 'rms_norm'):
        return _rms.rms_norm(x, weight, epsilon, return_r)
    return _rms.rms_norm_plain(x, weight, epsilon, return_r)


def paged_decode_attention(q, key_cache, value_cache, block_tables,
                           context_lens, scale=None, k_scale=None,
                           v_scale=None):
    """Single-token attention over paged KV pools (kernel K8 of
    PERF.md)."""
    fn = (_paged.paged_decode_attention
          if _on_card(q, 'paged_decode_attention')
          else _paged.paged_decode_attention_plain)
    return fn(q, key_cache, value_cache, block_tables, context_lens, scale,
              k_scale, v_scale)


__all__ = ['LAUNCHES', 'rms_norm', 'paged_decode_attention']
