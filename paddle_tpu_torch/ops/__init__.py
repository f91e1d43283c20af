"""Kernel entry points of the port (counterpart of paddle_tpu/ops).

A tensor on a CUDA device launches the hand-written Hopper kernel
(`ops/hopper/`, built from `csrc/`), which either runs or raises; a
tensor on the CPU takes the kernel's plain version. There is no flag and
no fallback from a failed kernel to the plain version. The training ops
are autograd Functions whose backward follows the same rule.

`LAUNCHES` counts launches per kernel (each wrapper adds one where it
launches), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import math

import torch

from ._build import LAUNCHES, on_card
from .hopper import flash_attention as _flash
from .hopper import paged_attention as _paged
from .hopper import rms_norm as _rms
from .hopper import softmax_xent as _xent


def rms_norm(x, weight=None, epsilon=1e-6):
    """Fused RMSNorm (kernels K1 forward, K2 backward of PERF.md),
    differentiable in x and weight."""
    if weight is None:
        weight = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _rms.RMSNormFn.apply(x, weight, float(epsilon))
    # nothing to differentiate (serving runs under no_grad): the forward
    # alone, with no row scale written and nothing saved
    fn = _rms.rms_norm if on_card(x, 'rms_norm') else _rms.rms_norm_plain
    return fn(x.contiguous(), weight, float(epsilon))


def softmax_cross_entropy(logits, labels):
    """Fused softmax cross-entropy (kernels K3 forward, K4 backward):
    logits (..., V), labels (...) int -> per-example nll (...), float32,
    differentiable in the logits."""
    V = logits.shape[-1]
    loss = _xent.SoftmaxXentFn.apply(logits.reshape(-1, V),
                                     labels.reshape(-1))
    return loss.reshape(logits.shape[:-1])


def flash_attention(q, k, v, causal=False, scale=None, segment_ids=None,
                    window_size=None):
    """Flash attention (kernels K5 forward, K6 backward) in the JAX
    package's layout: q (B, Sq, H, D), k and v (B, Sk, Hkv, D) ->
    (B, Sq, H, D), differentiable in q, k and v."""
    if segment_ids is not None or window_size is not None:
        raise NotImplementedError(
            'flash_attention: segment ids and sliding windows are not '
            'ported yet')
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    out = _flash.FlashAttentionFn.apply(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        bool(causal), scale)
    return out.transpose(1, 2)


def paged_decode_attention(q, key_cache, value_cache, block_tables,
                           context_lens, scale=None, k_scale=None,
                           v_scale=None):
    """Single-token attention over paged KV pools (kernel K8 of
    PERF.md)."""
    fn = (_paged.paged_decode_attention
          if on_card(q, 'paged_decode_attention')
          else _paged.paged_decode_attention_plain)
    return fn(q, key_cache, value_cache, block_tables, context_lens, scale,
              k_scale, v_scale)


__all__ = ['LAUNCHES', 'flash_attention', 'paged_decode_attention',
           'rms_norm', 'softmax_cross_entropy']
