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
from .hopper import decode_attention as _decode
from .hopper import flash_attention as _flash
from .hopper import headmajor_attention as _headmajor
from .hopper import moe_grouped_matmul as _moe
from .hopper import paged_attention as _paged
from .hopper import quant_matmul as _qmm
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
                    kv_segment_ids=None, window_size=None):
    """Flash attention (kernels K5 forward, K6 backward) in the JAX
    package's layout: q (B, Sq, H, D), k and v (B, Sk, Hkv, D) ->
    (B, Sq, H, D), differentiable in q, k and v.

    segment_ids (B, Sq) and kv_segment_ids (B, Sk, default segment_ids)
    int: packed sequences, a query attending only keys of its own
    segment (with `causal`, both masks), a query with no such key
    returning 0 (kernels K5s forward, K6s backward).

    window_size: sliding-window attention, each query attending only
    its last `window_size` keys, itself included; requires causal=True
    (kernels K5w forward, K6w backward; with segment ids, K5s / K6s
    with the band)."""
    if window_size is not None:
        window_size = int(window_size)
        if not causal:
            raise ValueError(
                'window_size requires causal=True (decoder sliding-window '
                'attention); use an explicit mask for bidirectional bands')
        if window_size < 1:
            raise ValueError(f'window_size must be >= 1, got {window_size}')
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError('kv_segment_ids requires segment_ids')
    qseg = kseg = None
    if segment_ids is not None:
        kv = segment_ids if kv_segment_ids is None else kv_segment_ids
        qseg, kseg = segment_ids.to(torch.int32), kv.to(torch.int32)
    out = _flash.FlashAttentionFn.apply(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        bool(causal), scale, qseg, kseg, window_size)
    return out.transpose(1, 2)


def paged_decode_attention(q, key_cache, value_cache, block_tables,
                           context_lens, scale=None, k_scale=None,
                           v_scale=None):
    """Single-token attention over paged KV pools (kernel K8 of
    PERF.md); int8 pools pass float32 `k_scale` / `v_scale`, per row
    (NB, Hkv, BS) or per (kv head, dim) (Hkv, D) (kernel K8q). See
    `ops/hopper/paged_attention.py`."""
    fn = (_paged.paged_decode_attention
          if on_card(q, 'paged_decode_attention')
          else _paged.paged_decode_attention_plain)
    return fn(q, key_cache, value_cache, block_tables, context_lens, scale,
              k_scale, v_scale)


def decode_attention(q, k_cache, v_cache, valid_len, scale=None,
                     k_scale=None, v_scale=None, start=None):
    """Single-token attention over a contiguous (B, S, Hkv, D) cache
    (kernel K7 of PERF.md): q (B, 1, Hq, D) attends its row's window
    [start, min(valid_len, S)); int8 caches pass per-(kv head, dim)
    float32 `k_scale` / `v_scale`. See `ops/hopper/decode_attention.py`."""
    fn = (_decode.decode_attention if on_card(q, 'decode_attention')
          else _decode.decode_attention_plain)
    return fn(q, k_cache, v_cache, valid_len, scale, k_scale, v_scale,
              start)


def decode_attention_headmajor(q, k_cache, v_cache, context_lens,
                               scale=None, k_scale=None, v_scale=None):
    """Single-token attention over a head-major (B, Hkv, S, D) cache
    (kernel K9 of PERF.md, masked_multihead_attention's decode): q
    (B, 1, Hq, D) attends its row's first min(context_lens, S)
    positions; int8 caches pass (Hkv, D) float32 `k_scale` / `v_scale`.
    See `ops/hopper/headmajor_attention.py`."""
    fn = (_headmajor.decode_attention_headmajor
          if on_card(q, 'decode_attention_headmajor')
          else _headmajor.decode_attention_headmajor_plain)
    return fn(q.contiguous(), k_cache, v_cache, context_lens, scale, k_scale,
              v_scale)


def dispatch_decode_attention(q, k_cache, v_cache, valid_len, start=None,
                              window=None, k_scale=None, v_scale=None,
                              scale=None):
    """The decode step's one entry (the JAX package's
    `dispatch_decode_attention`): a sliding `window` becomes a later
    per-row start, max(start, valid_len - window), so every caller
    applies the same window rule; then `decode_attention`."""
    if window is not None:
        B = q.shape[0]
        vl = (valid_len.to(torch.int32).reshape(-1).expand(B)
              if isinstance(valid_len, torch.Tensor)
              else torch.full((B,), int(valid_len), dtype=torch.int32,
                              device=q.device))
        wstart = torch.clamp(vl - int(window), min=0)
        if start is not None:
            st = (start.to(torch.int32) if isinstance(start, torch.Tensor)
                  else torch.tensor(int(start), dtype=torch.int32,
                                    device=q.device))
            wstart = torch.maximum(st.reshape(-1).expand(B), wstart)
        start = wstart
    return decode_attention(q, k_cache, v_cache, valid_len, scale=scale,
                            k_scale=k_scale, v_scale=v_scale, start=start)


def _no_grad_through(x, name):
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f'{name} has no gradient (the TPU kernel has no VJP either): '
            f'quantized weights serve inference only')


def quant_matmul(x, wq, scale):
    """Weight-only int8 product (kernel K10): x (M, K) bf16 / float32,
    codes (K, N) int8, per-column float32 scale (N,) -> (M, N) in x's
    dtype. Inference only: raises when x needs a gradient."""
    _no_grad_through(x, 'quant_matmul')
    fn = (_qmm.quant_matmul if on_card(x, 'quant_matmul')
          else _qmm.quant_matmul_plain)
    return fn(x, wq, scale)


def quant_matmul_fp8(x, wq, scale):
    """Weight-only fp8 product (kernel K10f8): codes (K, N) of
    torch.float8_e4m3fn or torch.float8_e5m2; otherwise as
    `quant_matmul`."""
    _no_grad_through(x, 'quant_matmul_fp8')
    fn = (_qmm.quant_matmul_fp8 if on_card(x, 'quant_matmul_fp8')
          else _qmm.quant_matmul_fp8_plain)
    return fn(x, wq, scale)


def quant_matmul_int4(x, wq_packed, scale):
    """Weight-only packed-int4 product (kernel K11): codes
    (ceil(K / 2), N), two 4-bit codes per byte along K; otherwise as
    `quant_matmul`."""
    _no_grad_through(x, 'quant_matmul_int4')
    fn = (_qmm.quant_matmul_int4 if on_card(x, 'quant_matmul_int4')
          else _qmm.quant_matmul_int4_plain)
    return fn(x, wq_packed, scale)


def moe_grouped_matmul(x, w, offsets):
    """The dropless MoE layer's grouped expert product (kernel X1 of
    PERF.md, in place of XLA's `ragged_dot`): x (R, K) rows sorted by
    expert, w (E, K, N) in x's dtype, offsets (E + 1,) int32 from 0 to R
    -> (R, N), each expert's rows times its weight with float32 sums. On
    the card the offsets stay on the device (one launch, no host read).
    Differentiable in x and w: under a gradient it runs
    `MoEGroupedMatmulFn`, whose backward launches the dx and dw kernels
    on the card and takes their plain versions on the CPU."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _moe.MoEGroupedMatmulFn.apply(x, w, offsets)
    fn = (_moe.moe_grouped_matmul if on_card(x, 'moe_grouped_matmul')
          else _moe.moe_grouped_matmul_plain)
    return fn(x, w, offsets)


__all__ = ['LAUNCHES', 'decode_attention', 'decode_attention_headmajor',
           'dispatch_decode_attention',
           'flash_attention', 'moe_grouped_matmul',
           'paged_decode_attention', 'quant_matmul',
           'quant_matmul_fp8', 'quant_matmul_int4', 'rms_norm',
           'softmax_cross_entropy']
