#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py     # one CUDA card with about 50 GB free

Phases, in order (any failure exits non-zero and prints no result):

  1. device   the card's name, and its name and power limit as
              nvidia-smi reports them;
  2. build    every kernel built from paddle_tpu_torch/csrc for sm_90a
              (one nvcc per source, all in parallel), with ptxas's
              register and shared-memory report;
  3. kernels  each kernel held against its plain PyTorch version on the
              card at the shapes the serving, decode and training paths
              give it (bf16, and float32 where a path runs it), with a
              stated tolerance, and timed with CUDA events (kernel,
              plain version, and the one PyTorch call that computes the
              same function, where there is one) against its bound, the
              least time the card needs for the bytes or the operations;
  4. serving  a ServingEngine over a Llama-7B-width model (all 32
              layers, bf16 weights drawn from a seeded generator)
              answers 8 requests, admitted while other rows decode; the
              kernels' launch counts over that run must match the
              engine's model calls, and no page may leak; then one
              decode window traced with torch.profiler (device time by
              kernel, and the share of the window the device was busy);
  5. logits   one served request's decode-step logits through the
              kernels against the plain versions on the same tokens:
              bounded in float32 (the served weights cast up); in bf16
              printed with each kernel alone and a kernel-free control;
  6. decode   the JAX bench's decode section at Llama-7B width (all 32
              layers, bf16): greedy single-token forwards over 2048-
              position contiguous caches at batch 1 and 8, with an int8
              KV cache, and with int8 and int4 weights (tokens/s, ms per
              forward, exact launch counts of K1, K7, K10, K11; one
              forward traced at b8 bf16 and at b1 int8 weights), then
              DecodeEngine end to end on a 13-token prompt, then the
              kernels against the plain versions in float32 (7B width,
              2 layers): logits of 16 decode steps in five modes, and
              DecodeEngine token-equal to generate;
  7. grads    one training step's loss and gradients (Llama-7B width, 2
              layers, 1 x 2048 tokens) through the kernels against the
              plain versions: bounded in float32, printed in bf16;
  8. train    TrainEngine + AdamW at the JAX bench's training
              configuration (Llama-7B width, 4 layers, bf16, 6 x 2048
              tokens): 2 warm-up and 5 timed steps on one repeated
              batch (tokens/s, ms per step, peak memory, per-step
              losses that must fall), exact launch counts per step, and
              one step traced with torch.profiler.

The last three lines are the card's name and power limit as nvidia-smi
gives them, a JSON object with one record per kernel, and
{"ok": true, "device": {...}}. With no CUDA card, or run without the
paddle_tpu_torch package beside it, the script fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from unittest import mock

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes, flops, peak_flops):
    """The least time the card needs: bytes over memory rate or
    operations over peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


class Timer:
    """Mean time of one call on the card, from CUDA events around each
    call, with the L2 cache flushed before every call (the serving path
    finds its KV pages cold: a decode step streams 13 GB of weights
    between two visits to one layer's pages). A device-side sleep after
    the flush holds the stream while the host enqueues the call, so the
    events time the call's kernels and not its Python wrapper's host
    time (which a kernel of a few microseconds would otherwise show)."""

    HOLD_CYCLES = 1_000_000      # ~0.5 ms at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device='cuda')

    def __call__(self, fn, iters=30, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters


def check_rms_norm(torch, timer, R, N, dtype, return_r):
    """K1 as a path calls it: serving (under no_grad) without the row
    scale r, training with it (RMSNormFn saves r for K2). Both variants
    are checked at every shape; the one the path runs is timed."""
    from paddle_tpu_torch.ops.hopper import rms_norm as k

    g = torch.Generator(device='cuda').manual_seed(R)
    x = torch.randn(R, N, device='cuda', generator=g).to(dtype)
    w = 1.0 + 0.1 * torch.randn(N, device='cuda', generator=g)
    eps = 1e-5
    out_only = k.rms_norm(x, w, eps)
    out, r = k.rms_norm(x, w, eps, return_r=True)
    ref, ref_r = k.rms_norm_plain(x, w, eps, return_r=True)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = f'rms_norm ({R}, {N}) {dtype}'
    err = max(within(out_only, ref, tol, what + ' out (no r)'),
              within(out, ref, tol, what + ' out'))
    r_err = ((r - ref_r).abs() / ref_r.abs()).max().item()
    if r_err > 1e-5:
        raise AssertionError(f'{what}: r relative error {r_err} > 1e-5')
    w_lib = w.to(x.dtype)        # the fused library path wants x's dtype
    nbytes = 2 * R * N * x.element_size() + N * 4 + (R * 4 if return_r
                                                      else 0)
    b, by = bound_ms(nbytes, 4 * R * N, F32_FLOPS)
    return {
        'shape': (f'x ({R}, {N}) {dname(torch, dtype)}, w ({N},) f32, '
                  f'{"with" if return_r else "without"} r'),
        'max_abs_err': err,
        'tolerance': f'out: {tol_text(tol)}; r: relative 1e-5',
        'ms': timer(lambda: k.rms_norm(x, w, eps, return_r=return_r)),
        'plain_ms': timer(lambda: k.rms_norm_plain(x, w, eps,
                                                   return_r=return_r)),
        'library_ms': timer(lambda: torch.nn.functional.rms_norm(
            x, (N,), w_lib, eps)),
        'library': 'F.rms_norm',
        'bound_ms': b, 'bound_by': by,
    }


def check_paged(torch, timer, Hq, Hkv, D=128, BS=16):
    """llama_7b decode shapes: 4 rows of ragged contexts up to 1024
    positions over shuffled pages; one row's count runs past its table
    (clamped), one table holds a -1 entry, one row has count 0."""
    from paddle_tpu_torch.ops.hopper import paged_attention as k

    g = torch.Generator(device='cuda').manual_seed(Hkv)
    B, MAXB = 4, 1024 // BS
    lens = [1100, 517, 0, 300]
    used = [min(math.ceil(n / BS), MAXB) for n in lens]
    NB = sum(used) + 40
    perm = torch.randperm(NB - 1, generator=g, device='cuda') + 1
    tbl = torch.zeros(B, MAXB, dtype=torch.int32, device='cuda')
    at = 0
    for b, u in enumerate(used):
        tbl[b, :u] = perm[at:at + u]
        at += u
    tbl[1, used[1]] = -1
    tbl[2] = perm[:MAXB]                      # count 0: entries unread
    q = torch.randn(B, 1, Hq, D, device='cuda',
                    generator=g).to(torch.bfloat16)
    kc = torch.randn(NB, Hkv, BS, D, device='cuda',
                     generator=g).to(torch.bfloat16)
    vc = torch.randn(NB, Hkv, BS, D, device='cuda',
                     generator=g).to(torch.bfloat16)
    cl = torch.tensor(lens, dtype=torch.int32, device='cuda')
    out = k.paged_decode_attention(q, kc, vc, tbl, cl)
    ref = k.paged_decode_attention_plain(q, kc, vc, tbl, cl)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    tol = 1e-2 + 1e-2 * ref.float().abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f'paged attention Hq={Hq} Hkv={Hkv}: max '
                             f'|kernel - plain| {err.max().item()}')
    if out[2].abs().max().item() != 0.0:
        raise AssertionError('paged attention: a count-0 row must be 0')
    ctx = sum(min(n, MAXB * BS) for n in lens)
    nbytes = (ctx * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2
              + B * MAXB * 4 + B * 4)
    b, by = bound_ms(nbytes, 4 * ctx * Hq * D, BF16_FLOPS)
    return {
        'shape': (f'B={B} Hq={Hq} Hkv={Hkv} D={D} BS={BS} '
                  f'lens={lens} bf16'),
        'max_abs_err': err.max().item(),
        'tolerance': '|kernel - plain| <= 1e-2 + 1e-2 * |plain|',
        'ms': timer(lambda: k.paged_decode_attention(q, kc, vc, tbl, cl)),
        'plain_ms': timer(lambda: k.paged_decode_attention_plain(
            q, kc, vc, tbl, cl)),
        'library_ms': None,
        'bound_ms': b, 'bound_by': by,
    }


def check_decode(torch, timer, B, Hq, Hkv, mode, S=2048, D=128):
    """K7 at the decode phase's shapes (a 2048-position cache of Llama-7B
    heads). B = 1 is the bench's row (window [0, 2000)); B = 8 varies
    the window per row: an empty one (start past valid_len), valid_len
    past S (clamped), starts inside the cache. Modes: bf16, float32, and
    int8 caches with per-(head, dim) scales under a bf16 query."""
    from paddle_tpu_torch.ops.hopper import decode_attention as k

    F = torch.nn.functional
    g = torch.Generator(device='cuda').manual_seed(B * 100 + Hkv)
    dtype = torch.float32 if mode == 'float32' else torch.bfloat16
    q = torch.randn(B, 1, Hq, D, device='cuda', generator=g).to(dtype)
    ks = vs = None
    if mode == 'int8':
        kc, vc = (torch.randint(-127, 128, (B, S, Hkv, D), device='cuda',
                                generator=g, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (0.005 + 0.015 * torch.rand(Hkv, D, device='cuda',
                                             generator=g)
                  for _ in range(2))
    else:
        kc, vc = (torch.randn(B, S, Hkv, D, device='cuda',
                              generator=g).to(dtype) for _ in range(2))
    if B == 1:
        vl_list, st_list = [S - 48], [0]
    else:
        vl_list = [S + 5, 700, S, 1500, 37, S - 1, 1024, 2047][:B]
        st_list = [0, 900, 100, 0, 0, 1000, 512, 2040][:B]
    vl = torch.tensor(vl_list, dtype=torch.int32, device='cuda')
    st = torch.tensor(st_list, dtype=torch.int32, device='cuda')
    out = k.decode_attention(q, kc, vc, vl, None, ks, vs, st)
    ref = k.decode_attention_plain(q, kc, vc, vl, None, ks, vs, st)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = f'decode attention B={B} Hq={Hq} Hkv={Hkv} {mode}'
    err = within(out, ref, tol, what)
    for b, (v_, s_) in enumerate(zip(vl_list, st_list)):
        if s_ >= min(v_, S) and out[b].abs().max().item() != 0.0:
            raise AssertionError(f'{what}: row {b} has an empty window and '
                                 f'must be 0')
    # the bytes this run's windows need: each K and V row once, q, out
    # (and the scales)
    pos = sum(max(0, min(v_, S) - min(max(s_, 0), S))
              for v_, s_ in zip(vl_list, st_list))
    nbytes = (2 * pos * Hkv * D * kc.element_size()
              + 2 * B * Hq * D * q.element_size()
              + (2 * Hkv * D * 4 if ks is not None else 0) + 2 * B * 4)
    b_, by = bound_ms(nbytes, 4 * pos * Hq * D,
                      BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    # the yardstick: SDPA over the whole cache with the window as a mask
    # (an int8 cache dequantized to bf16 first: the same function at
    # twice the cache bytes)
    kl, vl_ = kc, vc
    if ks is not None:
        kl = (kc.float() * ks).to(dtype)
        vl_ = (vc.float() * vs).to(dtype)
    kpos = torch.arange(S, device='cuda')
    mask = ((kpos[None] < vl[:, None]) & (kpos[None] >= st[:, None]))[
        :, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kl.transpose(1, 2), vl_.transpose(1, 2)
    lib = F.scaled_dot_product_attention
    return {
        'shape': (f'B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {mode} '
                  f'valid_len={vl_list} start={st_list}'),
        'max_abs_err': err, 'tolerance': tol_text(tol),
        'ms': timer(lambda: k.decode_attention(q, kc, vc, vl, None, ks, vs,
                                               st)),
        'plain_ms': timer(lambda: k.decode_attention_plain(
            q, kc, vc, vl, None, ks, vs, st), iters=10),
        'library_ms': timer(lambda: lib(qt, kt, vt, attn_mask=mask,
                                        enable_gqa=Hq != Hkv)),
        'library': ('F.scaled_dot_product_attention with the window as a '
                    'boolean mask' + (' over the cache dequantized to bf16'
                                      if ks is not None else '')),
        'bound_ms': b_, 'bound_by': by,
    }


def check_quant_matmul(torch, timer, M, K, N, dtype, bits):
    """K10 (bits 8) or K11 (bits 4) at a Llama-7B projection: M = 1 and 8
    decode rows, 16 (the bucketed prefill), 2048 (a long prompt). The
    yardstick is torch.matmul against the weight dequantized to x's
    dtype: the same product reading 2x (K10) or 4x (K11) the weight
    bytes in bf16; where the installed torch has a CUDA
    torch._weight_int8pack_mm (K10's function for bf16 x), it is timed
    too."""
    from paddle_tpu_torch.ops.hopper import quant_matmul as k

    g = torch.Generator(device='cuda').manual_seed(M + K + N + bits)
    w = 0.02 * torch.randn(K, N, device='cuda', generator=g)
    quant = k.quantize_weight_int4 if bits == 4 else k.quantize_weight
    codes, scale = quant(w)
    del w
    x = torch.randn(M, K, device='cuda', generator=g).to(dtype)
    kern = k.quant_matmul_int4 if bits == 4 else k.quant_matmul
    plain = k.quant_matmul_int4_plain if bits == 4 else k.quant_matmul_plain
    out = kern(x, codes, scale)
    ref = plain(x, codes, scale)
    torch.cuda.synchronize()
    # float32: sums of K products in another order; bf16: one rounding
    # step of the output on top
    tol = {'float32': (1e-4, 1e-4), 'bfloat16': TENSOR_TOL['bfloat16']}[
        dname(torch, dtype)]
    what = f'quant_matmul int{bits} M={M} K={K} N={N} {dtype}'
    err = within(out, ref, tol, what)
    del out, ref
    item = x.element_size()
    nbytes = (M * K * item + codes.numel() + N * 4 + M * N * item)
    b_, by = bound_ms(nbytes, 2 * M * K * N,
                      BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    if bits == 4:
        deq = (k.unpack_int4(codes)[:K] * scale).to(dtype)
    else:
        deq = (codes.float() * scale).to(dtype)
    iters = 20 if M <= 16 else 5
    rec = {
        'shape': f'x ({M}, {K}) {dname(torch, dtype)}, codes int{bits} '
                 f'{tuple(codes.shape)}',
        'max_abs_err': err, 'tolerance': tol_text(tol),
        'ms': timer(lambda: kern(x, codes, scale), iters=iters),
        'plain_ms': timer(lambda: plain(x, codes, scale), iters=iters),
        'library_ms': timer(lambda: torch.matmul(x, deq), iters=iters),
        'library': (f'torch.matmul against the weight dequantized to '
                    f'{dname(torch, dtype)} (the same product at '
                    f'{(2 if bits == 8 else 4) * item // 2}x the weight '
                    f'bytes)'),
        'bound_ms': b_, 'bound_by': by,
    }
    if bits == 8 and dtype == torch.bfloat16 and hasattr(
            torch, '_weight_int8pack_mm'):
        wt = codes.t().contiguous()
        try:
            torch._weight_int8pack_mm(x, wt, scale.to(dtype))
            rec['int8pack_ms'] = timer(lambda: torch._weight_int8pack_mm(
                x, wt, scale.to(dtype)), iters=iters)
        except RuntimeError as e:      # a yardstick only: record why not
            rec['int8pack_ms'] = None
            rec['int8pack'] = f'torch._weight_int8pack_mm: {e}'[:200]
        del wt
    del deq, codes
    return rec


# (rtol, atol as a fraction of max |plain|) for a kernel's tensor output
# against its plain version: float32 differs by summation order only;
# bf16 by one rounding step of each element (2^-8 relative) on top
TENSOR_TOL = {'float32': (1e-4, 1e-5), 'bfloat16': (2.0 ** -7, 2.0 ** -9)}
# float32 statistics (lse, loss) computed in float32 on both sides
STAT_TOL = (1e-5, 1e-6)


def within(got, ref, tol, what):
    """max |got - ref|, which must stay within rtol * |ref| + atol *
    max |ref| everywhere."""
    rtol, atol = tol
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if not bool((err <= rtol * r.abs() + atol * r.abs().max()).all()):
        raise AssertionError(
            f'{what}: max |kernel - plain| {err.max().item():.4g} exceeds '
            f'{rtol:g} * |plain| + {atol:g} * max |plain| (max |plain| '
            f'{r.abs().max().item():.4g})')
    return err.max().item()


def tol_text(tol):
    return f'|kernel - plain| <= {tol[0]:g} * |plain| + {tol[1]:g} * ' \
        f'max |plain|'


def dname(torch, dtype):
    return str(dtype).replace('torch.', '')


def check_rms_norm_bwd(torch, timer, R, N, dtype):
    """K2 at the training path's rows (6 x 2048 tokens)."""
    from paddle_tpu_torch.ops.hopper import rms_norm as k

    gen = torch.Generator(device='cuda').manual_seed(R + N)
    x = torch.randn(R, N, device='cuda', generator=gen).to(dtype)
    gy = torch.randn(R, N, device='cuda', generator=gen).to(dtype)
    w = 1.0 + 0.1 * torch.randn(N, device='cuda', generator=gen)
    _, r = k.rms_norm_plain(x, w, 1e-5, return_r=True)
    got = k.rms_norm_bwd(x, w, r, gy)
    ref = k.rms_norm_bwd_plain(x, w, r, gy)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    err = within(got, ref, tol, f'rms_norm_bwd ({R}, {N}) {dtype}')
    nbytes = 3 * R * N * x.element_size() + N * 4 + R * 4
    b, by = bound_ms(nbytes, 6 * R * N, F32_FLOPS)
    xr = x.detach().requires_grad_()
    lib = torch.nn.functional.rms_norm(xr, (N,), w.to(dtype), 1e-5)
    return {
        'shape': f'x, g ({R}, {N}) {dname(torch, dtype)}, w ({N},) f32',
        'max_abs_err': err, 'tolerance': tol_text(tol),
        'ms': timer(lambda: k.rms_norm_bwd(x, w, r, gy)),
        'plain_ms': timer(lambda: k.rms_norm_bwd_plain(x, w, r, gy)),
        'library_ms': timer(lambda: torch.autograd.grad(
            lib, xr, gy, retain_graph=True)),
        'library': 'backward of F.rms_norm (dx)',
        'bound_ms': b, 'bound_by': by,
    }


def check_xent(torch, timer, R, V, dtype):
    """K3 and K4 at the training path's logits (6 x 2048 tokens, Llama's
    32000-word vocab), with the mean's upstream gradient 1 / R. Each
    kernel is fed the plain version's inputs (K4 the plain lse), so each
    is checked alone."""
    from paddle_tpu_torch.ops.hopper import softmax_xent as k

    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(R + V)
    x = (2.0 * torch.randn(R, V, device='cuda', generator=gen)).to(dtype)
    labels = torch.randint(0, V, (R,), device='cuda', generator=gen)
    g = torch.full((R,), 1.0 / R, device='cuda')
    loss, lse = k.softmax_xent_fwd(x, labels)
    ref_loss, ref_lse = k.softmax_xent_fwd_plain(x, labels)
    dx = k.softmax_xent_bwd(x, labels, ref_lse, g)
    ref_dx = k.softmax_xent_bwd_plain(x, labels, ref_lse, g)
    torch.cuda.synchronize()
    what = f'softmax_xent ({R}, {V}) {dtype}'
    err_f = max(within(loss, ref_loss, STAT_TOL, what + ' loss'),
                within(lse, ref_lse, STAT_TOL, what + ' lse'))
    tol = TENSOR_TOL[dname(torch, dtype)]
    err_b = within(dx, ref_dx, tol, what + ' dx')
    item = x.element_size()
    shape = f'logits ({R}, {V}) {dname(torch, dtype)}, labels int64'
    b_f, by_f = bound_ms(R * V * item + R * 8 + 2 * R * 4, 4 * R * V,
                         F32_FLOPS)
    b_b, by_b = bound_ms(2 * R * V * item + R * 16, 4 * R * V, F32_FLOPS)
    xr = x.detach().requires_grad_()
    lib = F.cross_entropy(xr, labels, reduction='none')
    fwd = {
        'shape': shape, 'max_abs_err': err_f,
        'tolerance': 'loss, lse: ' + tol_text(STAT_TOL),
        'ms': timer(lambda: k.softmax_xent_fwd(x, labels)),
        'plain_ms': timer(lambda: k.softmax_xent_fwd_plain(x, labels)),
        'library_ms': timer(lambda: F.cross_entropy(x, labels,
                                                    reduction='none')),
        'library': 'F.cross_entropy(reduction="none")',
        'bound_ms': b_f, 'bound_by': by_f,
    }
    bwd = {
        'shape': shape, 'max_abs_err': err_b, 'tolerance': tol_text(tol),
        'ms': timer(lambda: k.softmax_xent_bwd(x, labels, ref_lse, g)),
        'plain_ms': timer(lambda: k.softmax_xent_bwd_plain(
            x, labels, ref_lse, g)),
        'library_ms': timer(lambda: torch.autograd.grad(
            lib, xr, g, retain_graph=True)),
        'library': 'backward of F.cross_entropy',
        'bound_ms': b_b, 'bound_by': by_b,
    }
    return fwd, bwd


def check_flash(torch, timer, B, H, Hkv, S, D, dtype):
    """K5 and K6, causal, in the model's layout ((B, S, H, D) tensors
    passed as (B, H, S, D) views). The backward kernels are fed the
    plain forward's out and lse, so each direction is checked alone."""
    from paddle_tpu_torch.ops.hopper import flash_attention as k

    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(H * 1000 + Hkv)

    def bshd(h):
        return torch.randn(B, S, h, D, device='cuda', generator=gen) \
            .to(dtype).transpose(1, 2)

    q, kk, v, do = bshd(H), bshd(Hkv), bshd(Hkv), bshd(H)
    scale = 1.0 / math.sqrt(D)
    out, lse = k.flash_attention_fwd(q, kk, v, True, scale)
    ref_out, ref_lse = k.flash_attention_fwd_plain(q, kk, v, True, scale)
    grads = k.flash_attention_bwd(q, kk, v, ref_out, ref_lse, do, True,
                                  scale)
    ref_grads = k.flash_attention_bwd_plain(q, kk, v, ref_out, ref_lse, do,
                                            True, scale)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = f'flash attention B={B} H={H} Hkv={Hkv} S={S} {dtype}'
    err_f = max(within(out, ref_out, tol, what + ' out'),
                within(lse, ref_lse, STAT_TOL, what + ' lse'))
    err_b = max(within(g, r, tol, f'{what} {n}') for n, g, r in
                zip(('dq', 'dk', 'dv'), grads, ref_grads))
    del out, lse, grads, ref_grads
    item = q.element_size()
    pairs = B * H * S * (S + 1) // 2          # causal (query, key) pairs
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    q_bytes, kv_bytes = B * H * S * D * item, B * Hkv * S * D * item
    b_f, by_f = bound_ms(2 * q_bytes + 2 * kv_bytes + B * H * S * 4,
                         4 * D * pairs, peak)
    # the least backward work: s recomputed, then dp, dv, dq and dk
    b_b, by_b = bound_ms(4 * q_bytes + 4 * kv_bytes + B * H * S * 4,
                         10 * D * pairs, peak)
    shape = (f'B={B} H={H} Hkv={Hkv} S={S} D={D} causal '
             f'{dname(torch, dtype)}')
    gqa = H != Hkv
    lib_in = [t.detach().requires_grad_() for t in (q, kk, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             scale=scale, enable_gqa=gqa)
    fwd = {
        'shape': shape, 'max_abs_err': err_f,
        'tolerance': f'out: {tol_text(tol)}; lse: {tol_text(STAT_TOL)}',
        'ms': timer(lambda: k.flash_attention_fwd(q, kk, v, True, scale)),
        'plain_ms': timer(lambda: k.flash_attention_fwd_plain(
            q, kk, v, True, scale), iters=10),
        'library_ms': timer(lambda: F.scaled_dot_product_attention(
            q, kk, v, is_causal=True, scale=scale, enable_gqa=gqa)),
        'library': 'F.scaled_dot_product_attention',
        'bound_ms': b_f, 'bound_by': by_f,
    }
    bwd = {
        'shape': shape, 'max_abs_err': err_b, 'tolerance': tol_text(tol),
        'ms': timer(lambda: k.flash_attention_bwd(
            q, kk, v, ref_out, ref_lse, do, True, scale)),
        'plain_ms': timer(lambda: k.flash_attention_bwd_plain(
            q, kk, v, ref_out, ref_lse, do, True, scale), iters=10),
        'library_ms': timer(lambda: torch.autograd.grad(
            lib_out, lib_in, do, retain_graph=True)),
        'library': 'backward of F.scaled_dot_product_attention',
        'bound_ms': b_b, 'bound_by': by_b,
    }
    return fwd, bwd


def decode_logits(torch, model, prompt, gen):
    """Logits of every decode step of one request (its prompt, then its
    generated tokens fed back one at a time) through a private page
    pool: the prefill's last-token logits, then one row per decode
    step."""
    from paddle_tpu_torch.inference.serving import _prefill_kv

    BS = 16
    dev = model.device
    n_pages = math.ceil((len(prompt) + len(gen)) / BS)
    pages = model.init_paged_cache(n_pages + 1, BS)
    btab = torch.arange(1, n_pages + 1, dtype=torch.int32,
                        device=dev)[None]
    ids = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    rl = torch.tensor([len(prompt)], device=dev)
    with torch.no_grad():
        last, pages = _prefill_kv(model, pages, ids, rl, btab)
        rows = [last.float()]
        ctx = len(prompt)
        for tok in gen[:-1]:
            logits, pages = model(
                torch.tensor([[int(tok)]], device=dev), caches=pages,
                kv_write_pos=torch.tensor([ctx], dtype=torch.int32,
                                          device=dev),
                block_tables=btab)
            rows.append(logits[:, -1].float())
            ctx += 1
    return torch.cat(rows)


def profile_window(torch, engine, prompts, card):
    """Trace one engine step that decodes a full window of 4 rows, and
    print the device time by kernel and the share of the step's wall
    time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    rids = [engine.submit(p, 16) for p in prompts[:4]]
    engine.step()                 # admissions + first window: not traced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    engine.run()
    for r in rids:
        engine.result(r)
    # kernel-level events only (an operator's device time is its
    # kernels' time, counted once)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print('profile: the profiler recorded no device time; device-busy '
              'share not measured')
        return
    busy = sum(r[0] for r in rows) / 1e3
    print(f'profile: one window of {engine.decode_window} decode forwards '
          f'x 4 rows under the profiler: wall {wall * 1e3:.1f} ms, device '
          f'busy {busy:.1f} ms ({busy / (wall * 1e3):.3f}) [{card}]')
    for t_us, n, key in rows[:15]:
        print(f'profile:   {t_us / 1e3:9.3f} ms  {n:6d}x  {key[:90]}')


def serve_phase(torch, np, card):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = dataclasses.replace(llama_7b(), dtype='bfloat16')
    L = cfg.num_hidden_layers
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f'model: llama_7b width, {L} layers, {n_params} parameters, '
          f'bf16, drawn in {time.perf_counter() - t:.1f} s')
    engine = ServingEngine(model, max_slots=4, block_size=16,
                           decode_window=8, max_new_tokens=32)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 513, 8)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    # warm the allocator and cuBLAS on one short request (not measured)
    engine.serve([prompts[0][:32]], max_new_tokens=8)
    before = engine.stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    # staggered arrivals: later requests are admitted while earlier
    # rows are still decoding
    rids = [engine.submit(p) for p in prompts[:2]]
    engine.step()
    rids += [engine.submit(p) for p in prompts[2:4]]
    engine.step()
    rids += [engine.submit(p) for p in prompts[4:]]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    after = engine.stats()
    outs = [engine.result(r) for r in rids]
    peak = torch.cuda.max_memory_allocated()

    for p, o in zip(prompts, outs):
        if o is None or len(o) != len(p) + 32 or not np.array_equal(
                o[:len(p)], p):
            raise AssertionError('a request did not return prompt + 32 ids')
        if o.min() < 0 or o.max() >= cfg.vocab_size:
            raise AssertionError('a returned id is outside the vocabulary')
    n_dec = after['decode_forwards'] - before['decode_forwards']
    n_pre = after['prefill_forwards'] - before['prefill_forwards']
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(paged_decode_attention=L * n_dec,
                rms_norm=(2 * L + 1) * (n_dec + n_pre))
    if launches != want:
        raise AssertionError(f'launch counts {launches} != expected {want} '
                             f'({n_dec} decode and {n_pre} prefill '
                             f'forwards)')
    if engine.allocator.in_use() != 0:
        raise AssertionError(f'{engine.allocator.in_use()} pages leaked')
    n_tok = after['tokens_generated'] - before['tokens_generated']
    n_steps = after['steps'] - before['steps']
    print(f'serving: {len(prompts)} requests, prompt lengths '
          f'{lens.tolist()}, {n_tok} tokens in {wall:.3f} s: '
          f'{n_tok / wall:.1f} tok/s, {wall / n_steps * 1e3:.1f} ms per '
          f'engine step ({n_steps} steps of {n_pre} prefills and '
          f'{n_dec // engine.decode_window} windows of '
          f'{engine.decode_window}), '
          f'{wall / n_dec * 1e3:.1f} ms per decode forward incl. prefill, '
          f'peak memory {peak / 2**30:.2f} GiB, preemptions '
          f'{after["preemptions"]} [{card}]')
    print(f'serving: launches {launches} over {n_dec} decode forwards and '
          f'{n_pre} prefill forwards; pages in use after drain: 0')

    profile_window(torch, engine, prompts, card)

    logits_phase(torch, model, cfg, prompts[2], outs[2][len(prompts[2]):])
    return launches


def rms_norm_f64(x, weight=None, epsilon=1e-6):
    """The plain RMSNorm computed in float64: it differs from the float32
    plain version by rounding alone, so it shows how far the model's
    logits move under a rounding difference that no kernel made."""
    xd = x.double()
    out = xd * (xd.square().mean(-1, keepdim=True) + epsilon).rsqrt()
    if weight is not None:
        out = out * weight.double()
    return out.to(x.dtype)


def logits_phase(torch, model, cfg, prompt, gen, f32_tol=1e-3):
    """One served request's decode-step logits through the kernels
    against the plain versions on the same tokens.

    float32 (the served weights cast up) is the check: there the two
    paths differ by summation order only, and max |kernels - plain| must
    stay within `f32_tol`. In bf16 a single rounding step anywhere in
    32 random-init layers moves the logits, so the bf16 differences are
    printed, not bounded, with each kernel swapped in alone and a
    kernel-free control (the plain path with RMSNorm in float64) beside
    them, to show what the bf16 difference is made of."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    plain = {'rms_norm': ops._rms.rms_norm_plain,
             'paged_decode_attention': ops._paged.paged_decode_attention_plain}

    def run(m, swap):
        with contextlib.ExitStack() as stack:
            for name, fn in swap.items():
                stack.enter_context(mock.patch.object(ops, name, fn))
            return decode_logits(torch, m, prompt, gen)

    head = f'request 2 ({len(prompt)} prompt + {len(gen)} decode steps)'
    ref = run(model, plain)
    variants = (
        ('both kernels', {}),
        ('rms_norm kernel only', {'paged_decode_attention':
                                  plain['paged_decode_attention']}),
        ('paged_decode_attention kernel only', {'rms_norm':
                                                plain['rms_norm']}),
        ('no kernel, RMSNorm in float64', dict(plain, rms_norm=rms_norm_f64)))
    for label, swap in variants:
        got = run(model, swap)
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f'logits bf16, {label}: {head}: max |this - plain| '
              f'{(got - ref).abs().max().item():.6g} (max |logit| '
              f'{ref.abs().max().item():.4f}), argmax agreement '
              f'{agree:.3f}')
        if not swap:
            served = float((got.argmax(-1).cpu().numpy() == gen).mean())
            print(f'logits bf16: kernel-path argmax equals the served '
                  f'tokens at {served:.3f}')

    f32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype='float32'),
                           seed=0)
    with torch.no_grad():
        for a, b in zip(f32.parameters(), model.parameters()):
            a.copy_(b)
    got, ref = run(f32, {}), run(f32, plain)
    err = (got - ref).abs().max().item()
    print(f'logits float32: {head}: max |kernels - plain| {err:.6g} '
          f'(bound {f32_tol:g}; max |logit| {ref.abs().max().item():.4f})')
    del f32
    if not err <= f32_tol:
        raise AssertionError(f'float32 decode logits differ by {err} > '
                             f'{f32_tol}')


@contextlib.contextmanager
def plain_kernels():
    """Every kernel swapped for its plain version: the ops and the
    autograd Functions look their kernel functions up at call time, so
    the same model code runs the plain math on the card."""
    from paddle_tpu_torch.ops.hopper import decode_attention as hd
    from paddle_tpu_torch.ops.hopper import flash_attention as hf
    from paddle_tpu_torch.ops.hopper import paged_attention as hp
    from paddle_tpu_torch.ops.hopper import quant_matmul as hq
    from paddle_tpu_torch.ops.hopper import rms_norm as hr
    from paddle_tpu_torch.ops.hopper import softmax_xent as hx

    with contextlib.ExitStack() as stack:
        for mod, name in ((hr, 'rms_norm'), (hr, 'rms_norm_bwd'),
                          (hx, 'softmax_xent_fwd'),
                          (hx, 'softmax_xent_bwd'),
                          (hf, 'flash_attention_fwd'),
                          (hf, 'flash_attention_bwd'),
                          (hp, 'paged_decode_attention'),
                          (hd, 'decode_attention'),
                          (hq, 'quant_matmul'), (hq, 'quant_matmul_int4')):
            stack.enter_context(mock.patch.object(
                mod, name, getattr(mod, name + '_plain')))
        yield


def loss_and_grads(torch, model, ids, plain):
    """One training step's loss and parameter gradients (no update)."""
    from paddle_tpu_torch import ops

    model.zero_grad(set_to_none=True)
    before = dict(ops.LAUNCHES)
    with plain_kernels() if plain else contextlib.nullcontext():
        loss = model.loss(ids)
        loss.backward()
    launched = dict(ops.LAUNCHES) != before
    if launched == plain:
        raise AssertionError(
            'the plain run launched a kernel' if plain
            else 'the kernel run launched no kernel')
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def grads_phase(torch, np, card, rel_tol=1e-4):
    """One training step's loss and gradients through the kernels
    against the plain versions, at Llama-7B width (2 layers, 1 x 2048
    tokens: the flash path, every RMSNorm, the loss).

    float32 is the check: the two paths differ by summation order only,
    so the loss may differ by 1e-5 of itself and each parameter's
    gradient by `rel_tol` in relative L2 norm. In bf16 a single rounding
    step anywhere moves every gradient below it, so bf16 is printed, not
    bounded (as the logits phase does)."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = dataclasses.replace(llama_7b(), num_hidden_layers=2,
                              dtype='float32')
    f32 = LlamaForCausalLM(cfg, seed=0)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 2049))).to(f32.device)
    results = {}
    for label, model in (('float32', f32), ('bfloat16', None)):
        if model is None:
            model = LlamaForCausalLM(dataclasses.replace(
                cfg, dtype='bfloat16'), seed=0)
            with torch.no_grad():
                for a, b in zip(model.parameters(), f32.parameters()):
                    a.copy_(b)
            del f32
        lk, gk = loss_and_grads(torch, model, ids, plain=False)
        lp, gp = loss_and_grads(torch, model, ids, plain=True)
        rel = {n: ((gk[n].float() - gp[n].float()).norm()
                   / gp[n].float().norm().clamp_min(1e-30)).item()
               for n in gp}
        worst = max(rel, key=rel.get)
        print(f'grads {label}: Llama-7B width, 2 layers, 1 x 2048 tokens: '
              f'loss kernels {lk:.6f} plain {lp:.6f} (|diff| '
              f'{abs(lk - lp):.3g}); worst gradient |kernels - plain| / '
              f'|plain| {rel[worst]:.3g} ({worst}), median '
              f'{float(np.median(list(rel.values()))):.3g} over '
              f'{len(rel)} parameters [{card}]', flush=True)
        results[label] = (lk, lp, rel[worst])
        del model, gk, gp
        gc.collect()
    lk, lp, worst = results['float32']
    if not (abs(lk - lp) <= 1e-5 * abs(lp) and worst <= rel_tol):
        raise AssertionError(f'float32 loss {lk} vs {lp} or gradient '
                             f'relative error {worst} > {rel_tol}')
    torch.cuda.empty_cache()


def count_launches(torch, fn):
    """fn() with every launch count set to 0 just before and read just
    after (synchronised): (result, counts)."""
    from paddle_tpu_torch import ops

    torch.cuda.synchronize()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def expect_launches(got, L, forwards, decode_forwards, quant=None):
    """The decode phase's exact launch counts: K1 2L + 1 per forward, K7
    L per single-token forward, K10 or K11 7L + 1 per forward of a
    quantized model, nothing else (K8 0)."""
    want = {name: 0 for name in got}
    want.update(rms_norm=(2 * L + 1) * forwards,
                decode_attention=L * decode_forwards)
    if quant:
        want[quant] = (7 * L + 1) * forwards
    if got != want:
        raise AssertionError(f'launch counts {got} != expected {want}')


def profile_forward(torch, fn, label, card):
    """Trace one decode forward: device time by kernel and the share of
    the forward's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print(f'decode profile {label}: the profiler recorded no device '
              f'time; device-busy share not measured')
        return
    busy = sum(r[0] for r in rows) / 1e3
    n = sum(r[1] for r in rows)
    print(f'decode profile {label}: one forward: wall {wall * 1e3:.2f} ms, '
          f'device busy {busy:.3f} ms ({busy / (wall * 1e3):.3f}), {n} '
          f'kernels [{card}]')
    for t_us, c, key in rows[:12]:
        print(f'decode profile {label}:   {t_us / 1e3:8.3f} ms  {c:5d}x  '
              f'{key[:90]}')


def bench_decode(torch, model, batch, label, card, quant=None,
                 kv_int8=False, cache_len=2048, steps=48, reps=3,
                 profile=False):
    """The JAX bench's decode measurement (bench.py:2739-2780): zero
    caches of `cache_len` positions, `steps` greedy single-token
    forwards per rep from cache index cache_len - steps - 2, one warm
    rep, then `reps` timed reps. With kv_int8 the caches are int8 with
    unit scales, as the JAX bench sets them (no prefill calibrates
    them). Checks the exact launch counts of all reps; returns
    (tokens/s, ms per forward, counts)."""
    L = model.config.num_hidden_layers
    caches = model.init_cache(batch, cache_len, quantized=kv_int8)
    if kv_int8:
        for c in caches:
            c.kscale.fill_(1.0)
            c.vscale.fill_(1.0)
    base = cache_len - steps - 2
    tok = torch.zeros(batch, 1, dtype=torch.int64, device=model.device)

    def rep(tok):
        for i in range(steps):
            logits, _ = model(tok, caches=caches, cache_index=base + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return tok

    def run():
        nonlocal tok
        with torch.no_grad():
            tok = rep(tok)                         # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                tok = rep(tok)
            torch.cuda.synchronize()
            return time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    dt, counts = count_launches(torch, run)
    n_fwd = (reps + 1) * steps
    expect_launches(counts, L, n_fwd, n_fwd, quant)
    if not bool(((tok >= 0) & (tok < model.config.vocab_size)).all()):
        raise AssertionError(f'{label}: a decoded id is outside the vocab')
    tps = batch * steps * reps / dt
    ms = dt / (steps * reps) * 1e3
    print(f'decode {label}: {tps:.2f} tokens/s, {ms:.3f} ms per forward '
          f'(batch {batch}, {steps} steps x {reps} timed reps over a '
          f'{cache_len}-position cache), peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
          f'{ {k: v for k, v in counts.items() if v} } over {n_fwd} '
          f'forwards [{card}]', flush=True)
    if profile:
        with torch.no_grad():
            profile_forward(torch, lambda: model(
                tok, caches=caches, cache_index=cache_len - 2), label, card)
    del caches
    return tps, ms, counts


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def capture_logits(torch, model, fn):
    """(fn()'s result, the last-position logits of every forward of
    `model` during it, stacked in float32)."""
    rows = []

    def hook(_mod, _args, out):
        rows.append(out[0][:, -1].float())

    h = model.register_forward_hook(hook)
    try:
        out = fn()
    finally:
        h.remove()
    return out, torch.stack(rows)


def agreement_phase(torch, np, card, steps=16, f32_tol=1e-3):
    """Kernels against plain versions on a float32 model at Llama-7B
    width with 2 layers: the logits of every forward of a generate
    (prefill, then `steps` decode forwards) in five modes must agree
    within `f32_tol`, with equal tokens; and DecodeEngine (padded to its
    bucket) must be token-equal to model.generate (unpadded)."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = dataclasses.replace(llama_7b(), num_hidden_layers=2,
                              dtype='float32')
    model = LlamaForCausalLM(cfg, seed=1)
    rng = np.random.default_rng(5)
    dev = model.device
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, 21))).to(dev)
    padded = torch.from_numpy(rng.integers(3, cfg.vocab_size, (3, 21))).to(
        dev)
    am = torch.ones_like(padded)
    am[0, :9] = 0
    am[2, :4] = 0
    padded = padded * am
    n = steps + 1
    modes = (
        ('float32 caches', model, dict(input_ids=ids), None),
        ('int8 KV, scales calibrated on the prefill', model,
         dict(input_ids=ids, kv_cache_int8=True), None),
        ('int8 weights', model.quantize_weights(8), dict(input_ids=ids),
         'quant_matmul'),
        ('int4 weights', model.quantize_weights(4), dict(input_ids=ids),
         'quant_matmul_int4'),
        ('left-padded batch, attention_mask', model,
         dict(input_ids=padded, attention_mask=am), None))
    for label, m, kw, quant in modes:
        def gen():
            return m.generate(max_new_tokens=n, **kw)

        (toks, lk), counts = count_launches(
            torch, lambda: capture_logits(torch, m, gen))
        expect_launches(counts, 2, n, steps, quant)
        with plain_kernels():
            (ptoks, lp), pcounts = count_launches(
                torch, lambda: capture_logits(torch, m, gen))
        if any(pcounts.values()):
            raise AssertionError(f'the plain run launched {pcounts}')
        err = (lk - lp).abs().max().item()
        print(f'agreement float32, {label}: Llama-7B width, 2 layers, '
              f'{steps} decode steps: max |kernels - plain| logit {err:.6g}'
              f' (bound {f32_tol:g}, max |logit| '
              f'{lp.abs().max().item():.4f}); tokens equal '
              f'{bool(torch.equal(toks, ptoks))} [{card}]', flush=True)
        if not (err <= f32_tol and torch.equal(toks, ptoks)):
            raise AssertionError(f'{label}: kernels and plain versions '
                                 f'disagree ({err} > {f32_tol} or tokens)')
        if kw.get('kv_cache_int8'):
            # an int8 code flips where K1 and the plain RMSNorm round a K
            # row differently: swap K7 alone, so both runs quantize the
            # same rows and the difference is K7's own
            from paddle_tpu_torch.ops.hopper import decode_attention as hd

            with mock.patch.object(hd, 'decode_attention',
                                   hd.decode_attention_plain):
                _, la = capture_logits(torch, m, gen)
            err = (lk - la).abs().max().item()
            print(f'agreement float32, {label}, K7 alone against its plain '
                  f'version: max |Δ| logit {err:.6g} (bound {f32_tol:g})')
            if not err <= f32_tol:
                raise AssertionError(f'{label}: K7 alone differs by {err}')
    prompt = ids[:, :13]
    got = DecodeEngine(model, max_new_tokens=n).generate(prompt)
    want = model.generate(prompt, max_new_tokens=n)
    print(f'agreement float32: DecodeEngine (13 tokens padded to 16) vs '
          f'generate (unpadded), {n} tokens: equal '
          f'{bool(torch.equal(got, want))}')
    if not torch.equal(got, want):
        raise AssertionError('DecodeEngine and generate disagree')
    del model, modes
    gc.collect()
    torch.cuda.empty_cache()


def decode_phase(torch, np, card):
    """The JAX bench's decode section (bench.py:2739-2860) at Llama-2-7B
    widths, all 32 layers, bf16 seeded weights: five bench_decode runs
    (b1, b8, b8 with an int8 KV cache, b1 with int8 weights, b1 with
    int4 weights), then DecodeEngine on a 13-token prompt (bucket 16)
    with 192 new tokens, then the float32 agreement checks. Returns the
    launch counts of the phase's measured runs."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama_7b(), dtype='bfloat16')
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    total = {}
    for batch, label, kv8, prof in ((1, 'b1 bf16', False, False),
                                    (8, 'b8 bf16', False, True),
                                    (8, 'b8 int8 KV', True, False)):
        add_counts(total, bench_decode(torch, model, batch, label, card,
                                       kv_int8=kv8, profile=prof)[2])
        gc.collect()
        torch.cuda.empty_cache()
    for bits, name in ((8, 'quant_matmul'), (4, 'quant_matmul_int4')):
        t = time.perf_counter()
        qm = model.quantize_weights(bits)
        torch.cuda.synchronize()
        nbytes = sum(b.numel() * b.element_size() for b in qm.buffers())
        print(f'decode: quantize_weights({bits}) in '
              f'{time.perf_counter() - t:.1f} s, {nbytes / 1e9:.3f} GB of '
              f'codes and scales')
        add_counts(total, bench_decode(
            torch, qm, 1, f'b1 int{bits} weights', card, quant=name,
            profile=bits == 8)[2])
        del qm
        gc.collect()
        torch.cuda.empty_cache()

    # DecodeEngine end to end (bench.py:2846-2860): one warm call, one
    # timed call over the engine's own (bucket + 192) cache
    eng_steps = 192
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, 13))).to(model.device)
    eng = DecodeEngine(model, max_new_tokens=eng_steps)
    eng.generate(prompt)
    torch.cuda.synchronize()

    def timed():
        t = time.perf_counter()
        out = eng.generate(prompt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (out, dt), counts = count_launches(torch, timed)
    expect_launches(counts, L, eng_steps, eng_steps - 1)
    add_counts(total, counts)
    print(f'decode DecodeEngine: {eng_steps / dt:.2f} tokens/s end to end '
          f'(13-token prompt in bucket 16, {eng_steps} new tokens, '
          f'{dt:.3f} s) [{card}]')
    gen = model.generate(prompt, max_new_tokens=eng_steps)
    same = (out[0, 13:] == gen[0, 13:]).int()
    lead = int(same.cumprod(0).sum().item())
    print(f'decode bf16, {L} layers: DecodeEngine (padded) and generate '
          f'(unpadded) agree on the first {lead} of {eng_steps} tokens '
          f'(printed, not asserted: bf16 rounding differs between the '
          f'padded and unpadded prefill)')
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()

    agreement_phase(torch, np, card)
    print(f'decode: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return total


KERNEL_GROUPS = (('flash_fwd', 'K5 flash fwd'), ('flash_bwd', 'K6 flash bwd'),
                 ('rms_norm_fwd', 'K1 rms fwd'), ('rms_norm_bwd', 'K2 rms bwd'),
                 ('xent_fwd', 'K3 xent fwd'), ('xent_bwd', 'K4 xent bwd'))


def kernel_group(key):
    for sub, label in KERNEL_GROUPS:
        if sub in key:
            return label
    low = key.lower()
    if any(t in low for t in ('gemm', 'nvjet', 'cutlass', 'xmma')):
        return 'GEMM (cuBLAS)'
    return 'other PyTorch kernels'


def profile_train_step(torch, eng, ids, card):
    """Trace one train step (forward, backward, AdamW update, one loss
    transfer): device time by kernel and by group, the share of the
    step's wall time the device was busy, and the AdamW update's share
    (CUDA events around it: its kernels run back to back on the
    stream)."""
    from torch.profiler import ProfilerActivity, profile

    opt = eng.optimizer
    update = opt.apply_gradients
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_update(grads):
        events[0].record()
        update(grads)
        events[1].record()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            mock.patch.object(opt, 'apply_gradients', timed_update):
        t = time.perf_counter()
        eng.step((ids,))
        eng.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    print(f'train profile: AdamW update {events[0].elapsed_time(events[1]):.1f}'
          f' ms of the step (CUDA events around apply_gradients)')
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print('train profile: the profiler recorded no device time; '
              'device-busy share not measured')
        return
    busy = sum(r[0] for r in rows) / 1e3
    print(f'train profile: one step under the profiler: wall '
          f'{wall * 1e3:.1f} ms, device busy {busy:.1f} ms '
          f'({busy / (wall * 1e3):.3f}) [{card}]')
    groups = {}
    for t_us, n, key in rows:
        g = groups.setdefault(kernel_group(key), [0.0, 0])
        g[0] += t_us / 1e3
        g[1] += n
    for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f'train profile:   {ms:9.3f} ms {ms / busy:6.3f}  {n:6d}x  '
              f'{label}')
    for t_us, n, key in rows[:15]:
        print(f'train profile:   {t_us / 1e3:9.3f} ms  {n:6d}x  {key[:90]}')


def train_phase(torch, np, card, warmup=2, steps=5):
    """TrainEngine + AdamW(1e-4, weight decay 0.01) at the JAX bench's
    training configuration (bench.py: Llama-2-7B widths, 4 layers, bf16,
    no remat, 6 x 2048 tokens), on one repeated batch."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.training import TrainEngine

    cfg = dataclasses.replace(llama_7b(), num_hidden_layers=4,
                              max_position_embeddings=2048,
                              dtype='bfloat16')
    L, B, S = cfg.num_hidden_layers, 6, 2048
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    eng = TrainEngine(model, AdamW(learning_rate=1e-4, weight_decay=0.01),
                      log_window=steps)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f'train: llama_7b width, {L} layers, {n_params} parameters, bf16 '
          f'(norm weights float32), float32 AdamW moments, built in '
          f'{time.perf_counter() - t:.1f} s')
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1))).to(model.device)
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    for _ in range(warmup):
        eng.step((ids,))
    warm = eng.sync()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = eng.step((ids,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = warm['losses'] + logs['losses']
    n = warmup + steps
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(flash_attention_fwd=L * n, flash_attention_bwd=2 * L * n,
                rms_norm=(2 * L + 1) * n, rms_norm_bwd=(2 * L + 1) * n,
                softmax_xent_fwd=n, softmax_xent_bwd=n)
    print(f'train: {steps} timed steps of {B} x {S} tokens after {warmup} '
          f'warm-up: {steps * B * S / wall:.1f} tokens/s, '
          f'{wall / steps * 1e3:.1f} ms per step, peak memory '
          f'{peak / 2**30:.2f} GiB [{card}]')
    print(f'train: losses per step {[round(x, 5) for x in losses]}')
    print(f'train: launches {launches} over {n} steps (per step: flash fwd '
          f'L, flash bwd 2L (dq, dk/dv), rms fwd and bwd 2L+1, xent fwd and '
          f'bwd 1; L = {L})', flush=True)
    if launches != want:
        raise AssertionError(f'train launch counts {launches} != {want}')
    # random-init logits are N(0, sigma^2) with sigma^2 = std^2 * hidden
    # (the final norm's output has unit RMS), so the first loss is about
    # ln V + sigma^2 / 2, not ln V
    first = math.log(cfg.vocab_size) + 0.5 * (
        cfg.initializer_range ** 2 * cfg.hidden_size)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'non-finite training loss: {losses}')
    if abs(losses[0] - first) > 0.1:
        raise AssertionError(f'first loss {losses[0]} is not within 0.1 of '
                             f'ln V + sigma^2 / 2 = {first:.4f}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'the loss did not fall on a repeated batch: '
                             f'{losses}')
    print(f'train: first loss {losses[0]:.4f} vs ln V + sigma^2 / 2 = '
          f'{first:.4f} (ln V = {math.log(cfg.vocab_size):.4f}); last '
          f'{losses[-1]:.4f}')
    profile_train_step(torch, eng, ids, card)
    return launches


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f'needs torch and numpy: {e}')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script drives the '
             'port on a CUDA card')
    try:
        from paddle_tpu_torch import ops
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f'paddle_tpu_torch is not importable beside this script: {e}')
    if torch.cuda.device_count() < 1:
        fail('no CUDA device')

    try:
        # 1. device
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        if smi.returncode:
            raise RuntimeError(f'nvidia-smi failed: {smi.stderr}')
        card = smi.stdout.strip().splitlines()[0]
        print(f'device: {kind}; torch {torch.__version__}, CUDA '
              f'{torch.version.cuda}')
        print(card, flush=True)

        # 2. build
        t = time.perf_counter()
        path = _build.build()
        _build.load()
        print(f'build: {path} in {time.perf_counter() - t:.1f} s')
        print(_build.build_log(), flush=True)

        # 3. kernels against their plain versions
        torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
        torch.backends.cudnn.allow_tf32 = False
        timer = Timer(torch)
        bf16, f32 = torch.bfloat16, torch.float32
        cases = {
            # decode and prefill rows (serving), then 6 x 2048 tokens
            # (training, bf16, and float32 as the gradient phase runs it)
            'rms_norm': [check_rms_norm(torch, timer, 4, 4096, bf16, False),
                         check_rms_norm(torch, timer, 2048, 4096, bf16,
                                        False),
                         check_rms_norm(torch, timer, 12288, 4096, bf16,
                                        True),
                         check_rms_norm(torch, timer, 12288, 4096, f32,
                                        True)],
            'paged_decode_attention': [check_paged(torch, timer, 32, 32),
                                       check_paged(torch, timer, 32, 8)],
            'rms_norm_bwd': [check_rms_norm_bwd(torch, timer, 12288, 4096,
                                                dt) for dt in (bf16, f32)],
        }
        for dt in (bf16, f32):
            fwd, bwd = check_xent(torch, timer, 12288, 32000, dt)
            cases.setdefault('softmax_xent_fwd', []).append(fwd)
            cases.setdefault('softmax_xent_bwd', []).append(bwd)
        for H, Hkv, dt in ((32, 32, bf16), (32, 32, f32), (32, 8, bf16)):
            fwd, bwd = check_flash(torch, timer, 1, H, Hkv, 2048, 128, dt)
            cases.setdefault('flash_attention_fwd', []).append(fwd)
            cases.setdefault('flash_attention_bwd', []).append(bwd)
            torch.cuda.empty_cache()
        # decode attention: the bench's b1 row first (the main path)
        cases['decode_attention'] = [
            check_decode(torch, timer, B, 32, Hkv, mode)
            for B in (1, 8) for Hkv in (32, 8)
            for mode in ('bfloat16', 'float32', 'int8')]
        torch.cuda.empty_cache()
        # weight-only products: M = 1 bf16 at 4096 x 4096 first
        for bits, name in ((8, 'quant_matmul'), (4, 'quant_matmul_int4')):
            cases[name] = [
                check_quant_matmul(torch, timer, M, K, N, dt, bits)
                for M in (1, 8, 16, 2048)
                for K, N in ((4096, 4096), (4096, 11008), (11008, 4096),
                             (4096, 32000))
                for dt in (bf16, f32)]
            torch.cuda.empty_cache()
        for name, cs in cases.items():
            for c in cs:
                print(f'kernel {name}: {json.dumps(c)} [{card}]', flush=True)
        del timer
        torch.cuda.empty_cache()

        # 4-5. serving, launch counts, leaks, logits
        serve_launches = serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()

        # 6. decode over contiguous caches: the JAX bench's decode
        # section, DecodeEngine, float32 agreement
        decode_launches = decode_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()

        # 7. a training step's gradients through the kernels vs plain
        grads_phase(torch, np, card)

        # 8. training at the JAX bench's configuration
        train_launches = train_phase(torch, np, card)

        records = []
        for name, src, rep in (
                ('rms_norm', 'rms_norm.cu', 'rms_norm.py:53'),
                ('rms_norm_bwd', 'rms_norm.cu', 'rms_norm.py:86'),
                ('softmax_xent_fwd', 'softmax_xent.cu', 'softmax_xent.py:92'),
                ('softmax_xent_bwd', 'softmax_xent.cu',
                 'softmax_xent.py:131'),
                ('flash_attention_fwd', 'flash_attention.cu',
                 'flash_attention.py:121'),
                ('flash_attention_bwd', 'flash_attention.cu',
                 'flash_attention.py:323'),
                ('paged_decode_attention', 'paged_attention.cu',
                 'paged_attention.py:140'),
                ('decode_attention', 'decode_attention.cu',
                 'decode_attention.py:164'),
                ('quant_matmul', 'quant_matmul.cu', 'quant_matmul.py:124'),
                ('quant_matmul_int4', 'quant_matmul.cu',
                 'quant_matmul.py:154')):
            cs = cases[name]
            head = cs[0]       # the main path's shape and dtype
            by_path = {'serving': serve_launches[name],
                       'decode': decode_launches.get(name, 0),
                       'train': train_launches[name]}
            records.append({
                'name': name, 'route': 'cuda',
                'source': f'paddle_tpu_torch/csrc/{src}',
                'replaces': f'paddle_tpu/ops/pallas/{rep}',
                'launches': sum(by_path.values()),
                'launches_by_path': by_path,
                'max_abs_err': max(c['max_abs_err'] for c in cs),
                'ms': head['ms'], 'plain_ms': head['plain_ms'],
                'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
                'library_ms': head['library_ms'], 'shape': head['shape'],
                'cases': cs})
        unused = [r['name'] for r in records if not r['launches']]
        if unused:
            raise AssertionError(f'kernels the paths never launched: '
                                 f'{unused}')
        print(card)
        print(json.dumps({'kernels': records}))
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        fail('a phase failed (traceback above)')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
