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
              card at the shapes the serving and training paths give it
              (bf16, and float32 for the training kernels), with a
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
  6. grads    one training step's loss and gradients (Llama-7B width, 2
              layers, 1 x 2048 tokens) through the kernels against the
              plain versions: bounded in float32, printed in bf16;
  7. train    TrainEngine + AdamW at the JAX bench's training
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
    between two visits to one layer's pages)."""

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
    """Every training kernel swapped for its plain version: the autograd
    Functions look their kernel functions up at call time, so the same
    model code runs the plain math on the card."""
    from paddle_tpu_torch.ops.hopper import flash_attention as hf
    from paddle_tpu_torch.ops.hopper import rms_norm as hr
    from paddle_tpu_torch.ops.hopper import softmax_xent as hx

    with contextlib.ExitStack() as stack:
        for mod, name in ((hr, 'rms_norm'), (hr, 'rms_norm_bwd'),
                          (hx, 'softmax_xent_fwd'),
                          (hx, 'softmax_xent_bwd'),
                          (hf, 'flash_attention_fwd'),
                          (hf, 'flash_attention_bwd')):
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
        for name, cs in cases.items():
            for c in cs:
                print(f'kernel {name}: {json.dumps(c)} [{card}]', flush=True)
        del timer
        torch.cuda.empty_cache()

        # 4-5. serving, launch counts, leaks, logits
        serve_launches = serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()

        # 6. a training step's gradients through the kernels vs plain
        grads_phase(torch, np, card)

        # 7. training at the JAX bench's configuration
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
                 'paged_attention.py:140')):
            cs = cases[name]
            head = cs[0]       # the main path's shape and dtype
            records.append({
                'name': name, 'route': 'cuda',
                'source': f'paddle_tpu_torch/csrc/{src}',
                'replaces': f'paddle_tpu/ops/pallas/{rep}',
                'launches': serve_launches[name] + train_launches[name],
                'launches_by_path': {'serving': serve_launches[name],
                                     'train': train_launches[name]},
                'max_abs_err': max(c['max_abs_err'] for c in cs),
                'ms': head['ms'], 'plain_ms': head['plain_ms'],
                'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
                'library_ms': head['library_ms'], 'shape': head['shape'],
                'cases': cs})
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
