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
              card, in bf16 at the shapes the serving path gives it,
              with a stated tolerance, and timed with CUDA events
              (kernel, plain version, and the one PyTorch call that
              computes the same function, where there is one) against
              its bound, the least time the card needs for the bytes;
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
              printed with each kernel alone and a kernel-free control.

The last three lines are the card's name and power limit as nvidia-smi
gives them, a JSON object with one record per kernel, and
{"ok": true, "device": {...}}. With no CUDA card, or run without the
paddle_tpu_torch package beside it, the script fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


def check_rms_norm(torch, timer, R, N):
    from paddle_tpu_torch.ops.hopper import rms_norm as k

    g = torch.Generator(device='cuda').manual_seed(R)
    x = torch.randn(R, N, device='cuda', generator=g).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(N, device='cuda', generator=g)
    eps = 1e-5
    out, r = k.rms_norm(x, w, eps, return_r=True)
    ref, ref_r = k.rms_norm_plain(x, w, eps, return_r=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    # one bf16 rounding step is 2^-8 relative; allow 2^-7
    tol = 2.0 ** -7 * ref.float().abs().clamp_min(1.0)
    if not bool((err <= tol).all()):
        raise AssertionError(f'rms_norm ({R}, {N}): max |kernel - plain| '
                             f'{err.max().item()} exceeds 2^-7 * max(1, |y|)')
    r_err = ((r - ref_r).abs() / ref_r.abs()).max().item()
    if r_err > 1e-5:
        raise AssertionError(f'rms_norm ({R}, {N}): r rel err {r_err}')
    w_lib = w.to(x.dtype)        # the fused library path wants x's dtype
    nbytes = R * N * 2 * 2 + N * 4
    b, by = bound_ms(nbytes, 4 * R * N, F32_FLOPS)
    return {
        'shape': f'x ({R}, {N}) bf16, w ({N},) f32',
        'max_abs_err': err.max().item(),
        'tolerance': '|kernel - plain| <= 2^-7 * max(1, |plain|)',
        'ms': timer(lambda: k.rms_norm(x, w, eps)),
        'plain_ms': timer(lambda: k.rms_norm_plain(x, w, eps)),
        'library_ms': timer(lambda: torch.nn.functional.rms_norm(
            x, (N,), w_lib, eps)),
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
    want = {'paged_decode_attention': L * n_dec,
            'rms_norm': (2 * L + 1) * (n_dec + n_pre)}
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
        timer = Timer(torch)
        rms_cases = [check_rms_norm(torch, timer, 4, 4096),
                     check_rms_norm(torch, timer, 2048, 4096)]
        paged_cases = [check_paged(torch, timer, 32, 32),
                       check_paged(torch, timer, 32, 8)]
        for c in rms_cases + paged_cases:
            print(f'kernel: {json.dumps(c)} [{card}]', flush=True)
        del timer

        # 4-5. serving, launch counts, leaks, logits
        launches = serve_phase(torch, np, card)

        records = []
        for name, src, rep, cases in (
                ('rms_norm', 'paddle_tpu_torch/csrc/rms_norm.cu',
                 'paddle_tpu/ops/pallas/rms_norm.py:53', rms_cases),
                ('paged_decode_attention',
                 'paddle_tpu_torch/csrc/paged_attention.cu',
                 'paddle_tpu/ops/pallas/paged_attention.py:140',
                 paged_cases)):
            head = cases[0]        # the decode-step shape
            records.append({
                'name': name, 'route': 'cuda', 'source': src,
                'replaces': rep, 'launches': launches[name],
                'max_abs_err': max(c['max_abs_err'] for c in cases),
                'ms': head['ms'], 'plain_ms': head['plain_ms'],
                'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
                'library_ms': head['library_ms'], 'shape': head['shape'],
                'cases': cases})
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
