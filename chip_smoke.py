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
              give it (bf16, and float32 where a path runs it; the window
              and segment modes of flash attention as kernels of their
              own, K5w / K6w at S = 4096 with a window of 1024, K6s over
              a packed 4096-token stream; the shapes built after fault
              E2's repair: K7, K8, K8q, K9 at GQA groups 3, 5, 6, 7 with
              head sizes 64, 80, 96, 128, K5 / K6 at head sizes 80, 96,
              256; K10f8, fp8 weights, at Llama-7B's and Qwen2-7B's
              projections; K8 / K8q at serving's 16-position and
              block_multihead_attention's 64-position pages and over
              float32 pages, each K7 / K8 / K9 row with its one CUDA
              kernel a call, registers and split (no decode-template
              kernel may spill); K1 off its row kernel too (a width
              that is not a multiple of 8, one row); K10 / K11 /
              K10f8 at M = 64 and 256, with
              the path each row took, every bf16 row past the skinny
              path on the tensor cores, and the two paths timed
              against each other at M = 8, 16, 32, 64; every flash row
              with the route it took, bf16 up to head size 128 on the
              tensor cores, float32 and D = 256 on the CUDA cores, and
              each output's error beside SDPA's against the same plain
              version), with a
              stated tolerance, and timed with CUDA events (kernel,
              plain version, and the one PyTorch call that computes the
              same function, where there is one) against its bound, the
              least time the card needs for the bytes or the operations;
  4. serving  a ServingEngine over a Llama-7B-width model (all 32
              layers, bf16 weights drawn from a seeded generator)
              answers 8 requests, admitted while other rows decode, its
              decode windows replayed as CUDA graphs; the kernels'
              launch counts over that run must match the engine's model
              calls, and no page may leak; then one decode window traced
              with torch.profiler (device time by kernel, and the share
              of the window the device was busy);
  5. logits   one served request's decode-step logits through the
              kernels against the plain versions on the same tokens:
              bounded in float32 (the served weights cast up); in bf16
              printed with each kernel alone and a kernel-free control;
              then int8 serving: the same model, settings and burst
              through ServingEngine(kv_cache_dtype='int8') (exact launch
              counts of K8q and K1, no leaked page, tokens equal to the
              bf16 engine printed), and at Llama-7B width with 2 layers
              in float32 the int8 streams through the kernels equal to
              the plain versions', and a preempting pool's equal to the
              uninterrupted engine's;
  6. decode   the JAX bench's decode section at Llama-7B width (all 32
              layers, bf16): greedy single-token forwards over 2048-
              position contiguous caches at batch 1 and 8, with an int8
              KV cache, and with int8 and int4 weights, each a replay of
              generate's captured decode step (tokens/s, ms per
              forward, exact launch counts of K1, K7, K10, K11; one
              forward traced at b8 bf16 and at b1 int8 weights), a
              2048-token prefill (generate with max_new_tokens=1, one
              warm and 3 timed calls) with bf16, int8 and int4 weights
              (ms per call, K10 / K11 launches 7L + 1 per call, all on
              the tensor cores, the first token equal to the plain
              versions'), then
              DecodeEngine end to end on a 13-token prompt, then the
              kernels against the plain versions in float32 (7B width,
              2 layers): logits of 16 decode steps in five modes (the
              steps run directly, their eager reference, so that every
              forward is seen; the captured steps' tokens equal to
              theirs), and DecodeEngine token-equal to generate;
  7. fused    Paddle's fused-inference ops at Llama-7B widths:
              fused_multi_transformer (32 layers, RMSNorm, bf16)
              prefilling 8 x 512 tokens, then 64 decode steps over
              2048-position head-major caches (ms per step, rows x
              steps / s, peak memory, exact launches of K5, K9 and K1,
              one step traced); FusedMultiTransformer (2 layers,
              float32) through the kernels against the plain versions;
              block_multihead_attention's varlen prefill (K5s) and 32
              paged decode steps (K8, or K8q with static int8 scales),
              bf16 and float32, float32 against the plain versions;
  8. grads    one training step's loss and gradients (Llama-7B width, 2
              layers, 1 x 2048 tokens) through the kernels against the
              plain versions: bounded in float32, printed in bf16;
  9. train    TrainEngine + AdamW at the JAX bench's training
              configuration (Llama-7B width, 4 layers, bf16, 6 x 2048
              tokens): 2 warm-up and 5 timed steps on one repeated
              batch (tokens/s, ms per step, peak memory, per-step
              losses that must fall), exact launch counts per step
              (every flash launch on the tensor cores), and one step
              traced with torch.profiler;
 10. swa      sliding-window and packed training at Mistral-7B-v0.1's
              published widths (window 4096, 32 heads, 8 kv heads,
              intermediate 14336): (a) TrainEngine + AdamW, 4 layers,
              bf16, 1 x 8192 tokens, as phase 9 (exact K5w / K6w
              launches, a falling loss, one step traced); (b) float32
              gradients, 2 layers, 1 x 1024 tokens, window 256 on layer
              1 only, kernels against plain versions; (c) float32 and
              bf16 gradients of flash_attn_unpadded over a packed
              4096-token stream (K5s, K6s) against the plain versions;
              (d) greedy decode: 2 layers float32 (window 512, 640-token
              prompt) token-equal through kernels and plain versions,
              then 4 layers bf16 over a 4608-token prompt (ms per decode
              step, K7 L per step over a window starting past 0);
 11. qwen2    a model at Qwen2-7B's published widths (its config.json
              typed in, through the port's hf_qwen2_config: 28 layers,
              28 heads over 4 kv heads, qkv biases, vocab 152064; bf16
              weights from a seeded generator): (a) phase 4's burst
              through ServingEngine over bf16 pools and (b) int8 pools
              (exact K1 / K8 / K8q launches, no leaked page); (c) the
              JAX bench's decode at b1 and b8 over 2048-position
              caches, bf16 and int8 KV (exact K1 / K7 launches), then
              DecodeEngine; fp8 weights of one layer through
              nn.quant.weight_only_linear (K10f8); (d) at 2 layers in
              float32, decode logits through the kernels against the
              plain versions and streams of generate, DecodeEngine and
              ServingEngine (both pool types) equal to theirs;
 12. prefix   per-request sampling, prefix caching and chunked prefill
              in ServingEngine at Llama-7B width (32 layers, bf16,
              phase 4's engine settings): (a) 8 requests sharing a
              512-token system prompt with prefix_cache on and off
              (tok/s, TTFT, hits, prefill tokens computed); (b) two
              1536-token prompts arriving while two short streams
              decode, prefill_chunk=256 against the monolithic engine
              (the short streams' inter-token latency); (c) four
              sampled rows beside four greedy rows (sampled streams
              equal across two runs and two batch orders, greedy rows
              equal to a greedy-only run); (d) int8 pages with both
              features; exact K1 / K8 / K8q launches and no held page
              after each run, the bf16 logits gap of a hit and of a
              chunked prefill against a monolithic one (bounded); at 2
              layers in float32, both features' streams equal to the
              monolithic engine's over float32 and int8 pages, and a
              one-token step at per-row offsets over a contiguous cache
              through K7 against the plain versions;
 13. spec     speculative decoding at Llama-7B width (32 layers, bf16),
              k = 4: (a) DecodeEngine.generate_speculative at batch 1
              (512-token prompt, 64 new tokens) with the model's int8
              weight-only copy and with a 2-layer draft (its first two
              layers under its embedding, norm and head) against
              model.generate in the same call (tok/s, accept rate,
              target forwards per token, first divergence), and the
              bf16 gap of a verify forward against one-token decode
              forwards (bounded); (b)
              DecodeEngine.generate_speculative at batch 8 (per-row
              rates); (c) ServingEngine(draft=int8 copy) over phase 4's
              burst on bf16 and int8 pages against the non-speculative
              engine (tok/s, TTFT and ITL percentiles), and four
              sampled rows beside four greedy ones (equal across two
              runs and two batch orders); exact K1 / K7 / K8 / K8q /
              K10 launches and no held page after each run; (d) at 2
              layers in float32, streams of generate_speculative,
              DecodeEngine and ServingEngine (float32 and int8 pages,
              prefix cache and chunked prefill) equal to the
              non-speculative ones, through the kernels and the plain
              versions, and a self-draft accepting every proposal. Every
              speculative window replays its CUDA graph (warmed before
              the timed runs: capture seconds and bytes per geometry).
 14. moe      the MoE language model (MoEForCausalLM), run right after
              phase 3 so that its trace is the process's first profiler
              session: (a) MoEConfig() at the JAX package's defaults,
              full width and depth (24 layers, 64 routed experts top-6
              and 2 shared, 14.2 B parameters, 28.5 GB of bf16 weights
              seeded on the card): generate at b1 and b8 over 512-token
              prompts, 32 new tokens, bf16 and int8 KV caches, then
              DecodeEngine at b8 (tok/s, ms per prefill and per decode
              forward, exact launches of K1 2L + 1, X1 3L and K7 L,
              every prefill launch of X1 on the tensor cores, the
              distinct experts a decode step reads and its byte bound,
              one b8 decode forward and one b8 512-token prefill forward
              traced); (b) Mixtral-8x7B's published widths (its
              config.json typed in, through the port's
              hf_mixtral_config) at 4 of its 32 layers: generate at b1
              and b8 (one b8 prefill forward traced), and a bf16 cached
              prefill's logits against the uncached forward where the
              routing agrees (bounded);
              (c) float32 at (a)'s widths, 2 layers: decode logits
              through the kernels against the plain versions (b1 and a
              left-padded b3), and the model as its own draft in
              generate_speculative and DecodeEngine accepting every
              proposal; (d) X1, the grouped expert product, against its
              plain version in phase 3 at (a)'s and (b)'s decode and
              prefill shapes, bf16 and float32, and at their b8
              512-token prefills in bf16 (every bf16 prefill row on the
              tensor cores and timed on the CUDA-core tiles too), then
              bf16 on the skinny path and the tensor cores at R = 0.5E
              .. 16E rows (the crossover that sets the skinny bound).
 15. graphs   the compiled decode window and decode step: (a) phase 4's
              engine at Llama-7B width over bf16 and int8 pools, warmed
              (capture seconds and bytes reserved per geometry), 4 rows
              (2 sampled) decoding: every window variant (greedy,
              sampled, with a speculative engine's carried token)
              replayed against a direct _window call on cloned state,
              tokens, last_logits and pools bit-equal, ms per window of
              each; (b) generate b1 / b8 at that width and (c)
              MoEConfig() b8, greedy and sampled: the replayed step's
              tokens equal to the direct steps', ms per decode forward
              of each; (d) the speculative windows at that width with a
              2-layer draft: phase 4's engine over bf16 and int8 pools,
              greedy and sampled, replayed against a direct _spec_window
              call on cloned state (candidates, commit counts, next
              tokens, carried logits, both models' pools past the
              scratch page bit-equal),
              and generate_speculative b1 / b8 and the sampled b1 (the
              same seed) against their windows run directly, ms per
              window of each, capture seconds and bytes; (e) in a fresh
              process (`--graphs-profile`, whose first profiler
              sessions they are), the device-busy share of one direct
              and one replayed window, speculative window, generate b8
              step and MoE b8 step, each replay's traced launches equal
              to its capture's counts.
 16. moe train MoE training, X1's backward on its dx and dW kernels:
              (a) one MoELayer(dispatch_mode='ragged') at MoEConfig()'s
              widths in float32 over 2 x 2048 tokens, the output and
              every parameter's gradient and dx through the kernels
              (exactly 3 X1, 3 dx and 3 dW launches) against the plain
              versions (1e-5 / 1e-4 relative L2); (b) TrainEngine +
              AdamW(1e-4, weight decay 0.01) over MoEConfig() cut to 4
              layers, dispatch 'ragged', bf16, 4 x 2048 tokens on one
              repeated batch as phase 9 runs it (falling losses,
              tokens/s, ms per step, peak memory, exact launches a step:
              K1 / K2 2L + 1, K5 L, K6 2L, X1 3L, dx 3L, dW 3L, every X1
              launch on the tensor cores; one step traced); (c) in phase
              3, dx and dW against their plain versions at (b)'s step,
              the b8 / b1 512-token prefills and Mixtral-8x7B's 4096
              tokens, bf16 and float32, and with half the experts empty,
              each timed beside its bound and torch._grouped_mm.

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


def one_kernel(torch, fn, what):
    """The CUDA kernels one call of fn launches, counted in a CUDA graph
    of the call (`_build.kernels_per_call`): exactly one (the last split
    combines the splits)."""
    from paddle_tpu_torch.ops import _build

    n = _build.kernels_per_call(fn, torch.device('cuda'))
    if n != 1:
        raise AssertionError(f'{what}: one call launched {n} CUDA kernels, '
                             f'not one')
    return n


def geometry(torch, fn, what, pl, B, units, S):
    """One K7 / K8 / K9 call's CUDA kernels (one), and its
    instantiation's registers, spilled bytes (none allowed), blocks per
    SM and context split over S positions (a paged call's table width)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.hopper import decode_attention as k

    n = one_kernel(torch, fn, what)
    idx = torch.cuda.current_device()
    nsplit, chunk = k.splits(B, units * pl.nchunk, S, pl.tile,
                             pl.blocks_per_sm, _build.sm_count(idx),
                             pl.stages)
    if pl.local_bytes:
        raise AssertionError(f'{what}: the kernel spills {pl.local_bytes} '
                             f'bytes')
    return {'kernels_per_call': n, 'regs': pl.regs,
            'spill_bytes': pl.local_bytes,
            'blocks_per_sm': pl.blocks_per_sm, 'heads_per_block': pl.heads,
            'tile': pl.tile, 'nsplit': nsplit, 'chunk': chunk}


def decode_geometry(torch, fn, q, B, S, Hq, Hkv, D, quant):
    """geometry() of a K7 / K9 call over an S-position cache."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.hopper import decode_attention as k

    pl = k.plan(q.device.index, _build.dtype_code(q, 'decode_attention'),
                quant, Hq, Hkv, D)
    return geometry(torch, fn, f'decode attention B={B} S={S} Hq={Hq} '
                    f'Hkv={Hkv} D={D}', pl, B, Hkv, S)


def paged_geometry(torch, fn, q, B, MAXB, BS, Hkv, D, mode):
    """geometry() of a K8 / K8q call: split over the table width
    MAXB x BS (never the counts)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.hopper import paged_attention as k

    Hq = q.shape[2]
    pl = k.plan(q.device.index, _build.dtype_code(q, 'paged'), mode, Hq,
                Hkv, D)
    return geometry(torch, fn, f'paged attention B={B} MAXB={MAXB} BS={BS} '
                    f'Hq={Hq} Hkv={Hkv} D={D} scale mode {mode}', pl, B, Hkv,
                    MAXB * BS)


def spilling_decode_kernels(log):
    """The decode-template instantiations (K7, K8, K8q, K9) that ptxas
    reports spilling in the build log, by mangled name."""
    spills, cur = [], None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            cur = line.split("'")[1]
        elif cur and 'spill stores' in line:
            nums = [int(w) for w in line.replace(',', ' ').split()
                    if w.isdigit()]
            if 'decode_kernel' in cur and any(nums[1:]):
                spills.append(cur)
    return spills


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


def check_paged(torch, timer, Hq, Hkv, D=128, BS=16, dtype=None):
    """llama_7b decode shapes: 4 rows of ragged contexts up to 1024
    positions over shuffled pages; one row's count runs past its table
    (clamped), one table holds a -1 entry, one row has count 0. bf16
    pages, or `dtype`'s."""
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
    dtype = dtype or torch.bfloat16
    q = torch.randn(B, 1, Hq, D, device='cuda', generator=g).to(dtype)
    kc = torch.randn(NB, Hkv, BS, D, device='cuda', generator=g).to(dtype)
    vc = torch.randn(NB, Hkv, BS, D, device='cuda', generator=g).to(dtype)
    cl = torch.tensor(lens, dtype=torch.int32, device='cuda')
    out = k.paged_decode_attention(q, kc, vc, tbl, cl)
    ref = k.paged_decode_attention_plain(q, kc, vc, tbl, cl)
    torch.cuda.synchronize()
    geo = paged_geometry(torch, lambda: k.paged_decode_attention(
        q, kc, vc, tbl, cl), q, B, MAXB, BS, Hkv, D, k.NO_SCALE)
    err = (out.float() - ref.float()).abs()
    tol = 1e-2 + 1e-2 * ref.float().abs()
    if dtype == torch.float32:
        tol = 1e-4 + 1e-4 * ref.float().abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f'paged attention Hq={Hq} Hkv={Hkv} D={D}: max '
                             f'|kernel - plain| {err.max().item()}')
    if out[2].abs().max().item() != 0.0:
        raise AssertionError('paged attention: a count-0 row must be 0')
    ctx = sum(min(n, MAXB * BS) for n in lens)
    item = q.element_size()
    nbytes = (ctx * Hkv * D * 2 * item + 2 * B * Hq * D * item
              + B * MAXB * 4 + B * 4)
    b, by = bound_ms(nbytes, 4 * ctx * Hq * D,
                     BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    tight = '1e-4' if dtype == torch.float32 else '1e-2'
    return {
        **geo,
        'shape': (f'B={B} Hq={Hq} Hkv={Hkv} D={D} BS={BS} '
                  f'lens={lens} {dname(torch, dtype)}'),
        'max_abs_err': err.max().item(),
        'tolerance': f'|kernel - plain| <= {tight} + {tight} * |plain|',
        'ms': timer(lambda: k.paged_decode_attention(q, kc, vc, tbl, cl)),
        'plain_ms': timer(lambda: k.paged_decode_attention_plain(
            q, kc, vc, tbl, cl)),
        'library_ms': None,
        'bound_ms': b, 'bound_by': by,
    }


def check_paged_int8(torch, timer, Hq, Hkv, rowscale, D=128, BS=16,
                     dtype=None):
    """K8q at check_paged's shapes (4 rows of ragged contexts up to 1024
    positions, one count past its table, a -1 entry, a count-0 row) over
    int8 pages: per-row (NB, Hkv, BS) scales as the int8 ServingEngine
    writes them, or per-(head, dim) (Hkv, D) scales as
    block_multihead_attention's static cache scales; bf16 queries, or
    `dtype`'s."""
    from paddle_tpu_torch.ops.hopper import paged_attention as k

    g = torch.Generator(device='cuda').manual_seed(Hkv + 7 * rowscale)
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
    dtype = dtype or torch.bfloat16
    q = torch.randn(B, 1, Hq, D, device='cuda', generator=g).to(dtype)
    kc, vc = (torch.randint(-127, 128, (NB, Hkv, BS, D), device='cuda',
                            generator=g, dtype=torch.int8)
              for _ in range(2))
    sshape = (NB, Hkv, BS) if rowscale else (Hkv, D)
    ks, vs = (0.002 + 0.028 * torch.rand(sshape, device='cuda', generator=g)
              for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device='cuda')
    out = k.paged_decode_attention(q, kc, vc, tbl, cl, None, ks, vs)
    ref = k.paged_decode_attention_plain(q, kc, vc, tbl, cl, None, ks, vs)
    torch.cuda.synchronize()
    geo = paged_geometry(torch, lambda: k.paged_decode_attention(
        q, kc, vc, tbl, cl, None, ks, vs), q, B, MAXB, BS, Hkv, D,
        k.ROW_SCALE if rowscale else k.HEAD_DIM_SCALE)
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = (f'paged attention int8 Hq={Hq} Hkv={Hkv} D={D} '
            f'{"row" if rowscale else "head-dim"} scales')
    err = within(out, ref, tol, what)
    if out[2].abs().max().item() != 0.0:
        raise AssertionError(f'{what}: a count-0 row must be 0')
    ctx = sum(min(n, MAXB * BS) for n in lens)
    scale_bytes = (2 * ctx * Hkv * 4 if rowscale else 2 * Hkv * D * 4)
    nbytes = (2 * ctx * Hkv * D + scale_bytes
              + 2 * B * Hq * D * q.element_size() + B * MAXB * 4 + B * 4)
    b, by = bound_ms(nbytes, 4 * ctx * Hq * D,
                     BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    return {
        **geo,
        'shape': (f'B={B} Hq={Hq} Hkv={Hkv} D={D} BS={BS} lens={lens} '
                  f'int8 pages, {"per-row" if rowscale else "(Hkv, D)"} '
                  f'f32 scales, {dname(torch, dtype)} q'),
        'max_abs_err': err, 'tolerance': tol_text(tol),
        'ms': timer(lambda: k.paged_decode_attention(q, kc, vc, tbl, cl,
                                                     None, ks, vs)),
        'plain_ms': timer(lambda: k.paged_decode_attention_plain(
            q, kc, vc, tbl, cl, None, ks, vs)),
        'library_ms': None,
        'library': 'none: PyTorch has no paged-attention call',
        'bound_ms': b, 'bound_by': by,
    }


def check_headmajor(torch, timer, B, Hq, Hkv, mode, S=2048, D=128):
    """K9 at the fused decode step's shapes: (B, Hkv, 2048, 128) caches.
    B = 1 attends 2000 positions; B = 8 ragged counts averaging ~600 (one
    past S, clipped; one 0). Modes: bf16, float32, and int8 caches with
    (Hkv, D) scales under a bf16 query."""
    from paddle_tpu_torch.ops.hopper import headmajor_attention as k

    F = torch.nn.functional
    g = torch.Generator(device='cuda').manual_seed(B * 10 + Hkv + 3)
    dtype = torch.float32 if mode == 'float32' else torch.bfloat16
    q = torch.randn(B, 1, Hq, D, device='cuda', generator=g).to(dtype)
    ks = vs = None
    if mode == 'int8':
        kc, vc = (torch.randint(-127, 128, (B, Hkv, S, D), device='cuda',
                                generator=g, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (0.005 + 0.015 * torch.rand(Hkv, D, device='cuda',
                                             generator=g)
                  for _ in range(2))
    else:
        kc, vc = (torch.randn(B, Hkv, S, D, device='cuda',
                              generator=g).to(dtype) for _ in range(2))
    counts = [2000] if B == 1 else [S + 52, 600, 0, 1000, 37, 700, 300, 63]
    cl = torch.tensor(counts, dtype=torch.int32, device='cuda')
    out = k.decode_attention_headmajor(q, kc, vc, cl, None, ks, vs)
    ref = k.decode_attention_headmajor_plain(q, kc, vc, cl, None, ks, vs)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = f'head-major decode attention B={B} Hq={Hq} Hkv={Hkv} {mode}'
    err = within(out, ref, tol, what)
    for b, c in enumerate(counts):
        if c == 0 and out[b].abs().max().item() != 0.0:
            raise AssertionError(f'{what}: row {b} has count 0 and must '
                                 f'be 0')
    pos = sum(min(max(c, 0), S) for c in counts)
    nbytes = (2 * pos * Hkv * D * kc.element_size()
              + 2 * B * Hq * D * q.element_size()
              + (2 * Hkv * D * 4 if ks is not None else 0) + B * 4)
    b_, by = bound_ms(nbytes, 4 * pos * Hq * D,
                      BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    # the yardstick: SDPA on the same (B, H, S, D) tensors (head-major is
    # its own layout) with the counts as a boolean mask (an int8 cache
    # dequantized to bf16 first: twice the cache bytes)
    kl, vl_ = kc, vc
    if ks is not None:
        kl = (kc.float() * ks[None, :, None]).to(dtype)
        vl_ = (vc.float() * vs[None, :, None]).to(dtype)
    mask = (torch.arange(S, device='cuda')[None] < cl[:, None])[
        :, None, None, :]
    qt = q.transpose(1, 2)
    lib = F.scaled_dot_product_attention
    geo = decode_geometry(
        torch, lambda: k.decode_attention_headmajor(q, kc, vc, cl, None, ks,
                                                    vs),
        q, B, S, Hq, Hkv, D, ks is not None)
    return {
        'shape': (f'B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {mode} '
                  f'counts={counts}'),
        'max_abs_err': err, 'tolerance': tol_text(tol), **geo,
        'ms': timer(lambda: k.decode_attention_headmajor(q, kc, vc, cl,
                                                         None, ks, vs)),
        'plain_ms': timer(lambda: k.decode_attention_headmajor_plain(
            q, kc, vc, cl, None, ks, vs), iters=10),
        'library_ms': timer(lambda: lib(qt, kl, vl_, attn_mask=mask,
                                        enable_gqa=Hq != Hkv)),
        'library': ('F.scaled_dot_product_attention with the counts as a '
                    'boolean mask' + (' over the cache dequantized to bf16'
                                      if ks is not None else '')),
        'bound_ms': b_, 'bound_by': by,
    }


def check_flash_seg(torch, timer, dtype, H=32, D=128):
    """K5s at block_multihead_attention's varlen prefill: a packed stream
    of 4 prompts (2012 tokens), 32 heads of 128, causal within each
    segment, in the model's (B, S, H, D) layout; 16 queries carry a
    segment id that no key has (they must return 0)."""
    from paddle_tpu_torch.ops.hopper import flash_attention as k

    F = torch.nn.functional
    g = torch.Generator(device='cuda').manual_seed(2012)
    lens = [700, 300, 512, 500]
    T = sum(lens)
    seg = torch.repeat_interleave(
        torch.arange(len(lens), device='cuda', dtype=torch.int32),
        torch.tensor(lens, device='cuda'))[None]
    qseg = seg.clone()
    qseg[0, 1000:1016] = 99

    def bshd():
        return torch.randn(1, T, H, D, device='cuda', generator=g) \
            .to(dtype).transpose(1, 2)

    q, kk, v = bshd(), bshd(), bshd()
    scale = 1.0 / math.sqrt(D)
    (out, lse), route = flash_call(torch, k, dtype, D, lambda: (
        k.flash_attention_fwd(q, kk, v, True, scale, qseg, seg)))
    ref, ref_lse = k.flash_attention_fwd_plain(q, kk, v, True, scale, qseg,
                                               seg)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = f'flash attention with segment ids T={T} H={H} {dtype}'
    err = within(out, ref, tol, what)
    if out[:, :, 1000:1016].abs().max().item() != 0.0:
        raise AssertionError(f'{what}: queries with no key in their '
                             f'segment must be 0')
    # the causal pairs inside each segment, less those of the 16 queries
    # that see nothing (positions 0..15 of segment 2: 1 + 2 + ... + 16)
    pairs = H * (sum(n * (n + 1) // 2 for n in lens) - sum(range(1, 17)))
    item = q.element_size()
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    b_, by = bound_ms(4 * T * H * D * item + 2 * T * 4 + H * T * 4,
                      4 * D * pairs, peak)
    qpos = torch.arange(T, device='cuda')
    mask = ((qseg[0][:, None] == seg[0][None, :])
            & (qpos[:, None] >= qpos[None, :]))[None, None]
    lib = F.scaled_dot_product_attention
    errs = against_library(torch, what, route, {'out': (
        out, lib(q, kk, v, attn_mask=mask, scale=scale), ref)})
    del out, lse, ref
    return {
        'shape': (f'B=1 T={T} (segments {lens}) H={H} D={D} causal '
                  f'{dname(torch, dtype)}'),
        'path': route, 'max_abs_err': err, 'tolerance': tol_text(tol),
        'errors': errs,
        'ms': timer(lambda: k.flash_attention_fwd(q, kk, v, True, scale,
                                                  qseg, seg)),
        'plain_ms': timer(lambda: k.flash_attention_fwd_plain(
            q, kk, v, True, scale, qseg, seg), iters=5),
        'library_ms': timer(lambda: lib(q, kk, v, attn_mask=mask,
                                        scale=scale)),
        'library': ('F.scaled_dot_product_attention with the block-'
                    'diagonal causal mask as a bool tensor'),
        'bound_ms': b_, 'bound_by': by,
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
    geo = decode_geometry(
        torch, lambda: k.decode_attention(q, kc, vc, vl, None, ks, vs, st),
        q, B, S, Hq, Hkv, D, ks is not None)
    return {
        'shape': (f'B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {mode} '
                  f'valid_len={vl_list} start={st_list}'),
        'max_abs_err': err, 'tolerance': tol_text(tol), **geo,
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


FP8 = {'e4m3': 'float8_e4m3fn', 'e5m2': 'float8_e5m2'}


def check_quant_matmul(torch, timer, M, K, N, dtype, bits):
    """K10 (bits 8), K11 (bits 4) or K10f8 (bits 'e4m3' or 'e5m2') at a
    Llama-7B or Qwen2-7B projection: M = 1 and 8 decode rows, 16 (the
    bucketed prefill), 64 and 256 (short prompts), 2048 (a long prompt),
    with the path the wrapper took (a bf16 row past the skinny path on an
    aligned shape must take the tensor cores). The yardstick is
    torch.matmul against the weight dequantized to x's dtype: the same
    product reading 2x (K10, K10f8) or 4x (K11) the weight bytes in
    bf16; where the installed torch has a CUDA torch._weight_int8pack_mm
    (K10's function for bf16 x), it is timed too."""
    from paddle_tpu_torch.ops.hopper import quant_matmul as k

    fp8 = bits in FP8
    g = torch.Generator(device='cuda').manual_seed(
        M + K + N + (len(bits) if fp8 else bits))
    w = 0.02 * torch.randn(K, N, device='cuda', generator=g)
    if fp8:
        codes, scale = k.quantize_weight_fp8(w, getattr(torch, FP8[bits]))
    else:
        quant = k.quantize_weight_int4 if bits == 4 else k.quantize_weight
        codes, scale = quant(w)
    del w
    x = torch.randn(M, K, device='cuda', generator=g).to(dtype)
    kern = {4: k.quant_matmul_int4, 8: k.quant_matmul}.get(
        bits, k.quant_matmul_fp8)
    plain = {4: k.quant_matmul_int4_plain, 8: k.quant_matmul_plain}.get(
        bits, k.quant_matmul_fp8_plain)
    before = dict(k.PATH_LAUNCHES)
    out = kern(x, codes, scale)
    took = [p for p, n in k.PATH_LAUNCHES.items() if n != before[p]]
    ref = plain(x, codes, scale)
    torch.cuda.synchronize()
    kind = bits if fp8 else f'int{bits}'
    what = f'quant_matmul {kind} M={M} K={K} N={N} {dtype}'
    # bf16 rows past the skinny path on aligned shapes take the tensor
    # cores
    if (M > k.SKINNY_M and dtype == torch.bfloat16 and K % 8 == 0
            and N % 16 == 0 and took != ['tensor_core']):
        raise AssertionError(f'{what} took path {took}, not tensor_core')
    # float32: sums of K products in another order; bf16: one rounding
    # step of the output on top
    tol = {'float32': (1e-4, 1e-4), 'bfloat16': TENSOR_TOL['bfloat16']}[
        dname(torch, dtype)]
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
        'shape': f'x ({M}, {K}) {dname(torch, dtype)}, codes {kind} '
                 f'{tuple(codes.shape)}',
        'path': took[0], 'max_abs_err': err, 'tolerance': tol_text(tol),
        'ms': timer(lambda: kern(x, codes, scale), iters=iters),
        'plain_ms': timer(lambda: plain(x, codes, scale), iters=iters),
        'library_ms': timer(lambda: torch.matmul(x, deq), iters=iters),
        'library': (f'torch.matmul against the weight dequantized to '
                    f'{dname(torch, dtype)} (the same product at '
                    f'{(4 if bits == 4 else 2) * item // 2}x the weight '
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


def path_crossover(torch, timer, card):
    """K10 and K11 at M = 8, 16, 32, 64, bf16 x, Llama-7B's four
    projections, on the tensor-core path and on the path the wrapper
    would otherwise take (skinny at M <= 16, the CUDA cores past it),
    in one call: the evidence for where bf16 x's bound of the skinny
    path belongs (float32 x has no tensor-core path, so it stays
    skinny up to SKINNY_M). Each output is held against the plain
    version."""
    from paddle_tpu_torch.ops.hopper import quant_matmul as k

    for bits, quant, plain in ((8, k.quantize_weight, k.quant_matmul_plain),
                               (4, k.quantize_weight_int4,
                                k.quant_matmul_int4_plain)):
        for K, N in ((4096, 4096), (4096, 11008), (11008, 4096),
                     (4096, 32000)):
            g = torch.Generator(device='cuda').manual_seed(K + N + bits)
            codes, scale = quant(0.02 * torch.randn(K, N, device='cuda',
                                                    generator=g))
            for M in (8, 16, 32, 64):
                x = torch.randn(M, K, device='cuda', generator=g).to(
                    torch.bfloat16)
                ref = plain(x, codes, scale)
                other = 'skinny' if M <= k.SKINNY_M else 'cuda_core'
                ms = {}
                for p in (other, 'tensor_core'):
                    within(k.launch_path(p, x, codes, scale, bits), ref,
                           TENSOR_TOL['bfloat16'],
                           f'int{bits} M={M} {K}x{N} on {p}')
                    ms[p] = timer(lambda: k.launch_path(
                        p, x, codes, scale, bits), iters=20)
                print(f'kernel path crossover: int{bits} M={M} {K}x{N} bf16: '
                      f'{other} {ms[other]:.4f} ms, tensor_core '
                      f'{ms["tensor_core"]:.4f} ms [{card}]', flush=True)
            del codes, scale


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


def flash_call(torch, k, dtype, D, fn):
    """fn(), one flash kernel call, and the route its launches took: the
    one `path()` names for the dtype and head size, which for bf16 with
    D <= 128 is the tensor cores. Returns (result, route)."""
    want = k.path(dtype, D)
    if dtype == torch.bfloat16 and D <= k.TC_MAX_HEAD_DIM \
            and want != 'tensor_core':
        raise AssertionError(f'bf16 flash at D = {D} routed to {want}')
    before = dict(k.FLASH_PATH_LAUNCHES)
    out = fn()
    took = [p for p, n in k.FLASH_PATH_LAUNCHES.items() if n != before[p]]
    if took != [want]:
        raise AssertionError(f'flash call at {dname(torch, dtype)} D = {D} '
                             f'took route {took}, not {want}')
    return out, want


def rel_err(torch, got, ref):
    """(max |got - ref|, ||got - ref||_2 / ||ref||_2), in float32."""
    d = got.float() - ref.float()
    return (d.abs().max().item(),
            (d.norm() / ref.float().norm().clamp_min(1e-30)).item())


def against_library(torch, what, route, triples):
    """Each output's error against the plain version beside the library
    call's (SDPA's) on the same inputs, {name: (kernel, library, plain)}:
    recorded for every row and printed for the tensor-core rows, where
    each relative L2 error must also be within 1e-2 and within 2x the
    library's (P and dS are rounded to bf16 there, as in SDPA). Where the
    library returns NaN (rows whose mask hides every key) its value is
    taken as exact, which only makes the comparison stricter."""
    rec = {}
    for name, (got, lib, ref) in triples.items():
        kmax, krel = rel_err(torch, got, ref)
        lmax, lrel = rel_err(torch, torch.where(torch.isfinite(lib), lib,
                                                ref.to(lib.dtype)), ref)
        rec[name] = {'max_abs': kmax, 'rel_l2': krel, 'library_max_abs': lmax,
                     'library_rel_l2': lrel}
        if route == 'tensor_core' and not (krel <= 1e-2 and krel <= 2 * lrel):
            raise AssertionError(
                f'{what} {name}: relative L2 error {krel:.4g} against the '
                f'plain version exceeds 1e-2 or 2x the library\'s {lrel:.4g}')
    if route == 'tensor_core':
        print(f'{what} ({route}): |x - plain| max / relative L2, kernel '
              f'vs library: ' + '; '.join(
                  f'{n} {e["max_abs"]:.4g} / {e["rel_l2"]:.4g} vs '
                  f'{e["library_max_abs"]:.4g} / {e["library_rel_l2"]:.4g}'
                  for n, e in rec.items()), flush=True)
    return rec


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
    plain forward's out and lse, so each direction is checked alone.
    Each record names the route the kernels took (`path`) and each
    output's error against the plain version beside SDPA's (`errors`)."""
    from paddle_tpu_torch.ops.hopper import flash_attention as k

    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(H * 1000 + Hkv)

    def bshd(h):
        return torch.randn(B, S, h, D, device='cuda', generator=gen) \
            .to(dtype).transpose(1, 2)

    q, kk, v, do = bshd(H), bshd(Hkv), bshd(Hkv), bshd(H)
    scale = 1.0 / math.sqrt(D)
    (out, lse), route = flash_call(torch, k, dtype, D, lambda: (
        k.flash_attention_fwd(q, kk, v, True, scale)))
    ref_out, ref_lse = k.flash_attention_fwd_plain(q, kk, v, True, scale)
    grads, _ = flash_call(torch, k, dtype, D, lambda: k.flash_attention_bwd(
        q, kk, v, ref_out, ref_lse, do, True, scale))
    ref_grads = k.flash_attention_bwd_plain(q, kk, v, ref_out, ref_lse, do,
                                            True, scale)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = f'flash attention B={B} H={H} Hkv={Hkv} S={S} D={D} {dtype}'
    err_f = max(within(out, ref_out, tol, what + ' out'),
                within(lse, ref_lse, STAT_TOL, what + ' lse'))
    err_b = max(within(g, r, tol, f'{what} {n}') for n, g, r in
                zip(('dq', 'dk', 'dv'), grads, ref_grads))
    gqa = H != Hkv
    lib_in = [t.detach().requires_grad_() for t in (q, kk, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             scale=scale, enable_gqa=gqa)
    lib_grads = torch.autograd.grad(lib_out, lib_in, do, retain_graph=True)
    errs_f = against_library(torch, what + ' forward', route,
                             {'out': (out, lib_out, ref_out)})
    errs_b = against_library(torch, what + ' backward', route, {
        n: t for n, t in zip(('dq', 'dk', 'dv'),
                             zip(grads, lib_grads, ref_grads))})
    del out, lse, grads, ref_grads, lib_grads
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
    fwd = {
        'shape': shape, 'path': route, 'max_abs_err': err_f,
        'tolerance': f'out: {tol_text(tol)}; lse: {tol_text(STAT_TOL)}',
        'errors': errs_f,
        'ms': timer(lambda: k.flash_attention_fwd(q, kk, v, True, scale)),
        'plain_ms': timer(lambda: k.flash_attention_fwd_plain(
            q, kk, v, True, scale), iters=10),
        'library_ms': timer(lambda: F.scaled_dot_product_attention(
            q, kk, v, is_causal=True, scale=scale, enable_gqa=gqa)),
        'library': 'F.scaled_dot_product_attention',
        'bound_ms': b_f, 'bound_by': by_f,
    }
    bwd = {
        'shape': shape, 'path': route, 'max_abs_err': err_b,
        'tolerance': tol_text(tol), 'errors': errs_b,
        'ms': timer(lambda: k.flash_attention_bwd(
            q, kk, v, ref_out, ref_lse, do, True, scale)),
        'plain_ms': timer(lambda: k.flash_attention_bwd_plain(
            q, kk, v, ref_out, ref_lse, do, True, scale), iters=10),
        'library_ms': timer(lambda: torch.autograd.grad(
            lib_out, lib_in, do, retain_graph=True)),
        'library': 'backward of F.scaled_dot_product_attention',
        'bound_ms': b_b, 'bound_by': by_b,
    }
    del lib_out, lib_in
    return fwd, bwd


def band_pairs(S, W):
    """(query, key) pairs of one head inside a causal window of W over S
    positions: query i sees min(i + 1, W) keys."""
    return W * (W + 1) // 2 + (S - W) * W if S >= W else S * (S + 1) // 2


def check_flash_window(torch, timer, H, Hkv, dtype, S=4096, W=1024, D=128):
    """K5w and K6w, the window mode of flash attention, in the model's
    layout (B = 1): at S = 4096 with a window of 1024, three quarters of
    the queries reach the band's lower edge, so the tile skips on both
    sides run. The backward kernels are fed the plain forward's out and
    lse, so each direction is checked alone."""
    from paddle_tpu_torch.ops.hopper import flash_attention as k

    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(H * 100 + Hkv + W)

    def bshd(h):
        return torch.randn(1, S, h, D, device='cuda', generator=gen) \
            .to(dtype).transpose(1, 2)

    q, kk, v, do = bshd(H), bshd(Hkv), bshd(Hkv), bshd(H)
    scale = 1.0 / math.sqrt(D)
    (out, lse), route = flash_call(torch, k, dtype, D, lambda: (
        k.flash_attention_fwd(q, kk, v, True, scale, window=W)))
    ref_out, ref_lse = k.flash_attention_fwd_plain(q, kk, v, True, scale,
                                                   window=W)
    grads, _ = flash_call(torch, k, dtype, D, lambda: k.flash_attention_bwd(
        q, kk, v, ref_out, ref_lse, do, True, scale, window=W))
    ref_grads = k.flash_attention_bwd_plain(q, kk, v, ref_out, ref_lse, do,
                                            True, scale, window=W)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = (f'flash attention window {W} H={H} Hkv={Hkv} S={S} D={D} '
            f'{dtype}')
    err_f = max(within(out, ref_out, tol, what + ' out'),
                within(lse, ref_lse, STAT_TOL, what + ' lse'))
    err_b = max(within(g, r, tol, f'{what} {n}') for n, g, r in
                zip(('dq', 'dk', 'dv'), grads, ref_grads))
    item = q.element_size()
    pairs = H * band_pairs(S, W)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    q_bytes, kv_bytes = H * S * D * item, Hkv * S * D * item
    b_f, by_f = bound_ms(2 * q_bytes + 2 * kv_bytes + H * S * 4,
                         4 * D * pairs, peak)
    b_b, by_b = bound_ms(4 * q_bytes + 4 * kv_bytes + H * S * 4,
                         10 * D * pairs, peak)
    shape = (f'B=1 H={H} Hkv={Hkv} S={S} D={D} causal window {W} '
             f'{dname(torch, dtype)}')
    pos = torch.arange(S, device='cuda')
    back = pos[:, None] - pos[None, :]
    band = ((back >= 0) & (back < W))[None, None]
    gqa = H != Hkv
    lib_in = [t.detach().requires_grad_() for t in (q, kk, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=band,
                                             scale=scale, enable_gqa=gqa)
    lib_grads = torch.autograd.grad(lib_out, lib_in, do, retain_graph=True)
    errs_f = against_library(torch, what + ' forward', route,
                             {'out': (out, lib_out, ref_out)})
    errs_b = against_library(torch, what + ' backward', route, {
        n: t for n, t in zip(('dq', 'dk', 'dv'),
                             zip(grads, lib_grads, ref_grads))})
    del out, lse, grads, ref_grads, lib_grads
    gc.collect()
    torch.cuda.empty_cache()
    lib = ('F.scaled_dot_product_attention with the band as a bool mask')
    fwd = {
        'shape': shape, 'path': route, 'max_abs_err': err_f,
        'tolerance': f'out: {tol_text(tol)}; lse: {tol_text(STAT_TOL)}',
        'errors': errs_f,
        'ms': timer(lambda: k.flash_attention_fwd(q, kk, v, True, scale,
                                                  window=W)),
        'plain_ms': timer(lambda: k.flash_attention_fwd_plain(
            q, kk, v, True, scale, window=W), iters=5),
        'library_ms': timer(lambda: F.scaled_dot_product_attention(
            q, kk, v, attn_mask=band, scale=scale, enable_gqa=gqa)),
        'library': lib, 'bound_ms': b_f, 'bound_by': by_f,
    }
    bwd = {
        'shape': shape, 'path': route, 'max_abs_err': err_b,
        'tolerance': tol_text(tol), 'errors': errs_b,
        'ms': timer(lambda: k.flash_attention_bwd(
            q, kk, v, ref_out, ref_lse, do, True, scale, window=W)),
        'plain_ms': timer(lambda: k.flash_attention_bwd_plain(
            q, kk, v, ref_out, ref_lse, do, True, scale, window=W),
            iters=5),
        'library_ms': timer(lambda: torch.autograd.grad(
            lib_out, lib_in, do, retain_graph=True)),
        'library': 'backward of ' + lib, 'bound_ms': b_b, 'bound_by': by_b,
    }
    del lib_out, lib_in
    return fwd, bwd


def check_flash_seg_bwd(torch, timer, Hkv, dtype, H=32, D=128):
    """K6s over a packed T = 4096 stream of segments (1000, 1900, 96,
    1100), causal, in the model's layout; 16 queries carry an id no key
    has: their dq must be exactly 0, and k and v get no gradient from
    them (zeroing their dout leaves dk and dv bit-equal). The kernels
    are fed the plain forward's out and lse."""
    from paddle_tpu_torch.ops.hopper import flash_attention as k

    F = torch.nn.functional
    g = torch.Generator(device='cuda').manual_seed(4096 + Hkv)
    lens = [1000, 1900, 96, 1100]
    T = sum(lens)
    seg = torch.repeat_interleave(
        torch.arange(len(lens), device='cuda', dtype=torch.int32),
        torch.tensor(lens, device='cuda'))[None]
    qseg = seg.clone()
    qseg[0, 1000:1016] = 99

    def bshd(h):
        return torch.randn(1, T, h, D, device='cuda', generator=g) \
            .to(dtype).transpose(1, 2)

    q, kk, v, do = bshd(H), bshd(Hkv), bshd(Hkv), bshd(H)
    scale = 1.0 / math.sqrt(D)
    out, lse = k.flash_attention_fwd_plain(q, kk, v, True, scale, qseg, seg)
    grads, route = flash_call(torch, k, dtype, D, lambda: (
        k.flash_attention_bwd(q, kk, v, out, lse, do, True, scale, qseg,
                              seg)))
    ref = k.flash_attention_bwd_plain(q, kk, v, out, lse, do, True, scale,
                                      qseg, seg)
    do0 = do.clone()
    do0[:, :, 1000:1016] = 0
    again = k.flash_attention_bwd(q, kk, v, out, lse, do0, True, scale, qseg,
                                  seg)
    torch.cuda.synchronize()
    tol = TENSOR_TOL[dname(torch, dtype)]
    what = f'flash backward with segment ids T={T} H={H} Hkv={Hkv} {dtype}'
    err = max(within(gk, r, tol, f'{what} {n}') for n, gk, r in
              zip(('dq', 'dk', 'dv'), grads, ref))
    if grads[0][:, :, 1000:1016].abs().max().item() != 0.0:
        raise AssertionError(f'{what}: queries with no key in their '
                             f'segment must have dq = 0')
    if not all(torch.equal(a, b) for a, b in zip(grads[1:], again[1:])):
        raise AssertionError(f'{what}: queries with no key in their '
                             f'segment moved dk or dv')
    del again
    pairs = H * (sum(n * (n + 1) // 2 for n in lens) - sum(range(1, 17)))
    item = q.element_size()
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    b_, by = bound_ms(4 * H * T * D * item + 4 * Hkv * T * D * item
                      + 2 * T * 4 + H * T * 4, 10 * D * pairs, peak)
    qpos = torch.arange(T, device='cuda')
    mask = ((qseg[0][:, None] == seg[0][None, :])
            & (qpos[:, None] >= qpos[None, :]))[None, None]
    gqa = H != Hkv
    lib_in = [t.detach().requires_grad_() for t in (q, kk, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                             scale=scale, enable_gqa=gqa)
    lib_grads = torch.autograd.grad(lib_out, lib_in, do, retain_graph=True)
    errs = against_library(torch, what, route, {
        n: t for n, t in zip(('dq', 'dk', 'dv'), zip(grads, lib_grads, ref))})
    del grads, ref, lib_grads
    rec = {
        'shape': (f'B=1 T={T} (segments {lens}) H={H} Hkv={Hkv} D={D} '
                  f'causal {dname(torch, dtype)}'),
        'path': route, 'max_abs_err': err, 'tolerance': tol_text(tol),
        'errors': errs,
        'ms': timer(lambda: k.flash_attention_bwd(q, kk, v, out, lse, do,
                                                  True, scale, qseg, seg)),
        'plain_ms': timer(lambda: k.flash_attention_bwd_plain(
            q, kk, v, out, lse, do, True, scale, qseg, seg), iters=5),
        'library_ms': timer(lambda: torch.autograd.grad(
            lib_out, lib_in, do, retain_graph=True)),
        'library': ('backward of F.scaled_dot_product_attention with the '
                    'block-diagonal causal mask as a bool tensor'),
        'bound_ms': b_, 'bound_by': by,
    }
    del lib_out, lib_in
    return rec


def window_vs_causal(torch, timer, card, S=8192, W=4096, H=32, Hkv=8,
                     D=128):
    """K5w / K6w at phase 10's own shape (Mistral-7B's heads, S = 8192,
    its window of 4096) beside K5 / K6 causal at the same shape, bf16:
    the band's work is band_pairs / causal pairs of causal (about 0.75
    here). Printed, not asserted."""
    from paddle_tpu_torch.ops.hopper import flash_attention as k

    gen = torch.Generator(device='cuda').manual_seed(S + W)

    def bshd(h):
        return torch.randn(1, S, h, D, device='cuda', generator=gen) \
            .to(torch.bfloat16).transpose(1, 2)

    q, kk, v, do = bshd(H), bshd(Hkv), bshd(Hkv), bshd(H)
    ms = {}
    for label, w in (('causal', None), ('window', W)):
        out, lse = k.flash_attention_fwd(q, kk, v, True, None, window=w)
        ms[label] = (
            timer(lambda: k.flash_attention_fwd(q, kk, v, True, None,
                                                window=w), iters=5),
            timer(lambda: k.flash_attention_bwd(q, kk, v, out, lse, do, True,
                                                None, window=w), iters=3,
                  warmup=1))
        del out, lse
    work = band_pairs(S, W) / (S * (S + 1) // 2)
    print(f'kernel window vs causal, B=1 H={H} Hkv={Hkv} S={S} D={D} bf16: '
          f'K5w {ms["window"][0]:.3f} ms vs K5 {ms["causal"][0]:.3f} ms '
          f'({ms["window"][0] / ms["causal"][0]:.3f}); K6w '
          f'{ms["window"][1]:.3f} ms vs K6 {ms["causal"][1]:.3f} ms '
          f'({ms["window"][1] / ms["causal"][1]:.3f}); the band\'s work is '
          f'{work:.3f} of causal (window {W}) [{card}]', flush=True)
    return ms


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


def profile_window(torch, engine, prompts, card, label='profile'):
    """Trace one engine step that decodes a full window of 4 rows, and
    print the device time by kernel, the kernel count, and the share of
    the step's wall time the device was busy."""
    rids = [engine.submit(p, 16) for p in prompts[:4]]
    engine.step()                 # admissions + first window: not traced
    trace_step(torch, engine, card, label, f'one window of '
               f'{engine.decode_window} decode forwards x 4 rows')
    engine.run()
    for r in rids:
        engine.result(r)


def trace_step(torch, engine, card, label, what):
    """Trace one engine step with torch.profiler and print its wall time,
    the device time by kernel, and the share of the wall the device was
    busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # kernel-level events only (an operator's device time is its
    # kernels' time, counted once)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print(f'{label}: the profiler recorded no device time; device-busy '
              f'share not measured')
        return
    busy = sum(r[0] for r in rows) / 1e3
    print(f'{label}: {what} under the profiler: wall {wall * 1e3:.1f} ms, '
          f'device busy {busy:.1f} ms ({busy / (wall * 1e3):.3f}), '
          f'{sum(r[1] for r in rows)} kernels [{card}]')
    for t_us, n, key in rows[:15]:
        print(f'{label}:   {t_us / 1e3:9.3f} ms  {n:6d}x  {key[:90]}')


def serve_burst(torch, engine, prompts):
    """Warm the engine on one short request (not measured), then serve
    `prompts` in three staggered waves (later requests admitted while
    earlier rows decode) with every launch count set to 0 just before
    and read just after. Returns the run's wall time, launch counts,
    engine stats before and after, outputs and peak memory."""
    from paddle_tpu_torch import ops

    engine.serve([prompts[0][:32]], max_new_tokens=8)
    before = engine.stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
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
    return wall, launches, before, after, outs, \
        torch.cuda.max_memory_allocated()


def check_burst(label, engine, prompts, vocab, wall, launches, before,
                after, outs, peak, kernel, card):
    """The burst's outputs, exact launch counts (`kernel` L per decode
    forward, K1 2L + 1 per forward, nothing else) and leaks; prints its
    throughput."""
    check_outputs(label, prompts, outs, vocab, [32] * len(prompts))
    n_dec, n_pre, _ = serving_launches(label, engine, before, after,
                                       launches, kernel)
    n_tok = after['tokens_generated'] - before['tokens_generated']
    n_steps = after['steps'] - before['steps']
    lens = [len(p) for p in prompts]
    print(f'{label}: {len(prompts)} requests, prompt lengths {lens}, '
          f'{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s, '
          f'{wall / n_steps * 1e3:.1f} ms per engine step ({n_steps} steps '
          f'of {n_pre} prefills and {n_dec // engine.decode_window} windows '
          f'of {engine.decode_window}), {wall / n_dec * 1e3:.1f} ms per '
          f'decode forward incl. prefill, peak memory {peak / 2**30:.2f} '
          f'GiB, preemptions {after["preemptions"]}, page bytes '
          f'{engine.allocator.stats()["bytes_per_page"]} [{card}]')
    print(f'{label}: launches { {k: v for k, v in launches.items() if v} } '
          f'over {n_dec} decode forwards and {n_pre} prefill forwards; '
          f'pages in use after drain: 0', flush=True)


def np_equal(a, b):
    return len(a) == len(b) and all(int(x) == int(y) for x, y in zip(a, b))


def serve_phase(torch, np, card):
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
    engine = ServingEngine(model, **SERVE_KW)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 513, 8)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    run = serve_burst(torch, engine, prompts)
    launches, outs = run[1], run[4]
    check_burst('serving', engine, prompts, cfg.vocab_size, *run,
                'paged_decode_attention', card)

    profile_window(torch, engine, prompts, card)

    logits_phase(torch, model, cfg, prompts[2], outs[2][len(prompts[2]):])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    int8_launches = int8_serve_phase(torch, np, card, model, prompts, outs)
    return launches, int8_launches


# phase 4's engine settings, shared by the int8 serving phase
SERVE_KW = dict(max_slots=4, block_size=16, decode_window=8,
                max_new_tokens=32)


def int8_serve_phase(torch, np, card, model, prompts, bf16_outs):
    """The int8-KV serving path: the same model, settings and staggered
    burst as phase 4 through ServingEngine(kv_cache_dtype='int8') (K8q
    in its per-row mode, L per decode forward); then, at Llama-7B width
    with 2 layers in float32, the int8 engine's streams through the
    kernels against the plain versions, and under a pool tight enough to
    preempt against the uninterrupted engine (both asserted)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    engine = ServingEngine(model, kv_cache_dtype='int8', **SERVE_KW)
    run = serve_burst(torch, engine, prompts)
    launches, outs = run[1], run[4]
    check_burst('int8 serving', engine, prompts, model.config.vocab_size,
                *run, 'paged_decode_attention_int8', card)
    profile_window(torch, engine, prompts, card, label='int8 profile')
    same = [int(np.sum(np.cumprod(o[len(p):] == b[len(p):])))
            for p, o, b in zip(prompts, outs, bf16_outs)]
    print(f'int8 serving: leading tokens equal to the bf16 engine per '
          f'request {same} of 32 (printed, not asserted: int8 pages round '
          f'every K/V row)')
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(llama_7b(), num_hidden_layers=2,
                              dtype='float32')
    f32 = LlamaForCausalLM(cfg, seed=2)
    small = [p[:96] for p in prompts[:4]]
    kw = dict(SERVE_KW, max_new_tokens=16, kv_cache_dtype='int8')
    got = ServingEngine(f32, **kw).serve(small)
    with plain_kernels():
        want = ServingEngine(f32, **kw).serve(small)
    equal = all(np_equal(a, b) for a, b in zip(got, want))
    print(f'int8 serving float32, Llama-7B width, 2 layers, {len(small)} '
          f'requests x 16 tokens: streams through the kernels equal to the '
          f'plain versions: {equal} [{card}]')
    if not equal:
        raise AssertionError('int8 serving: kernel and plain streams differ')
    # 12 usable 16-token pages: a 96-token prompt takes 6 pages to admit
    # and 7 by its end, so two admissions leave no page for the window
    # top-up and the younger request is preempted
    tight = ServingEngine(f32, num_blocks=13, **kw)
    tight_out = tight.serve(small)
    n_pre = tight.stats()['preemptions']
    equal = all(np_equal(a, b) for a, b in zip(tight_out, got))
    print(f'int8 serving float32: a 12-page pool preempted {n_pre} times; '
          f'streams equal to the uninterrupted engine: {equal}')
    if not (equal and n_pre > 0 and tight.allocator.in_use() == 0):
        raise AssertionError('int8 serving: preempted streams differ, no '
                             'preemption happened, or pages leaked')
    del f32, tight
    gc.collect()
    torch.cuda.empty_cache()
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
    from paddle_tpu_torch.ops.hopper import headmajor_attention as hh
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as hm
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
                          (hh, 'decode_attention_headmajor'),
                          (hq, 'quant_matmul'), (hq, 'quant_matmul_int4'),
                          (hq, 'quant_matmul_fp8'),
                          (hm, 'moe_grouped_matmul'),
                          (hm, 'moe_grouped_matmul_dx'),
                          (hm, 'moe_grouped_matmul_dw')):
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
    """fn() with every launch count (and K10 / K11's and flash attention's
    per-route counts) set to 0 just before and read just after
    (synchronised): (result, counts)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.hopper import flash_attention as hf
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as hm
    from paddle_tpu_torch.ops.hopper import quant_matmul as hq

    torch.cuda.synchronize()
    for counts in (ops.LAUNCHES, hq.PATH_LAUNCHES, hf.FLASH_PATH_LAUNCHES,
                   hm.PATH_LAUNCHES, hm.DX_PATH_LAUNCHES,
                   hm.DW_PATH_LAUNCHES):
        for name in counts:
            counts[name] = 0
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


def profile_forward(torch, fn, label, card, phase='decode',
                    what='one forward'):
    """Trace one decode (or prefill) forward (or `what` fn runs): device
    time by kernel and the share of its wall time the device was busy.
    Returns the traced kernels' (device us, count, name) rows."""
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
        print(f'{phase} profile {label}: the profiler recorded no device '
              f'time; device-busy share not measured')
        return rows
    busy = sum(r[0] for r in rows) / 1e3
    n = sum(r[1] for r in rows)
    print(f'{phase} profile {label}: {what}: wall {wall * 1e3:.2f} ms, '
          f'device busy {busy:.3f} ms ({busy / (wall * 1e3):.3f}), {n} '
          f'kernels [{card}]')
    for t_us, c, key in rows[:12]:
        print(f'{phase} profile {label}:   {t_us / 1e3:8.3f} ms  {c:5d}x  '
              f'{key[:90]}')
    for what, tag in (('decode attention (K7)', 'pt_decode::'),
                      ('X1 skinny', 'moe_skinny_kernel'),
                      ('X1 CUDA-core tiles', 'moe_tiled_kernel'),
                      ('X1 tensor cores', 'moe_tc_kernel')):
        hits = [r for r in rows if tag in r[2]]
        if hits:
            ms = sum(r[0] for r in hits) / 1e3
            print(f'{phase} profile {label}: {what} {ms:.3f} ms in '
                  f'{sum(r[1] for r in hits)} launches, {ms / busy:.3f} of '
                  f'device time')
    return rows


# the names the profiler records for the launches each counter counts,
# one traced kernel per counted launch (K7, K8 and K8q share the decode
# kernel's template)
TRACE_TAGS = {
    'rms_norm': ('rms_norm_fwd',),
    'decode_attention': ('pt_decode::',),
    'paged_decode_attention': ('pt_decode::',),
    'paged_decode_attention_int8': ('pt_decode::',),
    'moe_grouped_matmul': ('moe_skinny_kernel', 'moe_tiled_kernel',
                           'moe_tc_kernel'),
    **dict.fromkeys(('quant_matmul', 'quant_matmul_int4',
                     'quant_matmul_fp8'),
                    ('qmm_skinny_kernel', 'qmm_tiled_kernel',
                     'qmm_tc_kernel')),
}


def check_replay_trace(rows, graph, n, label):
    """The hand-written kernels that a traced run of n replays of `graph`
    launched, counted by name in the profiler's `rows`, against the
    launches its capture counted times n (what the runner adds to the
    counters on each replay): equal for every kernel family, none
    launched that the capture did not count."""
    want = dict.fromkeys(set(TRACE_TAGS.values()), 0)
    for name, inc in graph.increments[0].items():
        if name not in TRACE_TAGS:
            raise AssertionError(f'{label}: no traced name for {name}')
        want[TRACE_TAGS[name]] += n * inc
    got = {tags: sum(c for _, c, key in rows
                     if any(t in key for t in tags)) for tags in want}
    shown = {tags[0]: (got[tags], want[tags]) for tags in want
             if got[tags] or want[tags]}
    print(f'graphs profile {label}: traced launches against the capture\'s '
          f'counts x {n} (traced, counted): {shown}; equal '
          f'{got == want}', flush=True)
    if not rows or got != want:
        raise AssertionError(f'{label}: the traced replays launched '
                             f'{got}, the counters add {want}')


def decode_graph(torch, model, caches, batch, base, steps):
    """The JAX bench's scanned decode loop as the port runs generate's:
    generate's decode step (`_decode_step`, greedy, at the device
    position base + step over `caches`) captured once as a CUDA graph;
    `rep()` resets the step and replays it `steps` times. Returns (the
    graph, rep, its buffers)."""
    from paddle_tpu_torch.inference.graphs import GraphRunner
    from paddle_tpu_torch.models.generation import _decode_step

    dev = model.device
    bufs = dict(tok=torch.zeros(batch, dtype=torch.int64, device=dev),
                out=torch.zeros(batch, steps + 1, dtype=torch.int64,
                                device=dev),
                finished=torch.zeros(batch, dtype=torch.bool, device=dev),
                step=torch.zeros(1, dtype=torch.int64, device=dev))

    def body():
        _decode_step(model, caches, bufs['tok'], bufs['out'],
                     bufs['finished'], bufs['step'], S=base)

    with torch.no_grad():
        graph = GraphRunner(dev).capture(
            'bench_decode', body, bufs,
            [t for c in caches for t in c])

    def rep():
        bufs['step'].zero_()
        graph.run(steps)

    return graph, rep, bufs


def bench_decode(torch, model, batch, label, card, quant=None,
                 kv_int8=False, cache_len=2048, steps=48, reps=3,
                 profile=False):
    """The JAX bench's decode measurement (bench.py:2739-2780): zero
    caches of `cache_len` positions, `steps` greedy single-token
    forwards per rep from cache index cache_len - steps - 2, one warm
    rep, then `reps` timed reps, each forward a replay of generate's
    captured decode step (`decode_graph`, as the JAX bench jits its
    scanned loop). With kv_int8 the caches are int8 with unit scales, as
    the JAX bench sets them (no prefill calibrates them). Checks the
    exact launch counts of all reps; returns (tokens/s, ms per forward,
    counts)."""
    L = model.config.num_hidden_layers
    caches = model.init_cache(batch, cache_len, quantized=kv_int8)
    if kv_int8:
        for c in caches:
            c.kscale.fill_(1.0)
            c.vscale.fill_(1.0)
    base = cache_len - steps - 2
    graph, rep, bufs = decode_graph(torch, model, caches, batch, base, steps)
    tok = bufs['tok']

    def run():
        with torch.no_grad():
            rep()                              # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                rep()
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
          f'{cache_len}-position cache, each a replay of the captured '
          f'step, captured in {graph.capture_s:.3f} s, '
          f'{graph.reserved_bytes} bytes reserved), peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
          f'{ {k: v for k, v in counts.items() if v} } over {n_fwd} '
          f'forwards [{card}]', flush=True)
    if profile:
        bufs['step'].zero_()
        with torch.no_grad():
            profile_forward(torch, lambda: graph.run(1), label, card)
    del caches, graph
    return tps, ms, counts


def prefill_run(torch, np, model, label, card, quant=None, P=2048,
                reps=3, profile=False):
    """A long prompt's prefill through the normal entry point:
    generate(1 x P seeded ids, max_new_tokens=1) is one prefill forward
    and the first token. One warm call, then `reps` timed calls (ms per
    call), exact launch counts (K1 2L + 1 and, with quantized weights,
    K10 / K11 7L + 1 per forward, every one on the tensor-core path); a
    quantized model's first token must equal its run through the plain
    versions. With `profile`, one more call is traced. Returns the
    launch counts."""
    from paddle_tpu_torch.ops.hopper import quant_matmul as hq

    cfg = model.config
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(17).integers(
        3, cfg.vocab_size, (1, P))).to(model.device)
    first = model.generate(ids, max_new_tokens=1)
    torch.cuda.synchronize()

    def timed():
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            out = model.generate(ids, max_new_tokens=1)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return out, ts

    (out, ts), counts = count_launches(torch, timed)
    paths = dict(hq.PATH_LAUNCHES)
    expect_launches(counts, L, reps, 0, quant)
    if not torch.equal(out, first):
        raise AssertionError(f'prefill {label}: the first token changed '
                             f'between calls')
    line = (f'prefill {label}: generate(1 x {P} tokens, max_new_tokens=1) '
            f'{sum(ts) / reps:.2f} ms per call (calls '
            f'{", ".join(f"{t:.2f}" for t in ts)}; {L} layers)')
    if quant:
        tc = paths['tensor_core']
        if paths != dict(skinny=0, tensor_core=counts[quant], cuda_core=0):
            raise AssertionError(f'prefill {label}: paths {paths}, not all '
                                 f'{counts[quant]} on the tensor cores')
        with plain_kernels():
            plain = model.generate(ids, max_new_tokens=1)
        same = torch.equal(plain, out)
        line += (f'; {quant} {counts[quant] // reps} launches per call (7L '
                 f'+ 1 = {7 * L + 1}), tensor-core share '
                 f'{tc / counts[quant]:.3f}; first token {int(out[0, -1])},'
                 f' through the plain versions {int(plain[0, -1])}: equal '
                 f'{same}')
        if not same:
            raise AssertionError(f'prefill {label}: the first token differs '
                                 f'from the plain versions')
    print(line + f' [{card}]', flush=True)
    if profile:
        profile_forward(torch, lambda: model.generate(ids, max_new_tokens=1),
                        label, card, phase='prefill')
    return counts


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


@contextlib.contextmanager
def direct_steps():
    """generate's decode step and generate_speculative's windows run
    directly, the eager reference, in place of their captured graphs (a
    runner off the card calls the body): Python then runs every step, so
    forward hooks see every forward and the plain versions, which read
    the device on the host, can run."""
    from paddle_tpu_torch.inference.graphs import GraphRunner
    from paddle_tpu_torch.models import generation

    with mock.patch.object(generation, '_decode_graphs',
                           lambda owner, model: generation.DecodeGraphs(
                               GraphRunner('cpu'))):
        yield


def agreement_phase(torch, np, card, steps=16, f32_tol=1e-3, cfg=None,
                    width='Llama-7B', weights=True):
    """Kernels against plain versions on a float32 model at Llama-7B
    width (or `cfg`'s) with 2 layers: the logits of every forward of a
    generate (prefill, then `steps` decode forwards, run directly:
    `direct_steps`) in five modes (three without the quantized
    `weights`) must agree within `f32_tol`, with equal tokens, and the
    captured steps' tokens must equal the direct ones; and DecodeEngine
    (padded to its bucket) must be token-equal to model.generate
    (unpadded). Returns the model."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = dataclasses.replace(cfg or llama_7b(), num_hidden_layers=2,
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
        ('int8 weights', model.quantize_weights(8) if weights else None,
         dict(input_ids=ids), 'quant_matmul'),
        ('int4 weights', model.quantize_weights(4) if weights else None,
         dict(input_ids=ids), 'quant_matmul_int4'),
        ('left-padded batch, attention_mask', model,
         dict(input_ids=padded, attention_mask=am), None))
    modes = [m for m in modes if m[1] is not None]
    for label, m, kw, quant in modes:
        def gen():
            return m.generate(max_new_tokens=n, **kw)

        with direct_steps():
            (toks, lk), counts = count_launches(
                torch, lambda: capture_logits(torch, m, gen))
        expect_launches(counts, 2, n, steps, quant)
        with plain_kernels(), direct_steps():
            (ptoks, lp), pcounts = count_launches(
                torch, lambda: capture_logits(torch, m, gen))
        if any(pcounts.values()):
            raise AssertionError(f'the plain run launched {pcounts}')
        gtoks, gcounts = count_launches(torch, gen)
        expect_launches(gcounts, 2, n, steps, quant)
        if not torch.equal(gtoks, toks):
            raise AssertionError(f'{label}: the captured steps\' tokens '
                                 f'differ from the direct steps\'')
        err = (lk - lp).abs().max().item()
        print(f'agreement float32, {label}: {width} width, 2 layers, '
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
                                   hd.decode_attention_plain), \
                    direct_steps():
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
    del modes
    gc.collect()
    torch.cuda.empty_cache()
    return model


def decode_phase(torch, np, card):
    """The JAX bench's decode section (bench.py:2739-2860) at Llama-2-7B
    widths, all 32 layers, bf16 seeded weights: five bench_decode runs
    (b1, b8, b8 with an int8 KV cache, b1 with int8 weights, b1 with
    int4 weights), a 2048-token prefill with bf16, int8 and int4
    weights, then DecodeEngine on a 13-token prompt (bucket 16)
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
    add_counts(total, prefill_run(torch, np, model, 'bf16 weights', card))
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
        add_counts(total, prefill_run(torch, np, qm, f'int{bits} weights',
                                      card, quant=name, profile=bits == 8))
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

    agreement_phase(torch, np, card)      # its model is dropped here
    gc.collect()
    torch.cuda.empty_cache()
    print(f'decode: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return total


def fmt_weights(torch, L, E, H, Fd, dtype, seed, std=0.02):
    """Per-layer weight lists of fused_multi_transformer in the reference
    layout, drawn on the card from a seeded generator: norm scales at
    ones, no biases (the Llama family has none)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    D = E // H

    def n(*shape):
        return torch.empty(shape, dtype=dtype, device='cuda').normal_(
            0.0, std, generator=g)

    def ones():
        return torch.ones(E, dtype=dtype, device='cuda')

    return dict(
        ln_scales=[ones() for _ in range(L)], ln_biases=[None] * L,
        qkv_weights=[n(3, H, D, E) for _ in range(L)],
        qkv_biases=[None] * L, linear_weights=[n(E, E) for _ in range(L)],
        linear_biases=[None] * L, ffn_ln_scales=[ones() for _ in range(L)],
        ffn_ln_biases=[None] * L, ffn1_weights=[n(E, Fd) for _ in range(L)],
        ffn1_biases=[None] * L, ffn2_weights=[n(Fd, E) for _ in range(L)],
        ffn2_biases=[None] * L)


def expect_only(got, want, label):
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f'{label}: launch counts {got} != expected '
                             f'{full}')


def fused_phase(torch, np, card, steps=64, f32_tol=1e-3, L=32, E=4096,
                H=32, Fd=11008, B=8, S=512, T=2048, Sf=160):
    """Paddle's fused-inference ops at Llama-7B widths: the functional
    fused_multi_transformer (E 4096, 32 heads of 128, dim_feedforward
    11008, 32 layers, RMSNorm (K1), bf16 weights drawn on the card)
    prefilling batch 8 x 512 tokens (K5), then `steps` decode steps of
    fused_multi_transformer_decode_step over 2048-position caches (K9),
    one of them traced; FusedMultiTransformer (2 layers, float32) through
    the kernels against the plain versions; block_multihead_attention
    (32 heads of 128, block_size 64, one layer's pages): a varlen prefill
    of 4 prompts (K5s), then 32 decode steps (K8, or K8q with static
    (Hkv, D) int8 scales), in bf16 and float32, the float32 outputs held
    against the plain versions. Returns the phase's launch counts."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.incubate.nn import functional as FF

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    D = E // H
    t = time.perf_counter()
    w = fmt_weights(torch, L, E, H, Fd, bf16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for v in w.values() for a in v
                   if a is not None)
    print(f'fused: fused_multi_transformer at Llama-7B widths (E {E}, {H} '
          f'heads of {D}, dim_feedforward {Fd}), {L} layers, rmsnorm, '
          f'gelu, {n_params} parameters bf16 ({n_params * 2 / 1e9:.2f} GB) '
          f'drawn in {time.perf_counter() - t:.1f} s')
    caches = [torch.zeros(2, B, H, T, D, dtype=bf16, device='cuda')
              for _ in range(L)]
    g = torch.Generator(device='cuda').manual_seed(1)
    x = torch.randn(B, S, E, device='cuda', generator=g, dtype=bf16)
    xs = torch.randn(steps + 1, B, 1, E, device='cuda', generator=g,
                     dtype=bf16)
    kw = dict(norm_type='rmsnorm', activation='gelu', epsilon=1e-5)
    total = {}

    def prefill():
        with torch.no_grad():
            out, _ = FF.fused_multi_transformer(x, **w, cache_kvs=caches,
                                                **kw)
        return out

    torch.cuda.reset_peak_memory_stats()
    prefill()                                        # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, counts = count_launches(torch, prefill)
    dt = time.perf_counter() - t
    expect_only(counts, dict(flash_attention_fwd=L, rms_norm=2 * L),
                'fused prefill')
    add_counts(total, counts)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError('fused prefill: non-finite output')
    print(f'fused prefill: batch {B} x {S} tokens in {dt * 1e3:.1f} ms; '
          f'launches { {k: v for k, v in counts.items() if v} } [{card}]')

    def step(i):
        return FF.fused_multi_transformer_decode_step(
            xs[i], **w, cache_kvs=caches, time_step=S + i, **kw)[0]

    step(0)                                          # warm
    torch.cuda.synchronize()

    def decode():
        t = time.perf_counter()
        for i in range(1, steps + 1):
            out = step(i)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (out, dt), counts = count_launches(torch, decode)
    expect_only(counts, dict(decode_attention_headmajor=L * steps,
                             rms_norm=2 * L * steps), 'fused decode')
    add_counts(total, counts)
    if not (bool(torch.isfinite(out).all()) and out.shape == (B, 1, E)):
        raise AssertionError('fused decode: bad output')
    print(f'fused decode: {steps} steps of fused_multi_transformer_decode_'
          f'step, batch {B}, positions {S + 1}..{S + steps} of {T}: '
          f'{dt / steps * 1e3:.3f} ms per step, {B * steps / dt:.1f} '
          f'rows x steps / s, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
          f'per step: K9 {counts["decode_attention_headmajor"] // steps}, '
          f'K1 {counts["rms_norm"] // steps} [{card}]', flush=True)
    profile_forward(torch, lambda: step(steps), 'fused decode step b8', card)
    del w, caches, x, xs
    gc.collect()
    torch.cuda.empty_cache()

    # FusedMultiTransformer, float32, 2 layers: kernels against plain
    Lf, Bf, n = 2, 2, 16
    layer = FusedMultiTransformer(E, H, Fd, num_layers=Lf, dtype='float32',
                                  seed=0)
    xf = torch.randn(Bf, Sf + n, E, device='cuda', generator=g)

    def run_layer():
        caches = layer.gen_cache(Bf, Sf + n)
        with torch.no_grad():
            outs = [layer(xf[:, :Sf], caches=caches)[0][:, -1]]
            for i in range(n):
                outs.append(layer(xf[:, Sf + i:Sf + i + 1], caches=caches,
                                  time_step=Sf + i)[0][:, -1])
        return torch.stack(outs)

    got, counts = count_launches(torch, run_layer)
    expect_only(counts, dict(flash_attention_fwd=Lf,
                             decode_attention_headmajor=Lf * n),
                'FusedMultiTransformer')
    add_counts(total, counts)
    with plain_kernels():
        want, pcounts = count_launches(torch, run_layer)
    if any(pcounts.values()):
        raise AssertionError(f'the plain run launched {pcounts}')
    err = (got - want).abs().max().item()
    print(f'fused float32: FusedMultiTransformer at Llama-7B widths, {Lf} '
          f'layers, prefill {Bf} x {Sf} then {n} time_step decodes: max '
          f'|kernels - plain| {err:.6g} (bound {f32_tol:g}, max |out| '
          f'{want.abs().max().item():.4f}) [{card}]')
    if not err <= f32_tol:
        raise AssertionError(f'FusedMultiTransformer: kernels and plain '
                             f'versions differ by {err}')
    del layer, xf
    gc.collect()
    torch.cuda.empty_cache()

    add_counts(total, bmha_phase(torch, np, card, g, f32_tol, H=H, D=D))
    print(f'fused: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return total


def bmha_phase(torch, np, card, g, f32_tol, steps=32, H=32, D=128, BS=64,
               lens=(700, 300, 512, 500)):
    """block_multihead_attention over one layer's pages at Llama-7B heads
    (32 of 128, block_size 64): a varlen prefill of 4 prompts (2012
    tokens, segment ids: K5s), then `steps` decode steps of the 4 rows
    (K8, or K8q's (Hkv, D) mode over int8 pages with static scales). bf16
    and float32; float32 against the plain versions."""
    from paddle_tpu_torch.incubate.nn import functional as FF

    lens = list(lens)
    B, T = len(lens), sum(lens)
    MAXB = max(-(-(n + steps) // BS) for n in lens)
    NB = B * MAXB + 1
    tbl = (torch.randperm(NB - 1, generator=g, device='cuda')[:B * MAXB]
           + 1).reshape(B, MAXB).to(torch.int32)
    enc = torch.tensor(lens, dtype=torch.int32)
    zeros = torch.zeros(B, dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.int32)
    cu = torch.cumsum(torch.tensor([0] + lens), 0).to(torch.int32)
    total = {}
    for int8 in (False, True):
        mode = 'int8 pages, (Hkv, D) scales' if int8 else 'float pages'
        kernel = ('paged_decode_attention_int8' if int8
                  else 'paged_decode_attention')
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(T, 3 * H * D, device='cuda', generator=g,
                              dtype=dtype)
            dec_in = torch.randn(steps, B, 3 * H * D, device='cuda',
                                 generator=g, dtype=dtype)
            scales = {}
            if int8:
                ds = 0.03 + 0.01 * torch.rand(H, D, device='cuda',
                                              generator=g)
                scales = dict(cache_k_dequant_scales=ds,
                              cache_v_dequant_scales=ds)

            def run():
                cdt = torch.int8 if int8 else dtype
                kc = torch.zeros(NB, H, BS, D, dtype=cdt, device='cuda')
                vc = torch.zeros_like(kc)
                with torch.no_grad():
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = FF.block_multihead_attention(
                        qkv, kc, vc, enc, zeros, enc, cu_seqlens_q=cu,
                        block_tables=tbl, block_size=BS, num_heads=H,
                        **scales)[0]
                    torch.cuda.synchronize()
                    t_pre = time.perf_counter() - t
                    outs = [out]
                    t = time.perf_counter()
                    for i in range(steps):
                        outs.append(FF.block_multihead_attention(
                            dec_in[i], kc, vc, zeros, enc + i, ones,
                            block_tables=tbl, block_size=BS, num_heads=H,
                            **scales)[0])
                    torch.cuda.synchronize()
                    t_dec = time.perf_counter() - t
                return torch.cat(outs).float(), t_pre, t_dec

            (got, t_pre, t_dec), counts = count_launches(torch, run)
            expect_only(counts, {'flash_attention_fwd_seg': 1,
                                 kernel: steps},
                        f'block_multihead_attention {mode}')
            add_counts(total, counts)
            line = (f'bmha {mode}, {dname(torch, dtype)}: varlen prefill of '
                    f'{lens} ({T} tokens) {t_pre * 1e3:.2f} ms, {steps} '
                    f'decode steps {t_dec / steps * 1e3:.3f} ms per step '
                    f'(host clock, first call); launches '
                    f'{ {k: v for k, v in counts.items() if v} }')
            if dtype == torch.float32:
                with plain_kernels():
                    (want, _, _), pcounts = count_launches(torch, run)
                if any(pcounts.values()):
                    raise AssertionError(f'the plain run launched {pcounts}')
                err = (got - want).abs().max().item()
                line += (f'; max |kernels - plain| {err:.6g} (bound '
                         f'{f32_tol:g}, max |out| '
                         f'{want.abs().max().item():.4f})')
                if not err <= f32_tol:
                    raise AssertionError(f'bmha {mode}: kernels and plain '
                                         f'versions differ by {err}')
            elif not bool(torch.isfinite(got).all()):
                raise AssertionError(f'bmha {mode}: non-finite output')
            print(f'{line} [{card}]', flush=True)
    return total


KERNEL_GROUPS = (('flash_fwd', 'K5 flash fwd'), ('flash_bwd', 'K6 flash bwd'),
                 ('rms_norm_fwd', 'K1 rms fwd'), ('rms_norm_bwd', 'K2 rms bwd'),
                 ('xent_fwd', 'K3 xent fwd'), ('xent_bwd', 'K4 xent bwd'),
                 ('moe_dw', 'X1dW'), ('moe_tc_kernel<true>', 'X1dx'),
                 ('moe_tc_kernel<false>', 'X1 fwd'),
                 ('moe_', 'X1 CUDA-core routes'))


def kernel_group(key):
    for sub, label in KERNEL_GROUPS:
        if sub in key:
            return label
    low = key.lower()
    if any(t in low for t in ('gemm', 'nvjet', 'cutlass', 'xmma')):
        return 'GEMM (cuBLAS)'
    return 'other PyTorch kernels'


def profile_train_step(torch, eng, ids, card, label='train'):
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
    print(f'{label} profile: AdamW update '
          f'{events[0].elapsed_time(events[1]):.1f} ms of the step (CUDA '
          f'events around apply_gradients)')
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print(f'{label} profile: the profiler recorded no device time; '
              f'device-busy share not measured')
        return
    busy = sum(r[0] for r in rows) / 1e3
    print(f'{label} profile: one step under the profiler: wall '
          f'{wall * 1e3:.1f} ms, device busy {busy:.1f} ms '
          f'({busy / (wall * 1e3):.3f}) [{card}]')
    groups = {}
    for t_us, n, key in rows:
        g = groups.setdefault(kernel_group(key), [0.0, 0])
        g[0] += t_us / 1e3
        g[1] += n
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f'{label} profile:   {ms:9.3f} ms {ms / busy:6.3f}  {n:6d}x  '
              f'{group}')
    for t_us, n, key in rows[:15]:
        print(f'{label} profile:   {t_us / 1e3:9.3f} ms  {n:6d}x  '
              f'{key[:90]}')


def train_run(torch, np, card, cfg, B, S, label, flash, warmup=2, steps=5,
              model_fn=None, per_step=None, routes_fn=None):
    """TrainEngine + AdamW(1e-4, weight decay 0.01) over the model
    `model_fn()` builds (default LlamaForCausalLM(cfg, seed=0)) on one
    repeated batch of B x S tokens: `warmup` then `steps` timed steps
    (tokens/s, ms per step, peak memory, per-step losses that must fall
    from about ln V + sigma^2 / 2, plus aux_loss_weight a layer for an MoE
    model's balanced random routing), exact launch counts per step
    (`flash`: the forward and backward keys the attention runs; every
    flash launch of a bf16 model with head size up to 128 on the tensor
    cores; `per_step`: the other kernels' launches a step, default the
    Llama path's K1 / K2 2L + 1 and K3 / K4 1; `routes_fn(n)`, where
    given, checks the per-route counts after n steps), and one step
    traced with torch.profiler. Returns the launch counts."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops.hopper import flash_attention as hf
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as hm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.training import TrainEngine

    L = cfg.num_hidden_layers
    if per_step is None:
        per_step = dict(rms_norm=2 * L + 1, rms_norm_bwd=2 * L + 1,
                        softmax_xent_fwd=1, softmax_xent_bwd=1)
    t = time.perf_counter()
    model = (model_fn or (lambda: LlamaForCausalLM(cfg, seed=0)))()
    eng = TrainEngine(model, AdamW(learning_rate=1e-4, weight_decay=0.01),
                      log_window=steps)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f'{label}: {L} layers, {n_params} parameters, bf16 (norm weights '
          f'float32), float32 AdamW moments, built in '
          f'{time.perf_counter() - t:.1f} s')
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1))).to(model.device)
    torch.cuda.reset_peak_memory_stats()
    for counts in (ops.LAUNCHES, hf.FLASH_PATH_LAUNCHES, hm.PATH_LAUNCHES,
                   hm.DX_PATH_LAUNCHES, hm.DW_PATH_LAUNCHES):
        for name in counts:
            counts[name] = 0
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
    routes = dict(hf.FLASH_PATH_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = warm['losses'] + logs['losses']
    n = warmup + steps
    fwd_key, bwd_key = flash
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update({key: c * n for key, c in per_step.items()})
    want.update({fwd_key: L * n, bwd_key: 2 * L * n})
    print(f'{label}: {steps} timed steps of {B} x {S} tokens after {warmup} '
          f'warm-up: {steps * B * S / wall:.1f} tokens/s, '
          f'{wall / steps * 1e3:.1f} ms per step, peak memory '
          f'{peak / 2**30:.2f} GiB [{card}]')
    print(f'{label}: losses per step {[round(x, 5) for x in losses]}')
    print(f'{label}: launches {launches} over {n} steps (per step: '
          f'{fwd_key} L, {bwd_key} 2L (dq, dk/dv), {per_step}; L = {L})',
          flush=True)
    if launches != want:
        raise AssertionError(f'{label} launch counts {launches} != {want}')
    if routes_fn is not None:
        routes_fn(n)
    D = cfg.hidden_size // cfg.num_attention_heads
    dtype = model.cache_dtype()
    route = hf.path(dtype, D)
    want_routes = dict.fromkeys(routes, 0)
    want_routes[route] = 3 * L * n
    print(f'{label}: flash launches by route {routes} (every one on '
          f'{route}: {dtype}, head size {D})', flush=True)
    if routes != want_routes or (dtype == torch.bfloat16 and D <= 128
                                 and route != 'tensor_core'):
        raise AssertionError(f'{label} flash routes {routes} != '
                             f'{want_routes}')
    # random-init logits are N(0, sigma^2) with sigma^2 = std^2 * hidden
    # (the final norm's output has unit RMS), so the first loss is about
    # ln V + sigma^2 / 2, not ln V; an MoE model adds aux_loss_weight
    # times its layers' aux losses, each about 1 at a balanced routing
    first = math.log(cfg.vocab_size) + 0.5 * (
        cfg.initializer_range ** 2 * cfg.hidden_size) + getattr(
            cfg, 'aux_loss_weight', 0.0) * L
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'non-finite training loss: {losses}')
    if abs(losses[0] - first) > 0.1:
        raise AssertionError(f'first loss {losses[0]} is not within 0.1 of '
                             f'ln V + sigma^2 / 2 = {first:.4f}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'the loss did not fall on a repeated batch: '
                             f'{losses}')
    print(f'{label}: first loss {losses[0]:.4f} vs ln V + sigma^2 / 2 '
          f'(+ aux_loss_weight L for MoE) = {first:.4f} (ln V = '
          f'{math.log(cfg.vocab_size):.4f}); last {losses[-1]:.4f}')
    profile_train_step(torch, eng, ids, card, label)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_phase(torch, np, card):
    """TrainEngine + AdamW at the JAX bench's training configuration
    (bench.py: Llama-2-7B widths, 4 layers, bf16, no remat, 6 x 2048
    tokens), on one repeated batch."""
    from paddle_tpu_torch.models.llama import llama_7b

    cfg = dataclasses.replace(llama_7b(), num_hidden_layers=4,
                              max_position_embeddings=2048,
                              dtype='bfloat16')
    return train_run(torch, np, card, cfg, 6, 2048, 'train',
                     ('flash_attention_fwd', 'flash_attention_bwd'))


def mistral_7b(**kw):
    """Mistral-7B-v0.1's published widths (its config.json on the
    Hugging Face hub, mistralai/Mistral-7B-v0.1): a plain LlamaConfig
    with a sliding window on every layer."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**dict(
        dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
             num_hidden_layers=32, num_attention_heads=32,
             num_key_value_heads=8, max_position_embeddings=32768,
             rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096),
        **kw))


def rel_l2(torch, got, ref):
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-30)).item()


def swa_grads(torch, np, card, rel_tol=1e-4):
    """(b) One training step's loss and gradients through the kernels
    against the plain versions at Mistral-7B widths, 2 layers, 1 x 1024
    tokens, float32, window 256 with max_window_layers 1 (layer 0 full
    attention, K5 / K6; layer 1 windowed, K5w / K6w): the loss within
    1e-5 of itself, each parameter's gradient within `rel_tol` in
    relative L2, as grads_phase holds the causal path."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = mistral_7b(num_hidden_layers=2, sliding_window=256,
                     max_window_layers=1, dtype='float32')
    model = LlamaForCausalLM(cfg, seed=0)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 1025))).to(model.device)
    (lk, gk), counts = count_launches(
        torch, lambda: loss_and_grads(torch, model, ids, plain=False))
    lp, gp = loss_and_grads(torch, model, ids, plain=True)
    want = {'flash_attention_fwd': 1, 'flash_attention_bwd': 2,
            'flash_attention_fwd_window': 1, 'flash_attention_bwd_window': 2}
    got = {k: counts[k] for k in want}
    rel = {n: rel_l2(torch, gk[n], gp[n]) for n in gp}
    worst = max(rel, key=rel.get)
    print(f'swa grads float32: Mistral-7B widths, 2 layers (window 256 on '
          f'layer 1), 1 x 1024 tokens: loss kernels {lk:.6f} plain '
          f'{lp:.6f} (|diff| {abs(lk - lp):.3g}); worst gradient |kernels - '
          f'plain| / |plain| {rel[worst]:.3g} ({worst}), median '
          f'{float(np.median(list(rel.values()))):.3g} over {len(rel)} '
          f'parameters; flash launches {got} [{card}]', flush=True)
    if got != want:
        raise AssertionError(f'swa grads: flash launches {got} != {want}')
    if not (abs(lk - lp) <= 1e-5 * abs(lp) and rel[worst] <= rel_tol):
        raise AssertionError(f'swa grads: float32 loss {lk} vs {lp} or '
                             f'gradient relative error {rel[worst]} > '
                             f'{rel_tol}')
    del model, gk, gp
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def packed_grads(torch, np, card, rel_tol=1e-4, H=32, D=128):
    """(c) Gradients of (out.float() ** 2).sum() through
    flash_attn_unpadded(causal=True) over a packed T = 4096 stream of
    segments (1000, 1900, 96, 1100) at 32 heads of 128, kernels (K5s,
    K6s) against the plain versions: float32 within `rel_tol` in
    relative L2 (out and each gradient), bf16 printed. Exactly one K5s
    and two K6s launches per call. Returns the float32 kernel run's
    launch counts."""
    from paddle_tpu_torch.nn import functional as PF

    lens = [1000, 1900, 96, 1100]
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32,
                      device='cuda')
    T = sum(lens)
    g = torch.Generator(device='cuda').manual_seed(T)
    base = [torch.randn(T, H, D, device='cuda', generator=g)
            for _ in range(3)]
    total = {}
    for dtype in (torch.float32, torch.bfloat16):
        def run(plain):
            ts = [b.to(dtype, copy=True).requires_grad_() for b in base]
            with plain_kernels() if plain else contextlib.nullcontext():
                out, _ = PF.flash_attn_unpadded(*ts, cu, cu, max(lens),
                                                max(lens), causal=True)
                (out.float() ** 2).sum().backward()
            return [out.detach()] + [t.grad for t in ts]

        got, counts = count_launches(torch, lambda: run(False))
        ref, pcounts = count_launches(torch, lambda: run(True))
        want = {'flash_attention_fwd_seg': 1, 'flash_attention_bwd_seg': 2}
        launched = {k: v for k, v in counts.items() if v}
        if launched != want or any(pcounts.values()):
            raise AssertionError(f'packed grads: launches {launched} (plain '
                                 f'{pcounts}) != {want}')
        rel = [rel_l2(torch, a, b) for a, b in zip(got, ref)]
        print(f'packed grads {dname(torch, dtype)}: flash_attn_unpadded, '
              f'T={T} (segments {lens}), H={H} D={D} causal: |kernels - '
              f'plain| / |plain| out {rel[0]:.3g}, dq {rel[1]:.3g}, dk '
              f'{rel[2]:.3g}, dv {rel[3]:.3g}; launches {launched} [{card}]',
              flush=True)
        if dtype == torch.float32:
            total = counts
            if not max(rel) <= rel_tol:
                raise AssertionError(f'packed grads float32: relative error '
                                     f'{max(rel)} > {rel_tol}')
        elif not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError('packed grads bf16: non-finite output')
    return total


def swa_decode(torch, np, card, P=4608, N=32):
    """(d) Greedy decode of sliding-window models: at Mistral-7B widths,
    2 layers, float32, window 512 and a 640-token prompt, 16 tokens
    through the kernels equal to the plain versions'; then bf16, 4
    layers, the published window (4096) and a 4608-token prompt, 32
    tokens (ms per decode step), with exactly L launches of K7 per
    decode step, each over a window that starts past position 0.
    Returns the launch counts of the kernel runs."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    total = {}
    cfg = mistral_7b(num_hidden_layers=2, sliding_window=512,
                     dtype='float32')
    model = LlamaForCausalLM(cfg, seed=1)
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        3, cfg.vocab_size, (1, 640))).to(model.device)
    toks, counts = count_launches(
        torch, lambda: model.generate(ids, max_new_tokens=16))
    expect_launches(counts, 2, 16, 15)
    add_counts(total, counts)
    with plain_kernels(), direct_steps():
        ptoks = model.generate(ids, max_new_tokens=16)
    print(f'swa decode float32: Mistral-7B widths, 2 layers, window 512, '
          f'640-token prompt, 16 greedy tokens: kernels and plain versions '
          f'equal {bool(torch.equal(toks, ptoks))} [{card}]', flush=True)
    if not torch.equal(toks, ptoks):
        raise AssertionError('swa decode: the token streams through the '
                             'kernels and the plain versions differ')
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cfg = mistral_7b(num_hidden_layers=4, dtype='bfloat16')
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, seed=2)
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        3, cfg.vocab_size, (1, P))).to(model.device)
    starts = []
    inner = ops.decode_attention

    def recording(q, k_cache, v_cache, valid_len, *a, start=None, **kw):
        starts.append(start)
        return inner(q, k_cache, v_cache, valid_len, *a, start=start, **kw)

    def timed(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            out = model.generate(ids, max_new_tokens=n)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    timed(N)                          # warm: captures the step
    (_, t1), _ = count_launches(torch, lambda: timed(1))
    (out, tn), counts = count_launches(torch, lambda: timed(N))
    expect_launches(counts, L, N, N - 1)
    add_counts(total, counts)
    # the window starts K7 receives, recorded where Python runs every
    # step: the direct steps, the captured step's eager reference
    with mock.patch.object(ops, 'decode_attention', recording), \
            direct_steps():
        direct = model.generate(ids, max_new_tokens=N)
    if not torch.equal(direct, out):
        raise AssertionError('swa decode: the captured steps\' tokens '
                             'differ from the direct steps\'')
    low = min(int(s.min()) for s in starts)
    step_ms = (tn - t1) / (N - 1) * 1e3
    print(f'swa decode bf16: Mistral-7B widths, {L} layers, window '
          f'{cfg.sliding_window}, {P}-token prompt, {N} greedy tokens: '
          f'{step_ms:.3f} ms per decode step ((generate of {N} - generate '
          f'of 1) / {N - 1}; prefill {t1 * 1e3:.1f} ms), K7 launches '
          f'{counts["decode_attention"]} ({L} per decode step), lowest '
          f'window start {low} [{card}]', flush=True)
    if len(starts) != L * (N - 1) or low <= 0:
        raise AssertionError(f'swa decode: {len(starts)} decode-attention '
                             f'calls, lowest window start {low}')
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError('swa decode: a token id outside the vocab')
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return total


def swa_phase(torch, np, card):
    """Phase 10: sliding-window and packed training at Mistral-7B
    widths, and the decode of sliding-window models. Returns the launch
    counts of each path's kernel runs."""
    t = time.perf_counter()
    cfg = mistral_7b(num_hidden_layers=4, dtype='bfloat16')
    paths = {
        'swa train': train_run(
            torch, np, card, cfg, 1, 8192, 'swa train',
            ('flash_attention_fwd_window', 'flash_attention_bwd_window')),
        'swa grads': swa_grads(torch, np, card),
        'packed grads': packed_grads(torch, np, card),
        'swa decode': swa_decode(torch, np, card),
    }
    print(f'swa: phase took {time.perf_counter() - t:.1f} s', flush=True)
    return paths


# Qwen/Qwen2-7B's config.json on the Hugging Face hub, typed in (no
# download): 28 query heads over 4 kv heads (GQA group 7), head size 128,
# qkv biases, rope_theta 1e6, untied embeddings, no sliding window
QWEN2_7B = {
    'architectures': ['Qwen2ForCausalLM'], 'attention_dropout': 0.0,
    'bos_token_id': 151643, 'eos_token_id': 151643, 'hidden_act': 'silu',
    'hidden_size': 3584, 'initializer_range': 0.02,
    'intermediate_size': 18944, 'max_position_embeddings': 131072,
    'max_window_layers': 28, 'model_type': 'qwen2',
    'num_attention_heads': 28, 'num_hidden_layers': 28,
    'num_key_value_heads': 4, 'rms_norm_eps': 1e-06,
    'rope_theta': 1000000.0, 'sliding_window': 131072,
    'tie_word_embeddings': False, 'torch_dtype': 'bfloat16',
    'use_cache': True, 'use_sliding_window': False, 'vocab_size': 152064}


def qwen2_config():
    """Qwen2-7B's published widths through the port's HF converter."""
    from paddle_tpu_torch.models import hf_qwen2_config

    cfg = hf_qwen2_config(QWEN2_7B)
    if (cfg.num_attention_heads // cfg.num_key_value_heads, cfg.head_dim,
            cfg.attention_bias, cfg.sliding_window) != (7, 128, True, None):
        raise AssertionError(f'hf_qwen2_config mapped Qwen2-7B to {cfg}')
    return cfg


def fp8_linear(torch, model, card):
    """nn.quant's fp8 weight-only linear (K10f8) over layer 0's seven
    projections of the Qwen2-7B-width model, at a decode row (M = 1) and
    a 512-token prompt: weight_quantize(algo='weight_only_fp8'), then
    weight_only_linear with the default weight_dtype, which routes fp8
    codes to K10f8 (the q, k, v biases added). Each output against the
    bf16 product x @ w (bounded by e4m3's rounding: 4 significant bits,
    so |fp8 - bf16| / |bf16| <= 0.05 in L2) and against the plain
    version. Returns the launch counts."""
    from paddle_tpu_torch.nn import quant as nq
    from paddle_tpu_torch.ops.hopper import quant_matmul as k

    attn, mlp = model.model.layers[0].self_attn, model.model.layers[0].mlp
    projs = [('q', attn.q_proj, attn.q_bias), ('k', attn.k_proj, attn.k_bias),
             ('v', attn.v_proj, attn.v_bias), ('o', attn.o_proj, None),
             ('gate', mlp.gate_proj, None), ('up', mlp.up_proj, None),
             ('down', mlp.down_proj, None)]
    with torch.no_grad():
        quant = [(n, w, b, *nq.weight_quantize(w, algo='weight_only_fp8'))
                 for n, w, b in projs]
        dev = model.device
        g = torch.Generator(device=dev).manual_seed(12)
        worst = worst_plain = 0.0
        total = {}
        for M in (1, 512):
            for name, w, b, codes, scale in quant:
                x = torch.randn(M, w.shape[0], device=dev,
                                generator=g).to(torch.bfloat16)
                got, counts = count_launches(
                    torch, lambda: nq.weight_only_linear(
                        x, codes, bias=b, weight_scale=scale))
                if codes.dtype != torch.float8_e4m3fn or counts != dict(
                        dict.fromkeys(counts, 0), quant_matmul_fp8=1):
                    raise AssertionError(f'fp8 linear {name}: codes '
                                         f'{codes.dtype}, launches {counts}')
                add_counts(total, counts)
                dense = (x.float() @ w.float()) + (0 if b is None
                                                   else b.float())
                rel = ((got.float() - dense).norm() / dense.norm()).item()
                plain = k.quant_matmul_fp8_plain(x, codes, scale).float()
                if b is not None:
                    plain = plain + b.float()
                within(got, plain, TENSOR_TOL['bfloat16'],
                       f'fp8 linear {name} M={M} against its plain version')
                worst = max(worst, rel)
                worst_plain = max(worst_plain,
                                  (got.float() - plain).abs().max().item())
    print(f'qwen2 fp8 weights: layer 0\'s 7 projections through '
          f'nn.quant.weight_only_linear (K10f8) at M = 1 and 512: relative '
          f'L2 error against the bf16 product at most {worst:.4f} (bound '
          f'0.05), max |kernel - plain| {worst_plain:.4g}; launches '
          f'{ {k_: v for k_, v in total.items() if v} } [{card}]',
          flush=True)
    if not worst <= 0.05:
        raise AssertionError(f'fp8 linear: relative error {worst} > 0.05')
    return total


def qwen2_agreement(torch, np, card, cfg):
    """Phase 11 (d): at Qwen2-7B's widths with 2 layers in float32, 16
    decode-step logits through the kernels against the plain versions
    (float32 and int8 KV caches, a left-padded batch: agreement_phase's
    bound), DecodeEngine token-equal to generate, and ServingEngine's
    streams over float32 and int8 pools through the kernels equal to the
    plain versions'."""
    from paddle_tpu_torch.inference import ServingEngine

    model = agreement_phase(torch, np, card, cfg=cfg, width='Qwen2-7B',
                            weights=False)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (96, 40, 130, 17)]
    for kv in ('float32', 'int8'):
        kw = dict(SERVE_KW, max_new_tokens=16)
        if kv == 'int8':
            kw['kv_cache_dtype'] = 'int8'
        got, counts = count_launches(
            torch, lambda: ServingEngine(model, **kw).serve(prompts))
        with plain_kernels():
            want = ServingEngine(model, **kw).serve(prompts)
        key = ('paged_decode_attention_int8' if kv == 'int8'
               else 'paged_decode_attention')
        equal = all(np_equal(a, b) for a, b in zip(got, want))
        print(f'qwen2 agreement float32: ServingEngine over {kv} pools, 2 '
              f'layers, {len(prompts)} requests x 16 tokens: streams '
              f'through the kernels equal to the plain versions: {equal}; '
              f'{key} launches {counts[key]} [{card}]', flush=True)
        if not equal or not counts[key]:
            raise AssertionError(f'qwen2 serving over {kv} pools: kernel '
                                 f'and plain streams differ, or {key} never '
                                 f'ran')
    del model
    gc.collect()
    torch.cuda.empty_cache()


def qwen2_phase(torch, np, card):
    """Phase 11: a model at Qwen2-7B's published widths (28 layers, GQA
    group 7, qkv biases; bf16 weights drawn on the card from a seeded
    generator) served and decoded: (a) phase 4's burst through
    ServingEngine over bf16 pools (K1, K8 at group 7), (b) over int8
    pools (K8q), each with exact launches and no leaked page; (c) the
    JAX bench's decode at b1 and b8 over 2048-position caches, bf16 and
    int8 KV (K7 at group 7, exact launches), then DecodeEngine; (e) fp8
    weights through nn.quant (K10f8); (d) float32 agreement at 2 layers.
    Returns the launch counts of its runs by path."""
    from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    t_phase = time.perf_counter()
    cfg = qwen2_config()
    L = cfg.num_hidden_layers
    t = time.perf_counter()
    model = LlamaForCausalLM(dataclasses.replace(cfg, dtype='bfloat16'),
                             seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f'qwen2: Qwen2-7B widths (hf_qwen2_config of its config.json), '
          f'{L} layers, heads {cfg.num_attention_heads} / '
          f'{cfg.num_key_value_heads}, {n_params} parameters, bf16, drawn '
          f'in {time.perf_counter() - t:.1f} s', flush=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 513, 8)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    paths = {}
    for label, kv, kernel in (
            ('qwen2 serving', None, 'paged_decode_attention'),
            ('qwen2 int8 serving', 'int8', 'paged_decode_attention_int8')):
        kw = dict(SERVE_KW) if kv is None else dict(SERVE_KW,
                                                    kv_cache_dtype=kv)
        engine = ServingEngine(model, **kw)
        run = serve_burst(torch, engine, prompts)
        check_burst(label, engine, prompts, cfg.vocab_size, *run, kernel,
                    card)
        paths[label] = run[1]
        del engine, run
        gc.collect()
        torch.cuda.empty_cache()

    decode = {}
    for batch, label, kv8 in ((1, 'qwen2 b1 bf16', False),
                              (8, 'qwen2 b8 bf16', False),
                              (1, 'qwen2 b1 int8 KV', True),
                              (8, 'qwen2 b8 int8 KV', True)):
        add_counts(decode, bench_decode(torch, model, batch, label, card,
                                        kv_int8=kv8, steps=32, reps=2)[2])
        gc.collect()
        torch.cuda.empty_cache()
    eng_steps = 64
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 13))).to(
        model.device)
    eng = DecodeEngine(model, max_new_tokens=eng_steps)
    eng.generate(prompt)

    def timed():
        t = time.perf_counter()
        out = eng.generate(prompt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (out, dt), counts = count_launches(torch, timed)
    expect_launches(counts, L, eng_steps, eng_steps - 1)
    if out.shape != (1, 13 + eng_steps):
        raise AssertionError(f'qwen2 DecodeEngine returned {out.shape}')
    add_counts(decode, counts)
    paths['qwen2 decode'] = decode
    print(f'qwen2 DecodeEngine: {eng_steps / dt:.2f} tokens/s end to end '
          f'(13-token prompt, {eng_steps} new tokens, {dt:.3f} s) [{card}]',
          flush=True)
    del eng
    paths['qwen2 fp8 weights'] = fp8_linear(torch, model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    qwen2_agreement(torch, np, card, cfg)
    print(f'qwen2: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# Phase 12: per-request sampling, prefix caching and chunked prefill
# ---------------------------------------------------------------------------

# the largest |logit| difference a prefix-hit or chunked prefill may show
# against the monolithic one in bf16 at Llama-7B width (max |logit| ~6):
# a rounding-only control (phase 5's float64 RMSNorm, 33 forwards) moves
# the served logits by ~0.3 on the card
CHUNK_BF16_TOL = 0.5


def serving_launches(label, engine, before, after, launches, kernel):
    """The exact launch counts of an engine run: `kernel` L per decode
    forward, K1 2L + 1 per forward of any kind (admission prefill, chunk,
    decode), nothing else (prefill and chunk forwards attend through the
    plain masked path). Returns (decode, prefill, chunk) forwards."""
    from paddle_tpu_torch import ops

    L = engine.model.config.num_hidden_layers
    n = {k: after[k] - before[k] for k in ('decode_forwards',
                                           'prefill_forwards',
                                           'chunk_forwards')}
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want[kernel] = L * n['decode_forwards']
    want['rms_norm'] = (2 * L + 1) * sum(n.values())
    if launches != want:
        raise AssertionError(f'{label}: launch counts {launches} != '
                             f'expected {want} ({n})')
    if engine.allocator.in_use() != 0:
        raise AssertionError(f'{label}: {engine.allocator.in_use()} pages '
                             f'leaked')
    return n['decode_forwards'], n['prefill_forwards'], n['chunk_forwards']


def stepped_run(torch, engine, arrivals, watch=()):
    """Serve `arrivals` [(step index, prompt, submit kwargs)], each
    submitted just before that step, stepping until the engine drains,
    with every launch count set to 0 just before and read just after.
    Returns (wall, launches, stats before, stats after, outputs in
    arrival order, each request's time from its submission to its first
    token, [(step wall, tokens each `watch` arrival committed in it)])."""
    from paddle_tpu_torch import ops

    def generated(rid):
        req = engine._live.get(rid) or engine._terminal.get(rid)
        return len(req.generated)

    def watched():
        # arrivals not submitted yet have generated nothing
        return [generated(rids[w]) if w < len(rids) else 0 for w in watch]

    before = engine.stats()
    torch.cuda.synchronize()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    last = max(at for at, _p, _kw in arrivals)
    rids, sent, first, steps = [], {}, {}, []
    t0 = time.perf_counter()
    i = 0
    while i <= last or len(engine.queue) or engine.in_flight():
        for at, p, kw in arrivals:
            if at == i:
                rids.append(engine.submit(p, **kw))
                sent[rids[-1]] = time.perf_counter()
        n0 = watched()
        t = time.perf_counter()
        engine.step()
        now = time.perf_counter()
        steps.append((now - t, [n1 - n for n1, n in zip(watched(), n0)]))
        for r in rids:
            if r not in first and generated(r):
                first[r] = now - sent[r]
        i += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    after = engine.stats()
    outs = [engine.result(r) for r in rids]
    return wall, launches, before, after, outs, [first[r] for r in rids], \
        steps


def check_outputs(label, prompts, outs, vocab, new_tokens):
    for p, o, m in zip(prompts, outs, new_tokens):
        if o is None or len(o) != len(p) + m or not np_equal(o[:len(p)], p):
            raise AssertionError(f'{label}: a request did not return '
                                 f'prompt + {m} ids')
        if o.min() < 0 or o.max() >= vocab:
            raise AssertionError(f'{label}: a returned id is outside the '
                                 f'vocabulary')


def prefill_logits(torch, model, prompt, cuts):
    """The last-token logits of `prompt` through a private page pool:
    `cuts` None is one monolithic prefill (the admission path); else the
    prompt's first cuts[0] tokens (if any) prefill monolithically and
    each later span up to the next cut (or the end) is one chunk forward
    over the gathered prefix (`_chunk_kv`, the prefix-hit / chunked
    path)."""
    from paddle_tpu_torch.inference.engine import bucket_length
    from paddle_tpu_torch.inference.serving import _chunk_kv, _prefill_kv

    BS = 16
    dev = model.device
    n_pages = math.ceil(len(prompt) / BS)
    pages = model.init_paged_cache(n_pages + 1, BS)
    btab = torch.arange(1, n_pages + 1, dtype=torch.int32,
                        device=dev)[None]
    ids = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    edges = [len(prompt)] if cuts is None else list(cuts) + [len(prompt)]
    with torch.no_grad():
        p0 = edges[0]
        if p0:
            last, pages = _prefill_kv(
                model, pages, torch.nn.functional.pad(
                    ids[:, :p0], (0, bucket_length(p0) - p0)),
                torch.tensor([p0], device=dev), btab)
        for lo, hi in zip(edges, edges[1:]):
            Cb = bucket_length(hi - lo)
            chunk = torch.nn.functional.pad(ids[:, lo:hi],
                                            (0, Cb - (hi - lo)))
            last, pages = _chunk_kv(
                model, pages, chunk, torch.tensor([hi - lo], device=dev),
                torch.tensor([lo], device=dev), btab, bucket_length(lo + Cb))
    return last.float()


def logits_gap(torch, model, prompt, cuts, label, tol):
    """max |logit| difference of the cut prefill against the monolithic
    one, printed and held to `tol`."""
    mono = prefill_logits(torch, model, prompt, None)
    cut = prefill_logits(torch, model, prompt, cuts)
    gap = float((cut - mono).abs().max())
    same = int(cut.argmax()) == int(mono.argmax())
    print(f'{label}: {len(prompt)}-token prompt, last-token logits against '
          f'the monolithic prefill: max |Δ| {gap:.6g} (bound {tol}, max '
          f'|logit| {float(mono.abs().max()):.4f}), argmax equal {same}')
    if not gap <= tol:
        raise AssertionError(f'{label}: logits moved {gap} > {tol}')


def pct(np, xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def prefix_phase(torch, np, card):
    """Phase 12: per-request sampling, prefix caching and chunked prefill
    at Llama-7B width (32 layers, bf16 weights drawn on the card from a
    seeded generator), ServingEngine(max_slots=4, block_size=16,
    decode_window=8, max_new_tokens=32): (a) prefix_cache=True against
    the same burst with it off, in turns off / on / on / off (8
    requests of one 512-token system prompt plus 32-128 tokens); (b) prefill_chunk=256 against the
    monolithic engine (two 1536-token prompts arriving while two short
    streams decode: the short streams' inter-token latency); (c) four
    sampled rows beside four greedy rows (sampled streams equal across
    two runs and two batch orders, greedy rows equal to the greedy-only
    run); (d) an int8 pool with both features; each run with exact K1 /
    K8 / K8q launches and no page held after it; the bf16 logits gap of
    a hit and of a chunked prefill; then at 2 layers in float32 the
    streams of both features equal to the monolithic engine's over
    float32 and int8 pools, and a one-token forward with per-row offsets
    over a contiguous cache through K7 equal to the plain versions.
    Returns the launch counts of its runs by path."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama_7b(), dtype='bfloat16')
    V = cfg.vocab_size
    model = LlamaForCausalLM(cfg, seed=0)
    rng = np.random.default_rng(12)
    system = rng.integers(3, V, 512).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(3, V, n)]).astype(
        np.int32) for n in rng.integers(32, 129, 8)]
    warm = np.concatenate([system, rng.integers(3, V, 40)]).astype(
        np.int32)
    paths = {}

    # (a) prefix cache off / on / on / off over the same burst (the
    # steps are host-bound and swing between runs: compare in turns)
    res = {}
    for run, cached in enumerate((False, True, True, False), start=1):
        engine = ServingEngine(model, prefix_cache=cached, **SERVE_KW)
        # warm-up, not measured: with the cache on it indexes the system
        # prompt, as a served system prompt would have been
        engine.serve([warm], max_new_tokens=8)
        label = f'prefix {"on" if cached else "off"} (run {run})'
        wall, launches, before, after, outs, first, _ = stepped_run(
            torch, engine, [(0, p, {}) for p in prompts])
        check_outputs(label, prompts, outs, V, [32] * 8)
        serving_launches(label, engine, before, after, launches,
                         'paged_decode_attention')
        paths[label] = launches
        n_tok = after['tokens_generated'] - before['tokens_generated']
        pre = after['prefill_tokens'] - before['prefill_tokens']
        pfx = after['prefix']
        res[cached] = outs, pre
        waves = sorted(first)
        print(f'{label}: 8 requests of a 512-token system prompt + '
              f'{[len(p) - 512 for p in prompts]} tokens, {n_tok} tokens '
              f'in {wall:.3f} s: {n_tok / wall:.1f} tok/s, TTFT p50 '
              f'{pct(np, first, 50) * 1e3:.1f} ms (first wave mean '
              f'{sum(waves[:4]) / 4 * 1e3:.1f}, second '
              f'{sum(waves[4:]) / 4 * 1e3:.1f}), prefill tokens computed '
              f'{pre}, hits {pfx["hits"]}, hit tokens {pfx["hit_tokens"]}, '
              f'chunk forwards '
              f'{after["chunk_forwards"] - before["chunk_forwards"]} '
              f'[{card}]', flush=True)
        del engine
    (off, pre_off), (on, pre_on) = res[False], res[True]
    same = [int(np.sum(np.cumprod(a[len(p):] == b[len(p):])))
            for p, a, b in zip(prompts, on, off)]
    print(f'prefix: prefill tokens computed {pre_on} with the cache, '
          f'{pre_off} without ({pre_on / pre_off:.3f}); leading tokens '
          f'equal per request {same} of 32 (printed, not asserted: bf16 '
          f'sums a hit in another order)')
    if not pre_on < pre_off:
        raise AssertionError('prefix: the cache computed no fewer tokens')
    logits_gap(torch, model, prompts[0], [512], 'prefix bf16 hit',
               CHUNK_BF16_TOL)

    # (b) two long prompts arriving while two short streams decode
    short = [rng.integers(3, V, 64).astype(np.int32) for _ in range(2)]
    long = [rng.integers(3, V, 1536).astype(np.int32) for _ in range(2)]
    arrivals = ([(0, p, dict(max_new_tokens=96)) for p in short]
                + [(2, p, {}) for p in long])
    for chunk in (None, 256):
        engine = ServingEngine(model, prefill_chunk=chunk, **SERVE_KW)
        engine.serve([short[0][:32]], max_new_tokens=8)
        label = 'chunked 256' if chunk else 'monolithic'
        wall, launches, before, after, outs, first, steps = stepped_run(
            torch, engine, arrivals, watch=(0, 1))
        check_outputs(label, short + long, outs, V, [96, 96, 32, 32])
        serving_launches(label, engine, before, after, launches,
                         'paged_decode_attention')
        paths[label] = launches
        # the short streams' per-token latency from the long arrivals on:
        # each step's wall over the window's tokens, once per token
        itl = [w / k for w, ns in steps[2:] for k in ns if k
               for _ in range(k)]
        print(f'{label}: short streams ITL while two 1536-token prompts '
              f'prefill: p50 {pct(np, itl, 50) * 1e3:.1f} ms, p90 '
              f'{pct(np, itl, 90) * 1e3:.1f}, max {max(itl) * 1e3:.1f} over '
              f'{len(itl)} tokens; long prompts TTFT '
              f'{first[2] * 1e3:.1f} / {first[3] * 1e3:.1f} ms; '
              f'{after["chunk_forwards"] - before["chunk_forwards"]} chunk '
              f'forwards, {after["prefill_forwards"] - before["prefill_forwards"]} '
              f'prefills, {len(steps)} steps in {wall:.3f} s [{card}]',
              flush=True)
        if chunk:
            # one step of a 256-token chunk of each long prompt (past
            # their first) beside the short streams' window
            rids = [engine.submit(p, max_new_tokens=16) for p in short]
            engine.step()
            rids += [engine.submit(p, max_new_tokens=8) for p in long]
            engine.step()
            trace_step(torch, engine, card, 'chunk profile',
                       'one step of a 2 x 256-token chunk forward and a '
                       f'window of {engine.decode_window}')
            engine.run()
            for r in rids:
                engine.result(r)
        del engine
    logits_gap(torch, model, long[0], list(range(0, 1536, 256)),
               'chunked bf16', CHUNK_BF16_TOL)

    # (c) sampled rows beside greedy rows: one bucket, equal budgets, so
    # every admission wave is one prefill of 4 rows of the same shape
    sp = [rng.integers(3, V, n).astype(np.int32)
          for n in rng.integers(33, 65, 8)]
    sampled = [(p, dict(temperature=0.8, top_k=50, top_p=0.95, seed=s))
               for s, p in enumerate(sp[:4], start=1)]
    greedy = [(p, {}) for p in sp[4:]]
    mixed = [j for pair in zip(sampled, greedy) for j in pair]
    got = {}
    for name, jobs in (('mixed', mixed), ('again', mixed),
                       ('reversed', mixed[::-1]), ('greedy only', greedy)):
        engine = ServingEngine(model, **SERVE_KW)
        wall, launches, before, after, outs, _f, _s = stepped_run(
            torch, engine, [(0, p, kw) for p, kw in jobs])
        check_outputs(f'sampling {name}', [p for p, _ in jobs], outs, V,
                      [32] * len(jobs))
        serving_launches(f'sampling {name}', engine, before, after,
                         launches, 'paged_decode_attention')
        paths[f'sampling {name}'] = launches
        by = {id(p): o for (p, _), o in zip(jobs, outs)}
        got[name] = [by.get(id(p)) for p in sp]
        n_tok = after['tokens_generated'] - before['tokens_generated']
        print(f'sampling {name}: {len(jobs)} requests, {n_tok} tokens in '
              f'{wall:.3f} s: {n_tok / wall:.1f} tok/s [{card}]', flush=True)
        del engine
    rep = all(np_equal(got['mixed'][i], got[k][i]) for i in range(4)
              for k in ('again', 'reversed'))
    grd = all(np_equal(got['mixed'][i], got['greedy only'][i])
              for i in range(4, 8))
    print(f'sampling: sampled streams (temperature 0.8, top_k 50, top_p '
          f'0.95) equal across two runs and two batch orders: {rep}; greedy '
          f'rows equal to the greedy-only run: {grd}')
    if not (rep and grd):
        raise AssertionError('sampling: streams depend on the run or the '
                             'batch')

    # (d) an int8 pool with both features
    engine = ServingEngine(model, kv_cache_dtype='int8', prefix_cache=True,
                           prefill_chunk=256, **SERVE_KW)
    engine.serve([warm], max_new_tokens=8)
    wall, launches, before, after, outs, first, _ = stepped_run(
        torch, engine, [(0, p, {}) for p in prompts]
        + [(1, p, {}) for p in long])
    check_outputs('int8 prefix+chunked', prompts + long, outs, V, [32] * 10)
    serving_launches('int8 prefix+chunked', engine, before, after, launches,
                     'paged_decode_attention_int8')
    paths['int8 prefix+chunked'] = launches
    n_tok = after['tokens_generated'] - before['tokens_generated']
    pfx = after['prefix']
    print(f'int8 prefix+chunked: 8 system-prompt requests + two 1536-token '
          f'prompts, {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} '
          f'tok/s, TTFT p50 {pct(np, first, 50) * 1e3:.1f} ms, hits '
          f'{pfx["hits"]}, hit tokens {pfx["hit_tokens"]}, chunked '
          f'admissions {pfx["chunked_admissions"]}, chunk steps '
          f'{pfx["chunk_steps"]}, prefill tokens '
          f'{after["prefill_tokens"] - before["prefill_tokens"]} [{card}]',
          flush=True)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    prefix_agreement(torch, np, card, system, prompts, long)
    print(f'prefix: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return paths


def prefix_agreement(torch, np, card, system, prompts, long):
    """At Llama-7B width, 2 layers, float32: the streams of an engine
    with both features equal to the monolithic engine's over float32 and
    int8 pools (asserted), and a one-token forward with per-row write
    offsets over a contiguous cache (K7, L launches) equal to the plain
    versions within 1e-3."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = dataclasses.replace(llama_7b(), num_hidden_layers=2,
                              dtype='float32')
    model = LlamaForCausalLM(cfg, seed=2)
    # a 256-token system prompt (16 pages) with the burst's suffixes, and
    # a 700-token prompt that prefills in chunks of 128
    jobs = [np.concatenate([system[:256], p[512:]]) for p in prompts[:4]]
    jobs.append(long[0][:700])
    for kv in (None, 'int8'):
        kw = dict(SERVE_KW, max_new_tokens=16, kv_cache_dtype=kv)
        want = ServingEngine(model, **kw).serve(jobs)
        engine = ServingEngine(model, prefix_cache=True, prefill_chunk=128,
                               **kw)
        engine.serve([system[:256]], max_new_tokens=4)
        got = engine.serve(jobs)
        equal = all(np_equal(a, b) for a, b in zip(got, want))
        s = engine.stats()['prefix']
        name = 'int8' if kv else 'float32'
        print(f'prefix agreement float32, {name} pools, Llama-7B width, 2 '
              f'layers: {len(jobs)} requests x 16 tokens with prefix_cache '
              f'and prefill_chunk=128 ({s["hits"]} hits, '
              f'{s["chunked_admissions"]} chunked admissions, '
              f'{s["chunk_steps"]} chunk steps) equal to the monolithic '
              f'engine: {equal} [{card}]', flush=True)
        if not (equal and s['hits'] and s['chunk_steps']
                and engine.allocator.in_use() == 0):
            raise AssertionError(f'prefix agreement ({name} pools): streams '
                                 f'differ, no hit or chunk, or pages held')

    # one-token steps at per-row offsets over a contiguous cache
    dev = model.device
    starts = torch.tensor([0, 37, 100, 5], device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    ids = torch.randint(3, cfg.vocab_size, (4, 17), device=dev,
                        generator=gen)

    def run():
        caches = model.init_cache(4, 160)
        with torch.no_grad():
            model(ids[:, :16], caches=caches, kv_write_pos=starts)
            logits, _ = model(ids[:, 16:], caches=caches,
                              kv_write_pos=starts + 16)
        return logits.float()

    got, counts = count_launches(torch, run)
    with plain_kernels():
        want = run()
    L = cfg.num_hidden_layers
    gap = float((got - want).abs().max())
    print(f'per-row offsets over a contiguous cache, float32: a 16-token '
          f'chunk then a one-token step at starts {starts.tolist()}: '
          f'decode_attention launches {counts["decode_attention"]} (L = '
          f'{L}), max |kernels - plain| logit {gap:.6g} (bound 1e-3)')
    if counts['decode_attention'] != L or not gap <= 1e-3:
        raise AssertionError('per-row offsets: K7 not launched once per '
                             'layer, or logits off the plain versions')
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 13: speculative decoding
# ---------------------------------------------------------------------------

# the largest |logit| difference the target's (k + 1)-token verify forward
# may show against one-token decode forwards over the same tokens in bf16
# at Llama-7B width: the verify's GEMMs run at M = k + 1 and its attention
# is the float32 masked path where decode takes K7, so the two round
# differently, as a chunk does against a monolithic prefill
SPEC_BF16_TOL = 0.5
SPEC_K = 4


def leading_equal(np, a, b):
    """How many leading tokens two streams share."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(len(a), len(b))
    return int(np.sum(np.cumprod(a[:n] == b[:n])))


def spec_decode_launches(label, stats, Lt, Ld, got, quant=None):
    """The exact launch counts of a DecodeEngine.generate_speculative run
    from its stats: K7 only in the draft's one-token steps (Ld a step),
    K1 2L + 1 a forward of either model, K10 7Ld + 1 a forward of a draft
    with int8 weights, nothing else."""
    n_t = stats['prefill_forwards'] + stats['verify_forwards']
    n_d = stats['draft_prefill_forwards'] + stats['draft_decode_forwards']
    want = dict.fromkeys(got, 0)
    want.update(rms_norm=(2 * Lt + 1) * n_t + (2 * Ld + 1) * n_d,
                decode_attention=Ld * stats['draft_decode_forwards'])
    if quant:
        want[quant] = (7 * Ld + 1) * n_d
    if got != want:
        raise AssertionError(f'{label}: launch counts {got} != expected '
                             f'{want}')


def spec_serving_launches(label, engine, before, after, launches, kernel,
                          quant=None):
    """The exact launch counts of a speculative engine's run: `kernel` L
    per one-token forward of either model (the target's decode windows,
    the draft's k + 1 steps a speculative window), K1 2L + 1 per forward
    of either model of any kind, K10 7L + 1 per forward of an int8-weight
    draft, nothing else (prefills, chunks, catch-ups and verifies attend
    through the plain masked path). Returns the speculative counts."""
    from paddle_tpu_torch import ops

    Lt = engine.model.config.num_hidden_layers
    Ld = engine.draft.config.num_hidden_layers
    n = {k: after[k] - before[k] for k in ('decode_forwards',
                                           'prefill_forwards',
                                           'chunk_forwards')}
    sa, sb = after['spec'], before['spec']
    n['verify_forwards'] = sa['verify_forwards'] - sb['verify_forwards']
    d = {k: sa['draft_forwards'][k] - sb['draft_forwards'][k]
         for k in sa['draft_forwards']}
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want[kernel] = Lt * n['decode_forwards'] + Ld * d['decode']
    want['rms_norm'] = ((2 * Lt + 1) * sum(n.values())
                        + (2 * Ld + 1) * sum(d.values()))
    if quant:
        want[quant] = (7 * Ld + 1) * sum(d.values())
    if launches != want:
        raise AssertionError(f'{label}: launch counts {launches} != '
                             f'expected {want} ({n}, draft {d})')
    if engine.allocator.in_use() != 0:
        raise AssertionError(f'{label}: {engine.allocator.in_use()} pages '
                             f'held after the run')
    return {k: sa[k] - sb[k] for k in ('windows', 'proposed', 'accepted')}


def layer_draft(torch, model, layers, seed=3):
    """A draft of `layers` layers at the model's widths carrying the
    model's embedding, final norm, head and first `layers` layers over
    through the npz state format's names (framework.io)."""
    from paddle_tpu_torch.framework import io
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = dataclasses.replace(model.config, num_hidden_layers=layers)
    draft = LlamaForCausalLM(cfg, device=model.device, seed=seed)
    keep = {f'model.layers.{i}.' for i in range(layers)}
    flat = {io.jax_name(k): io.to_numpy(v)
            for k, v in model.state_dict().items()
            if not k.startswith('model.layers.')
            or any(k.startswith(p) for p in keep)}
    io.load_jax_state(draft, flat)
    torch.cuda.synchronize()
    return draft


def timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def verify_gap(torch, model, prompt, tokens, k, tol):
    """max |logit| difference of one (k + 1)-token verify forward against
    k + 1 one-token decode forwards over the same tokens after the same
    prefill (contiguous bf16 caches), printed and held to `tol`."""
    dev = model.device
    S = prompt.shape[1]
    win = torch.as_tensor(tokens[:k + 1], device=dev)[None]
    rows = []
    with torch.no_grad():
        for verify in (False, True):
            caches = model.init_cache(1, S + k + 1)
            model(prompt, caches=caches, cache_index=0)
            if verify:
                logits, _ = model(win, caches=caches, cache_index=S)
                rows.append(logits[0].float())
            else:
                rows.append(torch.cat([model(
                    win[:, i:i + 1], caches=caches, cache_index=S + i)[0][0]
                    for i in range(k + 1)]).float())
    gap = float((rows[0] - rows[1]).abs().max())
    print(f'spec bf16: a {k + 1}-token verify forward against {k + 1} '
          f'one-token decode forwards after a {S}-token prefill: max |Δ| '
          f'logit {gap:.6g} (bound {tol}, max |logit| '
          f'{float(rows[0].abs().max()):.4f}), argmax equal '
          f'{bool(torch.equal(rows[0].argmax(-1), rows[1].argmax(-1)))}')
    if not gap <= tol:
        raise AssertionError(f'spec bf16: verify logits moved {gap} > {tol}')


def spec_warmup(eng, draft, prompt_lens, B, k, label, card):
    """DecodeEngine.warmup over the decode_spec geometries of these
    prompt lengths at batch B and the engine's budget (the windows of
    the calls that follow, captured before them); prints the report and
    each window's capture seconds and reserved bytes."""
    from paddle_tpu_torch.inference.graphs import for_decode_engine
    from paddle_tpu_torch.models.generation import _decode_graphs

    geos = [g for g in for_decode_engine(eng, prompt_lens,
                                         spec_draft_tokens=[k],
                                         spec_batch_sizes=(B,))
            if g.kind == 'decode_spec']
    report = eng.warmup(geometries=geos, draft=draft)
    g = _decode_graphs(eng, eng.model).spec_runners[draft].stats()
    print(f'{label}: warmup {report}; per speculative geometry capture '
          f'{g["capture_s"]} s, reserved {g["reserved_bytes"]} bytes '
          f'[{card}]', flush=True)


def spec_generate_b1(torch, np, model, drafts, card, total):
    """(a) speculative decoding at batch 1 (512-token prompt, 64 new
    tokens, k = 4) with each draft against model.generate in the same
    call: timed through DecodeEngine.generate_speculative, whose stats
    give the exact accept counts and launches (it runs the loop of
    generate_speculative, whose own runs part (d) holds)."""
    from paddle_tpu_torch.inference import DecodeEngine

    V = model.config.vocab_size
    L = model.config.num_hidden_layers
    N, k = 64, SPEC_K
    prompt = torch.from_numpy(np.random.default_rng(13).integers(
        3, V, (1, 512))).to(model.device)
    model.generate(prompt, max_new_tokens=N)   # warm: captures the step
    ref, t_ref = timed(torch, lambda: model.generate(prompt,
                                                     max_new_tokens=N))
    ref = ref[0, 512:].tolist()
    print(f'spec generate b1: model.generate, {N} tokens after a 512-token '
          f'prompt: {N / t_ref:.2f} tok/s ({t_ref:.3f} s) [{card}]')
    verify_gap(torch, model, prompt, ref, k, SPEC_BF16_TOL)
    for name, draft, quant in drafts:
        Ld = draft.config.num_hidden_layers
        eng = DecodeEngine(model, max_new_tokens=N)
        spec_warmup(eng, draft, [512], 1, k, f'spec generate b1 {name}',
                    card)
        (out, t_spec), counts = count_launches(torch, lambda: timed(
            torch, lambda: eng.generate_speculative(draft, prompt,
                                                    num_draft_tokens=k)))
        s = eng.stats()
        spec_decode_launches(f'spec generate b1 {name}', s, L, Ld, counts,
                             quant)
        add_counts(total, counts)
        got = out[0, 512:].tolist()
        check_outputs(f'spec generate b1 {name}', [prompt[0].cpu().numpy()],
                      out.cpu().numpy(), V, [N])
        sp = s['spec']
        lead = leading_equal(np, got, ref)
        print(f'spec generate b1 (through DecodeEngine, windows '
              f'replayed), draft {name}: '
              f'{N / t_spec:.2f} tok/s ({t_spec:.3f} s, '
              f'{t_ref / t_spec:.3f}x model.generate replayed), '
              f'k {k}, {sp["windows"]} windows, accept rate '
              f'{sp["accept_rate"]:.4f} ({sp["accepted"]} of '
              f'{sp["proposed"]}), target forwards per token '
              f'{(1 + sp["windows"]) / N:.4f} (generate: 1), first '
              f'divergence from generate at token '
              f'{lead if lead < N else "none"} of {N} (printed, not '
              f'asserted: bf16); launches '
              f'{ {k_: v for k_, v in counts.items() if v} } [{card}]',
              flush=True)


def spec_generate_b8(torch, np, model, draft, card, total):
    """(b) DecodeEngine.generate_speculative at batch 8 (rows commit at
    their own rates: the draft's K7 at per-row lengths) against
    model.generate on the same prompts, exact launches."""
    from paddle_tpu_torch.inference import DecodeEngine

    V = model.config.vocab_size
    L, Ld = model.config.num_hidden_layers, draft.config.num_hidden_layers
    N, k = 32, SPEC_K
    ids = torch.from_numpy(np.random.default_rng(14).integers(
        3, V, (8, 256))).to(model.device)
    model.generate(ids, max_new_tokens=N)      # warm: captures the step
    ref, t_ref = timed(torch, lambda: model.generate(ids, max_new_tokens=N))
    eng = DecodeEngine(model, max_new_tokens=N)
    spec_warmup(eng, draft, [256], 8, k, 'spec DecodeEngine b8', card)
    before = eng.stats()
    (out, t_spec), counts = count_launches(torch, lambda: timed(
        torch, lambda: eng.generate_speculative(draft, ids,
                                                num_draft_tokens=k)))
    s = eng.stats()
    delta = {key: s[key] - before[key] for key in (
        'prefill_forwards', 'verify_forwards', 'draft_prefill_forwards',
        'draft_decode_forwards')}
    spec_decode_launches('spec DecodeEngine b8', delta, L, Ld, counts)
    add_counts(total, counts)
    sp = {key: s['spec'][key] - before['spec'][key]
          for key in ('windows', 'proposed', 'accepted')}
    leads = [leading_equal(np, out[b, 256:].tolist(), ref[b, 256:].tolist())
             for b in range(8)]
    print(f'spec DecodeEngine b8 (windows replayed), 2-layer draft: '
          f'{8 * N / t_spec:.2f} tok/s ({t_spec:.3f} s; model.generate b8 '
          f'replayed {8 * N / t_ref:.2f}, {t_ref / t_spec:.3f}x), '
          f'{sp["windows"]} windows, accept rate '
          f'{sp["accepted"] / sp["proposed"]:.4f}, leading tokens equal to '
          f'generate per row {leads} of {N} (printed: bf16); launches '
          f'{ {k_: v for k_, v in counts.items() if v} } [{card}]',
          flush=True)


def spec_serving(torch, np, model, draft, card, paths):
    """(c) ServingEngine(draft=int8 copy, num_draft_tokens=4): phase 4's
    burst over bf16 and int8 pools against the non-speculative engine in
    the same call (tok/s, TTFT, ITL), exact launches, no held page; then
    four sampled rows beside four greedy ones, equal across two runs and
    two batch orders."""
    from paddle_tpu_torch.inference import ServingEngine

    V = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, V, n).astype(np.int32)
               for n in rng.integers(32, 513, 8)]
    arrivals = ([(0, p, {}) for p in prompts[:2]]
                + [(1, p, {}) for p in prompts[2:4]]
                + [(2, p, {}) for p in prompts[4:]])
    for kv in (None, 'int8'):
        kernel = ('paged_decode_attention_int8' if kv
                  else 'paged_decode_attention')
        outs = {}
        for spec in (False, True):
            kw = dict(SERVE_KW, kv_cache_dtype=kv)
            if spec:
                kw.update(draft=draft, num_draft_tokens=SPEC_K)
            engine = ServingEngine(model, **kw)
            label = (f'spec serving {kv or "bf16"} '
                     f'{"speculative" if spec else "plain"}')
            if spec:
                # every verify ctx bucket the burst's contexts reach
                report = engine.warmup(geometries=engine.geometries(
                    prompt_lens=[32] + [len(p) for p in prompts],
                    max_new_tokens=32))
                g = engine.stats()['graphs']
                print(f'{label}: warmup {report}; per geometry capture '
                      f'{g["capture_s"]} s, reserved {g["reserved_bytes"]} '
                      f'bytes [{card}]', flush=True)
            engine.serve([prompts[0][:32]], max_new_tokens=8)    # warm
            wall, launches, before, after, out, first, steps = stepped_run(
                torch, engine, arrivals, watch=range(8))
            check_outputs(label, prompts, out, V, [32] * 8)
            if spec:
                sc = spec_serving_launches(label, engine, before, after,
                                           launches, kernel, 'quant_matmul')
            else:
                serving_launches(label, engine, before, after, launches,
                                 kernel)
            paths[label] = launches
            itl = []
            for r in range(8):
                seen = False
                for w, ns in steps:
                    if ns[r] and seen:
                        itl += [w / ns[r]] * ns[r]
                    seen = seen or bool(ns[r])
            n_tok = after['tokens_generated'] - before['tokens_generated']
            extra = ''
            if spec:
                extra = (f', {sc["windows"]} speculative windows, accept '
                         f'rate {sc["accepted"] / sc["proposed"]:.4f}, '
                         f"stats()['spec'] {after['spec']}")
            print(f'{label}: 8 requests in three waves, {n_tok} tokens in '
                  f'{wall:.3f} s: {n_tok / wall:.1f} tok/s, TTFT p50 '
                  f'{pct(np, first, 50) * 1e3:.1f} ms p90 '
                  f'{pct(np, first, 90) * 1e3:.1f} max '
                  f'{max(first) * 1e3:.1f}, ITL p50 '
                  f'{pct(np, itl, 50) * 1e3:.1f} ms p90 '
                  f'{pct(np, itl, 90) * 1e3:.1f} max {max(itl) * 1e3:.1f}, '
                  f'{len(steps)} steps{extra} [{card}]', flush=True)
            outs[spec] = out
            if spec and kv is None:
                for p in prompts[:4]:
                    engine.submit(p, max_new_tokens=16)
                engine.step()                 # admissions: not traced
                trace_step(torch, engine, card, 'spec profile',
                           f'one speculative window (k = {SPEC_K}) x 4 '
                           f'rows')            # the rest is not served
            del engine
            gc.collect()
        same = [leading_equal(np, a[len(p):], b[len(p):])
                for p, a, b in zip(prompts, outs[True], outs[False])]
        print(f'spec serving {kv or "bf16"}: leading tokens equal to the '
              f'non-speculative engine per request {same} of 32 (printed, '
              f'not asserted: bf16 verify rounds apart from decode)')
        torch.cuda.empty_cache()

    # sampled rows beside greedy rows in one speculative engine of 8
    # slots: one admission wave, so a batch order only permutes the slots
    # (in bf16 a row's verify logits move with the batch's shapes: the
    # prefill's rows, the gathered length of the longest context)
    sp = [rng.integers(3, V, n).astype(np.int32)
          for n in rng.integers(33, 65, 8)]
    sampled = [(p, dict(temperature=0.8, top_k=50, top_p=0.95, seed=s))
               for s, p in enumerate(sp[:4], start=1)]
    mixed = [j for pair in zip(sampled, [(p, {}) for p in sp[4:]])
             for j in pair]
    got = {}
    for name, jobs in (('mixed', mixed), ('again', mixed),
                       ('reversed', mixed[::-1])):
        engine = ServingEngine(model, draft=draft, num_draft_tokens=SPEC_K,
                               **dict(SERVE_KW, max_slots=8,
                                      max_context_len=256,
                                      max_new_tokens=8))
        wall, launches, before, after, outs, _f, _s = stepped_run(
            torch, engine, [(0, p, kw) for p, kw in jobs])
        label = f'spec sampling {name}'
        check_outputs(label, [p for p, _ in jobs], outs, V,
                      [8] * len(jobs))
        sc = spec_serving_launches(label, engine, before, after, launches,
                                   'paged_decode_attention', 'quant_matmul')
        paths[label] = launches
        by = {id(p): o for (p, _), o in zip(jobs, outs)}
        got[name] = [by[id(p)] for p in sp]
        print(f'{label}: 4 sampled + 4 greedy requests, '
              f'{after["tokens_generated"] - before["tokens_generated"]} '
              f'tokens in {wall:.3f} s, accept rate '
              f'{sc["accepted"] / sc["proposed"]:.4f} [{card}]', flush=True)
        del engine
    rep = all(np_equal(got['mixed'][i], got[k_][i]) for i in range(8)
              for k_ in ('again', 'reversed'))
    print(f'spec sampling: streams (temperature 0.8, top_k 50, top_p 0.95 '
          f'beside greedy, 8 slots) equal across two runs and two batch '
          f'orders: {rep}')
    if not rep:
        raise AssertionError('spec sampling: streams depend on the run or '
                             'the batch')


def spec_agreement(torch, np, card, total):
    """(d) Llama-7B width, 2 layers, float32, through the kernels and
    through the plain versions: the greedy streams of
    generate_speculative, DecodeEngine and ServingEngine (float32 and
    int8 pools, prefix_cache and prefill_chunk=256) equal to their
    non-speculative streams; a self-draft accepts every proposal (its
    prefix-hit and chunked rows included)."""
    from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
    from paddle_tpu_torch.models.generation import generate_speculative
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = dataclasses.replace(llama_7b(), num_hidden_layers=2,
                              dtype='float32')
    V = cfg.vocab_size
    model = LlamaForCausalLM(cfg, seed=4)
    draft = layer_draft(torch, model, 1)
    rng = np.random.default_rng(15)
    ids = torch.from_numpy(rng.integers(3, V, (1, 40))).to(model.device)
    ids3 = torch.from_numpy(rng.integers(3, V, (3, 40))).to(model.device)
    checks = []
    for label, d, x in (('generate_speculative b1', draft, ids),
                        ('generate_speculative b3', draft, ids3),
                        ('generate_speculative b1 self-draft', model, ids)):
        want = model.generate(x, max_new_tokens=16)
        got, counts = count_launches(torch, lambda: generate_speculative(
            model, d, x, max_new_tokens=16, num_draft_tokens=SPEC_K))
        add_counts(total, counts)
        with plain_kernels(), direct_steps():
            plain = generate_speculative(model, d, x, max_new_tokens=16,
                                         num_draft_tokens=SPEC_K)
        checks.append((label, torch.equal(got, want)
                       and torch.equal(got, plain), None))
    eng = DecodeEngine(model, max_new_tokens=16)
    got, counts = count_launches(torch, lambda: eng.generate_speculative(
        model, ids3, num_draft_tokens=SPEC_K))
    spec_decode_launches('spec agreement DecodeEngine', eng.stats(), 2, 2,
                         counts)
    add_counts(total, counts)
    checks.append(('DecodeEngine b3 self-draft', torch.equal(
        got, model.generate(ids3, max_new_tokens=16)),
        eng.stats()['spec']['accept_rate']))
    system = rng.integers(3, V, 256)
    jobs = [np.concatenate([system, rng.integers(3, V, n)])
            for n in (40, 70, 100, 9)] + [rng.integers(3, V, 700)]
    for kv in (None, 'int8'):
        kernel = ('paged_decode_attention_int8' if kv
                  else 'paged_decode_attention')
        # decode_window = k + 1 and budgets of its multiples: no
        # speculative window is cut short, so a self-draft reads 1.0
        kw = dict(SERVE_KW, max_new_tokens=10, decode_window=SPEC_K + 1,
                  kv_cache_dtype=kv, prefix_cache=True, prefill_chunk=256)
        want = ServingEngine(model, **kw).serve(jobs)
        for label, d in (('draft', draft), ('self-draft', model)):
            engine = ServingEngine(model, draft=d, num_draft_tokens=SPEC_K,
                                   **kw)
            engine.serve([system], max_new_tokens=5)   # index the prompt
            wall, launches, before, after, got, _f, _s = stepped_run(
                torch, engine, [(0, p, {}) for p in jobs[:2]]
                + [(1, p, {}) for p in jobs[2:]])
            spec_serving_launches(f'spec agreement {kv} {label}', engine,
                                  before, after, launches, kernel)
            add_counts(total, launches)
            pf = after['prefix']
            if not (pf['hits'] and pf['chunked_admissions']):
                raise AssertionError('spec agreement: no prefix hit or no '
                                     'chunked admission')
            ok = all(np_equal(a, b) for a, b in zip(got, want))
            if label == 'draft':
                with plain_kernels():
                    pe = ServingEngine(model, draft=d,
                                       num_draft_tokens=SPEC_K, **kw)
                    pe.serve([system], max_new_tokens=5)
                    plain = pe.serve(jobs[:2] + jobs[2:])
                ok = ok and all(np_equal(a, b) for a, b in zip(plain, want))
            checks.append((f'ServingEngine {kv or "float32"} pools, '
                           f'{label} ({pf["hits"]} hits, '
                           f'{pf["chunked_admissions"]} chunked admissions)',
                           ok, after['spec']['accept_rate'] if
                           label == 'self-draft' else None))
            del engine
    for label, ok, rate in checks:
        print(f'spec agreement float32, Llama-7B width, 2 layers: {label}: '
              f'streams equal to the non-speculative ones (and through the '
              f'plain versions) {ok}'
              + ('' if rate is None else f', accept rate {rate}')
              + f' [{card}]')
        if not ok or rate not in (None, 1.0):
            raise AssertionError(f'spec agreement: {label}: streams differ '
                                 f'or a self-draft rejected ({rate})')
    del model, draft, eng
    gc.collect()
    torch.cuda.empty_cache()


def spec_phase(torch, np, card):
    """Phase 13: speculative decoding at Llama-2-7B widths (32 layers, bf16
    weights drawn on the card from a seeded generator), k = 4: (a)
    generate_speculative at batch 1 with the model's int8 weight-only
    copy (K10 on its one-token steps) and with a 2-layer draft (the
    model's first two layers under its embedding, norm and head), against
    model.generate; (b) DecodeEngine.generate_speculative at batch 8;
    (c) ServingEngine(draft=int8 copy) over phase 4's burst on bf16 and
    int8 pools against the non-speculative engine, and sampled rows; (d)
    float32 at 2 layers: streams equal to the non-speculative ones through
    the kernels and the plain versions, and a self-draft accepting every
    proposal. Every speculative window replays its captured graph, its
    geometries warmed before the timed runs. Returns the launch counts
    of its runs as one path."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama_7b(), dtype='bfloat16')
    model = LlamaForCausalLM(cfg, seed=0)
    qdraft = model.quantize_weights(8)
    draft2 = layer_draft(torch, model, 2)
    total = {}
    spec_generate_b1(torch, np, model, (('2 layers', draft2, None),
                                        ('int8 copy', qdraft, 'quant_matmul')),
                     card, total)
    spec_generate_b8(torch, np, model, draft2, card, total)
    del draft2
    gc.collect()
    torch.cuda.empty_cache()
    paths = {}
    spec_serving(torch, np, model, qdraft, card, paths)
    for counts in paths.values():
        add_counts(total, counts)
    del model, qdraft
    gc.collect()
    torch.cuda.empty_cache()
    spec_agreement(torch, np, card, total)
    print(f'spec: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return {'speculative': total}


# ---------------------------------------------------------------------------
# 14. the MoE language model
# ---------------------------------------------------------------------------

# Mixtral-8x7B's published config.json (mistralai/Mixtral-8x7B-v0.1),
# typed in; phase 14b runs MIXTRAL_LAYERS of its 32 layers (the 93 GB of
# bf16 weights do not fit on one card)
MIXTRAL_8X7B = {
    'architectures': ['MixtralForCausalLM'], 'hidden_act': 'silu',
    'hidden_size': 4096, 'intermediate_size': 14336,
    'max_position_embeddings': 32768, 'model_type': 'mixtral',
    'num_attention_heads': 32, 'num_experts_per_tok': 2,
    'num_hidden_layers': 32, 'num_key_value_heads': 8,
    'num_local_experts': 8, 'rms_norm_eps': 1e-05, 'rope_theta': 1e6,
    'router_aux_loss_coef': 0.02, 'sliding_window': None,
    'tie_word_embeddings': False, 'torch_dtype': 'bfloat16',
    'vocab_size': 32000}
MIXTRAL_LAYERS = 4
MOE_PROMPT, MOE_NEW = 512, 32
# bf16 |Δ logit| of a cached prefill against the uncached forward with
# the routing held (`prefill_gap`)
MOE_BF16_TOL = 0.5


def x1_routing(np, T, E, k, seed, empty=()):
    """The expert offsets (E + 1,) int32 of T tokens' top-k choices over
    seeded router logits (the experts in `empty` receive no rows), and
    the experts that received rows."""
    lg = np.random.default_rng(seed).normal(size=(T, E))
    lg[:, list(empty)] = -np.inf
    counts = np.bincount(np.argsort(-lg, axis=1)[:, :k].reshape(-1),
                         minlength=E)
    return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            int((counts > 0).sum()))


X1_TOL = {'float32': (1e-4, 1e-4), 'bfloat16': TENSOR_TOL['bfloat16']}


def check_moe_matmul(torch, np, timer, T, E, k, K, N, dtype):
    """X1 at one product of the MoE path: T tokens' top-k rows sorted by
    expert (seeded routing) times (E, K, N) weights, against its plain
    version (a torch.matmul per expert, offsets read on the host), with
    the path the wrapper took (a bf16 row past the skinny path on an
    aligned shape must take the tensor cores, and is then timed on the
    CUDA-core tiles too: `tiled_ms`). The bound counts the bytes of x, of
    the experts that received rows and of y, and 2 R K N operations at
    the dtype's peak. The library call is torch._grouped_mm (bf16; its
    error against the plain version recorded too), timed where it
    runs."""
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as k_

    off, distinct = x1_routing(np, T, E, k, T * 7 + E + K)
    R = T * k
    g = torch.Generator(device='cuda').manual_seed(R + K + N)
    x = torch.randn(R, K, device='cuda', generator=g).to(dtype)
    w = (0.02 * torch.randn(E, K, N, device='cuda', generator=g)).to(dtype)
    offsets = torch.from_numpy(off).cuda()
    before = dict(k_.PATH_LAUNCHES)
    out = k_.moe_grouped_matmul(x, w, offsets)
    took = [p for p, n in k_.PATH_LAUNCHES.items() if n != before[p]]
    ref = k_.moe_grouped_matmul_plain(x, w, offsets)
    torch.cuda.synchronize()
    what = (f'moe_grouped_matmul T={T} E={E} top-{k} R={R} K={K} N={N} '
            f'{dname(torch, dtype)}')
    want = k_.path(R, E, K, N, dtype, True)
    if took != [want]:
        raise AssertionError(f'{what} took {took}, not {want}')
    if (dtype == torch.bfloat16 and R > k_.SKINNY_MEAN_ROWS[dtype] * E
            and K % 8 == 0 and N % 8 == 0 and took != ['tensor_core']):
        raise AssertionError(f'{what} took {took}, not tensor_core')
    # float32: sums of K products in another order; bf16: one rounding
    # of the float32 sum on top
    tol = X1_TOL[dname(torch, dtype)]
    err = within(out, ref, tol, what)
    item = x.element_size()
    nbytes = R * K * item + distinct * K * N * item + R * N * item \
        + (E + 1) * 4
    b_, by = bound_ms(nbytes, 2 * R * K * N,
                      BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    iters = 20 if R <= 64 else 5
    rec = {
        'shape': f'x ({R}, {K}) {dname(torch, dtype)} sorted over {E} '
                 f'experts ({distinct} with rows, top-{k} of {T} tokens), '
                 f'w ({E}, {K}, {N})',
        'path': took[0], 'experts_with_rows': distinct,
        'max_abs_err': err, 'tolerance': tol_text(tol),
        'ms': timer(lambda: k_.moe_grouped_matmul(x, w, offsets),
                    iters=iters),
        'plain_ms': timer(lambda: k_.moe_grouped_matmul_plain(x, w, offsets),
                          iters=iters),
        'bound_ms': b_, 'bound_by': by, 'library_ms': None,
        'library': 'torch._grouped_mm (bf16 only)'}
    if took == ['tensor_core']:
        # the CUDA-core tiles this route replaced, in the same call
        tiled = within(k_.launch_path('tiled', x, w, offsets), ref, tol,
                       f'{what} on tiled')
        rec['tiled_max_abs_err'] = tiled
        rec['tiled_ms'] = timer(lambda: k_.launch_path('tiled', x, w,
                                                       offsets),
                                iters=iters)
    if dtype == torch.bfloat16 and hasattr(torch, '_grouped_mm'):
        ends = offsets[1:]
        try:
            lib = torch._grouped_mm(x, w, offs=ends)
            rec['library_err'] = (lib.float() - ref.float()).abs().max(
            ).item()
            rec['library_ms'] = timer(lambda: torch._grouped_mm(
                x, w, offs=ends), iters=iters)
        except RuntimeError as e:     # a yardstick only: record why not
            rec['library'] = f'torch._grouped_mm: {e}'[:200]
    del x, w, out, ref
    return rec


def x1_bwd_inputs(torch, np, T, E, k, K, N, dtype, empty=()):
    """The inputs of one X1 product's backward: T tokens' seeded top-k
    routing over E experts (those in `empty` receive no rows), x (R, K),
    w (E, K, N) and the output's gradient dy (R, N) on the card; and the
    experts that received rows."""
    off, distinct = x1_routing(np, T, E, k, T * 7 + E + K, empty)
    R = T * k
    g = torch.Generator(device='cuda').manual_seed(R + K + N + 1)
    x = torch.randn(R, K, device='cuda', generator=g).to(dtype)
    w = (0.02 * torch.randn(E, K, N, device='cuda', generator=g)).to(dtype)
    dy = (0.02 * torch.randn(R, N, device='cuda', generator=g)).to(dtype)
    return x, w, dy, torch.from_numpy(off).to('cuda'), distinct


def check_moe_backward(torch, np, timer, T, E, k, K, N, dtype, empty=()):
    """X1's backward at one product of the MoE path (the forward x (R, K)
    @ w[e] (K, N) over T tokens' top-k rows): the dx kernel (dy w[e]^T
    over w as it lies, on the forward's route rule) and the dW kernel
    (x_e^T dy_e for every expert, zero without rows) against their plain
    versions, with the route each took (bf16 past the skinny bound on
    the tensor cores). Bounds: dx reads dy, the weights of the experts
    with rows and writes dx; dW reads x and dy and writes all of dw; both
    2 R K N operations at the dtype's peak. The library call is
    torch._grouped_mm over (dy, w^T) for dx and (x^T, dy) for dW, where
    the installed torch takes those shapes (else the row says why).
    Returns the (dx, dW) rows."""
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as k_

    x, w, dy, offsets, distinct = x1_bwd_inputs(torch, np, T, E, k, K, N,
                                                dtype, empty)
    R = x.shape[0]
    item = x.element_size()
    dt = dname(torch, dtype)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    shape = (f'x ({R}, {K}) {dt} over {E} experts ({distinct} with rows, '
             f'top-{k} of {T} tokens), w ({E}, {K}, {N}), dy ({R}, {N})')
    iters = 3 if R * K * N > 1e11 else 5
    ends = offsets[1:]
    rows = []
    for name, run, plain, library, nbytes, routes, want in (
            ('dx', lambda: k_.moe_grouped_matmul_dx(dy, w, offsets),
             lambda: k_.moe_grouped_matmul_dx_plain(dy, w, offsets),
             lambda: torch._grouped_mm(dy, w.transpose(-2, -1), offs=ends),
             R * N * item + distinct * K * N * item + R * K * item,
             k_.DX_PATH_LAUNCHES,
             k_.path(R, E, N, K, dtype, True)),
            ('dW', lambda: k_.moe_grouped_matmul_dw(x, dy, offsets),
             lambda: k_.moe_grouped_matmul_dw_plain(x, dy, offsets),
             lambda: torch._grouped_mm(x.t(), dy, offs=ends),
             R * K * item + R * N * item + E * K * N * item,
             k_.DW_PATH_LAUNCHES, k_.dw_path(K, N, dtype, True))):
        what = f'moe_grouped_matmul {name} {shape}'
        before = dict(routes)
        out = run()
        took = [p for p, n in routes.items() if n != before[p]]
        ref = plain()
        torch.cuda.synchronize()
        if took != [want] or (dtype == torch.bfloat16 and R > E
                              and took != ['tensor_core']):
            raise AssertionError(f'{what} took {took}, not {want}')
        # float32: sums of up to R products in another order; bf16: one
        # rounding of the float32 sum on top
        tol = X1_TOL[dt]
        err = within(out, ref, tol, what)
        b_, by = bound_ms(nbytes + (E + 1) * 4, 2 * R * K * N, peak)
        rec = {'shape': shape, 'product': name, 'path': took[0],
               'experts_with_rows': distinct, 'max_abs_err': err,
               'tolerance': tol_text(tol),
               'ms': timer(run, iters=iters),
               'plain_ms': timer(plain, iters=iters),
               'bound_ms': b_, 'bound_by': by, 'library_ms': None,
               'library': f'torch._grouped_mm ({dt})'}
        try:
            lib = library()
            rec['library_err'] = (lib.float() - ref.float()).abs().max(
            ).item()
            rec['library_ms'] = timer(library, iters=iters)
        except (RuntimeError, AttributeError) as e:   # a yardstick only
            rec['library'] = f'torch._grouped_mm: {e}'[:200]
        rows.append(rec)
        del out, ref
    del x, w, dy
    return rows


# the backward rows of phase 3: (T, E, k, K, N, dtypes, empty experts).
# MoEConfig()'s training step first (phase 16: 4 x 2048 tokens, the
# main path), then its b8 and b1 512-token prefills, Mixtral-8x7B's 4096
# tokens (R = 8192), each product in both directions (gate / up, down),
# and a routing with half the experts empty
X1_BWD_ROWS = (
    [(8192, 64, 6, 2048, 1408, ('bfloat16',), ()),
     (8192, 64, 6, 1408, 2048, ('bfloat16',), ())]
    + [(T, 64, 6, K, N, ('bfloat16', 'float32'), ())
       for T in (4096, 512) for K, N in ((2048, 1408), (1408, 2048))]
    + [(4096, 8, 2, K, N, ('bfloat16', 'float32'), ())
       for K, N in ((4096, 14336), (14336, 4096))]
    + [(512, 64, 6, 2048, 1408, ('bfloat16', 'float32'), tuple(range(32)))])


X1_CROSSOVER = ((64, 6, ((2048, 1408), (1408, 2048))),
                (8, 2, ((4096, 14336), (14336, 4096))))


def moe_crossover(torch, np, timer, card, shapes=X1_CROSSOVER,
                  mults=(0.5, 1, 1.5, 2, 4, 6, 8, 10, 12, 16)):
    """X1 in bf16 at R = m E rows for m in `mults` (T = ceil(m E / k)
    tokens' seeded top-k routing; 0.5E .. 16E: the decode shapes lie at
    0.09E .. 2E) at the 64-expert model's and Mixtral-8x7B's products,
    on the skinny path and on the tensor cores in one call, each held to
    the plain version: the evidence for bf16's SKINNY_MEAN_ROWS (float32
    has no tensor-core route and keeps R <= 8 E). Returns the rows."""
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as k_

    rows = []
    for E, k, kn in shapes:
        for K, N in kn:
            g = torch.Generator(device='cuda').manual_seed(E + K + N)
            w = (0.02 * torch.randn(E, K, N, device='cuda', generator=g)
                 ).to(torch.bfloat16)
            for m in mults:
                T = math.ceil(m * E / k)
                off, _ = x1_routing(np, T, E, k, T + K)
                offsets = torch.from_numpy(off).cuda()
                R = T * k
                x = torch.randn(R, K, device='cuda', generator=g).to(
                    torch.bfloat16)
                ref = k_.moe_grouped_matmul_plain(x, w, offsets)
                ms = {}
                for p in ('skinny', 'tensor_core'):
                    within(k_.launch_path(p, x, w, offsets), ref,
                           X1_TOL['bfloat16'],
                           f'X1 R={R} E={E} {K}x{N} on {p}')
                    ms[p] = timer(lambda: k_.launch_path(p, x, w, offsets),
                                  iters=10)
                rows.append({'E': E, 'K': K, 'N': N, 'R': R,
                             'rows_per_expert': R / E, **ms})
                print(f'moe crossover: R={R} ({R / E:.2f} E) E={E} '
                      f'{K}x{N} bf16: skinny {ms["skinny"]:.4f} ms, '
                      f'tensor_core {ms["tensor_core"]:.4f} ms '
                      f'(bound now {k_.SKINNY_MEAN_ROWS[torch.bfloat16]} '
                      f'E) [{card}]', flush=True)
            del w
    return rows


def moe_launches(label, counts, L, forwards, decode_forwards):
    """The MoE path's exact launch counts: K1 2L + 1 and X1 3L per
    forward of any kind (every cached forward routes dropless), K7 L per
    one-token forward, nothing else."""
    want = dict.fromkeys(counts, 0)
    want.update(rms_norm=(2 * L + 1) * forwards,
                moe_grouped_matmul=3 * L * forwards,
                decode_attention=L * decode_forwards)
    if counts != want:
        raise AssertionError(f'{label}: launch counts {counts} != expected '
                             f'{want}')


def x1_routes(total):
    """Add X1's launches per route since the last count_launches to
    `total`, under 'X1 <route>'; returns them."""
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as hm

    routes = dict(hm.PATH_LAUNCHES)
    add_counts(total, {f'X1 {p}': n for p, n in routes.items()})
    return routes


def moe_generate(torch, np, model, B, label, card, total, kv8=False):
    """generate at batch B over P = MOE_PROMPT seeded tokens a row: a
    warm call, a timed prefill (max_new_tokens=1, two calls) and a timed
    call of N = MOE_NEW new tokens, with exact launch counts (every
    prefill launch of X1 on the route `path()` gives its B P k rows: the
    tensor cores in bf16); prints tok/s, ms per prefill and ms per
    decode forward ((the N call - the faster prefill) / (N - 1)).
    Returns the prompts and the N call's output."""
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as hm

    cfg = model.config
    L = cfg.num_hidden_layers
    P, N = MOE_PROMPT, MOE_NEW
    ids = torch.from_numpy(np.random.default_rng(B + 40).integers(
        3, cfg.vocab_size, (B, P))).to(model.device)
    kw = dict(kv_cache_int8=kv8)
    model.generate(ids, max_new_tokens=N, **kw)   # warm: captures the step

    def prefill():
        ts = []
        for _ in range(2):
            _, t = timed(torch, lambda: model.generate(
                ids, max_new_tokens=1, **kw))
            ts.append(t)
        return ts

    ts, counts = count_launches(torch, prefill)
    moe_launches(f'moe {label} prefill', counts, L, 2, 0)
    add_counts(total, counts)
    dtype = model.embed_tokens.dtype
    H, M, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    route = hm.path(B * P * cfg.top_k, E, H, M, dtype, True)
    if hm.path(B * P * cfg.top_k, E, M, H, dtype, True) != route or \
            x1_routes(total) != {p: 6 * L if p == route else 0
                                 for p in hm.PATH_LAUNCHES}:
        raise AssertionError(f'moe {label} prefill: X1 routes '
                             f'{hm.PATH_LAUNCHES}, not 3L a forward on '
                             f'{route}')
    (out, t), counts = count_launches(torch, lambda: timed(
        torch, lambda: model.generate(ids, max_new_tokens=N, **kw)))
    moe_launches(f'moe {label}', counts, L, N, N - 1)
    add_counts(total, counts)
    x1_routes(total)
    check_outputs(f'moe {label}', list(ids.cpu().numpy()),
                  list(out.cpu().numpy()), cfg.vocab_size, [N] * B)
    pre = min(ts)
    ms = (t - pre) / (N - 1) * 1e3
    print(f'moe {label}: generate b{B}, {P}-token prompts, {N} new tokens: '
          f'{B * N / t:.2f} tok/s ({t:.3f} s), prefill {pre * 1e3:.2f} ms '
          f'(calls {", ".join(f"{x * 1e3:.2f}" for x in ts)}), '
          f'{ms:.2f} ms per decode forward ({B / ms * 1e3:.2f} tokens/s '
          f'of decode); launches per forward K1 {2 * L + 1}, X1 {3 * L}, '
          f'K7 {L} per one-token forward '
          f'({ {k: v for k, v in counts.items() if v} }; X1 prefills on '
          f'{route}) [{card}]', flush=True)
    return ids, out


def routed(torch, fn, force=None):
    """fn()'s result and, per MoE layer call during it, each token's
    chosen experts (T, k), read on the host outside every timed run.
    With `force` (such a list from another run) each layer call takes
    those experts instead of its own top-k: its gate values are its own
    probabilities at them, renormalised over the k, so only the
    discrete choice is held."""
    from paddle_tpu_torch.distributed import moe as dmoe

    seen = []
    inner_apply, inner_gates = dmoe.ragged_expert_apply, dmoe._topk_gates

    def record(tokens, expert_idx, *a, **kw):
        seen.append(expert_idx)
        return inner_apply(tokens, expert_idx, *a, **kw)

    def held(logits, k):
        probs, _, _, aux = inner_gates(logits, k)
        idx = force[len(seen)]
        vals = torch.gather(probs, 1, idx)
        return probs, vals / vals.sum(-1, keepdim=True), idx, aux

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(dmoe, 'ragged_expert_apply',
                                              record))
        if force is not None:
            stack.enter_context(mock.patch.object(dmoe, '_topk_gates',
                                                  held))
        out = fn()
    return out, seen


def prefill_gap(torch, model, prompt, card):
    """A bf16 cached prefill's logits (plain masked attention) against
    the uncached forward's (flash attention) over one prompt. Routing is
    discrete: where bf16 rounding moves a router logit across a near-tie
    the token takes other experts and its logits move by O(1), and so do
    the later tokens that attend to it. So the share of positions routed
    alike and their logits are printed, and the bound holds on a second
    uncached forward whose every layer takes the cached run's experts
    (its own gate probabilities at them)."""
    with torch.no_grad():
        caches = model.init_cache(1, prompt.shape[1])
        (cached, _), rc = routed(torch, lambda: model(
            prompt, caches=caches, cache_index=0))
        (uncached, _), ru = routed(torch, lambda: model(prompt))
        (held, _), _ = routed(torch, lambda: model(prompt), force=rc)
    alike = torch.stack([(torch.sort(a, -1)[0] == torch.sort(b, -1)[0])
                         .all(-1) for a, b in zip(rc, ru)]).all(0)
    gap = (cached.float() - uncached.float()).abs().amax(-1)[0]
    same = (cached.argmax(-1) == uncached.argmax(-1)).float().mean().item()
    first = int((~alike).nonzero()[0]) if not bool(alike.all()) else None
    err = (cached.float() - held.float()).abs().max().item()
    print(f'moe (b) bf16: {prompt.shape[1]}-token prefill, cached (plain '
          f'masked attention) against uncached (flash) logits: positions '
          f'routed alike in every layer {alike.float().mean().item():.4f} '
          f'(the first that is not: {first}), argmax equal at {same:.4f}, '
          f'max |Δ| {gap.max().item():.6g} (max |logit| '
          f'{uncached.float().abs().max().item():.4f}); with the cached '
          f'run\'s experts held: max |Δ| {err:.6g} (bound {MOE_BF16_TOL}) '
          f'[{card}]', flush=True)
    if not err <= MOE_BF16_TOL:
        raise AssertionError(f'moe (b): with the routing held, the cached '
                             f'prefill logits moved {err} > {MOE_BF16_TOL}')


def moe_step_experts(torch, np, model, ids):
    """The distinct routed experts each layer's expert product reads in
    one one-token decode step after the prompts' prefill (read on the
    host in an instrumented step, outside every timed run), and the
    least bytes that step reads: every layer's attention and router
    weights, its shared experts and its distinct routed experts, the
    head and the embedding rows."""
    cfg = model.config
    B, P = ids.shape
    with torch.no_grad():
        caches = model.init_cache(B, P + 1)
        logits, _ = model(ids, caches=caches, cache_index=0)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        _, chosen = routed(torch, lambda: model(tok, caches=caches,
                                                cache_index=P))
    seen = [int(torch.unique(c).numel()) for c in chosen]
    del caches
    item = model.embed_tokens.element_size()
    H, M = cfg.hidden_size, cfg.intermediate_size
    D = cfg.head_dim
    attn = (2 * cfg.num_attention_heads + 2 * cfg.num_key_value_heads) \
        * D * H * item
    expert = 3 * H * M * item
    nbytes = sum(attn + H * cfg.num_experts * 4
                 + (n + cfg.num_shared_experts) * expert for n in seen) \
        + H * cfg.vocab_size * item + B * H * item
    return seen, nbytes


def moe_full_phase(torch, np, card, total):
    """(a) MoEConfig() at the JAX package's defaults, full width and
    depth, bf16 weights seeded on the card."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM

    cfg = MoEConfig()
    L = cfg.num_hidden_layers
    t = time.perf_counter()
    model = MoEForCausalLM(cfg, seed=0, dtype='bfloat16')
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f'moe (a): MoEConfig() (vocab {cfg.vocab_size}, hidden '
          f'{cfg.hidden_size}, {L} layers, {cfg.num_attention_heads} / '
          f'{cfg.num_key_value_heads} heads of {cfg.head_dim}, '
          f'{cfg.num_experts} routed experts top-{cfg.top_k} + '
          f'{cfg.num_shared_experts} shared, intermediate '
          f'{cfg.intermediate_size}): {n_params / 1e9:.2f} B parameters, '
          f'{nbytes / 1e9:.2f} GB bf16, seeded on the card in '
          f'{time.perf_counter() - t:.1f} s', flush=True)
    streams = {}
    for B, kv8 in ((1, False), (1, True), (8, False), (8, True)):
        label = f'(a) b{B} {"int8 KV" if kv8 else "bf16 cache"}'
        ids, streams[B, kv8] = moe_generate(torch, np, model, B, label, card,
                                            total, kv8)
        if kv8:
            lead = min(leading_equal(np, a, b) for a, b in zip(
                streams[B, True][:, MOE_PROMPT:].tolist(),
                streams[B, False][:, MOE_PROMPT:].tolist()))
            print(f'moe {label}: the int8-KV stream leaves the bf16 one at '
                  f'token {lead if lead < MOE_NEW else "none"} of {MOE_NEW}'
                  f' (first over the rows; printed, not asserted: int8 '
                  f'codes and bf16 router near-ties)', flush=True)
        else:
            seen, step_bytes = moe_step_experts(torch, np, model, ids)
            print(f'moe {label}: distinct routed experts a decode step '
                  f'reads, per layer: min {min(seen)} / mean '
                  f'{sum(seen) / len(seen):.2f} / max {max(seen)} of '
                  f'{cfg.num_experts} ({cfg.top_k} per token); the step '
                  f'reads at least {step_bytes / 1e9:.3f} GB of weights: '
                  f'bound {step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms '
                  f'[{card}]', flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    # DecodeEngine at b8 (the prompts fill the 512 bucket)
    eng = DecodeEngine(model, max_new_tokens=MOE_NEW)
    ids = torch.from_numpy(np.random.default_rng(48).integers(
        3, cfg.vocab_size, (8, MOE_PROMPT))).to(model.device)
    eng.generate(ids)                             # warm: captures the step
    (out, dt), counts = count_launches(torch, lambda: timed(
        torch, lambda: eng.generate(ids)))
    moe_launches('moe (a) DecodeEngine b8', counts, L, MOE_NEW, MOE_NEW - 1)
    add_counts(total, counts)
    same = bool(torch.equal(out, streams[8, False]))
    print(f'moe (a) DecodeEngine b8: {8 * MOE_NEW / dt:.2f} tok/s end to '
          f'end ({MOE_PROMPT}-token prompts, the 512 bucket: no padding, '
          f'{MOE_NEW} new tokens, {dt:.3f} s); streams equal to generate '
          f'b8\'s {same} [{card}]', flush=True)
    if not same:
        raise AssertionError('moe (a): DecodeEngine and generate disagree '
                             'on unpadded prompts')
    # one b8 decode forward traced (the process's first profiler
    # session: phase 14 runs right after the kernel checks)
    with torch.no_grad():
        caches = model.init_cache(8, MOE_PROMPT + 2)
        logits, _ = model(ids, caches=caches, cache_index=0)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        model(tok, caches=caches, cache_index=MOE_PROMPT)
        profile_forward(torch, lambda: model(tok, caches=caches,
                                             cache_index=MOE_PROMPT + 1),
                        'moe (a) b8 bf16', card)
        # and one b8 512-token prefill forward (X1 on the tensor cores)
        profile_forward(torch, lambda: model(ids, caches=caches,
                                             cache_index=0),
                        'moe (a) b8 bf16', card, phase='prefill')
    del model, eng, caches
    gc.collect()
    torch.cuda.empty_cache()


def moe_mixtral_phase(torch, np, card, total):
    """(b) Mixtral-8x7B's published widths through the port's
    hf_mixtral_config, MIXTRAL_LAYERS of its 32 layers, bf16 seeded
    weights: generate at b1 and b8, and the bf16 cached prefill's logits
    against the uncached forward (dropless, flash attention)."""
    from paddle_tpu_torch.models.convert import hf_mixtral_config
    from paddle_tpu_torch.models.moe_lm import MoEForCausalLM

    cfg = dataclasses.replace(hf_mixtral_config(MIXTRAL_8X7B),
                              num_hidden_layers=MIXTRAL_LAYERS)
    model = MoEForCausalLM(cfg, seed=0, dtype='bfloat16')
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f'moe (b): Mixtral-8x7B widths (hidden {cfg.hidden_size}, '
          f'intermediate {cfg.intermediate_size}, {cfg.num_attention_heads} '
          f'/ {cfg.num_key_value_heads} heads, {cfg.num_experts} experts '
          f'top-{cfg.top_k}, vocab {cfg.vocab_size}, rope_theta '
          f'{cfg.rope_theta:g}, dispatch {cfg.dispatch_mode}) at '
          f'{MIXTRAL_LAYERS} of its 32 layers (depth cut: 93 GB of bf16 '
          f'weights do not fit on one card): {nbytes / 1e9:.2f} GB bf16',
          flush=True)
    for B in (1, 8):
        ids, out = moe_generate(torch, np, model, B, f'(b) Mixtral b{B}',
                                card, total)
    with torch.no_grad():
        caches = model.init_cache(8, MOE_PROMPT)
        profile_forward(torch, lambda: model(ids, caches=caches,
                                             cache_index=0),
                        'moe (b) Mixtral b8 bf16', card, phase='prefill')
    del caches
    prefill_gap(torch, model, ids[:1], card)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def moe_agreement(torch, np, card, total, steps=16, f32_tol=1e-3):
    """(c) float32 at (a)'s widths, 2 layers: the logits of every forward
    of generate (b1, and a left-padded b3; its steps run directly) through
    the kernels against the plain versions within f32_tol, equal
    streams, the captured steps' equal to the direct ones; the model as its
    own draft in generate_speculative and
    DecodeEngine.generate_speculative accepting every proposal, streams
    equal to generate's."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.generation import generate_speculative
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM

    cfg = dataclasses.replace(MoEConfig(), num_hidden_layers=2,
                              dispatch_mode='ragged')
    model = MoEForCausalLM(cfg, seed=1)
    rng = np.random.default_rng(6)
    dev = model.device
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, 21))).to(dev)
    padded = torch.from_numpy(rng.integers(3, cfg.vocab_size, (3, 21))).to(
        dev)
    am = torch.ones_like(padded)
    am[0, :9] = 0
    am[2, :4] = 0
    padded = padded * am
    n = steps + 1
    for label, kw in (('b1', dict(input_ids=ids)),
                      ('left-padded b3', dict(input_ids=padded,
                                              attention_mask=am))):
        def gen():
            return model.generate(max_new_tokens=n, **kw)

        with direct_steps():
            (toks, lk), counts = count_launches(
                torch, lambda: capture_logits(torch, model, gen))
        moe_launches(f'moe (c) {label}', counts, 2, n, steps)
        add_counts(total, counts)
        with plain_kernels(), direct_steps():
            (ptoks, lp), pcounts = count_launches(
                torch, lambda: capture_logits(torch, model, gen))
        if any(pcounts.values()):
            raise AssertionError(f'the plain run launched {pcounts}')
        gtoks, gcounts = count_launches(torch, gen)
        moe_launches(f'moe (c) {label}, captured steps', gcounts, 2, n,
                     steps)
        add_counts(total, gcounts)
        if not torch.equal(gtoks, toks):
            raise AssertionError(f'moe (c) {label}: the captured steps\' '
                                 f'tokens differ from the direct steps\'')
        err = (lk - lp).abs().max().item()
        print(f'moe (c) float32, {label}: MoEConfig() widths, 2 layers, '
              f'{steps} decode steps: max |kernels - plain| logit '
              f'{err:.6g} (bound {f32_tol:g}, max |logit| '
              f'{lp.abs().max().item():.4f}); tokens equal '
              f'{bool(torch.equal(toks, ptoks))} [{card}]', flush=True)
        if not (err <= f32_tol and torch.equal(toks, ptoks)):
            raise AssertionError(f'moe (c) {label}: kernels and plain '
                                 f'versions disagree ({err} > {f32_tol} or '
                                 f'tokens)')
    want = model.generate(ids, max_new_tokens=n)
    eng = DecodeEngine(model, max_new_tokens=n)
    (spec, eng_out), counts = count_launches(torch, lambda: (
        generate_speculative(model, model, ids, max_new_tokens=n,
                             num_draft_tokens=SPEC_K),
        eng.generate_speculative(model, ids, num_draft_tokens=SPEC_K)))
    add_counts(total, counts)
    rate = eng.stats()['spec']['accept_rate']
    print(f'moe (c) float32: the model as its own draft (k {SPEC_K}): '
          f'generate_speculative and DecodeEngine equal to generate '
          f'{bool(torch.equal(spec, want))} / '
          f'{bool(torch.equal(eng_out, want))}, accept rate {rate} [{card}]',
          flush=True)
    if not (torch.equal(spec, want) and torch.equal(eng_out, want)
            and rate == 1.0):
        raise AssertionError('moe (c): a self-draft must accept every '
                             'proposal and equal generate')
    del model
    gc.collect()
    torch.cuda.empty_cache()


def moe_phase(torch, np, card):
    """Phase 14: the MoE language model (MoEForCausalLM) on the card, its
    expert products on X1: (a) MoEConfig() at full width and depth, (b)
    Mixtral-8x7B's widths at MIXTRAL_LAYERS layers, (c) float32
    agreement at 2 layers and a self-draft. (d), X1's rows in phase 3,
    runs with the kernel checks. Returns the launch counts of its runs as
    one path."""
    t_phase = time.perf_counter()
    total = {}
    moe_full_phase(torch, np, card, total)
    moe_mixtral_phase(torch, np, card, total)
    moe_agreement(torch, np, card, total)
    print(f'moe: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return {'moe': total}


# ---------------------------------------------------------------------------
# Phase 15: the compiled decode window and decode step (CUDA graphs)
# ---------------------------------------------------------------------------

# generate's geometries in phase 15: prompt length and new tokens
GRAPH_PROMPT, GRAPH_NEW = 256, 32


def clone_pools(pages):
    return [type(pc)(*(f.clone() for f in pc)) for pc in pages]


def window_variant(torch, np, engine, label, sampled, forced, card,
                   reps=3):
    """One captured window of `engine` (its live slots' state) against a
    direct `_window` call on cloned pools and logits: tokens, last_logits
    and every pool byte equal; then the ms per window of each, `reps`
    more runs over the same inputs (each rewrites the same rows)."""
    from paddle_tpu_torch.inference.serving import _window

    live = np.asarray([r is not None and p is None for r, p in
                       zip(engine._slot_req, engine._pfill)])
    graph = engine._window_graph(sampled, forced)
    inputs = engine._window_inputs(live, sampled, forced)
    dev = engine.device
    t = {k: (v.clone() if isinstance(v, torch.Tensor)
             else torch.as_tensor(v, device=dev)) for k, v in inputs.items()}
    pages = clone_pools(engine._pages)
    sampling = (tuple(t[k] for k in ('temp', 'topk', 'topp', 'seed', 'plen'))
                if sampled else None)
    fkw = (dict(forced_tok=t['forced_tok'], forced=t['forced']) if forced
           else {})

    def direct():
        with torch.no_grad():
            return _window(engine.model, pages, t['last_logits'], t['btab'],
                           t['ctx'], t['live'], t['budget'],
                           window=engine.decode_window,
                           eos_token_id=engine.eos_token_id,
                           sampling=sampling, **fkw)[:2]

    def replay():
        graph.load(**inputs)
        return graph.run()

    toks_d, last_d = direct()
    toks_g, last_g = replay()
    same = (torch.equal(toks_d, toks_g) and torch.equal(last_d, last_g)
            and all(torch.equal(a, b) for pa, pb in zip(pages, engine._pages)
                    for a, b in zip(pa, pb)))
    times = {}
    for name, fn in (('direct', direct), ('replay', replay)):
        _, dt = timed(torch, lambda: [fn() for _ in range(reps)])
        times[name] = dt / reps * 1e3
    print(f'graphs {label} window ({"sampled" if sampled else "greedy"}'
          f'{", carried token" if forced else ""}): replay equal to the '
          f'direct body on cloned state (tokens, last_logits, pools) '
          f'{same}; {times["direct"]:.2f} ms per window direct, '
          f'{times["replay"]:.2f} ms replayed ({engine.decode_window} '
          f'forwards x {engine.max_slots} slots); captured in '
          f'{graph.capture_s:.3f} s, {graph.reserved_bytes} bytes reserved '
          f'[{card}]', flush=True)
    if not same:
        raise AssertionError(f'graphs {label}: the replayed window differs '
                             f'from the direct body')
    del pages


def window_checks(torch, np, model, card, kv):
    """Phase 4's engine settings at Llama-7B width over `kv` pools:
    warmup (report, capture time and bytes per geometry), 4 requests (2
    sampled) admitted and decoding, then every window variant against the
    direct body (the carried-token one as a speculative engine's chunk
    step runs it)."""
    from paddle_tpu_torch.inference import ServingEngine

    label = 'int8 pools' if kv else 'bf16 pools'
    engine = ServingEngine(model, kv_cache_dtype=kv, **SERVE_KW)
    report = engine.warmup()
    g = engine.stats()['graphs']
    print(f'graphs {label}: warmup {report}; per geometry capture '
          f'{g["capture_s"]} s, reserved {g["reserved_bytes"]} bytes '
          f'[{card}]', flush=True)
    rng = np.random.default_rng(31)
    for i, n in enumerate((96, 200, 333, 480)):
        engine.submit(rng.integers(3, model.config.vocab_size, n),
                      **(dict(temperature=0.8, top_p=0.95) if i % 2 else {}))
    engine.step()                    # admissions and the first window
    # the pages the next window writes, as a step tops them up first
    engine._ensure_window_pages()
    for sampled in (False, True):
        window_variant(torch, np, engine, label, sampled, False, card)
    for slot, req in enumerate(engine._slot_req):
        if slot % 2 == 0:
            req.spec_next = int(rng.integers(3, model.config.vocab_size))
    window_variant(torch, np, engine, label, False, True, card)
    for req in engine._slot_req:
        req.spec_next = None
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def spec_engine(torch, np, model, draft, kv, sampled_rows=True):
    """Phase 4's engine settings with `draft` (k = SPEC_K) over `kv`
    pools, 4 requests (2 sampled when `sampled_rows`) admitted and
    through their first window, the pages of the next window topped up:
    (engine, live rows, the next window's verify ctx bucket)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.engine import bucket_length

    engine = ServingEngine(model, draft=draft, num_draft_tokens=SPEC_K,
                           kv_cache_dtype=kv, **SERVE_KW)
    rng = np.random.default_rng(31)
    for i, n in enumerate((96, 200, 333, 480)):
        engine.submit(rng.integers(3, model.config.vocab_size, n),
                      **(dict(temperature=0.8, top_p=0.95)
                         if sampled_rows and i % 2 else {}))
    engine.step()                    # admissions and the first window
    # the pages the next window writes, as a step tops them up first
    engine._ensure_window_pages()
    live = np.asarray([r is not None and p is None for r, p in
                       zip(engine._slot_req, engine._pfill)])
    ctx = bucket_length(int(np.where(live, engine._ctx, 0).max())
                        + SPEC_K + 1, engine.buckets)
    return engine, live, ctx


def spec_direct(torch, engine, pages, dpages, t, ctx, sampled):
    """`_spec_window` called directly over `pages` / `dpages` and the
    window inputs `t` (tensors) of `engine`: its eager reference."""
    from paddle_tpu_torch.inference.serving import _spec_window

    sampling = (tuple(t[k] for k in ('temp', 'topk', 'topp', 'seed', 'plen'))
                if sampled else None)
    with torch.no_grad():
        return _spec_window(engine.model, engine.draft, pages, dpages,
                            t['last_logits'], t['forced_tok'], t['forced'],
                            t['btab'], t['ctx'], t['live'], t['budget'],
                            k=engine.spec_window, ctx_bucket=ctx,
                            eos_token_id=engine.eos_token_id,
                            sampling=sampling)


def spec_window_checks(torch, np, model, draft, card, kv, reps=2):
    """The captured speculative window of a live batch (`spec_engine`)
    against a direct `_spec_window` call on cloned pools and logits,
    greedy and sampled: candidates, commit counts, next tokens and
    carried logits equal bit for bit, and the target's and the draft's
    pages byte for byte after, past the scratch page (it takes every
    slot's uncommitted verify rows, which collide there and land in no
    fixed order; it is never read); then the ms per window of each, `reps`
    more runs over the same inputs (each rewrites the same rows), and
    the capture's seconds and reserved bytes."""
    label = 'int8 pools' if kv else 'bf16 pools'
    engine, live, ctx = spec_engine(torch, np, model, draft, kv)
    dev = engine.device
    for sampled in (False, True):
        graph = engine._spec_graph(ctx, sampled)
        inputs = engine._window_inputs(live, sampled, True)
        t = {k: (v.clone() if isinstance(v, torch.Tensor)
                 else torch.as_tensor(v, device=dev))
             for k, v in inputs.items()}
        pages, dpages = clone_pools(engine._pages), clone_pools(engine._dpages)

        def direct():
            return spec_direct(torch, engine, pages, dpages, t, ctx, sampled)

        def replay():
            graph.load(**inputs)
            return graph.run()

        want = direct()
        got = replay()
        outs = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        pools = [bool(torch.equal(a[1:], b[1:])) for pa, pb in zip(
            pages + dpages, engine._pages + engine._dpages)
            for a, b in zip(pa, pb)]
        # page 0, the scratch page, takes the rows no request keeps (the
        # verify's uncommitted rows of every slot): rows that land on one
        # slot there are written in no fixed order, and it is never read
        scratch = all(torch.equal(a[0], b[0]) for pa, pb in zip(
            pages + dpages, engine._pages + engine._dpages)
            for a, b in zip(pa, pb))
        same = all(outs) and all(pools)
        n_commit = int(got[1].sum())
        times = {}
        for name, fn in (('direct', direct), ('replay', replay)):
            _, dt = timed(torch, lambda: [fn() for _ in range(reps)])
            times[name] = dt / reps * 1e3
        mode = 'sampled' if sampled else 'greedy'
        print(f'graphs spec {label} window ({mode}, k {SPEC_K}, ctx bucket '
              f'{ctx}, 2-layer draft): replay equal to the direct body on '
              f'cloned state (candidates, commit counts, next tokens, '
              f'carried logits {outs}; target and draft pools past the '
              f'scratch page {all(pools)}, the scratch page {scratch}) '
              f'{same}; {n_commit} tokens committed; '
              f'{times["direct"]:.2f} ms per window direct, '
              f'{times["replay"]:.2f} ms replayed ({SPEC_K + 1} draft and 1 '
              f'verify forwards x {engine.max_slots} slots); captured in '
              f'{graph.capture_s:.3f} s, {graph.reserved_bytes} bytes '
              f'reserved [{card}]', flush=True)
        if not same:
            raise AssertionError(f'graphs spec {label}: the replayed '
                                 f'speculative window differs from the '
                                 f'direct body')
        del pages, dpages
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def spec_generate_checks(torch, np, model, draft, card, P=GRAPH_PROMPT,
                         N=GRAPH_NEW // 2):
    """DecodeEngine.generate_speculative at b1 and b8 and
    generate_speculative_sampled at b1 (the same seed) through the
    replayed windows against their windows run directly
    (`direct_steps`, which have nothing to capture): equal tokens; the
    ms per window of each, the capture's seconds and reserved bytes."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.generation import (
        _decode_graphs, generate_speculative_sampled)

    V = model.config.vocab_size
    for label, B in (('b1', 1), ('b8', 8), ('sampled b1', 1)):
        ids = torch.from_numpy(np.random.default_rng(B + 70).integers(
            3, V, (B, P))).to(model.device)
        eng = DecodeEngine(model, max_new_tokens=N)
        owner = eng
        if label.startswith('sampled'):
            owner = model

            def run():
                return generate_speculative_sampled(
                    model, draft, ids, max_new_tokens=N,
                    num_draft_tokens=SPEC_K, temperature=0.8, top_k=50,
                    rng_key=7)
        else:
            def run():
                return eng.generate_speculative(draft, ids,
                                                num_draft_tokens=SPEC_K)
        run()                                               # capture
        store = _decode_graphs(owner, model)
        graph = list(store.spec_runners[draft].entries.values())[-1]
        w0 = eng.stats()['spec']['windows']
        got, t_g = timed(torch, run)
        windows = eng.stats()['spec']['windows'] - w0
        with direct_steps():
            want, t_d = timed(torch, run)
        same = bool(torch.equal(got, want))
        per = (f'{t_d / windows * 1e3:.2f} ms per window direct, '
               f'{t_g / windows * 1e3:.2f} ms replayed ({windows} windows)'
               if windows else f'{t_d:.3f} s a call direct, {t_g:.3f} s '
               f'replayed')
        print(f'graphs spec generate {label} ({P}-token prompts, {N} new '
              f'tokens, k {SPEC_K}, 2-layer draft): tokens through the '
              f'replayed windows equal to the direct windows {same}; {per}; '
              f'captured in {graph.capture_s:.3f} s, {graph.reserved_bytes} '
              f'bytes reserved [{card}]', flush=True)
        if not same:
            raise AssertionError(f'graphs spec generate {label}: replayed '
                                 f'and direct windows disagree')
        if owner is model:
            model.release_graphs()
        eng.release()


def generate_checks(torch, np, model, B, label, card, P=GRAPH_PROMPT,
                    N=GRAPH_NEW):
    """generate at batch B through the captured steps against the direct
    steps, greedy and sampled (the same seed): equal tokens, the ms per
    decode forward of each ((the N-token call - a 1-token call) / (N -
    1)), the capture time and the bytes reserved."""
    from paddle_tpu_torch.models.generation import _decode_graphs

    ids = torch.from_numpy(np.random.default_rng(B + 60).integers(
        3, model.config.vocab_size, (B, P))).to(model.device)
    _, t1 = timed(torch, lambda: model.generate(ids, max_new_tokens=1))
    for mode, kw in (('greedy', {}),
                     ('sampled', dict(temperature=0.8, top_k=50))):
        runner = _decode_graphs(model, model).runner
        n0 = runner.captures
        model.generate(ids, max_new_tokens=N, rng_key=7, **kw)   # capture
        graph = list(runner.entries.values())[-1]
        got, t_g = timed(torch, lambda: model.generate(
            ids, max_new_tokens=N, rng_key=7, **kw))
        with direct_steps():
            model.generate(ids, max_new_tokens=N, rng_key=7, **kw)  # warm
            want, t_d = timed(torch, lambda: model.generate(
                ids, max_new_tokens=N, rng_key=7, **kw))
        same = bool(torch.equal(got, want))
        print(f'graphs {label} b{B} {mode}: generate ({P}-token prompts, '
              f'{N} new tokens) through the captured step equal to the '
              f'direct steps {same}; {(t_d - t1) / (N - 1) * 1e3:.2f} ms '
              f'per decode forward direct, {(t_g - t1) / (N - 1) * 1e3:.2f} '
              f'ms replayed (prefill {t1 * 1e3:.1f} ms); '
              f'{runner.captures - n0} capture in {graph.capture_s:.3f} s, '
              f'{graph.reserved_bytes} bytes reserved [{card}]', flush=True)
        if not same:
            raise AssertionError(f'graphs {label} b{B} {mode}: captured '
                                 f'and direct steps disagree')


def graphs_profile(torch, np, card):
    """The device-busy share of a direct and a replayed decode window
    (phase 4's engine at Llama-7B width), speculative window (the same
    engine with a 2-layer draft), generate's b8 decode step at that
    width, and MoEConfig()'s b8 step, each one traced: run in a fresh
    process (`--graphs-profile`), whose first profiler sessions these
    are."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.serving import _window
    from paddle_tpu_torch.models.generation import _decode_graphs
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM

    model = LlamaForCausalLM(dataclasses.replace(llama_7b(),
                                                 dtype='bfloat16'), seed=0)
    engine = ServingEngine(model, **SERVE_KW)
    rng = np.random.default_rng(31)
    for n in (96, 200, 333, 480):
        engine.submit(rng.integers(3, model.config.vocab_size, n))
    engine.step()
    engine._ensure_window_pages()
    live = np.asarray([r is not None for r in engine._slot_req])
    graph = engine._window_graph(False)
    inputs = engine._window_inputs(live, False)
    t = {k: (v.clone() if isinstance(v, torch.Tensor)
             else torch.as_tensor(v, device=engine.device))
         for k, v in inputs.items()}
    with torch.no_grad():
        profile_forward(torch, lambda: _window(
            model, engine._pages, t['last_logits'], t['btab'], t['ctx'],
            t['live'], t['budget'], window=engine.decode_window,
            eos_token_id=None), 'window direct', card, phase='graphs',
            what='one window')
    graph.load(**inputs)
    rows = profile_forward(torch, graph.run, 'window replayed', card,
                           phase='graphs', what='one window')
    check_replay_trace(rows, graph, 1, 'window replayed')
    del engine, graph

    # a speculative window (k = SPEC_K, the 2-layer draft) of 4 greedy
    # rows, traced direct and replayed
    draft = layer_draft(torch, model, 2)
    spec, live, ctx = spec_engine(torch, np, model, draft, None,
                                  sampled_rows=False)
    graph = spec._spec_graph(ctx, False)
    inputs = spec._window_inputs(live, False, True)
    t = {k: (v.clone() if isinstance(v, torch.Tensor)
             else torch.as_tensor(v, device=spec.device))
         for k, v in inputs.items()}
    what = f'one speculative window (k = {SPEC_K}, ctx bucket {ctx})'
    profile_forward(torch, lambda: spec_direct(
        torch, spec, spec._pages, spec._dpages, t, ctx, False),
        'spec window direct', card, phase='graphs', what=what)
    graph.load(**inputs)
    rows = profile_forward(torch, graph.run, 'spec window replayed', card,
                           phase='graphs', what=what)
    check_replay_trace(rows, graph, 1, 'spec window replayed')
    del spec, graph, draft
    gc.collect()
    torch.cuda.empty_cache()

    def step_profiles(m, label, P, n=8):
        ids = torch.from_numpy(np.random.default_rng(68).integers(
            3, m.config.vocab_size, (8, P))).to(m.device)
        m.generate(ids, max_new_tokens=GRAPH_NEW)
        g = list(_decode_graphs(m, m).runner.entries.values())[-1]
        g.static['step'].zero_()
        with torch.no_grad():
            profile_forward(torch, lambda: [g.body() for _ in range(n)],
                            f'{label} step direct', card, phase='graphs',
                            what=f'{n} decode steps')
        g.static['step'].zero_()
        rows = profile_forward(torch, lambda: g.run(n),
                               f'{label} step replayed', card,
                               phase='graphs', what=f'{n} decode steps')
        check_replay_trace(rows, g, n, f'{label} step replayed')

    step_profiles(model, 'generate b8', GRAPH_PROMPT)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    step_profiles(MoEForCausalLM(MoEConfig(), seed=0, dtype='bfloat16'),
                  'moe b8', MOE_PROMPT)


def graphs_phase(torch, np, card):
    """Phase 15: the decode window, the decode step and the speculative
    windows replayed as CUDA graphs against their direct bodies at
    Llama-7B width (phase 4's engine over bf16 and int8 pools, plain and
    with a 2-layer draft; generate b1 and b8; generate_speculative b1
    and b8, sampled b1) and at MoEConfig() (generate b8), then the busy
    shares from a fresh process. Returns the launch counts of its
    runs."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM

    t_phase = time.perf_counter()
    model = LlamaForCausalLM(dataclasses.replace(llama_7b(),
                                                 dtype='bfloat16'), seed=0)

    def checks():
        for kv in (None, 'int8'):
            window_checks(torch, np, model, card, kv)
        for B in (1, 8):
            generate_checks(torch, np, model, B, 'Llama-7B', card)
        draft = layer_draft(torch, model, 2)
        for kv in (None, 'int8'):
            spec_window_checks(torch, np, model, draft, card, kv)
        spec_generate_checks(torch, np, model, draft, card)

    _, counts = count_launches(torch, checks)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    moe = MoEForCausalLM(MoEConfig(), seed=0, dtype='bfloat16')
    _, moe_counts = count_launches(torch, lambda: generate_checks(
        torch, np, moe, 8, 'MoEConfig()', card, P=MOE_PROMPT, N=MOE_NEW))
    add_counts(counts, moe_counts)
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    prof = subprocess.run([sys.executable, __file__, '--graphs-profile',
                           card], capture_output=True, text=True,
                          timeout=600)
    print(prof.stdout, end='', flush=True)
    if prof.returncode:
        print(prof.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f'graphs: the profile process failed '
                             f'({prof.returncode})')
    print(f'graphs: profile process {time.perf_counter() - t:.1f} s; phase '
          f'took {time.perf_counter() - t_phase:.1f} s', flush=True)
    return {'graphs': counts}


# ---------------------------------------------------------------------------
# Phase 16: MoE training (X1's backward)
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S = 4, 4, 2048
MOE_LAYER_TOKENS = (2, 2048)


def moe_layer_grads(torch, np, card, out_tol=1e-5, rel_tol=1e-4):
    """(a) One MoELayer(dispatch_mode='ragged') at MoEConfig()'s widths
    (64 routed experts top 6, 2 shared) in float32 over 2 x 2048 tokens:
    the output and aux loss of sum(out * g) + 0.01 aux, every parameter's
    gradient and dx, through the kernels (exactly 3 X1, 3 dx and 3 dW
    launches) against the plain versions. The router's float32 product
    runs before X1 in the same layer, so both runs route alike. Bounds:
    the output within `out_tol` relative L2, every gradient within
    `rel_tol` (grads_phase's bound: summation order only)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed.moe import MoELayer
    from paddle_tpu_torch.models.moe_lm import MoEConfig

    cfg = MoEConfig()
    H = cfg.hidden_size
    layer = MoELayer(H, cfg.intermediate_size, num_experts=cfg.num_experts,
                     top_k=cfg.top_k,
                     num_shared_experts=cfg.num_shared_experts,
                     return_aux=True, dispatch_mode='ragged',
                     dtype=torch.float32, device='cuda',
                     generator=torch.Generator(device='cuda').manual_seed(0))
    g = torch.Generator(device='cuda').manual_seed(1)
    x0 = torch.randn(*MOE_LAYER_TOKENS, H, device='cuda', generator=g)
    cot = torch.randn(*MOE_LAYER_TOKENS, H, device='cuda', generator=g)

    def run():
        layer.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        out, aux = layer(x)
        ((out * cot).sum() + 0.01 * aux).backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in layer.named_parameters()}
        grads['dx'] = x.grad
        return out.detach(), aux.item(), grads

    (out, aux, grads), counts = count_launches(torch, run)
    want = dict.fromkeys(counts, 0)
    want.update(moe_grouped_matmul=3, moe_grouped_matmul_dx=3,
                moe_grouped_matmul_dw=3)
    if counts != want:
        raise AssertionError(f'moe layer grads: launch counts {counts} != '
                             f'{want}')
    before = dict(ops.LAUNCHES)
    with plain_kernels():
        p_out, p_aux, p_grads = run()
    torch.cuda.synchronize()
    if dict(ops.LAUNCHES) != before:
        raise AssertionError('moe layer grads: the plain run launched a '
                             'kernel')
    out_err = rel_l2(torch, out, p_out)
    rel = {n: rel_l2(torch, grads[n], p_grads[n]) for n in p_grads}
    worst = max(rel, key=rel.get)
    print(f'moe train (a): MoELayer float32, {cfg.num_experts} experts '
          f'top-{cfg.top_k} + {cfg.num_shared_experts} shared, '
          f'{H} -> {cfg.intermediate_size}, {MOE_LAYER_TOKENS} tokens: '
          f'output |kernels - plain| / |plain| {out_err:.3g}, aux '
          f'{aux:.6f} vs {p_aux:.6f}; worst gradient {rel[worst]:.3g} '
          f'({worst}) over {sorted(rel)} [{card}]', flush=True)
    if not (out_err <= out_tol and abs(aux - p_aux) <= 1e-6 * abs(p_aux)
            and rel[worst] <= rel_tol):
        raise AssertionError(f'moe layer grads: output {out_err} > '
                             f'{out_tol}, aux {aux} vs {p_aux}, or gradient '
                             f'{worst} {rel[worst]} > {rel_tol}')
    del layer, grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()


def moe_train_routes(L):
    """The route check of phase 16 (b): every X1 launch, forward, dx and
    dW, on the tensor cores (bf16, R = B S k rows, far past the skinny
    bound)."""
    from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as hm

    def check(n):
        got = {'forward': dict(hm.PATH_LAUNCHES),
               'dx': dict(hm.DX_PATH_LAUNCHES),
               'dW': dict(hm.DW_PATH_LAUNCHES)}
        print(f'moe train: X1 launches by route {got}', flush=True)
        for what, routes in got.items():
            want = dict.fromkeys(routes, 0)
            want['tensor_core'] = 3 * L * n
            if routes != want:
                raise AssertionError(f'moe train: X1 {what} routes {routes} '
                                     f'!= {want}')
    return check


def moe_train_phase(torch, np, card):
    """Phase 16: MoE training. (a) float32 layer gradients through the
    kernels against the plain versions; (b) TrainEngine + AdamW over
    MoEConfig() at 4 layers, dispatch 'ragged', bf16, 4 x 2048 tokens
    (train_run: falling losses, exact launches a step: K1 / K2 2L + 1,
    K5 L, K6 2L, X1 3L forward, 3L dx and 3L dW, every X1 launch on the
    tensor cores; the loss is the plain float32 log-softmax, as the JAX
    package's MoE loss is, so no K3 / K4; one step traced). Returns its
    launch counts as one path."""
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM

    t_phase = time.perf_counter()
    moe_layer_grads(torch, np, card)
    L = MOE_TRAIN_LAYERS
    cfg = dataclasses.replace(MoEConfig(), num_hidden_layers=L,
                              dispatch_mode='ragged')
    launches = train_run(
        torch, np, card, cfg, MOE_TRAIN_B, MOE_TRAIN_S, 'moe train',
        ('flash_attention_fwd', 'flash_attention_bwd'),
        model_fn=lambda: MoEForCausalLM(cfg, seed=0, dtype='bfloat16'),
        per_step=dict(rms_norm=2 * L + 1, rms_norm_bwd=2 * L + 1,
                      moe_grouped_matmul=3 * L,
                      moe_grouped_matmul_dx=3 * L,
                      moe_grouped_matmul_dw=3 * L),
        routes_fn=moe_train_routes(L))
    print(f'moe train: phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return {'moe train': launches}


def lap_timer():
    """lap(name) prints the seconds since the previous lap (the first:
    since the timer was made) as the time phase `name` took."""
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        print(f'chip_smoke: phase {name} took {now - last[0]:.1f} s',
              flush=True)
        last[0] = now

    return lap


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

    t_start = time.perf_counter()
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
        spills = spilling_decode_kernels(_build.build_log())
        if spills:
            raise AssertionError(f'decode-template kernels that spill: '
                                 f'{spills}')

        lap = lap_timer()

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
                                        True),
                         # phase 11's Qwen2-7B hidden size
                         check_rms_norm(torch, timer, 4, 3584, bf16, False),
                         check_rms_norm(torch, timer, 2048, 3584, bf16,
                                        False),
                         # bf16 off the row kernel: a width that is not a
                         # multiple of 8 (the scalar path); one row
                         check_rms_norm(torch, timer, 2048, 4095, bf16,
                                        False),
                         check_rms_norm(torch, timer, 1, 4096, bf16, False)],
            # serving's 16-position pages, then block_multihead_
            # attention's 64-position ones, and float32 pages
            'paged_decode_attention': [
                check_paged(torch, timer, 32, 32),
                check_paged(torch, timer, 32, 8),
                check_paged(torch, timer, 32, 32, BS=64),
                check_paged(torch, timer, 32, 32, dtype=f32)],
            # int8 serving's per-row scales first (its main path), then
            # block_multihead_attention's static (Hkv, D) scales
            'paged_decode_attention_int8': [
                check_paged_int8(torch, timer, Hq, Hkv, row)
                for row in (True, False) for Hq, Hkv in ((32, 32),
                                                         (32, 8))] + [
                check_paged_int8(torch, timer, 32, 32, False, BS=64)],
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
        # head sizes built after fault E2's repair (padded tiles): Qwen's
        # 80 and 96 at GQA 28 / 4, and 256 (Gemma-7B's 16 heads)
        for H, Hkv, D in ((28, 4, 80), (28, 4, 96), (16, 16, 256)):
            for dt in (bf16, f32):
                fwd, bwd = check_flash(torch, timer, 1, H, Hkv, 2048, D, dt)
                cases['flash_attention_fwd'].append(fwd)
                cases['flash_attention_bwd'].append(bwd)
                torch.cuda.empty_cache()
        cases['flash_attention_fwd_seg'] = [
            check_flash_seg(torch, timer, dt) for dt in (bf16, f32)]
        torch.cuda.empty_cache()
        # the window and segment modes' backward: Mistral's GQA 32/8 bf16
        # first (the main path), then MHA, each in bf16 and float32
        for Hkv, dt in ((8, bf16), (8, f32), (32, bf16), (32, f32)):
            fwd, bwd = check_flash_window(torch, timer, 32, Hkv, dt)
            cases.setdefault('flash_attention_fwd_window', []).append(fwd)
            cases.setdefault('flash_attention_bwd_window', []).append(bwd)
            cases.setdefault('flash_attention_bwd_seg', []).append(
                check_flash_seg_bwd(torch, timer, Hkv, dt))
            torch.cuda.empty_cache()
        window_vs_causal(torch, timer, card)
        torch.cuda.empty_cache()
        # head-major decode attention: the fused decode step's b8 bf16
        # MHA first (the main path)
        cases['decode_attention_headmajor'] = [
            check_headmajor(torch, timer, B, 32, Hkv, mode)
            for B in (8, 1) for Hkv in (32, 8)
            for mode in ('bfloat16', 'float32', 'int8')]
        torch.cuda.empty_cache()
        # decode attention: the bench's b1 row first (the main path), then
        # b1 over a 32768-position cache
        cases['decode_attention'] = [
            check_decode(torch, timer, B, 32, Hkv, mode)
            for B in (1, 8) for Hkv in (32, 8)
            for mode in ('bfloat16', 'float32', 'int8')] + [
            check_decode(torch, timer, 1, 32, 32, 'bfloat16', S=32768)]
        torch.cuda.empty_cache()
        # the decode kernels at the GQA groups and head sizes built after
        # fault E2's repair: groups 7 (Qwen2-7B, phase 11's main path
        # first), 3, 5 and 6 over 4 kv heads at D = 128, 64, 80, 96, bf16
        # and int8 (K8q in the int8 serving's per-row mode), float32 at
        # group 7; K7 / K9 at the bench's b1 row, K8 / K8q at
        # check_paged's 4 ragged rows
        for g in (7, 3, 5, 6):
            for D in (128, 64, 80, 96):
                Hq = 4 * g
                modes = ('bfloat16', 'int8') + (
                    ('float32',) if g == 7 else ())
                for mode in modes:
                    cases['decode_attention'].append(check_decode(
                        torch, timer, 1, Hq, 4, mode, D=D))
                    cases['decode_attention_headmajor'].append(
                        check_headmajor(torch, timer, 1, Hq, 4, mode, D=D))
                for dt in (bf16,) + ((f32,) if g == 7 else ()):
                    cases['paged_decode_attention'].append(check_paged(
                        torch, timer, Hq, 4, D=D, dtype=dt))
                    cases['paged_decode_attention_int8'].append(
                        check_paged_int8(torch, timer, Hq, 4, True, D=D,
                                         dtype=dt))
        # K7 at phase 11's b8 decode (bf16 and int8 caches)
        cases['decode_attention'] += [
            check_decode(torch, timer, 8, 28, 4, mode)
            for mode in ('bfloat16', 'int8')]
        torch.cuda.empty_cache()
        # weight-only products: M = 1 bf16 at 4096 x 4096 first, then
        # the short prompts' M = 64 and 256 in bf16 (the tensor cores)
        llama_proj = ((4096, 4096), (4096, 11008), (11008, 4096),
                      (4096, 32000))
        for bits, name in ((8, 'quant_matmul'), (4, 'quant_matmul_int4')):
            cases[name] = [
                check_quant_matmul(torch, timer, M, K, N, dt, bits)
                for M in (1, 8, 16, 2048) for K, N in llama_proj
                for dt in (bf16, f32)] + [
                check_quant_matmul(torch, timer, M, K, N, bf16, bits)
                for M in (64, 256) for K, N in llama_proj]
            torch.cuda.empty_cache()
        # fp8 codes (K10f8): K10's Llama-7B rows and Qwen2-7B's MLP
        # projections in bf16 e4m3 (the nn.quant default), then e5m2 and
        # a float32 x at M = 1
        cases['quant_matmul_fp8'] = [
            check_quant_matmul(torch, timer, M, K, N, bf16, 'e4m3')
            for M in (1, 8, 16, 2048, 64, 256) for K, N in llama_proj] + [
            check_quant_matmul(torch, timer, M, K, N, bf16, 'e4m3')
            for M in (1, 2048) for K, N in ((3584, 18944), (18944, 3584))] + [
            check_quant_matmul(torch, timer, 1, 4096, 4096, bf16, 'e5m2'),
            check_quant_matmul(torch, timer, 1, 4096, 4096, f32, 'e4m3')]
        torch.cuda.empty_cache()
        path_crossover(torch, timer, card)
        torch.cuda.empty_cache()
        # 14 (d). the grouped expert product X1: the 64-expert model's
        # decode at b1 / b8 (gate / up, then down) and 512-token prefill,
        # then Mixtral-8x7B's decode at b1 / b8 and 512-token prefill;
        # then both b8 512-token prefills in bf16 (where the operations
        # come level with the bytes or take over)
        cases['moe_grouped_matmul'] = [
            check_moe_matmul(torch, np, timer, T, E, k, K, N, dt)
            for E, k, shapes in (
                (64, 6, ((1, 2048, 1408), (1, 1408, 2048), (8, 2048, 1408),
                         (8, 1408, 2048), (512, 2048, 1408),
                         (512, 1408, 2048))),
                (8, 2, ((1, 4096, 14336), (1, 14336, 4096),
                        (8, 4096, 14336), (8, 14336, 4096),
                        (512, 4096, 14336), (512, 14336, 4096))))
            for T, K, N in shapes for dt in (bf16, f32)] + [
            check_moe_matmul(torch, np, timer, 4096, E, k, K, N, bf16)
            for E, k, K, N in ((64, 6, 2048, 1408), (64, 6, 1408, 2048),
                               (8, 2, 4096, 14336), (8, 2, 14336, 4096))]
        torch.cuda.empty_cache()
        moe_crossover(torch, np, timer, card)
        torch.cuda.empty_cache()
        # 16 (c). X1's backward, dx and dW, at phase 16's training step,
        # the b8 / b1 prefills and Mixtral's shapes, with empty experts
        for T, E, k, K, N, dts, empty in X1_BWD_ROWS:
            for dt in dts:
                dx, dw = check_moe_backward(torch, np, timer, T, E, k, K, N,
                                            getattr(torch, dt), empty)
                cases.setdefault('moe_grouped_matmul_dx', []).append(dx)
                cases.setdefault('moe_grouped_matmul_dw', []).append(dw)
            torch.cuda.empty_cache()
        for name, cs in cases.items():
            for c in cs:
                print(f'kernel {name}: {json.dumps(c)} [{card}]', flush=True)
        for name in ('decode_attention', 'decode_attention_headmajor',
                     'paged_decode_attention',
                     'paged_decode_attention_int8'):
            for c in cases[name]:
                lib = ('' if c['library_ms'] is None
                       else f', SDPA {c["library_ms"]:.4f}')
                print(f'{name} {c["shape"]}: {c["kernels_per_call"]} CUDA '
                      f'kernel per call, {c["regs"]} registers, '
                      f'{c["spill_bytes"]} bytes spilled, '
                      f'{c["blocks_per_sm"]} blocks per SM, '
                      f'{c["nsplit"]} splits of {c["chunk"]}; '
                      f'{c["ms"]:.4f} ms, bound {c["bound_ms"]:.4f}{lib} '
                      f'[{card}]')
        for c in cases['rms_norm']:
            print(f'rms_norm {c["shape"]}: {c["ms"]:.4f} ms, bound '
                  f'{c["bound_ms"]:.4f}, F.rms_norm '
                  f'{c["library_ms"]:.4f} [{card}]')
        for c in cases['moe_grouped_matmul']:
            lib = ('' if c['library_ms'] is None
                   else f', torch._grouped_mm {c["library_ms"]:.4f}')
            tiled = (f' (CUDA-core tiles {c["tiled_ms"]:.4f})'
                     if 'tiled_ms' in c else '')
            print(f'moe_grouped_matmul {c["shape"]} ({c["path"]}): '
                  f'{c["ms"]:.4f} ms{tiled}, bound {c["bound_ms"]:.4f} '
                  f'({c["bound_by"]}), plain {c["plain_ms"]:.4f}{lib} '
                  f'[{card}]')
        for c in cases['moe_grouped_matmul_dx'] + cases[
                'moe_grouped_matmul_dw']:
            lib = ('' if c['library_ms'] is None
                   else f', torch._grouped_mm {c["library_ms"]:.4f}')
            print(f'moe_grouped_matmul {c["product"]} {c["shape"]} '
                  f'({c["path"]}): {c["ms"]:.4f} ms, bound '
                  f'{c["bound_ms"]:.4f} ({c["bound_by"]}), plain '
                  f'{c["plain_ms"]:.4f}{lib} [{card}]')
        del timer
        torch.cuda.empty_cache()
        lap('3 (kernel checks)')

        # 14 (a)-(c). the MoE language model, right after the kernel
        # checks: its profile is the process's first profiler session
        moe_launches_ = moe_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('14 (MoE LM)')

        # 4-5. serving, launch counts, leaks, logits; then int8 serving
        serve_launches, int8_launches = serve_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('4-5 (serving)')

        # 6. decode over contiguous caches: the JAX bench's decode
        # section, DecodeEngine, float32 agreement
        decode_launches = decode_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('6 (decode)')

        # 7. Paddle's fused-inference ops: fused_multi_transformer,
        # FusedMultiTransformer, block_multihead_attention
        fused_launches = fused_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('7 (fused inference)')

        # 8. a training step's gradients through the kernels vs plain
        grads_phase(torch, np, card)
        lap('8 (gradients)')

        # 9. training at the JAX bench's configuration
        train_launches = train_phase(torch, np, card)
        lap('9 (training)')

        # 10. sliding-window and packed training, sliding-window decode
        swa_launches = swa_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('10 (SWA, packed)')

        # 11. Qwen2-7B widths: serving, decode, fp8 weights, agreement
        qwen2_launches = qwen2_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('11 (Qwen2-7B)')

        # 12. per-request sampling, prefix caching, chunked prefill
        prefix_launches = prefix_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('12 (prefix, chunks)')

        # 13. speculative decoding: generate, DecodeEngine, ServingEngine
        spec_launches = spec_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('13 (speculative)')

        # 15. the compiled decode window and step against their bodies
        graph_launches = graphs_phase(torch, np, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap('15 (graphs)')

        # 16. MoE training: layer gradients, TrainEngine at MoEConfig()
        moe_train_launches = moe_train_phase(torch, np, card)
        lap('16 (MoE training)')

        records = []
        for name, src, rep in (
                ('rms_norm', 'rms_norm.cu', 'rms_norm.py:53'),
                ('rms_norm_bwd', 'rms_norm.cu', 'rms_norm.py:86'),
                ('softmax_xent_fwd', 'softmax_xent.cu', 'softmax_xent.py:92'),
                ('softmax_xent_bwd', 'softmax_xent.cu',
                 'softmax_xent.py:131'),
                ('flash_attention_fwd', 'flash_attention_tc.cu',
                 'flash_attention.py:121'),
                ('flash_attention_fwd_seg', 'flash_attention_tc.cu',
                 'flash_attention.py:121'),
                ('flash_attention_fwd_window', 'flash_attention_tc.cu',
                 'flash_attention.py:121'),
                ('flash_attention_bwd', 'flash_attention_tc.cu',
                 'flash_attention.py:323'),
                ('flash_attention_bwd_seg', 'flash_attention_tc.cu',
                 'flash_attention.py:323'),
                ('flash_attention_bwd_window', 'flash_attention_tc.cu',
                 'flash_attention.py:323'),
                ('paged_decode_attention', 'paged_attention.cu',
                 'paged_attention.py:140'),
                ('paged_decode_attention_int8', 'paged_attention.cu',
                 'paged_attention.py:140'),
                ('decode_attention', 'decode_attention.cu',
                 'decode_attention.py:164'),
                ('decode_attention_headmajor', 'decode_attention.cu',
                 'paged_attention.py:206'),
                ('quant_matmul', 'quant_matmul.cu', 'quant_matmul.py:124'),
                ('quant_matmul_int4', 'quant_matmul.cu',
                 'quant_matmul.py:154'),
                ('quant_matmul_fp8', 'quant_matmul.cu',
                 'quant_matmul.py:124'),
                ('moe_grouped_matmul', 'moe_grouped_matmul.cu', None),
                ('moe_grouped_matmul_dx', 'moe_grouped_matmul_tc.cu', None),
                ('moe_grouped_matmul_dw', 'moe_grouped_matmul_dw.cu',
                 None)):
            cs = cases[name]
            head = cs[0]       # the main path's shape and dtype
            by_path = {'serving': serve_launches[name],
                       'int8 serving': int8_launches[name],
                       'decode': decode_launches.get(name, 0),
                       'fused': fused_launches.get(name, 0),
                       'train': train_launches[name]}
            for paths in (swa_launches, qwen2_launches, prefix_launches,
                          spec_launches, moe_launches_, graph_launches,
                          moe_train_launches):
                by_path.update((path, counts.get(name, 0))
                               for path, counts in paths.items())
            records.append({
                'name': name, 'route': 'cuda',
                'source': f'paddle_tpu_torch/csrc/{src}',
                # X1 replaces XLA's lax.ragged_dot, not a Pallas kernel,
                # and its dx / dW the VJP XLA supplies for it
                'replaces': (f'paddle_tpu/ops/pallas/{rep}' if rep else
                             'paddle_tpu/distributed/moe.py:104'),
                'launches': sum(by_path.values()),
                'launches_by_path': by_path,
                'max_abs_err': max(c['max_abs_err'] for c in cs),
                'ms': head['ms'], 'plain_ms': head['plain_ms'],
                'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
                'library_ms': head['library_ms'], 'shape': head['shape'],
                'cases': cs})
            if name.startswith('quant_matmul'):
                # past the skinny path, bf16 x takes the tensor cores
                records[-1]['tensor_core_source'] = \
                    'paddle_tpu_torch/csrc/quant_matmul_tc.cu'
            if name == 'moe_grouped_matmul':
                # past the skinny path, bf16 takes the tensor cores (the
                # prefills of phase 14's generate calls)
                records[-1]['tensor_core_source'] = \
                    'paddle_tpu_torch/csrc/moe_grouped_matmul_tc.cu'
                records[-1]['launches_by_route'] = {
                    p: moe_launches_['moe'].get(f'X1 {p}', 0)
                    for p in ('skinny', 'tensor_core', 'tiled')}
                # bf16 decode on the skinny path, prefills on the tensor
                # cores (float32 and odd shapes take the CUDA-core tiles:
                # phase 3's rows)
                by_route = records[-1]['launches_by_route']
                if not (by_route['skinny'] and by_route['tensor_core']):
                    raise AssertionError(f'X1 routes phase 14 never '
                                         f'launched: {by_route}')
            if name == 'moe_grouped_matmul_dx':
                # the forward's routes over the transposed weight: bf16
                # past the skinny bound on the tensor cores, the rest in
                # moe_grouped_matmul.cu
                records[-1]['cuda_core_source'] = \
                    'paddle_tpu_torch/csrc/moe_grouped_matmul.cu'
            if name.startswith('flash_attention'):
                # bf16 up to D = 128 (the main paths) on the tensor cores;
                # float32 and bf16 past 128 on the CUDA cores
                records[-1]['path'] = head['path']
                records[-1]['cuda_core_source'] = \
                    'paddle_tpu_torch/csrc/flash_attention.cu'
        unused = [r['name'] for r in records if not r['launches']]
        if unused:
            raise AssertionError(f'kernels the paths never launched: '
                                 f'{unused}')
        print(f'chip_smoke: every phase in '
              f'{time.perf_counter() - t_start:.1f} s')
        print(card)
        print(json.dumps({'kernels': records}))
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        fail('a phase failed (traceback above)')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


def profile_main(card):
    """`chip_smoke.py --graphs-profile CARD`: phase 15's traces in a
    process of their own (the parent has built the kernels)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false')
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs_profile(torch, np, card)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--graphs-profile']:
        profile_main(sys.argv[2])
    else:
        main()
