#!/usr/bin/env python3
"""The MoE language model's 512-token prefill, and the decode forwards
after it, on one CUDA card, for comparing trees.

    python3 paddle_tpu_torch/tools/moe_prefill.py [TREE] [--repeats N]

Imports paddle_tpu_torch from TREE (default: the checkout this file lies
in) and builds its kernels, then for MoEConfig() (24 layers, 64 routed
experts top 6 + 2 shared, bf16) and Mixtral-8x7B's widths at 4 of its 32
layers (its config.json as chip_smoke.py types it in), each with
weights drawn from seed 0 as chip_smoke.py's phase 14 draws them:

- times generate(max_new_tokens=1) over seeded 512-token prompts at
  batch 1 and 8, one warm call and N timed ones (host clock around a
  synchronised call: the prefill and one token's sampling), then
  generate(max_new_tokens=17) N times: ms per decode forward is its
  time less the faster prefill, over 16;
- traces one b8 prefill forward (the model over the prompts into fresh
  caches) with torch.profiler: wall and device-busy time, X1's device
  time by kernel (its skinny, CUDA-core and tensor-core kernels), and
  the top kernels.

Each model prints one JSON line. To compare two trees, run this script
on each in turn within one call on one machine (A, B, B, A).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

PROMPT, DECODE = 512, 16
# X1's kernels by name in a trace
X1_KERNELS = ('moe_skinny_kernel', 'moe_tiled_kernel', 'moe_tc_kernel')


def trace(torch, fn):
    """(wall ms, busy ms, kernels, {X1 kernel: ms}, top 8 rows) of fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')
                   and e.self_device_time_total > 0), reverse=True)
    x1 = {tag: sum(r[0] for r in rows if tag in r[2]) for tag in X1_KERNELS}
    return (wall, sum(r[0] for r in rows), sum(r[1] for r in rows),
            {k: v for k, v in x1.items() if v},
            [[round(ms, 4), n, key[:80]] for ms, n, key in rows[:8]])


def run(torch, np, model, label, card, repeats):
    cfg = model.config
    out = {'model': label, 'layers': cfg.num_hidden_layers, 'card': card}
    for B in (1, 8):
        ids = torch.from_numpy(np.random.default_rng(B + 40).integers(
            3, cfg.vocab_size, (B, PROMPT))).to(model.device)
        model.generate(ids, max_new_tokens=2)                  # warm
        ms = {}
        for n in (1, DECODE + 1):
            ms[n] = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                t = time.perf_counter()
                model.generate(ids, max_new_tokens=n)
                torch.cuda.synchronize()
                ms[n].append((time.perf_counter() - t) * 1e3)
        out[f'b{B}_prefill_ms'] = ms[1]
        out[f'b{B}_decode_forward_ms'] = [(t - min(ms[1])) / DECODE
                                          for t in ms[DECODE + 1]]
    with torch.no_grad():
        caches = model.init_cache(8, PROMPT)
        wall, busy, n, x1, top = trace(
            torch, lambda: model(ids, caches=caches, cache_index=0))
    out.update(b8_trace_wall_ms=wall, b8_trace_busy_ms=busy,
               b8_trace_kernels=n, b8_trace_x1_ms=x1, b8_trace_top=top)
    del caches
    return out


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tree', nargs='?',
                    default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument('--repeats', type=int, default=3)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit('moe_prefill: needs a CUDA card')
    import chip_smoke
    from paddle_tpu_torch.models.convert import hf_mixtral_config
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.ops import _build

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    _build.load()
    for label, cfg in (
            ('MoEConfig()', MoEConfig()),
            ('Mixtral-8x7B widths', dataclasses.replace(
                hf_mixtral_config(chip_smoke.MIXTRAL_8X7B),
                num_hidden_layers=chip_smoke.MIXTRAL_LAYERS))):
        model = MoEForCausalLM(cfg, seed=0, dtype='bfloat16')
        rec = run(torch, np, model, label, card, args.repeats)
        rec['tree'] = tree
        print(json.dumps(rec), flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
