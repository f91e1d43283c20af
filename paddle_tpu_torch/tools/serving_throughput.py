#!/usr/bin/env python3
"""Serving throughput of the port on one CUDA card, for comparing trees.

    python3 paddle_tpu_torch/tools/serving_throughput.py [TREE] [--repeats N]

Imports paddle_tpu_torch from TREE (default: the checkout this file lies
in), builds a ServingEngine over a Llama-7B-width model (all 32 layers,
bf16, weights drawn from seed 0) as chip_smoke.py's serving phase does,
warms it on one short request, then serves chip_smoke.py's burst (8
requests of 32-512 prompt tokens and 32 new tokens each, admitted in
three waves) N times. Each run prints one JSON line: tokens, wall time,
tokens/s and ms per decode forward. Then one engine step that decodes a
full window of 4 rows is traced with torch.profiler (its wall, device-
busy time and their ratio, one more JSON line). To compare two trees,
run this script on each in turn within one call on one machine (A, B,
B, A): the host's speed drifts between calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time


def burst(engine, prompts):
    """chip_smoke.py's staggered arrivals: 2 requests, a step, 2 more, a
    step, the rest, then run to completion."""
    rids = [engine.submit(p) for p in prompts[:2]]
    engine.step()
    rids += [engine.submit(p) for p in prompts[2:4]]
    engine.step()
    rids += [engine.submit(p) for p in prompts[4:]]
    engine.run()
    return [engine.result(r) for r in rids]


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
        sys.exit('serving_throughput: needs a CUDA card')
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.ops import _build

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    _build.load()
    cfg = dataclasses.replace(llama_7b(), dtype='bfloat16')
    model = LlamaForCausalLM(cfg, seed=0)
    engine = ServingEngine(model, max_slots=4, block_size=16,
                           decode_window=8, max_new_tokens=32)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 513, 8)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    engine.serve([prompts[0][:32]], max_new_tokens=8)
    for rep in range(args.repeats):
        before = engine.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = burst(engine, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = engine.stats()
        if any(o is None or len(o) != len(p) + 32
               for p, o in zip(prompts, outs)):
            sys.exit('serving_throughput: a request did not return '
                     'prompt + 32 ids')
        n_tok = after['tokens_generated'] - before['tokens_generated']
        n_dec = after['decode_forwards'] - before['decode_forwards']
        print(json.dumps({
            'tree': tree, 'run': rep, 'tokens': n_tok,
            'wall_s': wall, 'tok_s': n_tok / wall,
            'ms_per_decode_forward': wall / n_dec * 1e3, 'card': card}),
            flush=True)
    rids = [engine.submit(p, 16) for p in prompts[:4]]
    engine.step()                 # admissions and a first window
    wall, busy = window_trace(torch, engine)
    engine.run()
    for r in rids:
        engine.result(r)
    print(json.dumps({'tree': tree, 'window_trace_wall_ms': wall,
                      'window_trace_busy_ms': busy,
                      'window_busy_share': busy / wall, 'card': card}),
          flush=True)


def window_trace(torch, engine):
    """(wall ms, device-busy ms) of one engine step traced with
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA')) / 1e3
    return wall, busy


if __name__ == '__main__':
    main()
