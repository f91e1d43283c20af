#!/usr/bin/env python3
"""Speculative decoding throughput of the port on one CUDA card, for
comparing trees.

    python3 paddle_tpu_torch/tools/spec_throughput.py [TREE] [--repeats N]

Imports paddle_tpu_torch from TREE (default: the checkout this file lies
in) and builds, as chip_smoke.py's phase 13 does, a Llama-7B-width model
(all 32 layers, bf16, weights drawn from seed 0) and a 2-layer draft (its
first two layers under its embedding, final norm and head), k = 4. Each
measurement runs once untimed (a tree that captures its windows captures
them then), then N timed runs, each printed as one JSON line:

  - `b1`: DecodeEngine.generate_speculative, one 512-token prompt, 64 new
    tokens, against model.generate on the same prompt;
  - `b8`: the same at 8 x 256 tokens, 32 new tokens;
  - `serving`: chip_smoke.py's serving burst (8 requests of 32-512 prompt
    tokens and 32 new tokens, admitted in three waves) through
    ServingEngine(draft=) against the engine without a draft;
  - `window_trace`: one speculative engine step of 4 greedy rows traced
    with torch.profiler (its wall, device-busy time and their ratio).

Every line carries tokens/s (or ms), the speculative windows and the
card's name and power limit. To compare two trees, run this script on
each in turn within one call on one machine (A, B, B, A): the host's
speed drifts between calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

# serving_throughput.py lies beside this file (on sys.path as the
# script's directory): the same burst and traced step
from serving_throughput import burst, window_trace


def layer_draft(torch, model, layers):
    """The model's first `layers` layers under its embedding, final norm
    and head, as a model of its own."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = dataclasses.replace(model.config, num_hidden_layers=layers)
    draft = LlamaForCausalLM(cfg, device=model.device, seed=3)
    keep = tuple(f'model.layers.{i}.' for i in range(layers))
    draft.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith('model.layers.')
                           or k.startswith(keep)})
    return draft


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tree', nargs='?',
                    default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument('--repeats', type=int, default=2)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit('spec_throughput: needs a CUDA card')
    from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.ops import _build

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    _build.load()
    k = 4
    model = LlamaForCausalLM(dataclasses.replace(llama_7b(),
                                                 dtype='bfloat16'), seed=0)
    draft = layer_draft(torch, model, 2)
    V = model.config.vocab_size

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def emit(**row):
        print(json.dumps(dict(tree=tree, card=card, **row)), flush=True)

    for label, B, P, N in (('b1', 1, 512, 64), ('b8', 8, 256, 32)):
        ids = torch.from_numpy(np.random.default_rng(13 + B).integers(
            3, V, (B, P))).to(model.device)
        eng = DecodeEngine(model, max_new_tokens=N)
        eng.generate_speculative(draft, ids, num_draft_tokens=k)
        model.generate(ids, max_new_tokens=N)
        for rep in range(args.repeats):
            w0 = eng.stats()['spec']['windows']
            out, t_spec = timed(lambda: eng.generate_speculative(
                draft, ids, num_draft_tokens=k))
            windows = eng.stats()['spec']['windows'] - w0
            ref, t_ref = timed(lambda: model.generate(ids,
                                                      max_new_tokens=N))
            emit(what=label, run=rep, spec_tok_s=B * N / t_spec,
                 plain_tok_s=B * N / t_ref, ratio=t_ref / t_spec,
                 windows=windows, ms_per_window=t_spec / windows * 1e3,
                 equal_to_generate=bool(torch.equal(out, ref)))
        eng.release()

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, V, n).astype(np.int32)
               for n in rng.integers(32, 513, 8)]
    kw = dict(max_slots=4, block_size=16, decode_window=8,
              max_new_tokens=32)
    for spec in (False, True):
        engine = ServingEngine(model, **(dict(kw, draft=draft,
                                              num_draft_tokens=k)
                                         if spec else kw))
        burst(engine, prompts)          # untimed: captures, allocations
        for rep in range(args.repeats):
            before = engine.stats()
            outs, wall = timed(lambda: burst(engine, prompts))
            after = engine.stats()
            if any(o is None or len(o) != len(p) + 32
                   for p, o in zip(prompts, outs)):
                sys.exit('spec_throughput: a request did not return '
                         'prompt + 32 ids')
            n_tok = after['tokens_generated'] - before['tokens_generated']
            emit(what='serving', speculative=spec, run=rep, tokens=n_tok,
                 wall_s=wall, tok_s=n_tok / wall,
                 windows=(after['spec']['windows']
                          - before['spec']['windows']))
        if spec:
            rids = [engine.submit(p, 16) for p in prompts[:4]]
            engine.step()             # admissions and a first window
            wall, busy = window_trace(torch, engine)
            engine.run()
            for r in rids:
                engine.result(r)
            emit(what='window_trace', wall_ms=wall, busy_ms=busy,
                 busy_share=busy / wall)
        del engine


if __name__ == '__main__':
    main()
