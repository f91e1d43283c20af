#!/usr/bin/env python3
"""Decode-attention (K7 / K9) times of the PyTorch port on one CUDA card,
for comparing trees and kernel variants.

    python3 tools/decode_times.py [TREE] [LABEL] [--forwards]

Imports paddle_tpu_torch and chip_smoke.py from TREE (default: the
checkout this file lies in) and prints one line per row, each timed by
chip_smoke.Timer (CUDA events, L2 flushed before every call): the decode
rows of PERF.md's table that move most with the kernel's design (b1 and
b8, MHA and GQA, bf16 / int8 / float32, Qwen2-7B's group 7, b1 over a
32768-position cache); the fixed cost of a call (the same b1 call over an
empty window, 64 positions and 2000 positions, and a one-element fill_
kernel); and the b1 MHA rows again with the flush followed by a read of
another 128 MB buffer, so that the L2 holds clean lines and not the
flush's dirty ones. With --forwards it prints instead phase 6's b1 and
b8 decode forwards (Llama-7B width, 32 layers, bf16, 2048-position
caches) as TREE's chip_smoke.bench_decode runs them, each followed by
one forward traced with torch.profiler (wall, device busy and their
ratio), and one JSON line per batch. Run each tree in turn within one
call (A, B, B, A): one card, one power limit.
"""
from __future__ import annotations

import argparse
import os
import sys


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tree', nargs='?', default=os.path.dirname(here))
    ap.add_argument('label', nargs='?', default=None)
    ap.add_argument('--forwards', action='store_true')
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        sys.exit('decode_times: needs a CUDA card')
    import chip_smoke as cs
    from paddle_tpu_torch.ops.hopper import decode_attention as k

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.forwards:
        forwards(torch, cs, tree, label)
        return
    timer = cs.Timer(torch)

    def show(name, r):
        geo = ''
        if 'regs' in r:      # trees since the one-launch kernel
            geo = (f' regs {r["regs"]} blocks/SM {r["blocks_per_sm"]} '
                   f'nsplit {r["nsplit"]}')
        print(f'{label} {name} {r["shape"][:48]}: ms {r["ms"]:.4f} bound '
              f'{r["bound_ms"]:.4f} SDPA {r["library_ms"]:.4f}{geo}',
              flush=True)

    for B, Hq, Hkv, mode in ((1, 32, 32, 'bfloat16'), (1, 32, 32, 'int8'),
                             (1, 32, 32, 'float32'), (1, 32, 8, 'bfloat16'),
                             (8, 32, 32, 'bfloat16'), (8, 32, 32, 'int8'),
                             (8, 32, 32, 'float32'), (8, 32, 8, 'bfloat16'),
                             (8, 32, 8, 'int8'), (1, 28, 4, 'bfloat16'),
                             (1, 28, 4, 'int8'), (8, 28, 4, 'bfloat16')):
        show('K7', cs.check_decode(torch, timer, B, Hq, Hkv, mode))
        if Hq == 32:
            show('K9', cs.check_headmajor(torch, timer, B, Hq, Hkv, mode))
    show('K7', cs.check_decode(torch, timer, 1, 32, 32, 'bfloat16',
                               S=32768))
    torch.cuda.empty_cache()

    # the fixed cost of a b1 call
    for Hq, Hkv in ((32, 32), (28, 4)):
        q = torch.randn(1, 1, Hq, 128, device='cuda').bfloat16()
        kc = torch.randn(1, 2048, Hkv, 128, device='cuda').bfloat16()
        for vl in (0, 64, 2000):
            ms = timer(lambda: k.decode_attention(q, kc, kc, vl))
            print(f'{label} fixed cost: K7 b1 {Hq}/{Hkv} bf16 over '
                  f'{vl} positions: ms {ms:.4f}', flush=True)
    one = torch.empty(1, device='cuda')
    print(f'{label} fixed cost: a one-element fill_: ms '
          f'{timer(lambda: one.fill_(1.0)):.4f}', flush=True)

    class CleanTimer(cs.Timer):
        """The flush, then a read of another 128 MB (clean L2 lines)."""

        def __init__(self, torch):
            super().__init__(torch)
            self.other = torch.ones(128 << 20, dtype=torch.uint8,
                                    device='cuda')

        def __call__(self, fn, iters=30, warmup=3):
            for _ in range(warmup):
                fn()
            total = 0.0
            for _ in range(iters):
                self.flush.zero_()
                self.other.sum(dtype=torch.int32)
                torch.cuda._sleep(self.HOLD_CYCLES)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                e.synchronize()
                total += s.elapsed_time(e)
            return total / iters

    clean = CleanTimer(torch)
    for mode in ('bfloat16', 'int8'):
        show('K7 (clean L2)', cs.check_decode(torch, clean, 1, 32, 32, mode))


def forwards(torch, cs, tree, label):
    """Phase 6's b1 and b8 bf16 decode forwards through the tree's
    bench_decode (its launch-count checks included), each profiled."""
    import dataclasses
    import json
    import subprocess

    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    model = LlamaForCausalLM(dataclasses.replace(llama_7b(),
                                                 dtype='bfloat16'), seed=0)
    for B in (1, 8):
        tps, ms, _ = cs.bench_decode(torch, model, B, f'{label} b{B} bf16',
                                     card, profile=True)
        print(json.dumps({'tree': tree, 'batch': B, 'tokens_s': tps,
                          'ms_per_forward': ms, 'card': card}), flush=True)
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
