#!/usr/bin/env python3
"""The flash backward's dk/dv grid under GQA, swept on one CUDA card.

    python3 tools/flash_dkv_sweep.py

At S = 2048, D = 128, 32 query heads, causal, bf16 (the tensor-core
route), for batch B in (1, 2, 4) and kv heads Hkv in (32, 16, 8, 4, 2,
1): the backward's time with its dk/dv blocks walking the whole GQA
group (one slice: B x Hkv x S / 128 blocks) and with the slices that
`dkv_slices` picks, then the window (S = 4096, window 1024) and packed
(T = 4096) shapes of chip_smoke.py's phase 3 at GQA 32 / 8 with 1, 2
and 4 slices. One JSON line per row (CUDA events, L2 flushed before each
call, chip_smoke.Timer), then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        sys.exit('flash_dkv_sweep: needs a CUDA card')
    import chip_smoke as cs
    from paddle_tpu_torch.ops.hopper import flash_attention as k

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = cs.Timer(torch)
    g = torch.Generator(device='cuda').manual_seed(5)

    def inputs(B, S, H, Hkv, D=128):
        def bshd(h):
            return torch.randn(B, S, h, D, device='cuda', generator=g) \
                .to(torch.bfloat16).transpose(1, 2)
        return bshd(H), bshd(Hkv), bshd(Hkv), bshd(H)

    H, S = 32, 2048
    for B in (1, 2, 4):
        for Hkv in (32, 16, 8, 4, 2, 1):
            q, kk, v, do = inputs(B, S, H, Hkv)
            out, lse = k.flash_attention_fwd(q, kk, v, True, None)
            auto = k.dkv_slices(B, Hkv, S, H // Hkv, sms)
            row = {'shape': f'B={B} H={H} Hkv={Hkv} S={S} D=128 causal',
                   'blocks': B * Hkv * -(-S // k.TC_KEYS), 'auto': auto}
            for n in sorted({1, auto}):
                row[f'ms_slices_{n}'] = timer(lambda: k.flash_attention_bwd(
                    q, kk, v, out, lse, do, True, None, slices=n), iters=10)
            print(json.dumps(row), flush=True)
            del q, kk, v, do, out, lse
    T, W, Hkv = 4096, 1024, 8
    q, kk, v, do = inputs(1, T, H, Hkv)
    lens = [1000, 1900, 96, 1100]
    seg = torch.repeat_interleave(
        torch.arange(len(lens), device='cuda', dtype=torch.int32),
        torch.tensor(lens, device='cuda'))[None]
    for label, kw in ((f'window {W}', {'window': W}),
                      (f'segments {lens}', {'qseg': seg, 'kseg': seg})):
        out, lse = k.flash_attention_fwd(q, kk, v, True, None, **kw)
        row = {'shape': f'B=1 H={H} Hkv={Hkv} S={T} D=128 causal {label}',
               'blocks': Hkv * -(-T // k.TC_KEYS),
               'auto': k.dkv_slices(1, Hkv, T, H // Hkv, sms)}
        for n in (1, 2, 4):
            row[f'ms_slices_{n}'] = timer(lambda: k.flash_attention_bwd(
                q, kk, v, out, lse, do, True, None, **kw, slices=n),
                iters=10)
        print(json.dumps(row), flush=True)
    print(card)


if __name__ == '__main__':
    main()
