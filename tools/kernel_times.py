#!/usr/bin/env python3
"""Kernel times of the PyTorch port on one CUDA card, for comparing trees.

    python3 tools/kernel_times.py [TREE]

Imports paddle_tpu_torch and chip_smoke.py from TREE (default: the
checkout this file lies in), builds the kernels, and times the decode,
paged, flash and weight-only kernels with TREE's own chip_smoke.py check
functions (each checked against its plain version, timed with CUDA
events and the L2 cache flushed). Prints one JSON line per kernel shape:
the kernel's name, the shape, and its ms. The shapes are Llama-7B's rows
of PERF.md's kernel table, K7 / K9 at the GQA groups and head sizes of
fault E2's repair and K7 over a 32768-position cache, which trees since
the GQA-group and head-size repair build too (K10f8's since the fp8
codes), so an older tree and a newer one compare row by row;
chip_smoke.py's phase 3 holds every shape of the current tree. A flash
row also names the route its kernels took (`path`: tensor_core or
cuda_core) where the tree has routes.
Run it on each tree in turn within one call on one machine (A, B, B, A):
kernel times hold within a few per cent there, and the card may differ
between calls.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tree', nargs='?', default=os.path.dirname(here))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        sys.exit('kernel_times: needs a CUDA card')
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    _build.build()
    _build.load()
    build_s = time.perf_counter() - t
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def add(name, rec):
        rows.append((name, rec['shape'], rec['ms'], rec.get('path')))

    for B in (1, 8):
        for Hkv in (32, 8):
            for mode in ('bfloat16', 'float32', 'int8'):
                add('decode_attention',
                    cs.check_decode(torch, timer, B, 32, Hkv, mode))
                add('decode_attention_headmajor',
                    cs.check_headmajor(torch, timer, B, 32, Hkv, mode))
    # the decode kernels at the GQA groups and head sizes of fault E2's
    # repair (Qwen2-7B's group 7 first) and b1 over a 32768-position cache
    e2 = [(7, 128, mode) for mode in ('bfloat16', 'int8', 'float32')] + [
        (7, D, 'bfloat16') for D in (64, 80, 96)] + [
        (g, 128, 'bfloat16') for g in (3, 5, 6)]
    for g, D, mode in e2:
        add('decode_attention',
            cs.check_decode(torch, timer, 1, 4 * g, 4, mode, D=D))
        add('decode_attention_headmajor',
            cs.check_headmajor(torch, timer, 1, 4 * g, 4, mode, D=D))
    for mode in ('bfloat16', 'int8'):
        add('decode_attention', cs.check_decode(torch, timer, 8, 28, 4, mode))
    add('decode_attention',
        cs.check_decode(torch, timer, 1, 32, 32, 'bfloat16', S=32768))
    torch.cuda.empty_cache()
    for Hkv in (32, 8):
        add('paged_decode_attention', cs.check_paged(torch, timer, 32, Hkv))
        for row in (True, False):
            add('paged_decode_attention_int8',
                cs.check_paged_int8(torch, timer, 32, Hkv, row))
    for H, Hkv, dt in ((32, 32, bf16), (32, 32, f32), (32, 8, bf16)):
        fwd, bwd = cs.check_flash(torch, timer, 1, H, Hkv, 2048, 128, dt)
        add('flash_attention_fwd', fwd)
        add('flash_attention_bwd', bwd)
        torch.cuda.empty_cache()
    # the head sizes of fault E2's repair: D 80 / 96 at GQA 28 / 4 on the
    # tensor cores, 256 on the CUDA cores
    for H, Hkv, D, dt in ((28, 4, 80, bf16), (28, 4, 96, bf16),
                          (16, 16, 256, bf16)):
        fwd, bwd = cs.check_flash(torch, timer, 1, H, Hkv, 2048, D, dt)
        add('flash_attention_fwd', fwd)
        add('flash_attention_bwd', bwd)
        torch.cuda.empty_cache()
    for Hkv, dt in ((8, bf16), (32, bf16), (32, f32)):
        fwd, bwd = cs.check_flash_window(torch, timer, 32, Hkv, dt)
        add('flash_attention_fwd_window', fwd)
        add('flash_attention_bwd_window', bwd)
        torch.cuda.empty_cache()
    for dt in (bf16, f32):
        add('flash_attention_fwd_seg', cs.check_flash_seg(torch, timer, dt))
    for Hkv in (8, 32):
        add('flash_attention_bwd_seg',
            cs.check_flash_seg_bwd(torch, timer, Hkv, bf16))
    torch.cuda.empty_cache()
    # weight-only products: decode rows (the skinny path) in bf16 and
    # float32, short and long prompts in bf16 (the tensor cores) and
    # float32 at M = 2048 (the CUDA cores), fp8 at M = 2048
    for bits, name in ((8, 'quant_matmul'), (4, 'quant_matmul_int4')):
        for M, dts in ((1, (bf16, f32)), (16, (bf16, f32)), (64, (bf16,)),
                       (256, (bf16,)), (2048, (bf16, f32))):
            for K, N in ((4096, 4096), (4096, 32000)):
                for dt in dts:
                    add(name, cs.check_quant_matmul(torch, timer, M, K, N,
                                                    dt, bits))
        torch.cuda.empty_cache()
    for K, N in ((4096, 4096), (4096, 32000)):
        add('quant_matmul_fp8', cs.check_quant_matmul(torch, timer, 2048, K,
                                                      N, bf16, 'e4m3'))
    for name, shape, ms, path in rows:
        row = {'tree': tree, 'kernel': name, 'shape': shape, 'ms': ms,
               'card': card}
        if path is not None:
            row['path'] = path
        print(json.dumps(row), flush=True)
    print(json.dumps({'tree': tree, 'build_s': build_s, 'card': card}))


if __name__ == '__main__':
    main()
