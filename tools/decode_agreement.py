#!/usr/bin/env python3
"""Where the float32 int8-KV agreement of chip_smoke.py's phase 6 comes
from, on one CUDA card.

    python3 tools/decode_agreement.py [TREE]

Imports paddle_tpu_torch and chip_smoke.py from TREE (default: the
checkout this file lies in) and prints:

  1. K7 with a float32 query over int8 caches against a float64
     reference and against its plain version (mean relative error, and
     the share of output elements that are not bit-equal);
  2. phase 6's int8-KV generate (2 layers, float32, at Llama-7B and
     Qwen2-7B widths, the same seed and prompt) run four ways, K1 and K7
     each through its kernel or its plain version: the largest logit
     difference between each pair of runs, and for Llama-7B every int8
     code and calibrated scale the two runs of a pair quantize
     differently, with the flipped value's distance from a rounding
     boundary (in code steps).

Run it on each tree to compare (it changes no bound: phase 6 keeps its
own check).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from unittest import mock


def k7_accuracy(torch, k):
    g = torch.Generator(device='cuda').manual_seed(0)
    for S, Hq, Hkv in ((38, 32, 32), (38, 28, 4), (2048, 32, 32)):
        dev, errk, errp, neq = [], [], [], []
        for trial in range(20):
            q = torch.randn(1, 1, Hq, 128, device='cuda', generator=g)
            kc, vc = (torch.randint(-127, 128, (1, S, Hkv, 128),
                                    device='cuda', generator=g,
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (0.005 + 0.015 * torch.rand(Hkv, 128, device='cuda',
                                                 generator=g)
                      for _ in range(2))
            vl = S - 3 - trial
            got = k.decode_attention(q, kc, vc, vl, None, ks, vs)
            pl = k.decode_attention_plain(q, kc, vc, vl, None, ks, vs)
            G = Hq // Hkv
            K = (kc[:, :vl].double() * ks.double()).repeat_interleave(G, 2)
            V = (vc[:, :vl].double() * vs.double()).repeat_interleave(G, 2)
            sc = torch.einsum('bhd,bshd->bhs',
                              q[:, 0].double() / 128 ** 0.5, K)
            ref = torch.einsum('bhs,bshd->bhd', torch.softmax(sc, -1),
                               V)[:, None]

            def rel(a, b):
                return ((a.double() - b.double()).abs()
                        / b.double().abs().clamp_min(1e-3)).mean().item()

            dev.append(rel(got, pl))
            errk.append(rel(got, ref))
            errp.append(rel(pl, ref))
            neq.append((got != pl).float().mean().item())
        print(f'K7 float32 q, int8 caches, S={S} {Hq}/{Hkv}: mean relative '
              f'|kernel - plain| {sum(dev) / 20:.3g}; against float64: '
              f'kernel {sum(errk) / 20:.3g}, plain {sum(errp) / 20:.3g}; '
              f'share not bit-equal {sum(neq) / 20:.3f}', flush=True)


def split(torch, np, cs, cfg0, width, flips):
    from paddle_tpu_torch.models import llama as ll
    from paddle_tpu_torch.ops.hopper import decode_attention as hd
    from paddle_tpu_torch.ops.hopper import rms_norm as hr

    cfg = dataclasses.replace(cfg0, num_hidden_layers=2, dtype='float32')
    model = ll.LlamaForCausalLM(cfg, seed=1)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, 21))).to(
        model.device)
    quantize = ll.quantize_kv_rows

    def run(k1, k7):
        rows = []

        def record(x, scale):
            out = quantize(x, scale)
            rows.append((x.detach().float().cpu(), out.cpu(),
                         scale.detach().cpu()))
            return out

        with mock.patch.object(hr, 'rms_norm', hr.rms_norm if k1
                               else hr.rms_norm_plain), \
                mock.patch.object(hd, 'decode_attention',
                                  hd.decode_attention if k7
                                  else hd.decode_attention_plain), \
                mock.patch.object(ll, 'quantize_kv_rows', record):
            logits = cs.capture_logits(torch, model, lambda: model.generate(
                input_ids=ids, max_new_tokens=17, kv_cache_int8=True))[1]
        return logits, rows

    runs = {(a, b): run(a, b) for a in (True, False) for b in (True, False)}
    kk, kp, pk, pp = (True, True), (True, False), (False, True), (False,
                                                                  False)
    for x, y, label in ((kk, pp, 'kernels vs plain (the phase-6 check)'),
                        (kk, kp, 'K7 kernel vs plain, K1 kernel in both'),
                        (pk, pp, 'K7 kernel vs plain, K1 plain in both'),
                        (kk, pk, 'K1 kernel vs plain, K7 kernel in both'),
                        (kp, pp, 'K1 kernel vs plain, K7 plain in both')):
        (lx, rx), (ly, ry) = runs[x], runs[y]
        d = (lx - ly).abs().amax(dim=(1, 2))
        print(f'{width}, {label}: max |Δ logit| {d.max().item():.4g} at '
              f'forward {int(d.argmax())}; per forward '
              + ' '.join(f'{v:.2g}' for v in d.tolist()), flush=True)
        if not flips:
            continue
        # four quantizations a forward: layer 0 K, V, layer 1 K, V
        for i, (a, b) in enumerate(zip(rx, ry)):
            n = int((a[1] != b[1]).sum())
            if not n:
                continue
            fwd, rest = divmod(i, 4)
            t = (b[0] / b[2][None, None])[a[1] != b[1]]
            edge = (t - t.floor() - 0.5).abs().min().item()
            print(f'  forward {fwd} layer {rest // 2} {"KV"[rest % 2]}: {n} '
                  f'codes differ (nearest {edge:.3g} code steps from a '
                  f'rounding boundary), {int((a[2] != b[2]).sum())} '
                  f'calibrated scales differ', flush=True)
    del model
    torch.cuda.empty_cache()


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tree', nargs='?', default=os.path.dirname(here))
    sys.path.insert(0, os.path.abspath(ap.parse_args().tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit('decode_agreement: needs a CUDA card')
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import llama_7b
    from paddle_tpu_torch.ops.hopper import decode_attention as k

    torch.backends.cuda.matmul.allow_tf32 = False
    k7_accuracy(torch, k)
    split(torch, np, cs, llama_7b(), 'Llama-7B', True)
    split(torch, np, cs, cs.qwen2_config(), 'Qwen2-7B', False)


if __name__ == '__main__':
    main()
