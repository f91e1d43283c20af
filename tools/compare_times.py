#!/usr/bin/env python3
"""Compare two trees' kernel times from four runs of tools/kernel_times.py
made A, B, B, A in one call on one card.

    python3 tools/compare_times.py A1.jsonl B1.jsonl B2.jsonl A2.jsonl \
        [--kernels rms_norm,paged_decode_attention] [--all]

For every shape both trees timed, prints B's mean over its two runs
against A's (the ratio B / A), the same ratio from each tree's faster
run (a single run that a neighbour on the machine slowed moves the mean
and not the minimum), and the bound, plain and library ms of B's first
run. Rows of the named kernels (prefixes) are printed one by one; the
others are summarised by their ratio range, with the rows outside
0.95-1.05 listed.
"""
from __future__ import annotations

import argparse
import json


def load(path):
    rows = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except ValueError:      # a check's own printout
                continue
            if 'kernel' in r:
                rows[(r['kernel'], r['shape'])] = r
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('runs', nargs=4, help='A, B, B, A kernel_times output')
    ap.add_argument('--kernels', default='rms_norm,paged_decode_attention',
                    help='kernel name prefixes to print row by row')
    ap.add_argument('--all', action='store_true', help='print every row')
    args = ap.parse_args()
    a1, b1, b2, a2 = (load(p) for p in args.runs)
    named = tuple(args.kernels.split(','))
    others = []
    for key, rb in b1.items():
        if key not in a1 or key not in a2 or key not in b2:
            continue
        ta, tb = (a1[key]['ms'], a2[key]['ms']), (rb['ms'], b2[key]['ms'])
        mean = sum(tb) / sum(ta)
        low = min(tb) / min(ta)
        if args.all or key[0].startswith(named):
            lib = rb.get('library_ms')
            print(f'{key[0]} | {key[1]} | A {sum(ta) / 2:.4f} B '
                  f'{sum(tb) / 2:.4f} | x{mean:.3f} (faster runs x{low:.3f})'
                  f' | bound {rb.get("bound_ms", float("nan")):.4f} plain '
                  f'{rb.get("plain_ms", float("nan")):.4f} library '
                  f'{"none" if lib is None else f"{lib:.4f}"} | '
                  f'{rb["card"]}')
        else:
            others.append((mean, low, key, ta, tb))
    if others:
        means = [o[0] for o in others]
        lows = [o[1] for o in others]
        print(f'{len(others)} other rows: x{min(means):.3f}-x{max(means):.3f}'
              f' (faster runs x{min(lows):.3f}-x{max(lows):.3f})')
        for mean, low, key, ta, tb in others:
            if not 0.95 <= mean <= 1.05:
                print(f'  outside 0.95-1.05: {key[0]} | {key[1]} | x{mean:.3f}'
                      f' (faster runs x{low:.3f}) | A runs {ta} B runs {tb}')


if __name__ == '__main__':
    main()
