"""The grouped expert product of the dropless MoE layer (X1 of PERF.md):
the hand-written Hopper kernel and its plain version.

The kernels (`csrc/moe_grouped_matmul.cu`: the skinny and CUDA-core
tiled paths; `csrc/moe_grouped_matmul_tc.cu`: the tensor cores) replace
XLA's `jax.lax.ragged_dot` at `paddle_tpu/distributed/moe.py:104-106`,
which the JAX package leaves outside Pallas:

    y[offsets[e]:offsets[e + 1]] = x[offsets[e]:offsets[e + 1]] @ w[e]

x (R, K) with its rows sorted by expert, w (E, K, N), both bf16 or both
float32; offsets (E + 1,) int32, nondecreasing from 0 to R (the
exclusive scan of the group sizes); float32 sums; y (R, N) in x's dtype.

Each kernel reads the offsets on the device: its grid comes from R, E
and N alone and each block finds its (expert, row tile) pair itself,
so one product is one launch, no count is read on the host, and the
launch can be captured in a CUDA graph. `moe_grouped_matmul_plain`
loops over the experts with `torch.matmul` on slices, reading the
offsets on the host: the CPU path, and the yardstick the kernels are
held to.
"""
from __future__ import annotations

import torch

from .. import _build

MAX_EXPERTS = 1024          # the kernels stage the offsets in shared memory
# the skinny path's bound on R / E: float32 (the CUDA-core tiles past
# it), and bf16, where the tensor cores match or beat it from R = E / 2
# and beat it at every measured shape from R = E (chip_smoke.py's
# moe_crossover, PERF.md)
SKINNY_MEAN_ROWS = {torch.float32: 8, torch.bfloat16: 1}

# launches per path, beside `_build.LAUNCHES`' count
PATH_LAUNCHES = {'skinny': 0, 'tensor_core': 0, 'tiled': 0}


def path(R, E, K, N, dtype, ptrs_aligned):
    """The kernel a product of R sorted rows (R, K) over E experts'
    (K, N) weights takes:

    - 'skinny' while R <= SKINNY_MEAN_ROWS[dtype] * E (decode, a row or
      two an expert: each expert's weight slab streamed once for every 4
      of its rows), any shape;
    - 'tensor_core': bf16 past it with K % 8 == 0, N % 8 == 0 and x and
      w 16-byte aligned (the kernel's 16-byte copies; a bf16 wgmma with
      float32 sums computes the plain version's function but for the
      order of the sums): a prompt's prefill;
    - 'tiled': the rest past it, float32 (TF32 would round it) and
      unaligned or odd bf16 shapes (64 x 64 CUDA-core tiles).

    Shapes, dtype and alignment only: never the counts."""
    if R <= SKINNY_MEAN_ROWS.get(dtype, 8) * E:
        return 'skinny'
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 \
            and ptrs_aligned:
        return 'tensor_core'
    return 'tiled'


def _aligned(x, w):
    return x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


def _check(x, w, offsets):
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f'moe_grouped_matmul: x must be (R, K) and w '
                         f'(E, K, N), got {tuple(x.shape)} and '
                         f'{tuple(w.shape)}')
    R, K = x.shape
    E, K2, N = w.shape
    if K2 != K:
        raise ValueError(f'moe_grouped_matmul: w {tuple(w.shape)} does not '
                         f'match K={K}')
    if tuple(offsets.shape) != (E + 1,):
        raise ValueError(f'moe_grouped_matmul: offsets must be ({E + 1},), '
                         f'got {tuple(offsets.shape)}')
    if offsets.dtype != torch.int32:
        raise TypeError(f'moe_grouped_matmul: offsets must be int32, got '
                        f'{offsets.dtype}')
    if w.dtype != x.dtype:
        raise TypeError(f'moe_grouped_matmul: x and w must share a dtype, '
                        f'got {x.dtype} and {w.dtype}')
    return R, K, N, E


def moe_grouped_matmul_plain(x, w, offsets):
    """x (R, K) sorted by expert, w (E, K, N), offsets (E + 1,) int32 ->
    (R, N) in x's dtype: each expert's rows times its weight in
    float32. Reads the offsets on the host and raises unless they run
    nondecreasing from 0 to R."""
    R, K, N, E = _check(x, w, offsets)
    off = [int(v) for v in offsets.tolist()]
    if off[0] != 0 or off[-1] != R or any(
            b < a for a, b in zip(off, off[1:])):
        raise ValueError(f'moe_grouped_matmul: offsets must run '
                         f'nondecreasing from 0 to R={R}, got {off}')
    y = torch.empty(R, N, dtype=x.dtype, device=x.device)
    for e in range(E):
        a, b = off[e], off[e + 1]
        if b > a:
            y[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return y


def _checked(x, w, offsets):
    """Shapes of a product whose inputs the kernel takes, else raise."""
    R, K, N, E = _check(x, w, offsets)
    tensors = (x, w, offsets)
    dev = x.device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'moe_grouped_matmul kernel: every input must be '
                         f'on one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('moe_grouped_matmul kernel: inputs must be '
                         'contiguous')
    if E > MAX_EXPERTS:
        raise NotImplementedError(f'moe_grouped_matmul kernel: {E} experts; '
                                  f'the kernel takes up to {MAX_EXPERTS}')
    return R, K, N, E


def _run(p, x, w, offsets, R, K, N, E):
    code = _build.dtype_code(x, 'moe_grouped_matmul')
    if p == 'tensor_core' and not (x.dtype == torch.bfloat16 and K % 8 == 0
                                   and N % 8 == 0 and _aligned(x, w)):
        raise ValueError(f'moe_grouped_matmul: the tensor-core path takes '
                         f'bf16 with K and N multiples of 8 and 16-byte-'
                         f'aligned x and w, got {x.dtype}, K={K}, N={N}')
    y = torch.empty(R, N, dtype=x.dtype, device=x.device)
    if R == 0 or N == 0:
        return y
    lib = _build.load()
    if p == 'tensor_core':
        err = lib.pt_moe_grouped_matmul_tc(
            x.device.index, x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
            y.data_ptr(), R, K, N, E, code, _build.stream_ptr(x))
    else:
        vec = 16 // x.element_size()
        vec_ok = N % vec == 0 and w.data_ptr() % 16 == 0
        err = lib.pt_moe_grouped_matmul(
            x.device.index, x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
            y.data_ptr(), R, K, N, E, int(p == 'skinny'), int(vec_ok), code,
            _build.stream_ptr(x))
    _build.check(err, f'moe_grouped_matmul ({p})')
    _build.LAUNCHES['moe_grouped_matmul'] += 1
    PATH_LAUNCHES[p] += 1
    return y


def launch_path(p, x, w, offsets):
    """The product on path `p` ('skinny', 'tensor_core' or 'tiled')
    whatever `path()` would pick, for testing and timing the paths;
    'tensor_core' raises on inputs it does not take."""
    if p not in PATH_LAUNCHES:
        raise ValueError(f'no moe_grouped_matmul path {p!r}: one of '
                         f'{list(PATH_LAUNCHES)}')
    return _run(p, x, w, offsets, *_checked(x, w, offsets))


def moe_grouped_matmul(x, w, offsets):
    """The kernel (X1), same arguments as the plain version. Raises on
    non-CUDA or mixed devices, non-contiguous inputs, a dtype other than
    bf16 / float32, or more than MAX_EXPERTS experts. R = 0 returns an
    empty (0, N) tensor without a launch."""
    R, K, N, E = _checked(x, w, offsets)
    return _run(path(R, E, K, N, x.dtype, _aligned(x, w)), x, w, offsets,
                R, K, N, E)
