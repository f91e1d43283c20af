"""The grouped expert product of the dropless MoE layer (X1 of PERF.md):
the hand-written Hopper kernels, forward and backward, and their plain
versions.

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

The backward (`MoEGroupedMatmulFn`, in place of the VJP XLA supplies for
`ragged_dot`) is two more products, each one launch with the offsets on
the device:

    dx[a:b] = dy[a:b] @ w[e].T        (R, K), on the forward's kernels
                                      over w as it lies (`trans_w`)
    dw[e]   = x[a:b].T @ dy[a:b]      (E, K, N), zero for an expert with
                                      no rows (`csrc/moe_grouped_matmul_dw.cu`)

with float32 sums, dx in dy's dtype and dw in x's (= w's). Their plain
versions loop over the experts as the forward's does.
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

# launches per path, beside `_build.LAUNCHES`' counts: the forward's, the
# backward's dx (the forward's paths over the transposed weight) and dW
PATH_LAUNCHES = {'skinny': 0, 'tensor_core': 0, 'tiled': 0}
DX_PATH_LAUNCHES = {'skinny': 0, 'tensor_core': 0, 'tiled': 0}
DW_PATH_LAUNCHES = {'tensor_core': 0, 'tiled': 0}


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


def dw_path(K, N, dtype, ptrs_aligned):
    """The kernel the weight gradient dw (E, K, N) takes: 'tensor_core'
    for bf16 with K % 8 == 0, N % 8 == 0 and x and dy 16-byte aligned
    (a bf16 wgmma with float32 sums: the plain version's function but
    for the order of the sums); 'tiled' (64 x 64 CUDA-core tiles) for
    float32, which TF32 would round, and the rest. Its work is the rows
    of each expert whatever R is, so it has no skinny path."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 \
            and ptrs_aligned:
        return 'tensor_core'
    return 'tiled'


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check_offsets(offsets, E, what):
    if tuple(offsets.shape) != (E + 1,):
        raise ValueError(f'{what}: offsets must be ({E + 1},), got '
                         f'{tuple(offsets.shape)}')
    if offsets.dtype != torch.int32:
        raise TypeError(f'{what}: offsets must be int32, got '
                        f'{offsets.dtype}')


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
    _check_offsets(offsets, E, 'moe_grouped_matmul')
    if w.dtype != x.dtype:
        raise TypeError(f'moe_grouped_matmul: x and w must share a dtype, '
                        f'got {x.dtype} and {w.dtype}')
    return R, K, N, E


def _host_offsets(offsets, R):
    """The offsets as a host list; raises unless they run nondecreasing
    from 0 to R."""
    off = [int(v) for v in offsets.tolist()]
    if off[0] != 0 or off[-1] != R or any(
            b < a for a, b in zip(off, off[1:])):
        raise ValueError(f'moe_grouped_matmul: offsets must run '
                         f'nondecreasing from 0 to R={R}, got {off}')
    return off


def _check_dx(dy, w, offsets):
    """dy (R, N) and w (E, K, N): the shapes (R, K, N, E) of dx."""
    if dy.dim() != 2 or w.dim() != 3 or dy.shape[1] != w.shape[2]:
        raise ValueError(f'moe_grouped_matmul_dx: dy must be (R, N) and w '
                         f'(E, K, N), got {tuple(dy.shape)} and '
                         f'{tuple(w.shape)}')
    E, K, N = w.shape
    _check_offsets(offsets, E, 'moe_grouped_matmul_dx')
    if dy.dtype != w.dtype:
        raise TypeError(f'moe_grouped_matmul_dx: dy and w must share a '
                        f'dtype, got {dy.dtype} and {w.dtype}')
    return dy.shape[0], K, N, E


def _check_dw(x, dy, offsets):
    """x (R, K) and dy (R, N): the shapes (R, K, N, E) of dw."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f'moe_grouped_matmul_dw: x must be (R, K) and dy '
                         f'(R, N), got {tuple(x.shape)} and '
                         f'{tuple(dy.shape)}')
    E = offsets.numel() - 1
    _check_offsets(offsets, E, 'moe_grouped_matmul_dw')
    if dy.dtype != x.dtype:
        raise TypeError(f'moe_grouped_matmul_dw: x and dy must share a '
                        f'dtype, got {x.dtype} and {dy.dtype}')
    return x.shape[0], x.shape[1], dy.shape[1], E


def moe_grouped_matmul_plain(x, w, offsets):
    """x (R, K) sorted by expert, w (E, K, N), offsets (E + 1,) int32 ->
    (R, N) in x's dtype: each expert's rows times its weight in
    float32. Reads the offsets on the host and raises unless they run
    nondecreasing from 0 to R."""
    R, K, N, E = _check(x, w, offsets)
    off = _host_offsets(offsets, R)
    y = torch.empty(R, N, dtype=x.dtype, device=x.device)
    for e in range(E):
        a, b = off[e], off[e + 1]
        if b > a:
            y[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return y


def moe_grouped_matmul_dx_plain(dy, w, offsets):
    """dy (R, N) sorted by expert, w (E, K, N), offsets (E + 1,) int32 ->
    dx (R, K) in dy's dtype: each expert's rows of dy times its weight
    transposed, in float32 (the offsets read on the host)."""
    R, K, N, E = _check_dx(dy, w, offsets)
    off = _host_offsets(offsets, R)
    dx = torch.empty(R, K, dtype=dy.dtype, device=dy.device)
    for e in range(E):
        a, b = off[e], off[e + 1]
        if b > a:
            dx[a:b] = (dy[a:b].float() @ w[e].float().T).to(dy.dtype)
    return dx


def moe_grouped_matmul_dw_plain(x, dy, offsets):
    """x (R, K) and dy (R, N) sorted by expert, offsets (E + 1,) int32 ->
    dw (E, K, N) in x's dtype: each expert's rows of x transposed times
    its rows of dy, in float32; zero for an expert with no rows (the
    offsets read on the host)."""
    R, K, N, E = _check_dw(x, dy, offsets)
    off = _host_offsets(offsets, R)
    dw = torch.zeros(E, K, N, dtype=x.dtype, device=x.device)
    for e in range(E):
        a, b = off[e], off[e + 1]
        if b > a:
            dw[e] = (x[a:b].float().T @ dy[a:b].float()).to(x.dtype)
    return dw


def _on_one_card(what, E, *tensors):
    """Raise unless the kernel takes these tensors: one CUDA device,
    contiguous, at most MAX_EXPERTS experts."""
    dev = tensors[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{what} kernel: every input must be on one CUDA '
                         f'device, got {[str(t.device) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what} kernel: inputs must be contiguous')
    if E > MAX_EXPERTS:
        raise NotImplementedError(f'{what} kernel: {E} experts; the kernel '
                                  f'takes up to {MAX_EXPERTS}')


def _checked(x, w, offsets):
    """Shapes of a product whose inputs the kernel takes, else raise."""
    R, K, N, E = _check(x, w, offsets)
    _on_one_card('moe_grouped_matmul', E, x, w, offsets)
    return R, K, N, E


def _tc_refusal(what, x, K, N, *ts):
    if not (x.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
            and _aligned(*ts)):
        raise ValueError(f'{what}: the tensor-core path takes bf16 with K '
                         f'and N multiples of 8 and 16-byte-aligned '
                         f'inputs, got {x.dtype}, K={K}, N={N}')


def _run(p, x, w, offsets, R, K, N, E, trans_w=False):
    """x (R, K) times w[e] (K, N), or with trans_w times w[e].T for w
    (E, N, K), on path p: the forward (key 'moe_grouped_matmul') or dx
    ('moe_grouped_matmul_dx')."""
    key = 'moe_grouped_matmul_dx' if trans_w else 'moe_grouped_matmul'
    code = _build.dtype_code(x, key)
    if p == 'tensor_core':
        _tc_refusal(key, x, K, N, x, w)
    y = torch.empty(R, N, dtype=x.dtype, device=x.device)
    if R == 0 or N == 0:
        return y
    lib = _build.load()
    if p == 'tensor_core':
        err = lib.pt_moe_grouped_matmul_tc(
            x.device.index, x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
            y.data_ptr(), R, K, N, E, int(trans_w), code,
            _build.stream_ptr(x))
    else:
        # the skinny path's 16-byte loads run along w's rows: N, or K
        # (with x's rows) when w is transposed
        vec = 16 // x.element_size()
        vec_ok = (K % vec == 0 and _aligned(x, w) if trans_w
                  else N % vec == 0 and _aligned(w))
        err = lib.pt_moe_grouped_matmul(
            x.device.index, x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
            y.data_ptr(), R, K, N, E, int(p == 'skinny'), int(vec_ok),
            int(trans_w), code, _build.stream_ptr(x))
    _build.check(err, f'{key} ({p})')
    _build.LAUNCHES[key] += 1
    (DX_PATH_LAUNCHES if trans_w else PATH_LAUNCHES)[p] += 1
    return y


def _run_dw(p, x, dy, offsets, R, K, N, E):
    code = _build.dtype_code(x, 'moe_grouped_matmul_dw')
    if p == 'tensor_core':
        _tc_refusal('moe_grouped_matmul_dw', x, K, N, x, dy)
    dw = torch.empty(E, K, N, dtype=x.dtype, device=x.device)
    if K == 0 or N == 0:
        return dw
    err = _build.load().pt_moe_grouped_matmul_dw(
        x.device.index, x.data_ptr(), dy.data_ptr(), offsets.data_ptr(),
        dw.data_ptr(), R, K, N, E, int(p == 'tensor_core'), code,
        _build.stream_ptr(x))
    _build.check(err, f'moe_grouped_matmul_dw ({p})')
    _build.LAUNCHES['moe_grouped_matmul_dw'] += 1
    DW_PATH_LAUNCHES[p] += 1
    return dw


def _checked_dx(dy, w, offsets):
    R, K, N, E = _check_dx(dy, w, offsets)
    _on_one_card('moe_grouped_matmul_dx', E, dy, w, offsets)
    return R, K, N, E


def _checked_dw(x, dy, offsets):
    R, K, N, E = _check_dw(x, dy, offsets)
    _on_one_card('moe_grouped_matmul_dw', E, x, dy, offsets)
    return R, K, N, E


def _known(p, paths, what):
    if p not in paths:
        raise ValueError(f'no {what} path {p!r}: one of {list(paths)}')


def launch_path(p, x, w, offsets):
    """The product on path `p` ('skinny', 'tensor_core' or 'tiled')
    whatever `path()` would pick, for testing and timing the paths;
    'tensor_core' raises on inputs it does not take."""
    _known(p, PATH_LAUNCHES, 'moe_grouped_matmul')
    return _run(p, x, w, offsets, *_checked(x, w, offsets))


def launch_dx_path(p, dy, w, offsets):
    """dx on path `p` whatever `path()` would pick (as `launch_path`)."""
    _known(p, DX_PATH_LAUNCHES, 'moe_grouped_matmul_dx')
    R, K, N, E = _checked_dx(dy, w, offsets)
    return _run(p, dy, w, offsets, R, N, K, E, trans_w=True)


def launch_dw_path(p, x, dy, offsets):
    """dw on path `p` whatever `dw_path()` would pick (as
    `launch_path`)."""
    _known(p, DW_PATH_LAUNCHES, 'moe_grouped_matmul_dw')
    return _run_dw(p, x, dy, offsets, *_checked_dw(x, dy, offsets))


def moe_grouped_matmul(x, w, offsets):
    """The kernel (X1), same arguments as the plain version. Raises on
    non-CUDA or mixed devices, non-contiguous inputs, a dtype other than
    bf16 / float32, or more than MAX_EXPERTS experts. R = 0 returns an
    empty (0, N) tensor without a launch."""
    R, K, N, E = _checked(x, w, offsets)
    return _run(path(R, E, K, N, x.dtype, _aligned(x, w)), x, w, offsets,
                R, K, N, E)


def moe_grouped_matmul_dx(dy, w, offsets):
    """The dx kernel: dy (R, N) sorted by expert, w (E, K, N) as the
    forward read it, offsets (E + 1,) int32 on the card -> (R, K) in dy's
    dtype. The route is the forward's rule for a product of R rows over
    (N, K) weights (`path`); raises as `moe_grouped_matmul` does. R = 0
    returns an empty (0, K) tensor without a launch."""
    R, K, N, E = _checked_dx(dy, w, offsets)
    return _run(path(R, E, N, K, dy.dtype, _aligned(dy, w)), dy, w, offsets,
                R, N, K, E, trans_w=True)


def moe_grouped_matmul_dw(x, dy, offsets):
    """The dw kernel: x (R, K) and dy (R, N) sorted by expert, offsets
    (E + 1,) int32 on the card -> (E, K, N) in x's dtype, zero for an
    expert with no rows (so R = 0 launches too). Route by `dw_path`;
    raises as `moe_grouped_matmul` does."""
    R, K, N, E = _checked_dw(x, dy, offsets)
    return _run_dw(dw_path(K, N, x.dtype, _aligned(x, dy)), x, dy, offsets,
                   R, K, N, E)


class MoEGroupedMatmulFn(torch.autograd.Function):
    """X1 with its backward: the kernels on a CUDA tensor, the plain
    versions on a CPU one (the counterpart of the VJP XLA supplies for
    `jax.lax.ragged_dot`). dx and dw are one launch each, with the
    offsets on the device; no gradient for the offsets. The kernel
    functions are looked up in this module at call time, so a harness can
    swap in the plain ones."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        fwd = (moe_grouped_matmul
               if _build.on_card(x, 'moe_grouped_matmul')
               else moe_grouped_matmul_plain)
        ctx.save_for_backward(x, w, offsets)
        return fwd(x, w, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        card = _build.on_card(dy, 'moe_grouped_matmul')
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (moe_grouped_matmul_dx if card
                  else moe_grouped_matmul_dx_plain)(dy, w, offsets)
        if ctx.needs_input_grad[1]:
            dw = (moe_grouped_matmul_dw if card
                  else moe_grouped_matmul_dw_plain)(x, dy, offsets)
        return dx, dw, None
