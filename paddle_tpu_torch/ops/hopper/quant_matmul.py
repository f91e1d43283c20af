"""Weight-only quantized matrix products: the quantizers, the
hand-written Hopper kernels and their plain versions.

The kernels (`csrc/quant_matmul.cu` and `csrc/quant_matmul_tc.cu`, each
one template on the code type) replace the TPU kernels
`paddle_tpu/ops/pallas/quant_matmul.py::quant_matmul` (int8 codes, K10;
fp8 codes, K10f8) and `::quant_matmul_int4` (packed int4 codes, K11).
`quant_matmul` / `quant_matmul_fp8` / `quant_matmul_int4` launch them on
CUDA tensors, on one of three paths that `path()` picks; the `_plain`
twins compute the same function with plain PyTorch ops:

    out = ((x in float32) @ (codes in float32)) * scale, cast to x's dtype

x (M, K) bf16 or float32; int8 codes (K, N); fp8 codes (K, N) of
`torch.float8_e4m3fn` or `torch.float8_e5m2`; packed int4 codes
(ceil(K / 2), N) int8, two sign-extended 4-bit codes per byte along K
(row 2r in the low nibble, 2r + 1 in the high one), an odd K padding x
with a zero column; scale (N,) float32.

The quantizers are the JAX package's, written again in PyTorch: per
output column absmax scales, round half to even (`torch.round`, as
`jnp.round`; the fp8 cast rounds to nearest even as the JAX cast does),
so codes and scales come out bit-equal to the JAX package's.
"""
from __future__ import annotations

import functools

import torch

from .. import _build


def quantize_weight(w):
    """Float weight (K, N) -> (int8 codes (K, N), float32 per-column
    scale (N,))."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale.reshape(-1)


# the largest finite value of each fp8 code type (the JAX package's
# FP8_MAX)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
# code types of the C entry (csrc/quant_matmul.cu)
CODES = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 2, torch.int8: 8}
CODES_INT4 = 4


def quantize_weight_fp8(w, dtype=torch.float8_e4m3fn):
    """Float weight (K, N) -> (fp8 codes (K, N) of `dtype`, e4m3 or e5m2,
    float32 per-column scale (N,)): absmax / the type's largest value,
    at least 1e-12."""
    fmax = FP8_MAX.get(dtype)
    if fmax is None:
        raise ValueError(f'fp8 codes are float8_e4m3fn or float8_e5m2, got '
                         f'{dtype}')
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax / fmax, min=1e-12)
    return (wf / scale).to(dtype), scale.reshape(-1)


def quantize_weight_int4(w):
    """Float weight (K, N) -> (packed int4 codes (ceil(K / 2), N) int8,
    float32 per-column scale (N,)). Odd K packs one zero row."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int8)
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros(1, q.shape[1])], 0)
    lo = q[0::2] & 0xF
    hi = (q[1::2] & 0xF) << 4
    return (lo | hi).to(torch.int8), scale.reshape(-1)


def unpack_int4(packed):
    """(H, N) packed int8 -> (2H, N) float32 sign-extended codes."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    H, N = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * H, N).float()


def _check(x, wq, scale, bits):
    """Shapes of a product; bits 8 (int8 codes), 4 (packed int4) or
    'fp8' (e4m3 / e5m2 codes)."""
    if x.dim() != 2 or wq.dim() != 2:
        raise ValueError(f'quant_matmul: x and codes must be 2-D, got '
                         f'{tuple(x.shape)} and {tuple(wq.shape)}')
    M, K = x.shape
    R, N = wq.shape
    if bits != 4 and R != K:
        raise ValueError(f'quant_matmul: codes {tuple(wq.shape)} do not '
                         f'match K={K}')
    if bits == 4 and 2 * R not in (K, K + 1):
        raise ValueError(f'packed int4 weight rows {R} do not match K={K}')
    if bits == 'fp8':
        if wq.dtype not in FP8_MAX:
            raise TypeError(f'quant_matmul_fp8: codes must be float8_e4m3fn '
                            f'or float8_e5m2, got {wq.dtype}')
    elif wq.dtype != torch.int8:
        raise TypeError(f'quant_matmul: codes must be int8, got {wq.dtype}')
    if tuple(scale.shape) != (N,):
        raise ValueError(f'quant_matmul: scale must be ({N},), got '
                         f'{tuple(scale.shape)}')
    return M, K, N


def quant_matmul_plain(x, wq, scale):
    """x (M, K); int8 codes (K, N); scale (N,) -> (M, N) in x's dtype."""
    _check(x, wq, scale, 8)
    acc = x.float() @ wq.float()
    return (acc * scale.float()[None]).to(x.dtype)


def quant_matmul_fp8_plain(x, wq, scale):
    """x (M, K); fp8 codes (K, N), e4m3 or e5m2; scale (N,) -> (M, N) in
    x's dtype."""
    _check(x, wq, scale, 'fp8')
    acc = x.float() @ wq.float()
    return (acc * scale.float()[None]).to(x.dtype)


def quant_matmul_int4_plain(x, wq_packed, scale):
    """x (M, K); packed int4 codes (ceil(K / 2), N); scale (N,) ->
    (M, N) in x's dtype."""
    M, K, _ = _check(x, wq_packed, scale, 4)
    xf = x.float()
    if K % 2:
        xf = torch.cat([xf, xf.new_zeros(M, 1)], 1)
    acc = xf @ unpack_int4(wq_packed)
    return (acc * scale.float()[None]).to(x.dtype)


SKINNY_M = 16      # rows of x the skinny (weight-streaming) path takes
STRIP = 128        # columns per block of the skinny path
WARPS = 8          # warps per block of the skinny path

# launches per path, beside `_build.LAUNCHES`' per-kernel counts: each
# wrapper call adds one to the path it launched
PATH_LAUNCHES = {'skinny': 0, 'tensor_core': 0, 'cuda_core': 0}


def path(M, K, N, dtype, ptrs_aligned):
    """The kernel a product of x (M, K) and codes (.., N) takes:

    - 'skinny': M <= SKINNY_M, any dtype and shape (decode rows; the
      weight streamed once, K split across blocks);
    - 'tensor_core': bf16 x past the skinny path, K % 8 == 0, N % 16 ==
      0 and x and the codes 16-byte aligned (the kernel's 16-byte
      copies; bf16 wgmma with float32 sums computes the reference's
      function exactly but for the order of the sums);
    - 'cuda_core': the rest past the skinny path: float32 x (TF32 would
      round it) and unaligned bf16 shapes (float32 FMAs, 64 x 64 tiles).
    """
    if M <= SKINNY_M:
        return 'skinny'
    if (dtype == torch.bfloat16 and K % 8 == 0 and N % 16 == 0
            and ptrs_aligned):
        return 'tensor_core'
    return 'cuda_core'


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split(units, blocks, sms, least, multiple=1):
    """(nsplit, units per split) of a product whose `blocks` output blocks
    walk `units` of work each: one split when the blocks alone cover the
    card; else split until about two blocks per SM are in flight, each
    split holding at least `least` units, a multiple of `multiple`."""
    n = 1 if blocks >= sms else -(-2 * sms // blocks)
    n = max(1, min(n, units // least))
    per = max(1, -(-(-(-units // n)) // multiple) * multiple)
    return max(1, -(-units // per)), per


def splits(rows, N, sms):
    """(nsplit, rows_per_split) of the skinny path: its 128-column strips
    walk the code rows, at least 64 per split, a multiple of the block's
    8 warps."""
    return _split(rows, -(-N // STRIP), sms, 64, WARPS)


TILE, STEP = 128, 64   # output tile and K step of the tensor-core path


def tc_splits(M, K, N, sms):
    """(nsplit, steps_per_split) of the tensor-core path: its 128 x 128
    output tiles walk K in steps of 64, at least 4 per split."""
    return _split(-(-K // STEP), -(-M // TILE) * -(-N // TILE), sms, 4)


_NAMES = {8: 'quant_matmul', 4: 'quant_matmul_int4', 'fp8': 'quant_matmul_fp8'}


def _checked(x, wq, scale, bits):
    """Shapes of a product whose inputs the kernels take, else raise."""
    name = _NAMES[bits]
    M, K, N = _check(x, wq, scale, bits)
    dev = x.device
    tensors = (x, wq, scale)
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{name} kernel: every input must be on one CUDA '
                         f'device, got {[str(t.device) for t in tensors]}')
    if scale.dtype != torch.float32:
        raise TypeError(f'{name} kernel: scale must be float32, got '
                        f'{scale.dtype}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} kernel: inputs must be contiguous')
    return M, K, N


def launch_path(p, x, wq, scale, bits):
    """The product on path `p` ('skinny', 'tensor_core' or 'cuda_core')
    whatever `path()` would pick, for timing two paths against each
    other; the C entry refuses a path that does not take the shape."""
    if p not in PATH_LAUNCHES:
        raise ValueError(f'no quant_matmul path {p!r}: one of '
                         f'{list(PATH_LAUNCHES)}')
    return _run(p, x, wq, scale, bits, *_checked(x, wq, scale, bits))


def _run(p, x, wq, scale, bits, M, K, N):
    name = _NAMES[bits]
    dev = x.device
    code = _build.dtype_code(x, name)
    codes = CODES_INT4 if bits == 4 else CODES[wq.dtype]
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    sms = _sm_count(dev.index)
    if p == 'tensor_core':
        nsplit, per = tc_splits(M, K, N, sms)
    elif p == 'skinny':
        nsplit, per = splits(wq.shape[0], N, sms)
    else:
        nsplit, per = 1, 1
    part = None
    if nsplit > 1:
        part = torch.empty(nsplit, M, N, dtype=torch.float32, device=dev)
    args = (dev.index, x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
            out.data_ptr(), 0 if part is None else part.data_ptr(), M, K, N,
            codes)
    lib = _build.load()
    if p == 'tensor_core':
        err = lib.pt_quant_matmul_tc(*args, nsplit, per, code,
                                     _build.stream_ptr(x))
    else:
        err = lib.pt_quant_matmul(*args, int(p == 'skinny'), nsplit, per,
                                  code, _build.stream_ptr(x))
    _build.check(err, f'{name} ({p})')
    _build.LAUNCHES[name] += 1
    PATH_LAUNCHES[p] += 1
    return out


def _launch(x, wq, scale, bits):
    M, K, N = _checked(x, wq, scale, bits)
    aligned = x.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    return _run(path(M, K, N, x.dtype, aligned), x, wq, scale, bits, M, K, N)


def quant_matmul(x, wq, scale):
    """The int8 kernel (K10), same arguments as the plain version.
    Raises on non-CUDA or mixed devices, non-contiguous inputs, or an x
    other than bf16 / float32."""
    return _launch(x, wq, scale, 8)


def quant_matmul_fp8(x, wq, scale):
    """The fp8 kernel (K10f8), same arguments as the plain version; the
    same checks as `quant_matmul`."""
    return _launch(x, wq, scale, 'fp8')


def quant_matmul_int4(x, wq_packed, scale):
    """The packed int4 kernel (K11), same arguments as the plain
    version."""
    return _launch(x, wq_packed, scale, 4)
