"""Weight-only quantized matrix products: the quantizers, the
hand-written Hopper kernels and their plain versions.

The kernels (`csrc/quant_matmul.cu`, one template on the code type)
replace the TPU kernels `paddle_tpu/ops/pallas/quant_matmul.py::
quant_matmul` (int8 codes, K10; fp8 codes, K10f8) and
`::quant_matmul_int4` (packed int4 codes, K11). `quant_matmul` /
`quant_matmul_fp8` / `quant_matmul_int4` launch them on CUDA tensors;
the `_plain` twins compute the same function with plain PyTorch ops:

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


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(rows, N, sms):
    """(nsplit, rows_per_split) of the skinny path: split the code rows
    until the (strip, split) blocks fill about two blocks per SM; one
    split when the column strips alone cover the card. Each split holds
    a multiple of the block's 8 warps, and at least 64 rows."""
    strips = -(-N // STRIP)
    n = 1 if strips >= sms else -(-2 * sms // strips)
    n = max(1, min(n, rows // 64))
    per = -(-(-(-rows // n)) // WARPS) * WARPS
    return max(1, -(-rows // per)), max(per, 1)


def _launch(x, wq, scale, bits):
    name = {8: 'quant_matmul', 4: 'quant_matmul_int4',
            'fp8': 'quant_matmul_fp8'}[bits]
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
    code = _build.dtype_code(x, name)
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    nsplit, per = splits(wq.shape[0], N, _sm_count(dev.index))
    part = None
    if M <= SKINNY_M and nsplit > 1:
        part = torch.empty(nsplit, M, N, dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.pt_quant_matmul(
        dev.index, x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), M, K, N,
        CODES_INT4 if bits == 4 else CODES[wq.dtype], nsplit, per, code,
        _build.stream_ptr(x))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


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
