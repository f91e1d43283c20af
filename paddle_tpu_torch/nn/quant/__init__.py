"""Weight-only quantized matrix products (counterpart of
paddle_tpu/nn/quant): int8 and packed int4 weights with per-output-column
float32 scales, served by kernels K10 / K11 (`ops.quant_matmul`,
`ops.quant_matmul_int4`).
"""
from __future__ import annotations

import torch

from ... import ops
from ...ops.hopper import quant_matmul as _qmm

_ALGOS = {'weight_only_int8': 8, 'llm.int8': 8, 'weight_only_int4': 4}


def weight_quantize(x, algo='weight_only_int8'):
    """(codes, scale) of a float weight (K, N): int8 codes (K, N), or for
    'weight_only_int4' packed codes (ceil(K / 2), N), two 4-bit codes per
    byte along K; scale (N,) float32."""
    if algo in ('fp8', 'weight_only_fp8', 'float8_e4m3fn'):
        return _qmm.quantize_weight_fp8(x)
    bits = _ALGOS.get(algo)
    if bits is None:
        raise ValueError(f'unknown quantize algo: {algo}')
    if bits == 4:
        return _qmm.quantize_weight_int4(x)
    return _qmm.quantize_weight(x)


def weight_dequantize(x, scale, algo='weight_only_int8',
                      out_dtype=torch.float32, out_features=None):
    """codes * scale in `out_dtype`. For packed int4, `out_features`
    drops the zero row an odd K was padded with."""
    if algo == 'weight_only_int4':
        codes = _qmm.unpack_int4(x)
        if out_features is not None:
            codes = codes[:out_features]
        return (codes * scale).to(out_dtype)
    return (x.float() * scale).to(out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype='int8'):
    """x (..., K) times quantized `weight` (codes) with per-column
    `weight_scale`, plus `bias`: kernel K10 for 'int8', K11 for 'int4'."""
    K = x.shape[-1]
    lead = x.shape[:-1]
    mm = ops.quant_matmul_int4 if weight_dtype == 'int4' else ops.quant_matmul
    out = mm(x.reshape(-1, K).contiguous(), weight, weight_scale)
    out = out.reshape(*lead, -1)
    if bias is not None:
        out = out + bias
    return out


class QuantizedWeight(torch.nn.Module):
    """A weight-only quantized (K, N) projection: buffers `codes` (int8
    (K, N), or packed int4 (ceil(K / 2), N)) and `scale` (N,) float32.
    It stands where a dense weight stood: `x @ w` reaches `__rmatmul__`
    and runs kernel K10 or K11, and the state dict holds `<name>.codes`
    / `<name>.scale`, the JAX package's names."""

    def __init__(self, codes, scale, bits=8, shape=None):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f'bits must be 4 or 8, got {bits}')
        self.register_buffer('codes', codes)
        self.register_buffer('scale', scale)
        self.bits = int(bits)
        # the logical (K, N) of the dense weight (int4 packs K in halves)
        self.shape = tuple(shape) if shape is not None else tuple(
            codes.shape)

    @classmethod
    def quantize(cls, w, bits=8):
        algo = {8: 'weight_only_int8', 4: 'weight_only_int4'}.get(bits)
        if algo is None:
            raise ValueError(f'bits must be 4 or 8, got {bits}')
        with torch.no_grad():
            codes, scale = weight_quantize(w, algo=algo)
        return cls(codes, scale, bits, shape=w.shape)

    def matmul(self, x):
        return weight_only_linear(
            x, self.codes, weight_scale=self.scale,
            weight_dtype='int4' if self.bits == 4 else 'int8')

    def __rmatmul__(self, x):
        return self.matmul(x)

    def extra_repr(self):
        return f'bits={self.bits}, shape={self.shape}'


__all__ = ['QuantizedWeight', 'weight_dequantize', 'weight_only_linear',
           'weight_quantize']
