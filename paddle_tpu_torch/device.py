"""Device resolution for the port's entry points (counterpart of
paddle_tpu/device).

Entry points run on the card unless the caller asks for another device:
`resolve_device(None)` is the current CUDA device, and raises when there
is none. Nothing drops to the CPU without being asked.
"""
from __future__ import annotations

import torch


def resolve_device(device=None):
    """`device` as a torch.device; None means the current CUDA device.
    Raises RuntimeError when a CUDA device is meant and none is
    present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available: paddle_tpu_torch runs on the '
                'card by default; pass device="cpu" to run the plain '
                'PyTorch versions on the CPU')
        return torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'device {device} requested but no CUDA '
                               f'device is available')
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    return device


DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'float16': torch.float16}


def torch_dtype(dtype):
    """A dtype name of the JAX package's configs ('float32', 'bfloat16',
    'float16') or a torch.dtype, as a torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f'unsupported dtype {dtype!r}; expected one of '
                         f'{sorted(DTYPES)}') from None
