"""Weight-only post-training quantization of a model (counterpart of
paddle_tpu/quantization's `quantize_matmul_weights`)."""
from __future__ import annotations

import copy

import torch

from ..nn.quant import QuantizedWeight


def quantize_matmul_weights(model, bits=8, min_features=64, exclude=()):
    """A new model in which every trainable 2-D floating parameter with
    min(shape) >= `min_features` is a `QuantizedWeight` (int8, or packed
    int4 for bits=4), used as `x @ w` by the model's own code.

    Exclusion is structural, as in the JAX package: `nn.Embedding`
    subtrees are never touched, and a module opts out with
    `no_quantize = True` (its whole subtree) or a tuple of its parameter
    names (e.g. a model's `embed_tokens`); `exclude` adds path
    substrings. A tied LM head served off the embedding stays full
    precision. The original model is untouched: the new one holds copies
    of the parameters that stay, and the codes of those that went."""
    if bits not in (4, 8):
        raise ValueError(f'bits must be 4 or 8, got {bits}')
    targets = []

    def walk(mod, path):
        nq = getattr(mod, 'no_quantize', ())
        if nq is True or isinstance(mod, torch.nn.Embedding):
            return
        for name, p in mod.named_parameters(recurse=False):
            full = f'{path}.{name}' if path else name
            if (name in nq or any(e in full for e in exclude)
                    or not p.requires_grad or p.dim() != 2
                    or min(p.shape) < min_features
                    or not p.is_floating_point()):
                continue
            targets.append((path, name, p))
        for cname, child in mod.named_children():
            walk(child, f'{path}.{cname}' if path else cname)

    walk(model, '')
    # copy everything but the weights being quantized (stand-ins for
    # those, so a 7B model is never held twice in full)
    memo = {id(p): torch.empty(0) for _path, _name, p in targets}
    new = copy.deepcopy(model, memo)
    for path, name, p in targets:
        sub = new.get_submodule(path)
        del sub._parameters[name]
        setattr(sub, name, QuantizedWeight.quantize(p.detach(), bits))
    return new


__all__ = ['QuantizedWeight', 'quantize_matmul_weights']
