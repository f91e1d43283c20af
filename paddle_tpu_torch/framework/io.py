"""Weights across the two packages: the `paddle_tpu.v1` npz format, read
and written with numpy alone (counterpart of paddle_tpu/framework/io.py),
and `load_jax_state`, which loads the JAX package's parameters into a
port model.

The port keeps the JAX package's parameter names and layouts, with one
difference: the JAX `LayerList` names its children `L0`, `L1`, ...
(`model.layers.L0.self_attn.q_proj`) where `nn.ModuleList` names them
`0`, `1`, ... (`model.layers.0.self_attn.q_proj`). `port_name` and
`jax_name` map between the two.

numpy has no bfloat16: the JAX package's npz files store bf16 arrays as
2-byte void records ('V2'), and so does `save` here.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

FORMAT = 'paddle_tpu.v1'

_JAX_CHILD = re.compile(r'^L(\d+)$')


def port_name(name):
    """JAX parameter name -> port name (`L3` segments -> `3`)."""
    return '.'.join(_JAX_CHILD.sub(r'\1', s) for s in name.split('.'))


def jax_name(name):
    """Port parameter name -> JAX name (`3` segments -> `L3`)."""
    return '.'.join(f'L{s}' if s.isdigit() else s for s in name.split('.'))


def to_numpy(t):
    """A tensor as a numpy array (bf16 as 'V2' records, as the JAX
    package's npz files hold them)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view('V2')
    return t.numpy()


def _is_bf16(arr):
    return (arr.dtype.kind == 'V' and arr.dtype.itemsize == 2) \
        or arr.dtype.name == 'bfloat16'


def array_dtype(arr):
    """The torch dtype a numpy array carries ('V2' and ml_dtypes'
    bfloat16 read as bfloat16)."""
    if _is_bf16(arr):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, arr.dtype)).dtype


def to_tensor(arr):
    # ascontiguousarray makes a 0-d array 1-d: keep the shape (scalar
    # buffers such as an MoE layer's aux_loss)
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if _is_bf16(arr):
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def jax_state_dict(model):
    """The model's parameters under JAX names, as numpy arrays."""
    return {jax_name(k): to_numpy(v) for k, v in model.state_dict().items()}


def save(obj, path):
    """Write a module's parameters (under JAX names) or a flat
    name -> tensor/array dict as a `paddle_tpu.v1` npz. Atomic: writes a
    temporary file, then renames it into place."""
    if isinstance(obj, torch.nn.Module):
        flat, kind = jax_state_dict(obj), type(obj).__name__
    else:
        flat = {k: to_numpy(v) if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in obj.items()}
        kind = 'dict'
    path = str(path)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    meta = np.frombuffer(json.dumps({'format': FORMAT, 'kind': kind})
                         .encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix='.npz')
    os.close(fd)
    try:
        np.savez(tmp, __meta__=meta, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(path):
    """Read a `paddle_tpu.v1` npz: a flat name -> numpy array dict for a
    state dict, nested dicts where names hold '/' (the JAX package's
    pytree paths); '#none' entries read as None, '#json' entries as
    their JSON value."""
    out = {}
    with np.load(str(path), allow_pickle=False) as data:
        for key in data.files:
            if key == '__meta__':
                continue
            v = data[key]
            if key.endswith('#none'):
                key, v = key[:-5], None
            elif key.endswith('#json'):
                key, v = key[:-5], json.loads(v.tobytes().decode())
            node = out
            parts = key.split('/')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def load_jax_state(model, flat):
    """Copy the JAX package's parameters (`flat`: JAX name -> numpy
    array, e.g. from `paddle_tpu`'s `state_dict()` or `load(path)`) into
    `model`. Every name, shape and dtype is checked both ways before
    anything is copied: a missing or extra name, or a shape or dtype
    that differs, raises ValueError listing all of them."""
    own = model.state_dict()
    mapped = {port_name(k): k for k in flat}
    missing = sorted(set(own) - set(mapped))
    extra = sorted(mapped[k] for k in set(mapped) - set(own))
    problems = []
    if missing:
        problems.append(f'missing from the JAX state: {missing}')
    if extra:
        problems.append(f'not in the port model: {extra}')
    arrays = {}
    for name in sorted(set(own) & set(mapped)):
        arr = np.asarray(flat[mapped[name]])
        want = own[name]
        if tuple(arr.shape) != tuple(want.shape):
            problems.append(f'{name}: shape {tuple(arr.shape)} vs '
                            f'{tuple(want.shape)}')
        elif array_dtype(arr) != want.dtype:
            problems.append(f'{name}: dtype {array_dtype(arr)} vs '
                            f'{want.dtype}')
        arrays[name] = arr
    if problems:
        raise ValueError('load_jax_state mismatch: ' + '; '.join(problems))
    with torch.no_grad():
        for name, arr in arrays.items():
            own[name].copy_(to_tensor(arr))
    return model
