"""The port's kernel modules against the JAX package's Pallas kernels.

The plain PyTorch version beside each hand-written Hopper kernel
(paddle_tpu_torch/ops/hopper/) is held against the JAX package's Pallas
kernel, run in interpret mode on the CPU as the JAX package's own tests
run it, on the same seeded numpy inputs, in float32. The kernels
themselves run only on a CUDA card: tests/test_torch_cuda.py holds them
against these plain versions there.

Also: `import paddle_tpu_torch` pulls in neither JAX nor the JAX
package, and entry points raise instead of dropping to the CPU when no
CUDA device is present.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged)
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops.hopper import paged_attention as t_paged
from paddle_tpu_torch.ops.hopper import rms_norm as t_rms

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 on both sides; the two differ only in summation order
RMS_TOL = dict(rtol=1e-5, atol=1e-5)
# the tolerance of tests/test_paged_attention.py for the Pallas kernel
PAGED_TOL = dict(rtol=2e-4, atol=2e-4)


class TestRmsNormPlain:
    @pytest.mark.parametrize('shape', [(6, 256), (5, 200), (2, 3, 96),
                                       (1, 4096)])
    def test_matches_pallas_kernel(self, shape):
        """Includes widths that are not multiples of 128 (the TPU
        kernel's lane tiling; the port takes any width)."""
        rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
        x = rng.normal(size=shape).astype(np.float32)
        w = (1.0 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
        want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
        got = ops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
        np.testing.assert_allclose(got.numpy(), want, **RMS_TOL)

    def test_no_weight_and_r(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(3, 40)).astype(np.float32)
        want = np.asarray(jax_rms_norm(jnp.asarray(x), None, 1e-6))
        got, r = t_rms.rms_norm_plain(torch.from_numpy(x), None, 1e-6,
                                      return_r=True)
        np.testing.assert_allclose(got.numpy(), want, **RMS_TOL)
        want_r = 1.0 / np.sqrt(np.mean(x.astype(np.float64) ** 2, -1,
                                       keepdims=True) + 1e-6)
        np.testing.assert_allclose(r.numpy(), want_r, rtol=1e-5)


def _paged_case(seed, B, Hq, Hkv, D, BS, NB, MAXB, lens, holes=()):
    """Seeded pools and shuffled page tables; `holes` are (row, col)
    table entries set to -1."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    kc = rng.normal(size=(NB, Hkv, BS, D)).astype(np.float32)
    vc = rng.normal(size=(NB, Hkv, BS, D)).astype(np.float32)
    tbl = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB) \
        if NB >= B * MAXB else rng.integers(0, NB, (B, MAXB))
    tbl = tbl.astype(np.int32)
    for r, c in holes:
        tbl[r, c] = -1
    return q, kc, vc, tbl, np.asarray(lens, np.int32)


class TestPagedAttentionPlain:
    @pytest.mark.parametrize('case', [
        # MHA, shuffled pages, ragged counts
        dict(seed=0, B=3, Hq=4, Hkv=4, D=16, BS=8, NB=16, MAXB=4,
             lens=[30, 9, 32]),
        # GQA 4/2 with -1 entries past the count
        dict(seed=1, B=3, Hq=4, Hkv=2, D=16, BS=8, NB=16, MAXB=4,
             lens=[20, 3, 17], holes=[(0, 3), (1, 1), (1, 2)]),
        # GQA 8/1, a count past the table (clamped), a count-0 row
        dict(seed=2, B=3, Hq=8, Hkv=1, D=32, BS=16, NB=12, MAXB=3,
             lens=[100, 0, 33], holes=[(1, 0)]),
    ], ids=['mha', 'gqa-holes', 'gqa8-clamp-zero'])
    def test_matches_pallas_kernel(self, case):
        q, kc, vc, tbl, lens = _paged_case(**case)
        want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(tbl),
                                    jnp.asarray(lens)))
        got = ops.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(tbl), torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), want, **PAGED_TOL)
        for b in np.flatnonzero(lens == 0):
            assert not got[b].any(), 'a count-0 row must return zeros'

    def test_scale_and_int8_rejected(self):
        q, kc, vc, tbl, lens = _paged_case(3, 2, 4, 2, 16, 8, 8, 2, [10, 16])
        args = [torch.from_numpy(a) for a in (q, kc, vc, tbl, lens)]
        want = np.asarray(jax_paged(*[jnp.asarray(a) for a in
                                      (q, kc, vc, tbl, lens)], scale=0.3))
        got = ops.paged_decode_attention(*args, scale=0.3)
        np.testing.assert_allclose(got.numpy(), want, **PAGED_TOL)
        # scales go with int8 pages only (K8q): on float pages they raise
        with pytest.raises(TypeError, match='int8'):
            ops.paged_decode_attention(*args, k_scale=torch.ones(2, 16),
                                       v_scale=torch.ones(2, 16))


class TestNoSilentFallback:
    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """The kernel wrappers launch or raise: handed a CPU tensor they
        raise instead of computing the plain version."""
        x = torch.ones(2, 8)
        with pytest.raises(ValueError, match='CUDA'):
            t_rms.rms_norm(x, torch.ones(8))
        q, kc, vc, tbl, lens = _paged_case(4, 1, 2, 2, 16, 8, 4, 2, [5])
        with pytest.raises(ValueError, match='CUDA'):
            t_paged.paged_decode_attention(
                *[torch.from_numpy(a) for a in (q, kc, vc, tbl, lens)])

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match='no kernel for device'):
            ops.rms_norm(torch.ones(2, 8, device='meta'))

    def test_entry_points_raise_without_cuda(self, monkeypatch):
        from paddle_tpu_torch import resolve_device
        from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                                   llama_tiny)

        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            resolve_device()
        with pytest.raises(RuntimeError, match='no CUDA device'):
            LlamaForCausalLM(llama_tiny())
        with pytest.raises(RuntimeError, match='no CUDA device'):
            resolve_device('cuda')
        assert resolve_device('cpu') == torch.device('cpu')


def _port_sources():
    pkg = os.path.join(REPO, 'paddle_tpu_torch')
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)
    yield os.path.join(REPO, 'chip_smoke.py')


class TestImportIsolation:
    def test_import_pulls_in_no_jax(self):
        """Every module of the port, imported in a fresh interpreter,
        leaves no `jax` and no `paddle_tpu` in sys.modules."""
        code = (
            'import importlib, pkgutil, sys\n'
            'import paddle_tpu_torch\n'
            'for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n'
            "                               'paddle_tpu_torch.'):\n"
            '    importlib.import_module(m.name)\n'
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'paddle_tpu'))\n"
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
        res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr

    def test_sources_import_no_jax(self):
        """No module of the port, and not chip_smoke.py, names JAX or the
        JAX package in an import statement, lazy ones included."""
        for path in _port_sources():
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    assert n.split('.')[0] not in (
                        'jax', 'jaxlib', 'paddle_tpu'), (path, n)
