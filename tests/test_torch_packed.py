"""Packed-sequence attention with gradients in the port against the JAX
package.

The plain backward beside the segment-id mode of the flash kernels (K6s
of PERF.md) is held against the JAX package's Pallas `_bwd` with
`qseg` / `kseg` (the backward `_flash_seg` runs), after `_fwd` with the
same ids, in interpret mode under one `jax.jit` per case with blocks of
32, so the segment tile skips run: a
query segment that no key has (dq = 0, no gradient to any key or
value), Sq != Sk, and segments combined with a window. The varlen entry
points (`flash_attn_unpadded`, `flash_attn_varlen_qkvpacked`) and
`scaled_dot_product_attention(segment_ids=)` are held against the JAX
functions, outputs and `jax.grad` gradients; on the CPU the JAX package
takes its masked path, the port the plain versions of its kernels.
Float32; inputs from seeded numpy.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as jax_attention
from paddle_tpu.nn.functional.flash_attention import \
    flash_attn_unpadded as jax_unpadded
from paddle_tpu.ops.pallas import flash_attention as jax_flash_mod
from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import flash_attention as t_flash

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


# float32 on both sides, summation order apart (tests/test_torch_train_
# kernels.py)
FLASH_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _bhsd(a):
    return torch.from_numpy(np.asarray(a)).transpose(1, 2)


def _ids(*lens):
    return np.repeat(np.arange(len(lens)), lens).astype(np.int32)


def _empty(ids, lo, hi):
    """`ids` with queries lo..hi-1 moved to a segment (9) no key has."""
    out = ids.copy()
    out[lo:hi] = 9
    return out


# (B, H, Hkv, Sq, Sk, D, causal, window, qseg, kseg): sorted packed
# segments of uneven lengths, each case with 16 queries in a segment no
# key has; not causal with Sq < Sk and per-side ids; causal with a
# window under GQA
SEG_CASES = {
    'full-sq<sk': (2, 4, 2, 128, 160, 16, False, None,
                   _empty(_ids(40, 1, 87), 50, 66), _ids(60, 1, 99)),
    'causal-window': (1, 4, 1, 160, 160, 16, True, 24,
                      _empty(_ids(70, 1, 89), 70, 86), _ids(70, 1, 89)),
}


class TestSegmentBackward:
    @pytest.mark.parametrize('case', SEG_CASES.values(),
                             ids=SEG_CASES.keys())
    def test_plain_matches_pallas(self, case):
        """out, dq, dk, dv of the plain K5s / K6s against the Pallas
        `_fwd` / `_bwd` with qseg / kseg."""
        B, H, Hkv, Sq, Sk, D, causal, w, qs, ks = case
        rng = np.random.default_rng(Sq + Sk + H)
        q, do = _np(rng, (B, Sq, H, D)), _np(rng, (B, Sq, H, D))
        k, v = _np(rng, (B, Sk, Hkv, D)), _np(rng, (B, Sk, Hkv, D))
        qseg, kseg = np.tile(qs, (B, 1)), np.tile(ks, (B, 1))
        scale = 1.0 / math.sqrt(D)

        def pallas(q, k, v, do, qseg, kseg):
            q, k, v, do = (jnp.swapaxes(a, 1, 2) for a in (q, k, v, do))
            out, lse = jax_flash_mod._fwd(q, k, v, scale, causal, 32, 32,
                                          qseg, kseg, window=w)
            return (out,) + jax_flash_mod._bwd(
                scale, causal, 32, 32, (q, k, v, out, lse), (do, None), qseg,
                kseg, window=w)

        want, *want_grads = jax.jit(pallas)(
            *(jnp.asarray(a) for a in (q, k, v, do, qseg, kseg)))
        tqs, tks = torch.from_numpy(qseg), torch.from_numpy(kseg)
        out, lse = t_flash.flash_attention_fwd_plain(
            _bhsd(q), _bhsd(k), _bhsd(v), causal, scale, tqs, tks, w)
        grads = t_flash.flash_attention_bwd_plain(
            _bhsd(q), _bhsd(k), _bhsd(v), out, lse, _bhsd(do), causal, scale,
            tqs, tks, w)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   **FLASH_TOL)
        for name, got, ref in zip('qkv', grads, want_grads):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       err_msg='d' + name, **FLASH_TOL)
        empty = qs == 9
        assert not out[:, :, empty].any(), 'an empty segment returns 0'
        assert not grads[0][:, :, empty].any(), 'and has dq = 0'
        # and gives no gradient to any key or value: its dout is moot
        do2 = do.copy()
        do2[:, empty] = 0
        again = t_flash.flash_attention_bwd_plain(
            _bhsd(q), _bhsd(k), _bhsd(v), out, lse, _bhsd(do2), causal,
            scale, tqs, tks, w)
        for got, ref in zip(grads[1:], again[1:]):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)

    def test_sdpa_segments_differentiable(self):
        """SDPA with segment ids and a gradient (the flash op's K5s / K6s
        at 128 queries and more) against jax.grad of the JAX SDPA."""
        rng = np.random.default_rng(5)
        B, S, H, D = 2, 128, 2, 16
        q, k, v, do = (_np(rng, (B, S, H, D)) for _ in range(4))
        seg = np.tile(_ids(40, 60, 28), (B, 1))

        def jloss(q, k, v):
            out = jax_attention.scaled_dot_product_attention(
                q, k, v, is_causal=True, segment_ids=jnp.asarray(seg))
            return (out * do).sum(), out

        (_, want), want_grads = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a) for a in (q, k, v)))
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = F.scaled_dot_product_attention(
            *ts, is_causal=True, segment_ids=torch.from_numpy(seg))
        (out * torch.from_numpy(do)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **FLASH_TOL)
        for t, ref in zip(ts, want_grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                       **FLASH_TOL)


class TestVarlenEntryPoints:
    # 3 sequences of 60, 100 and 40 tokens: the stream takes the flash op
    CU = np.array([0, 60, 160, 200], np.int32)

    @pytest.mark.parametrize('causal', [True, False],
                             ids=['causal', 'full'])
    def test_flash_attn_unpadded_equal_to_jax(self, causal):
        """Outputs and gradients of (out * dout).sum() equal the JAX
        function's; the scale is passed through."""
        rng = np.random.default_rng(int(causal))
        T, H, D = int(self.CU[-1]), 4, 16
        q, k, v, do = (_np(rng, (T, H, D)) for _ in range(4))
        scale = 0.3

        def jloss(q, k, v):
            out, _ = jax_unpadded(
                q, k, v, jnp.asarray(self.CU), jnp.asarray(self.CU), 100,
                100, scale=scale, causal=causal)
            return (out * do).sum(), out

        (_, want), want_grads = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a) for a in (q, k, v)))
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        before = dict(ops.LAUNCHES)
        out, softmax = F.flash_attn_unpadded(
            *ts, torch.from_numpy(self.CU), torch.from_numpy(self.CU), 100,
            100, scale=scale, causal=causal)
        (out * torch.from_numpy(do)).sum().backward()
        assert softmax is None and ops.LAUNCHES == before
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **FLASH_TOL)
        for t, ref in zip(ts, want_grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                       **FLASH_TOL)

    def test_flash_attn_varlen_qkvpacked_equal_to_jax(self):
        rng = np.random.default_rng(7)
        T, H, D = int(self.CU[-1]), 2, 16
        qkv, do = _np(rng, (T, 3, H, D)), _np(rng, (T, H, D))

        def jloss(qkv):
            out, _ = jax_attention.flash_attn_varlen_qkvpacked(
                qkv, jnp.asarray(self.CU), jnp.asarray(self.CU), 100, 100,
                0.25, causal=True)
            return (out * do).sum(), out

        (_, want), want_grad = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jnp.asarray(qkv))
        t = torch.from_numpy(qkv).requires_grad_()
        out, _ = F.flash_attn_varlen_qkvpacked(
            t, self.CU, self.CU, 100, 100, 0.25, causal=True)
        (out * torch.from_numpy(do)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **FLASH_TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad),
                                   **FLASH_TOL)

    def test_flash_attn_qkvpacked_equal_to_jax(self):
        rng = np.random.default_rng(8)
        qkv = _np(rng, (2, 128, 3, 2, 16))
        want, _ = jax_attention.flash_attn_qkvpacked(jnp.asarray(qkv),
                                                     causal=True)
        with torch.no_grad():
            got, _ = F.flash_attn_qkvpacked(torch.from_numpy(qkv),
                                            causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FLASH_TOL)
        with pytest.raises(NotImplementedError, match='return_softmax'):
            F.flash_attn_unpadded(
                torch.from_numpy(qkv[0, :, 0]), torch.from_numpy(qkv[0, :, 1]),
                torch.from_numpy(qkv[0, :, 2]), self.CU, self.CU, 100, 100,
                return_softmax=True)
