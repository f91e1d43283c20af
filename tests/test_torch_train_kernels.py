"""The training path's kernel modules against the JAX package's Pallas
kernels.

Each plain forward / backward function beside a hand-written Hopper
kernel (paddle_tpu_torch/ops/hopper/) is held against `jax.vjp` of the
JAX package's Pallas kernel, run in interpret mode on the CPU as the JAX
package's own tests run it, on the same seeded numpy inputs, in float32.
Each autograd Function (the CPU path of the ops entry points) is held
against torch.autograd through naive math. The kernels themselves run
only on a CUDA card: tests/test_torch_cuda.py holds them against these
plain versions there.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_flash_mod
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu.ops.pallas.softmax_xent import \
    softmax_cross_entropy_with_logits as jax_xent
from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import flash_attention as t_flash
from paddle_tpu_torch.ops.hopper import rms_norm as t_rms
from paddle_tpu_torch.ops.hopper import softmax_xent as t_xent

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


# float32 on both sides; the two differ only in summation order
TOL = dict(rtol=1e-5, atol=1e-5)
# attention sums up to 256 products per score and per gradient entry
FLASH_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jit_vjp(fn, *primals, cotangent):
    """fn(*primals) and its vjp at `cotangent`, under one jit: the
    interpreted Pallas kernels compile once together instead of each
    pallas_call running eagerly."""
    def run(primals, ct):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(ct)

    return jax.jit(run)([jnp.asarray(p) for p in primals],
                        jnp.asarray(cotangent))


class TestRmsNormBackward:
    @pytest.mark.parametrize('shape', [(6, 256), (5, 200), (2, 3, 96)])
    def test_plain_matches_pallas_vjp(self, shape):
        """dx (the `_dx_kernel`) and dw against jax.vjp of the Pallas
        RMSNorm; 200 is not a multiple of the TPU's 128 lanes."""
        rng = np.random.default_rng(shape[-1])
        x, g = _np(rng, shape), _np(rng, shape)
        w = 1.0 + _np(rng, shape[-1:], 0.1)
        want_dx, want_dw = _jit_vjp(lambda a, b: jax_rms_norm(a, b, 1e-5),
                                    x, w, cotangent=g)[1]
        _, r = t_rms.rms_norm_plain(_t(x), _t(w), 1e-5, return_r=True)
        dx = t_rms.rms_norm_bwd_plain(_t(x), _t(w), r, _t(g))
        dw = t_rms.rms_norm_dweight(_t(x), r, _t(g), torch.float32)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw),
                                   rtol=1e-5, atol=1e-4)

    def test_function_matches_autograd(self):
        rng = np.random.default_rng(2)
        x = _t(_np(rng, (2, 5, 64))).requires_grad_()
        w = _t(1.0 + _np(rng, (64,), 0.1)).requires_grad_()
        g = _t(_np(rng, (2, 5, 64)))
        (ops.rms_norm(x, w, 1e-5) * g).sum().backward()
        x2 = x.detach().clone().requires_grad_()
        w2 = w.detach().clone().requires_grad_()
        xf = x2 * torch.rsqrt(x2.square().mean(-1, keepdim=True) + 1e-5)
        (xf * w2 * g).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), **TOL)
        np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(),
                                   rtol=1e-5, atol=1e-4)

    def test_no_grad_runs_the_forward_alone(self):
        """Under no_grad (serving) ops.rms_norm skips the Function: no
        autograd node, the same values."""
        rng = np.random.default_rng(4)
        x = _t(_np(rng, (3, 64)))
        w = _t(1.0 + _np(rng, (64,), 0.1)).requires_grad_()
        with torch.no_grad():
            fast = ops.rms_norm(x, w, 1e-5)
        tracked = ops.rms_norm(x, w, 1e-5)
        assert fast.grad_fn is None and tracked.grad_fn is not None
        torch.testing.assert_close(fast, tracked.detach(), rtol=0, atol=0)


class TestSoftmaxXent:
    @pytest.mark.parametrize('R,V', [(10, 1000), (7, 2500), (3, 4096)],
                             ids=['one-block', 'tail-2048', 'two-blocks'])
    def test_plain_matches_pallas_vjp(self, R, V):
        """Loss and dlogits against jax.vjp of the Pallas kernel; 2500
        leaves a masked tail in the TPU kernel's 2048-wide vocab
        blocks."""
        rng = np.random.default_rng(V)
        x = _np(rng, (R, V), 3.0)
        labels = rng.integers(0, V, R).astype(np.int32)
        g = rng.uniform(0.5, 1.5, R).astype(np.float32)
        want, (want_dx,) = _jit_vjp(
            lambda a: jax_xent(a, jnp.asarray(labels)), x, cotangent=g)
        loss, lse = t_xent.softmax_xent_fwd_plain(_t(x), _t(labels))
        dx = t_xent.softmax_xent_bwd_plain(_t(x), _t(labels), lse, _t(g))
        np.testing.assert_allclose(loss.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
        np.testing.assert_allclose(
            lse.numpy(), np.log(np.exp(x.astype(np.float64)).sum(-1)),
            rtol=1e-6)

    def test_label_out_of_range_picks_neg_inf(self):
        x = torch.zeros(2, 8)
        loss, _ = t_xent.softmax_xent_fwd_plain(x, torch.tensor([8, 3]))
        assert loss[0].item() > 1e29 and abs(loss[1] - math.log(8)) < 1e-6

    def test_function_matches_autograd(self):
        rng = np.random.default_rng(3)
        x = _t(_np(rng, (2, 6, 300), 2.0)).requires_grad_()
        labels = _t(rng.integers(0, 300, (2, 6)))
        ops.softmax_cross_entropy(x, labels).mean().backward()
        x2 = x.detach().clone().requires_grad_()
        nll = (torch.logsumexp(x2, -1)
               - x2.gather(-1, labels[..., None])[..., 0])
        nll.mean().backward()
        np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), **TOL)


# (B, H, Hkv, Sq, Sk, D, causal)
FLASH_CASES = {
    'mha-causal': (1, 2, 2, 128, 128, 32, True),
    'gqa-causal': (2, 4, 2, 128, 128, 16, True),
    'gqa8-noncausal-sq<sk': (1, 4, 1, 128, 192, 16, False),
    'causal-sq<sk': (1, 2, 2, 96, 160, 16, True),
    'causal-sq>sk': (1, 2, 2, 160, 96, 16, True),
}


def _flash_inputs(case):
    B, H, Hkv, Sq, Sk, D, _ = case
    rng = np.random.default_rng(Sq * 7 + Sk + H)
    return (_np(rng, (B, Sq, H, D)), _np(rng, (B, Sk, Hkv, D)),
            _np(rng, (B, Sk, Hkv, D)), _np(rng, (B, Sq, H, D)))


def _bhsd(a):
    return _t(a).transpose(1, 2)


class TestFlashAttention:
    @pytest.mark.parametrize('case', FLASH_CASES.values(),
                             ids=FLASH_CASES.keys())
    def test_plain_matches_pallas_vjp(self, case):
        """out, lse, dq, dk, dv against the Pallas kernels (`_fwd` for
        lse, jax.vjp of `flash_attention` for the rest): MHA and GQA,
        bottom-right causal with Sq != Sk both ways."""
        causal = case[-1]
        q, k, v, do = _flash_inputs(case)
        scale = 1.0 / math.sqrt(q.shape[-1])

        def pallas(q, k, v, do):
            out, vjp = jax.vjp(
                lambda a, b, c: jax_flash_mod.flash_attention(
                    a, b, c, causal=causal), q, k, v)
            _, lse = jax_flash_mod._fwd(
                *(jnp.swapaxes(a, 1, 2) for a in (q, k, v)), scale, causal,
                1024, 1024)
            return (out, lse) + vjp(do)

        # one jit: the interpreted kernels compile once together instead
        # of each pallas_call running eagerly
        want, want_lse, want_dq, want_dk, want_dv = jax.jit(pallas)(
            *(jnp.asarray(a) for a in (q, k, v, do)))
        out, lse = t_flash.flash_attention_fwd_plain(
            _bhsd(q), _bhsd(k), _bhsd(v), causal, scale)
        dq, dk, dv = t_flash.flash_attention_bwd_plain(
            _bhsd(q), _bhsd(k), _bhsd(v), out, lse, _bhsd(do), causal, scale)
        np.testing.assert_allclose(out.transpose(1, 2).numpy(),
                                   np.asarray(want), **FLASH_TOL)
        want_lse = np.asarray(want_lse)[:, :, 0]
        seen = want_lse > -1e29
        np.testing.assert_allclose(lse.numpy()[seen], want_lse[seen],
                                   **FLASH_TOL)
        assert (lse.numpy()[~seen] < -1e29).all()
        for got, ref in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
            np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                       np.asarray(ref), **FLASH_TOL)
        if causal and case[3] > case[4]:
            assert not out[:, :, :case[3] - case[4]].any()

    @pytest.mark.parametrize('case', [FLASH_CASES['gqa-causal'],
                                      FLASH_CASES['causal-sq>sk']],
                             ids=['gqa-causal', 'causal-sq>sk'])
    def test_function_matches_autograd(self, case):
        """ops.flash_attention's gradients against torch.autograd through
        naive masked attention (rows that see no key give 0)."""
        q, k, v, do = (_t(a) for a in _flash_inputs(case))
        qs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*qs, causal=True)
        (out * do).sum().backward()
        rs = [t.clone().requires_grad_() for t in (q, k, v)]
        B, Sq, H, D = q.shape
        Sk, group = k.shape[1], H // k.shape[2]
        kk = rs[1].repeat_interleave(group, 2)
        vv = rs[2].repeat_interleave(group, 2)
        s = torch.einsum('bqhd,bkhd->bhqk', rs[0], kk) / math.sqrt(D)
        ok = (torch.arange(Sq)[:, None] + Sk - Sq) >= torch.arange(Sk)
        p = torch.softmax(torch.where(ok, s, -1e30), -1) * ok.any(-1)[:, None]
        ref = torch.einsum('bhqk,bkhd->bqhd', p, vv)
        (ref * do).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(),
                                   ref.detach().numpy(), **FLASH_TOL)
        for a, b in zip(qs, rs):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                       **FLASH_TOL)

    def test_dispatch_rule(self):
        """The JAX package's rule: unmasked attention over >= 128 queries
        with head_dim % 8 == 0 takes the flash op; a mask, or fewer
        queries, takes the plain masked path. Both agree."""
        q, k, v, _ = (_t(a).requires_grad_()
                      for a in _flash_inputs(FLASH_CASES['gqa-causal']))
        flash = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        assert 'FlashAttentionFn' in type(flash.grad_fn.next_functions[0][0]
                                          ).__name__
        mask = torch.ones(128, 128, dtype=torch.bool).tril()[None, None]
        masked = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        assert 'FlashAttentionFn' not in str(masked.grad_fn)
        np.testing.assert_allclose(masked.detach().numpy(),
                                   flash.detach().numpy(), **FLASH_TOL)
        short = F.scaled_dot_product_attention(q[:, :64], k[:, :64],
                                               v[:, :64], is_causal=True)
        np.testing.assert_allclose(short.detach().numpy(),
                                   flash[:, :64].detach().numpy(),
                                   **FLASH_TOL)


class TestFlashRoute:
    """The one route rule of the flash kernels (`path`): bf16 with a head
    size that is a multiple of 8 up to 128 takes the tensor cores,
    float32 and bf16 past 128 the CUDA cores; and the tensor-core dk/dv
    pass's slices of a GQA group (`dkv_slices`). Pure Python: the
    kernels themselves run in tests/test_torch_cuda.py."""

    @pytest.mark.parametrize('dtype,D,route', [
        (torch.bfloat16, D, 'tensor_core') for D in (8, 40, 64, 80, 96, 128)
    ] + [(torch.bfloat16, 136, 'cuda_core'),
         (torch.bfloat16, 256, 'cuda_core'),
         (torch.float32, 64, 'cuda_core'), (torch.float32, 128, 'cuda_core'),
         (torch.float32, 256, 'cuda_core'), (torch.float16, 64, 'cuda_core')])
    def test_route_rule(self, dtype, D, route):
        assert t_flash.path(dtype, D) == route
        t_flash.check_built('flash', D)     # every case here is built

    @pytest.mark.parametrize('D', [100, 4, 264])
    def test_unbuilt_head_sizes_are_refused(self, D):
        """Neither route takes a head size off the multiples of 8 up to
        256: the wrappers refuse it before choosing a route."""
        assert t_flash.path(torch.bfloat16, D) == 'cuda_core'
        with pytest.raises(NotImplementedError, match=f'head_dim {D}'):
            t_flash.check_built('flash', D)

    @pytest.mark.parametrize('B,Hkv,S,group,want', [
        (1, 32, 2048, 1, 1),      # Llama-7B MHA: 512 blocks fill the card
        (1, 8, 2048, 4, 4),       # GQA 32 / 8: 128 blocks -> 4 slices
        (6, 8, 2048, 4, 1),       # the same heads at batch 6
        (1, 8, 8192, 4, 1),       # Mistral-7B's heads over 8192 tokens
        (1, 4, 2048, 7, 7),       # Qwen2-7B's 28 / 4
        (1, 8, 4096, 4, 1),       # the packed 4096-token stream: 256
        (1, 16, 2048, 2, 1),      # 256 blocks: one wave already
        (2, 4, 2048, 8, 4),       # 128 blocks -> 4 slices (512)
        (1, 1, 128, 6, 6)])       # no divisor fills it: the whole group
    def test_dkv_slices(self, B, Hkv, S, group, want):
        got = t_flash.dkv_slices(B, Hkv, S, group, 132)
        assert got == want and group % got == 0


class TestRefusals:
    def test_unported_options_raise(self):
        # segment ids and windows are ported with their backward (K6s,
        # K6w): tests/test_torch_packed.py, tests/test_torch_window.py
        q = torch.zeros(1, 128, 2, 16)
        with pytest.raises(NotImplementedError, match='dropout'):
            F.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
        with pytest.raises(NotImplementedError):
            F.flash_attention(q, q, q, causal=True, return_softmax=True)

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """No fallback: handed CPU tensors, the kernel wrappers raise."""
        x = torch.ones(2, 64)
        r = torch.ones(2, 1)
        with pytest.raises(ValueError, match='CUDA'):
            t_rms.rms_norm_bwd(x, torch.ones(64), r, x)
        labels = torch.zeros(2, dtype=torch.int64)
        with pytest.raises(ValueError, match='CUDA'):
            t_xent.softmax_xent_fwd(x, labels)
        with pytest.raises(ValueError, match='CUDA'):
            t_xent.softmax_xent_bwd(x, labels, r[:, 0], r[:, 0])
        q = torch.zeros(1, 2, 128, 64)
        with pytest.raises(ValueError, match='CUDA'):
            t_flash.flash_attention_fwd(q, q, q, True)
        with pytest.raises(ValueError, match='CUDA'):
            t_flash.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 128),
                                        q, True)
        # on the tensor-core route too
        qb = q.bfloat16()
        with pytest.raises(ValueError, match='CUDA'):
            t_flash.flash_attention_fwd(qb, qb, qb, True)
        with pytest.raises(ValueError, match='CUDA'):
            t_flash.flash_attention_bwd(qb, qb, qb, qb,
                                        torch.zeros(1, 2, 128), qb, True,
                                        slices=1)
