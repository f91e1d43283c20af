"""Sliding-window attention in the port against the JAX package.

The plain forward and backward beside the window mode of the flash
kernels (K5w, K6w of PERF.md) are held against the JAX package's Pallas
kernels `_fwd` and `_bwd` in window mode, run in interpret mode under
one `jax.jit` per case, with blocks of 32 and 64 so the window's tile
skips run. The autograd Function is held against naive autograd of the band
mask. A sliding-window Llama (Mistral-style: every layer windowed, or
Qwen2-style: `max_window_layers` 1) is held against the JAX model on the
same weights: logits through the flash path, greedy `generate` (plain,
left-padded, int8 KV), `DecodeEngine`, and 3 AdamW `TrainEngine` steps.
On the CPU the JAX model takes its masked attention (the band folded
into the mask); the port takes the plain versions of its kernels.
Everything is float32; inputs come from seeded numpy.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn.functional.attention import \
    scaled_dot_product_attention as jax_sdpa
from paddle_tpu.ops.pallas import flash_attention as jax_flash_mod
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.training.engine import TrainEngine as JaxEngine
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import flash_attention as t_flash
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.training import TrainEngine

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


# float32 on both sides, summation order apart (tests/test_torch_train_
# kernels.py): attention sums up to a few hundred products per entry
FLASH_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
EPS = 1e-6        # Adam's epsilon: see tests/test_torch_train.py

CFG = dict(vocab_size=128, hidden_size=64, layers=2, heads=4, kv_heads=2,
           intermediate_size=128, max_pos=256)


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _bhsd(a):
    return torch.from_numpy(np.asarray(a)).transpose(1, 2)


# (B, H, Hkv, Sq, Sk, D, window): every window with GQA, Sq = Sk, Sq < Sk
# and Sq > Sk (bottom-right: a query sees keys j <= i + Sk - Sq)
WINDOW_CASES = {
    'w1-sq=sk': (1, 4, 2, 128, 128, 16, 1),
    'w7-sq<sk': (1, 4, 2, 96, 160, 16, 7),
    'w48-sq>sk': (1, 4, 1, 160, 96, 16, 48),
    'w200-mha': (2, 2, 2, 130, 130, 16, 200),
}


class TestWindowKernels:
    @pytest.mark.parametrize('case', WINDOW_CASES.values(),
                             ids=WINDOW_CASES.keys())
    def test_plain_matches_pallas(self, case):
        """out, lse, dq, dk, dv of the plain K5w / K6w against the Pallas
        `_fwd` / `_bwd` in window mode (blocks 32 x 64, so whole tiles are
        skipped on both sides of the band)."""
        B, H, Hkv, Sq, Sk, D, w = case
        rng = np.random.default_rng(Sq + Sk + w)
        q, do = _np(rng, (B, Sq, H, D)), _np(rng, (B, Sq, H, D))
        k, v = _np(rng, (B, Sk, Hkv, D)), _np(rng, (B, Sk, Hkv, D))
        scale = 1.0 / math.sqrt(D)

        def pallas(q, k, v, do):
            q, k, v, do = (jnp.swapaxes(a, 1, 2) for a in (q, k, v, do))
            out, lse = jax_flash_mod._fwd(q, k, v, scale, True, 32, 64,
                                          window=w)
            return (out, lse) + jax_flash_mod._bwd(
                scale, True, 32, 64, (q, k, v, out, lse), (do, None),
                window=w)

        want, want_lse, *want_grads = jax.jit(pallas)(
            *(jnp.asarray(a) for a in (q, k, v, do)))
        out, lse = t_flash.flash_attention_fwd_plain(
            _bhsd(q), _bhsd(k), _bhsd(v), True, scale, window=w)
        grads = t_flash.flash_attention_bwd_plain(
            _bhsd(q), _bhsd(k), _bhsd(v), out, lse, _bhsd(do), True, scale,
            window=w)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   **FLASH_TOL)
        want_lse = np.asarray(want_lse)[:, :, 0]
        seen = want_lse > -1e29
        np.testing.assert_allclose(lse.numpy()[seen], want_lse[seen],
                                   **FLASH_TOL)
        assert (lse.numpy()[~seen] < -1e29).all()
        for name, got, ref in zip('qkv', grads, want_grads):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       err_msg='d' + name, **FLASH_TOL)

    @pytest.mark.parametrize('w', [1, 33])
    def test_function_matches_autograd(self, w):
        """ops.flash_attention(window_size=) forward and gradients against
        torch.autograd through naive attention with the band mask."""
        rng = np.random.default_rng(w)
        B, S, H, Hkv, D = 2, 128, 4, 2, 16
        q, do = (torch.from_numpy(_np(rng, (B, S, H, D))) for _ in range(2))
        k, v = (torch.from_numpy(_np(rng, (B, S, Hkv, D))) for _ in range(2))
        got_in = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*got_in, causal=True, window_size=w)
        (out * do).sum().backward()
        ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
        kk, vv = (t.repeat_interleave(H // Hkv, 2) for t in ref_in[1:])
        s = torch.einsum('bqhd,bkhd->bhqk', ref_in[0], kk) / math.sqrt(D)
        back = torch.arange(S)[:, None] - torch.arange(S)[None, :]
        band = (back >= 0) & (back < w)
        p = torch.softmax(torch.where(band, s, -1e30), -1)
        ref = torch.einsum('bhqk,bkhd->bqhd', p, vv)
        (ref * do).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(),
                                   ref.detach().numpy(), **FLASH_TOL)
        for a, b in zip(got_in, ref_in):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                       **FLASH_TOL)

    def test_window_checks(self):
        q = torch.zeros(1, 128, 2, 16)
        with pytest.raises(ValueError, match='causal'):
            ops.flash_attention(q, q, q, causal=False, window_size=4)
        with pytest.raises(ValueError, match='>= 1'):
            ops.flash_attention(q, q, q, causal=True, window_size=0)
        with pytest.raises(ValueError, match='is_causal'):
            F.scaled_dot_product_attention(q, q, q, window_size=4)

    @pytest.mark.parametrize('mask', ['none', 'bool', 'float'])
    def test_sdpa_window_equal_to_jax(self, mask):
        """SDPA's window_size on the masked path (a mask, or fewer than
        128 queries) folds the band into the mask as the JAX package's
        does; without a mask at 128 queries it takes the flash op's
        window mode, and both agree."""
        rng = np.random.default_rng(3)
        B, S, H, D, w = 2, 128, 2, 16, 9
        q, k, v = (_np(rng, (B, S, H, D)) for _ in range(3))
        m = None
        if mask != 'none':
            keep = rng.random((B, 1, S, S)) > 0.2
            m = keep if mask == 'bool' else np.where(
                keep, rng.normal(size=keep.shape), -1e30).astype(np.float32)
        n = S if mask != 'none' else 64     # the masked path either way
        want = jax.jit(lambda q, k, v, m: jax_sdpa(
            q, k, v, attn_mask=m, is_causal=True, window_size=w))(
                *(jnp.asarray(a[:, :n]) for a in (q, k, v)),
                None if m is None else jnp.asarray(m))
        got = F.scaled_dot_product_attention(
            *(torch.from_numpy(a[:, :n]) for a in (q, k, v)),
            attn_mask=None if m is None else torch.from_numpy(m),
            is_causal=True, window_size=w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FLASH_TOL)
        if mask == 'none':
            flash = F.scaled_dot_product_attention(
                *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True,
                window_size=w)
            np.testing.assert_allclose(flash[:, :n].numpy(), got.numpy(),
                                       **FLASH_TOL)


def _swa(cfg, window, max_window_layers):
    return dataclasses.replace(cfg, sliding_window=window,
                               max_window_layers=max_window_layers)


@functools.lru_cache(maxsize=None)
def _models(window, max_window_layers=0):
    pt.seed(0)
    jm = JaxLlama(_swa(jax_tiny(**CFG), window, max_window_layers))
    tm = LlamaForCausalLM(_swa(llama_tiny(**CFG), window, max_window_layers),
                          device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(3, CFG['vocab_size'],
                                                (B, S)).astype(np.int32)


class TestSlidingWindowLlama:
    @pytest.mark.parametrize('mwl', [0, 1], ids=['mistral', 'qwen2'])
    def test_logits_equal_to_jax(self, mwl):
        """Logits of a 160-token forward (the flash path, window 48) equal
        the JAX model's; the windowed layers really differ from full
        attention past the window."""
        jm, tm = _models(48, mwl)
        assert [a.self_attn.sliding_window for a in tm.model.layers] == \
            [None if i < mwl else 48 for i in range(CFG['layers'])]
        ids = _prompts(1, 160, 1)
        want = np.asarray(jax.jit(jm)(jnp.asarray(ids)))
        before = dict(ops.LAUNCHES)
        with torch.no_grad():
            got = tm(torch.from_numpy(ids)).numpy()
        assert ops.LAUNCHES == before, 'the CPU runs no kernel'
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        full_model = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
        io.load_jax_state(full_model, {k: np.asarray(v)
                                       for k, v in jm.state_dict().items()})
        with torch.no_grad():
            full = full_model(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(full[0, :48], got[0, :48], **LOGIT_TOL)
        assert not np.allclose(full[0, -1], got[0, -1], atol=1e-3)

    @pytest.mark.parametrize('setting', ['plain', 'left_padded', 'kv8'])
    def test_greedy_token_equal_to_jax(self, setting):
        """Greedy streams over a window of 5 (prompts of 10, 8 new
        tokens, so every decode step drops keys), equal to the JAX
        model's; int8 KV holds the port against the JAX int8 path with
        the same window."""
        jm, tm = _models(5)
        ids = _prompts(2, 10, 4)
        kw = dict(max_new_tokens=8)
        if setting == 'left_padded':
            am = np.ones_like(ids)
            am[0, :3] = 0
            ids = ids * am
            kw['attention_mask'] = am
        if setting == 'kv8':
            kw['kv_cache_int8'] = True
        jkw = dict(kw)
        if 'attention_mask' in kw:
            jkw['attention_mask'] = jnp.asarray(kw['attention_mask'])
            kw['attention_mask'] = torch.from_numpy(kw['attention_mask'])
        # the JAX generate under one jax.jit (its eager prefill compiles
        # every operation), the mask a constant
        want = np.asarray(jax.jit(lambda x: jm.generate(x, **jkw))(
            jnp.asarray(ids)))
        got = tm.generate(torch.from_numpy(ids), **kw)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_decode_engine_token_equal_to_jax(self):
        jm, tm = _models(5)
        ids = _prompts(2, 7, 6)
        want = np.asarray(JaxDecodeEngine(jm, max_new_tokens=9).generate(
            jnp.asarray(ids)))
        got = DecodeEngine(tm, max_new_tokens=9).generate(
            torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_train_steps_equal_to_jax_engine(self):
        """3 AdamW steps of 2 x 128 tokens (the flash path: K5w / K6w's
        plain versions through the autograd Function) on a model whose
        second layer is windowed: losses and trained parameters equal the
        JAX engine's."""
        pt.seed(0)
        jm = JaxLlama(_swa(jax_tiny(**CFG), 40, 1))
        tm = LlamaForCausalLM(_swa(llama_tiny(**CFG), 40, 1), device='cpu')
        io.load_jax_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
        jeng = JaxEngine(jm, JaxAdamW(learning_rate=1e-3, epsilon=EPS,
                                      weight_decay=0.01), log_window=1)
        teng = TrainEngine(tm, AdamW(learning_rate=1e-3, epsilon=EPS,
                                     weight_decay=0.01), log_window=1)
        rng = np.random.default_rng(11)
        for step in range(3):
            ids = rng.integers(0, CFG['vocab_size'], (2, 129))
            want = jeng.step((jnp.asarray(ids, jnp.int32),))['loss']
            got = teng.step((torch.from_numpy(ids),))['loss']
            np.testing.assert_allclose(got, want, err_msg=f'step {step}',
                                       **LOSS_TOL)
        jstate = {k: np.asarray(v)
                  for k, v in jeng.model.state_dict().items()}
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       jstate[io.jax_name(name)],
                                       err_msg=name, **PARAM_TOL)

    def test_serving_engine_refuses_sliding_window(self):
        _, tm = _models(5)
        with pytest.raises(NotImplementedError, match='sliding-window'):
            ServingEngine(tm)
