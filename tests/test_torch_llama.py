"""The port's Llama model against the JAX package's, on the same
weights.

The JAX model's parameters (drawn by the JAX package from a fixed
seed) are loaded into the port with `load_jax_state`; token ids come
from seeded numpy. Logits are compared in float32 on the CPU, through
the uncached forward and through paged decode (prefill into pages, then
single-token steps over the block tables).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import _prefill_kv as jax_prefill_kv
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference.serving import _prefill_kv
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)

# float32 on both sides; summation order differs between XLA and PyTorch
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(seed=0, **cfg):
    pt.seed(seed)
    jm = JaxLlama(dataclasses.replace(jax_tiny(**cfg)))
    tm = LlamaForCausalLM(llama_tiny(**cfg), device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


class TestLoadJaxState:
    def test_names_shapes_dtypes_carry_across(self):
        pt.seed(0)
        jm = JaxLlama(jax_tiny())
        flat = {k: np.asarray(v) for k, v in jm.state_dict().items()}
        tm = LlamaForCausalLM(llama_tiny(), device='cpu')
        io.load_jax_state(tm, flat)
        own = tm.state_dict()
        assert {io.jax_name(k) for k in own} == set(flat)
        for name, t in own.items():
            arr = flat[io.jax_name(name)]
            assert tuple(t.shape) == arr.shape, name
            assert t.dtype == io.array_dtype(arr), name
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)

    def test_missing_extra_and_mismatch_raise(self):
        pt.seed(0)
        flat = {k: np.asarray(v)
                for k, v in JaxLlama(jax_tiny()).state_dict().items()}
        tm = LlamaForCausalLM(llama_tiny(), device='cpu')
        missing = dict(flat)
        del missing['model.layers.L1.mlp.up_proj']
        with pytest.raises(ValueError, match='missing.*layers.1.mlp.up_proj'):
            io.load_jax_state(tm, missing)
        extra = dict(flat, **{'model.layers.L2.mlp.up_proj':
                              flat['model.layers.L1.mlp.up_proj']})
        with pytest.raises(ValueError, match='not in the port model'):
            io.load_jax_state(tm, extra)
        shape = dict(flat, **{'lm_head': flat['lm_head'][:, :-1]})
        with pytest.raises(ValueError, match='lm_head: shape'):
            io.load_jax_state(tm, shape)
        dtype = dict(flat, **{'lm_head': flat['lm_head'].astype(np.float16)})
        with pytest.raises(ValueError, match='lm_head: dtype'):
            io.load_jax_state(tm, dtype)

    def test_bf16_npz_round_trip_with_jax_package(self, tmp_path):
        """A bf16 model saved by the JAX package loads into the port, and
        the port's save reads back bit-identically."""
        pt.seed(0)
        jm = JaxLlama(dataclasses.replace(jax_tiny(), dtype='bfloat16'))
        pt.save(jm.state_dict(), tmp_path / 'jax.npz')
        tm = LlamaForCausalLM(
            dataclasses.replace(llama_tiny(), dtype='bfloat16'), device='cpu')
        io.load_jax_state(tm, io.load(tmp_path / 'jax.npz'))
        want = {k: np.asarray(v) for k, v in jm.state_dict().items()}
        for name, t in tm.state_dict().items():
            np.testing.assert_array_equal(
                t.float().numpy(),
                want[io.jax_name(name)].astype(np.float32), err_msg=name)
        io.save(tm, tmp_path / 'port.npz')
        back = io.load(tmp_path / 'port.npz')
        assert set(back) == set(want)
        tm2 = LlamaForCausalLM(
            dataclasses.replace(llama_tiny(), dtype='bfloat16'), device='cpu',
            seed=5)
        io.load_jax_state(tm2, back)
        for (n1, a), (n2, b) in zip(tm.state_dict().items(),
                                    tm2.state_dict().items()):
            assert n1 == n2 and torch.equal(a, b), n1


class TestLogits:
    @pytest.mark.parametrize('cfg', [
        dict(vocab_size=96, hidden_size=64, layers=2),             # GQA 4/2
        dict(vocab_size=128, hidden_size=64, layers=3, heads=4, kv_heads=4),
    ], ids=['gqa', 'mha'])
    def test_uncached_forward(self, cfg):
        jm, tm = _pair(**cfg)
        ids = np.random.default_rng(0).integers(0, cfg['vocab_size'],
                                                (2, 21))
        # the JAX forward under one jax.jit (an eager run compiles every
        # operation)
        want = np.asarray(jax.jit(lambda x: jm(x))(jnp.asarray(ids,
                                                               jnp.int32)))
        with torch.no_grad():
            got = tm(torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)

    def test_rope_scalings(self):
        """llama3 and yarn frequency scalings follow the JAX package."""
        from paddle_tpu.models.llama import rope_cos_sin as jax_rope
        from paddle_tpu_torch.models.llama import rope_cos_sin

        pos = np.arange(0, 300, 7)
        for scaling in (None,
                        {'rope_type': 'llama3', 'factor': 8.0,
                         'original_max_position_embeddings': 64},
                        {'rope_type': 'yarn', 'factor': 4.0,
                         'original_max_position_embeddings': 64}):
            jc, js = jax_rope(jnp.asarray(pos), 16, 500.0,
                              rope_scaling=scaling)
            tc, ts = rope_cos_sin(torch.from_numpy(pos), 16, 500.0,
                                  rope_scaling=scaling)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                       rtol=1e-5, atol=1e-5)

    def test_paged_decode(self):
        """Prefill two right-padded prompts into shuffled pages, then
        decode five tokens through the block tables: the port's logits
        (paged-attention plain version on the CPU) follow the JAX
        model's (its paged gather path) at every step."""
        cfg = dict(vocab_size=96, hidden_size=64, layers=2)
        jm, tm = _pair(**cfg)
        rng = np.random.default_rng(1)
        BS, NB, MAXB, Sb = 4, 24, 6, 16
        lens = np.asarray([13, 6])
        ids = np.zeros((2, Sb), np.int32)
        for b, n in enumerate(lens):
            ids[b, :n] = rng.integers(0, 96, n)
        btab = (rng.permutation(NB - 1)[:2 * MAXB] + 1).reshape(2, MAXB)
        btab = btab.astype(np.int32)
        jpages = jm.init_paged_cache(NB, BS)
        tpages = tm.init_paged_cache(NB, BS)
        # the JAX side under one jax.jit per forward shape (compiled
        # once, where an eager run compiles every operation)
        jprefill = jax.jit(lambda pages, ids, lens, btab: jax_prefill_kv(
            jm, pages, ids, lens, btab))
        jstep = jax.jit(lambda tok, pages, ctx, btab: jm(
            tok, caches=pages, kv_write_pos=ctx, block_tables=btab))
        jlast, jpages = jprefill(jpages, jnp.asarray(ids), jnp.asarray(lens),
                                 jnp.asarray(btab))
        with torch.no_grad():
            tlast, tpages = _prefill_kv(tm, tpages, torch.from_numpy(ids),
                                        torch.from_numpy(lens),
                                        torch.from_numpy(btab))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   **LOGIT_TOL)
        ctx = lens.astype(np.int32)
        for step in range(5):
            tok = np.asarray(jlast).argmax(-1).astype(np.int32)[:, None]
            jlogits, jpages = jstep(jnp.asarray(tok), jpages,
                                    jnp.asarray(ctx), jnp.asarray(btab))
            with torch.no_grad():
                tlogits, tpages = tm(torch.from_numpy(tok), caches=tpages,
                                     kv_write_pos=torch.from_numpy(ctx),
                                     block_tables=torch.from_numpy(btab))
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       err_msg=f'step {step}', **LOGIT_TOL)
            jlast = jlogits[:, -1]
            ctx = ctx + 1
        for (jk, jv), (tk, tv) in zip(jpages, tpages):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       **LOGIT_TOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       **LOGIT_TOL)

    def test_unserved_configs_raise(self):
        # sliding-window models are ported (tests/test_torch_window.py)
        for knob in (dict(sequence_parallel=True), dict(remat=True)):
            with pytest.raises(NotImplementedError):
                LlamaForCausalLM(dataclasses.replace(llama_tiny(), **knob),
                                 device='cpu')
        tm = LlamaForCausalLM(llama_tiny(), device='cpu')
        # pools are bf16, float32 or int8 (int8 since the int8-KV slice)
        with pytest.raises(NotImplementedError, match='int8'):
            tm.init_paged_cache(4, 4, dtype=torch.float16)
