"""The port's training path against the JAX package's, on the same
weights and batches.

The JAX model's parameters (drawn by the JAX package from a fixed seed)
are loaded into the port with `load_jax_state`; token batches come from
seeded numpy. Both TrainEngines run AdamW on the CPU in float32 (the
JAX model through its lax reference paths, the port through the plain
versions of its kernels, wired through the same autograd Functions the
card runs), and the per-step losses and the trained parameters are
compared. Also: the clip and the schedules against their JAX versions,
AdamW's float32 moments for bf16 parameters against the JAX optimizer,
and the engine's refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.training.engine import TrainEngine as JaxEngine
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW, lr
from paddle_tpu_torch.training import TrainEngine

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


CFG = dict(vocab_size=128, hidden_size=64, layers=2, heads=4, kv_heads=2,
           intermediate_size=128, max_pos=256)
# float32 on both sides; the two differ in summation order only
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
# Adam's step lr * m / (sqrt(v) + eps) moves by lr / eps per unit of
# gradient where a gradient is near 0; at the default eps (1e-8) a
# float32 rounding difference of 1e-10 in such a gradient moves that
# element by 1e-5. eps = 1e-6 keeps that under 1e-7, so the comparison
# can stay at float32 rounding.
EPS = 1e-6


def _jax_state(model):
    return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _pair(dtype='float32'):
    pt.seed(0)
    jm = JaxLlama(dataclasses.replace(jax_tiny(**CFG), dtype=dtype))
    tm = LlamaForCausalLM(dataclasses.replace(llama_tiny(**CFG),
                                              dtype=dtype), device='cpu')
    io.load_jax_state(tm, _jax_state(jm))
    return jm, tm


def _schedule(mod):
    """Warmup over 2 steps into a cosine decay over 10."""
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


class TestTrainEngine:
    @pytest.mark.parametrize('accum', [1, 2])
    def test_steps_match_jax_engine(self, accum):
        """3 AdamW steps of 4 x 128 tokens (S = 128: the flash path):
        losses per step and the trained parameters agree (the JAX-trained
        state crosses into a fresh port model through load_jax_state,
        whose names training leaves unchanged). accum=2 also
        runs the warmup + cosine schedule and a global-norm clip that
        bites (norm ~1 against 0.5)."""
        jm, tm = _pair()
        if accum == 1:
            jopt = JaxAdamW(learning_rate=1e-3, epsilon=EPS,
                            weight_decay=0.01)
            topt = AdamW(learning_rate=1e-3, epsilon=EPS, weight_decay=0.01)
        else:
            jopt = JaxAdamW(learning_rate=_schedule(jax_lr), epsilon=EPS,
                            weight_decay=0.01, grad_clip=JaxClip(0.5))
            topt = AdamW(learning_rate=_schedule(lr), epsilon=EPS,
                         weight_decay=0.01,
                         grad_clip=ClipGradByGlobalNorm(0.5))
        jeng = JaxEngine(jm, jopt, accum_steps=accum, log_window=1)
        teng = TrainEngine(tm, topt, accum_steps=accum, log_window=1)
        rng = np.random.default_rng(accum)
        for step in range(3):
            ids = rng.integers(0, CFG['vocab_size'], (4, 129))
            want = jeng.step((jnp.asarray(ids, jnp.int32),))['loss']
            got = teng.step((torch.from_numpy(ids),))['loss']
            np.testing.assert_allclose(got, want, err_msg=f'step {step}',
                                       **LOSS_TOL)
        trained = LlamaForCausalLM(llama_tiny(**CFG), device='cpu', seed=9)
        io.load_jax_state(trained, _jax_state(jeng.model))
        want = dict(trained.named_parameters())
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].detach().numpy(),
                                       err_msg=name, **PARAM_TOL)
        assert topt.state['step'] == 3

    def test_window_sync_and_eval(self):
        """Logs arrive once per window with the window's losses; eval
        losses match the model's loss."""
        _, tm = _pair()
        eng = TrainEngine(tm, AdamW(learning_rate=1e-3), log_window=3)
        ids = torch.from_numpy(np.random.default_rng(5).integers(
            0, CFG['vocab_size'], (2, 129)))
        assert eng.step((ids,)) is None and eng.step((ids,)) is None
        logs = eng.step((ids,))
        assert logs['window'] == 3 and logs['loss'] < logs['loss_mean']
        assert logs['losses'][-1] == logs['loss'] and len(logs['losses']) == 3
        assert eng.sync() == logs
        assert eng.eval_step((ids,)) is None
        with torch.no_grad():
            want = tm.loss(ids).item()
        assert eng.eval_sync() == pytest.approx([want], rel=1e-6)

    def test_loss_fn_mode(self):
        """hapi's shape: loss_fn(model(*inputs), *labels)."""
        _, tm = _pair()
        from paddle_tpu_torch import ops

        def loss_fn(logits, labels):
            return ops.softmax_cross_entropy(logits, labels).mean()

        ids = torch.from_numpy(np.random.default_rng(6).integers(
            0, CFG['vocab_size'], (2, 129)))
        with torch.no_grad():
            want = tm.loss(ids).item()
        eng = TrainEngine(tm, AdamW(learning_rate=1e-3), loss_fn=loss_fn,
                          log_window=1)
        got = eng.step((ids[:, :-1],), (ids[:, 1:],))['loss']
        assert got == pytest.approx(want, rel=1e-6)

    def test_prefetch_order(self):
        _, tm = _pair()
        eng = TrainEngine(tm, AdamW(learning_rate=1e-3))
        batches = [(np.full((2, 3), i),) for i in range(5)]
        got = [int(b[0][0, 0]) for b in eng.prefetch(iter(batches), size=2)]
        assert got == list(range(5))

    def test_refusals(self):
        _, tm = _pair()
        eng = TrainEngine(tm, AdamW(learning_rate=1e-3), accum_steps=3)
        with pytest.raises(ValueError, match='not divisible'):
            eng.step((torch.zeros(4, 17, dtype=torch.int64),))
        for kw in (dict(mesh=object()), dict(scaler=object()),
                   dict(metrics=[object()])):
            with pytest.raises(NotImplementedError):
                TrainEngine(tm, AdamW(), **kw)
        with pytest.raises(RuntimeError, match='eval-only'):
            TrainEngine(tm).step((torch.zeros(2, 17, dtype=torch.int64),))


class TestOptimizer:
    def test_bf16_parameters_keep_float32_moments(self):
        """Two AdamW updates of a bf16 model against the JAX optimizer
        on the same parameters and gradients: the moments stay float32
        (torch.optim would keep them in bf16), decay runs before the
        update, norms decay too, and the parameters agree."""
        jm, tm = _pair('bfloat16')
        jopt = JaxAdamW(learning_rate=1e-2, weight_decay=0.1)
        topt = AdamW(learning_rate=1e-2, weight_decay=0.1)
        jstate = jopt.init(jm)
        topt.init(tm)

        def jgrad(p):
            return jnp.sin(p.astype(jnp.float32) * 37.0 + 1.0).astype(p.dtype)

        for _ in range(2):
            t, _ = pt.framework.tree.split_trainable(jm)
            jm, jstate = jopt.apply_gradients(jm, jax.tree.map(jgrad, t),
                                              jstate)
            topt.apply_gradients(
                {n: torch.sin(p.float() * 37.0 + 1.0).to(p.dtype)
                 for n, p in tm.named_parameters()})
        for kind in ('m', 'v'):
            for name, s in topt.state['slots'][kind].items():
                assert s.dtype == torch.float32, (kind, name)
        assert all(jnp.asarray(x).dtype == jnp.float32
                   for x in jax.tree.leaves(jstate['slots']['m']))
        want = {io.port_name(k): v for k, v in _jax_state(jm).items()}
        for name, p in tm.named_parameters():
            assert p.dtype == io.array_dtype(want[name]), name
            ref = torch.from_numpy(
                np.array(jnp.asarray(want[name], jnp.float32)))
            # one bf16 rounding step of the updated parameter
            torch.testing.assert_close(p.float(), ref, rtol=2 ** -7,
                                       atol=1e-6, msg=name)

    def test_global_norm_clip_matches_jax(self):
        rng = np.random.default_rng(0)
        grads = {'a': rng.normal(size=(4, 5)).astype(np.float32),
                 'b': rng.normal(size=(7,)).astype(np.float32)}
        for clip in (0.5, 100.0):
            want = JaxClip(clip)({k: jnp.asarray(v)
                                  for k, v in grads.items()})
            got = ClipGradByGlobalNorm(clip)({k: torch.from_numpy(v)
                                              for k, v in grads.items()})
            for k in grads:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-6)

    def test_schedules_match_jax(self):
        for mk in (_schedule,
                   lambda m: m.CosineAnnealingDecay(0.1, T_max=7,
                                                    eta_min=0.01),
                   lambda m: m.LinearWarmup(0.05, 4, 0.0, 0.05)):
            want, got = mk(jax_lr), mk(lr)
            for step in range(15):
                np.testing.assert_allclose(
                    got(step), float(want(jnp.float32(step))), rtol=1e-6,
                    atol=1e-9, err_msg=f'step {step}')
