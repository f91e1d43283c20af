"""MoE training in the port against the JAX package (float32, CPU).

- X1's backward: the dx and dw plain versions against `jax.vjp` of
  `jax.lax.ragged_dot` (an empty expert, an expert holding every row, no
  rows at all); `MoEGroupedMatmulFn` on CPU tensors against plain
  autograd of the plain forward, with no kernel launch.
- `MoELayer` gradients (ragged and dense dispatch, with shared experts,
  k = 1 and 2; the parameters' and the input's) against `jax.grad` of the
  JAX layer, the aux loss in the objective.
- `MoEForCausalLM` at `moe_tiny(dispatch_mode='ragged')` and the dense
  `moe_tiny()`: the loss and every parameter's gradient against
  `jax.grad` of the JAX model's `loss` on weights carried across by
  `load_jax_state`.
- Three `TrainEngine` + AdamW steps (accum 1 and 2) against the JAX
  engine's: the losses and the trained weights.

JAX references run under `jax.jit`; the JAX models draw their weights
from numpy (`_numpy_init`), each built once per module where nothing
trains it. Tolerances: float32 on both sides, differing in summation
order only.
"""
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.framework.tree import merge, split_trainable
from paddle_tpu.models.moe_lm import MoEForCausalLM as JaxMoE
from paddle_tpu.models.moe_lm import moe_tiny as jax_tiny
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.training.engine import TrainEngine as JaxEngine
from paddle_tpu_torch import ops
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.models.moe_lm import MoEForCausalLM, moe_tiny
from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as x1
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.training import TrainEngine

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)

# float32 on both sides, summation order apart
TOL = dict(rtol=1e-5, atol=1e-5)
# Adam's step moves an element with a near-zero gradient by lr / eps per
# unit of gradient: eps = 1e-6 keeps a float32 rounding difference there
# under 1e-7 (as tests/test_torch_train.py's EPS)
EPS = 1e-6


def _np(x):
    return np.asarray(x)


def _rng(seed):
    return np.random.default_rng(seed)


@contextlib.contextmanager
def _numpy_init(seed):
    """JAX models built inside draw their normal(mean, std) weights from
    a numpy generator (the JAX initializer's eager random ops compile
    once per shape)."""
    rng = _rng(seed)

    def normal(init, shape, dtype):
        return jnp.asarray((rng.normal(size=shape) * init.std
                            + init.mean).astype(np.dtype(dtype)))

    with mock.patch.object(jinit.Normal, '__call__', normal):
        yield


def _jax_grads(fn, model, *args):
    """(value, named gradients of the model's trainable leaves, gradients
    of `args`) of fn(model, *args), under one jax.jit."""
    trainable, frozen = split_trainable(model)

    @jax.jit
    def run(t, *a):
        return jax.value_and_grad(lambda t_, *a_: fn(merge(t_, frozen), *a_),
                                  argnums=tuple(range(len(a) + 1)))(t, *a)

    value, grads = run(trainable, *map(jnp.asarray, args))
    named = {io.port_name(k): _np(v)
             for k, v in grads[0].state_dict().items() if v is not None}
    return float(value), named, [_np(g) for g in grads[1:]]


def _assert_grads(module, want, what):
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want), what
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name],
                                   err_msg=f'{what}: {name}', **TOL)


# ---------------------------------------------------------------------------
# X1's backward
# ---------------------------------------------------------------------------

# rows per expert: experts with rows beside an empty one, empty experts
# around the rows, one expert holding every row, no rows at all
X1_BWD = {'ragged': (3, 7, 0, 5, 2), 'empty_experts': (0, 4, 0, 0, 6),
          'one_expert_all_rows': (0, 0, 13, 0), 'no_rows': (0, 0, 0)}


@pytest.mark.parametrize('case', list(X1_BWD))
def test_backward_plain_equal_jax_vjp(case):
    """dx = dy w[e]^T and dw[e] = x_e^T dy_e against jax.vjp of
    ragged_dot, whose weight gradient is zero for an expert with no
    rows."""
    counts = np.asarray(X1_BWD[case], np.int32)
    E, R, K, N = len(counts), int(counts.sum()), 12, 10
    rng = _rng(len(case))
    x = rng.normal(size=(R, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    dy = rng.normal(size=(R, N)).astype(np.float32)
    sizes = jnp.asarray(counts)
    want_y, (want_dx, want_dw) = jax.jit(lambda a, b, g: (
        jax.lax.ragged_dot(a, b, sizes),
        jax.vjp(lambda a_, b_: jax.lax.ragged_dot(a_, b_, sizes), a, b)[1](
            g)))(x, w, dy)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(
        np.int32))
    tx, tw, tdy = map(torch.from_numpy, (x, w, dy))
    np.testing.assert_allclose(
        x1.moe_grouped_matmul_plain(tx, tw, off).numpy(), _np(want_y), **TOL)
    dx = x1.moe_grouped_matmul_dx_plain(tdy, tw, off)
    dw = x1.moe_grouped_matmul_dw_plain(tx, tdy, off)
    assert dx.shape == (R, K) and dw.shape == (E, K, N)
    np.testing.assert_allclose(dx.numpy(), _np(want_dx), **TOL)
    np.testing.assert_allclose(dw.numpy(), _np(want_dw), **TOL)
    for e in np.flatnonzero(counts == 0):
        assert not dw[e].any() and not _np(want_dw)[e].any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_function_equal_plain_autograd(dtype):
    """ops.moe_grouped_matmul under a gradient on CPU tensors: the
    autograd Function over the plain versions, equal to plain autograd of
    the plain forward (the same float32 products, rounded once to the
    dtype), with no kernel launch; offsets get no gradient."""
    rng = _rng(3)
    counts = (4, 0, 9, 2)
    E, R, K, N = len(counts), sum(counts), 16, 8
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                       dtype=torch.int32)
    x0 = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(E, K, N)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(R, N)).astype(np.float32)).to(
        dtype)
    before = dict(ops.LAUNCHES)
    runs = []
    for fn in (ops.moe_grouped_matmul, x1.moe_grouped_matmul_plain):
        x = x0.to(dtype).clone().requires_grad_()
        w = w0.to(dtype).clone().requires_grad_()
        y = fn(x, w, off)
        y.backward(g)
        runs.append((y.detach(), x.grad, w.grad))
    assert dict(ops.LAUNCHES) == before
    for got, want in zip(*runs):
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not runs[0][2][1].any()            # expert 1 has no rows
    # the Function's backward is the two plain versions
    x = x0.clone().requires_grad_()
    x1.MoEGroupedMatmulFn.apply(x, w0, off).sum().backward()
    torch.testing.assert_close(x.grad, x1.moe_grouped_matmul_dx_plain(
        torch.ones(R, N), w0, off))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

# name: (dispatch_mode, shared experts, k)
LAYER = {'ragged_shared_k2': ('ragged', 1, 2), 'ragged_k1': ('ragged', 0, 1),
         'dense_shared_k2': ('dense', 2, 2), 'dense_k1': ('dense', 0, 1)}


@pytest.mark.parametrize('case', list(LAYER))
def test_moe_layer_gradients_equal_jax(case):
    """The objective sum(out * g) + 0.01 aux through the router, the
    top-k gates, the dispatch and the experts: every parameter's gradient
    and the input's against jax.grad of the JAX layer."""
    mode, shared, k = LAYER[case]
    H, M, E = 32, 48, 5
    with _numpy_init(3):
        jl = jmoe.MoELayer(H, M, num_experts=E, top_k=k,
                           num_shared_experts=shared, return_aux=True,
                           dispatch_mode=mode)
    tl = tmoe.MoELayer(H, M, num_experts=E, top_k=k,
                       num_shared_experts=shared, return_aux=True,
                       dispatch_mode=mode, device='cpu')
    io.load_jax_state(tl, {k_: _np(v) for k_, v in jl.state_dict().items()})
    rng = _rng(4)
    x = rng.normal(size=(2, 9, H)).astype(np.float32)
    g = rng.normal(size=(2, 9, H)).astype(np.float32)

    def objective(m, a):
        out, aux = m(a)
        return (out * g).sum() + 0.01 * aux

    value, want, (want_dx,) = _jax_grads(objective, jl, x)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tl(tx)
    loss = (out * torch.from_numpy(g)).sum() + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(loss.item(), value, **TOL)
    _assert_grads(tl, want, case)
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, **TOL)
    assert tl.gate.grad.abs().max() > 0        # the router learns


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _pair(mode, seed=0):
    """(JAX model, port model) of moe_tiny in `mode` on the same weights."""
    with _numpy_init(seed):
        jm = JaxMoE(jax_tiny(dispatch_mode=mode))
    tm = MoEForCausalLM(moe_tiny(dispatch_mode=mode), device='cpu')
    io.load_jax_state(tm, {k: _np(v) for k, v in jm.state_dict().items()})
    return jm, tm


_models = functools.lru_cache(maxsize=None)(_pair)


def _ids(seed, B, S, V=256):
    return _rng(seed).integers(3, V, (B, S)).astype(np.int32)


@pytest.mark.parametrize('mode', ['ragged', 'auto'])
def test_model_loss_and_gradients_equal_jax(mode):
    """`loss` (float32 NLL + aux_loss_weight x aux) and every parameter's
    gradient, dropless ('ragged') and through the GShard dispatch ('auto'
    is dense at 4 experts), within 1e-5 of jax.grad of the JAX model's
    loss."""
    jm, tm = _models(mode)
    ids = _ids(1, 2, 13)
    value, want, _ = _jax_grads(lambda m: m.loss(jnp.asarray(ids)), jm)
    tm.zero_grad(set_to_none=True)
    loss = tm.loss(torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), value, **TOL)
    _assert_grads(tm, want, mode)
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize('accum', [1, 2])
def test_train_engine_steps_equal_jax(accum):
    """Three AdamW steps of 4 x 16 tokens through both TrainEngines on
    the dropless model (loss_fn=None: model.loss, aux included): the
    per-step losses and the trained parameters."""
    jm, tm = _pair('ragged', seed=1)
    jeng = JaxEngine(jm, JaxAdamW(learning_rate=1e-3, epsilon=EPS,
                                  weight_decay=0.01),
                     accum_steps=accum, log_window=1)
    teng = TrainEngine(tm, AdamW(learning_rate=1e-3, epsilon=EPS,
                                 weight_decay=0.01),
                       accum_steps=accum, log_window=1)
    rng = _rng(10 + accum)
    losses = []
    for step in range(3):
        ids = rng.integers(3, 256, (4, 17)).astype(np.int32)
        want = jeng.step((jnp.asarray(ids),))['loss']
        got = teng.step((torch.from_numpy(ids),))['loss']
        np.testing.assert_allclose(got, want, err_msg=f'step {step}', **TOL)
        losses.append(got)
    trained = MoEForCausalLM(moe_tiny(dispatch_mode='ragged'), device='cpu',
                             seed=9)
    io.load_jax_state(trained, {k: _np(v) for k, v in
                                jeng.model.state_dict().items()})
    want = dict(trained.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **TOL)
    assert teng.optimizer.state['step'] == 3


def test_router_and_experts_move_under_training():
    """A few AdamW steps on one repeated batch: the loss falls and every
    parameter moves, the router and the routed experts included (each
    expert receives rows at moe_tiny's top 2 of 4)."""
    tm = MoEForCausalLM(moe_tiny(dispatch_mode='ragged'), device='cpu',
                        seed=2)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    eng = TrainEngine(tm, AdamW(learning_rate=1e-2), log_window=4)
    ids = torch.from_numpy(_ids(7, 2, 17))
    for _ in range(4):
        logs = eng.step((ids,))
    assert logs['losses'][-1] < logs['losses'][0]
    still = [n for n, p in tm.named_parameters()
             if torch.equal(p.detach(), start[n])]
    assert not still, still
