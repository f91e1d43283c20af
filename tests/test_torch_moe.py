"""The MoE language model in the port against the JAX package, on the same
weights and inputs (float32, CPU).

- Gating: `_topk_gates`, `limit_by_capacity`, `top_k_gating` equal to the
  JAX functions (indices exactly, ties to the lower expert; values within
  1e-6).
- `ragged_expert_apply` (the grouped product X1's plain version under
  it) equal to the JAX function within 1e-5, also with experts that
  receive no rows; X1's plain version, its gradient on CPU tensors and
  its path rule (the rest of MoE training: tests/test_torch_moe_train.py).
- `MoELayer` equal to the JAX layer within 1e-5: dropless, dense with
  capacity drops and 'ragged', with and without shared experts, k = 1,
  2, 3, the aux loss (returned and in the buffer); the 'auto' warning.
- `MoEForCausalLM`: uncached logits and aux within 1e-5 (dense and
  ragged dispatch); the JAX state dict round-trips through
  `load_jax_state`, `aux_loss` buffers included; greedy `generate`
  token-equal to JAX at batch 1 and 2 with eos, a left-padded
  `attention_mask`, and int8 KV caches; `DecodeEngine` with bucket
  padding token-equal.
- Speculative decoding: `generate_speculative` and
  `DecodeEngine.generate_speculative` with the model as its own draft
  (tests/test_decode.py's MoE config) and with a 1-layer MoE draft,
  token-equal to the JAX package's with equal accept counts;
  `generate_speculative_sampled`'s properties.
- The Mixtral converter and `fused_moe` (float32, bf16, weight-only
  int8) against the JAX ones; the converted model's loss and gradients
  against `jax.grad`; every refusal.

JAX references run under `jax.jit` (its eager ops compile one by one),
each model built once per module, its random weights drawn by numpy
(`_numpy_init`).
"""
import contextlib
import functools
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import autograd as jautograd
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.incubate.nn import functional as jinc
from paddle_tpu.inference import engine as jengine
from paddle_tpu.models import convert as jconvert
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.moe_lm import MoEConfig as JaxConfig
from paddle_tpu.models.moe_lm import MoEForCausalLM as JaxMoE
from paddle_tpu.models.moe_lm import moe_tiny as jax_tiny
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch import ops
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.incubate.nn import functional as tinc
from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
from paddle_tpu_torch.models import convert as tconvert
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM, moe_tiny
from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as x1
from paddle_tpu_torch.quantization import quantize_matmul_weights

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _rng(seed):
    return np.random.default_rng(seed)


@contextlib.contextmanager
def _numpy_init(seed):
    """JAX models built inside draw their normal(mean, std) weights from
    a numpy generator seeded with `seed`: the weights only cross into the
    port, and the JAX initializer's eager random ops compile once per
    shape (~5 s for moe_tiny)."""
    rng = _rng(seed)

    def normal(init, shape, dtype):
        return jnp.asarray((rng.normal(size=shape) * init.std
                            + init.mean).astype(np.dtype(dtype)))

    with mock.patch.object(jinit.Normal, '__call__', normal):
        yield


# ---------------------------------------------------------------------------
# gating and the dropless product
# ---------------------------------------------------------------------------

def _logits(T=24, E=6, seed=0):
    """Router logits with exact ties: column 4 copies column 1, and row
    0 is constant."""
    lg = _rng(seed).normal(size=(T, E)).astype(np.float32)
    lg[:, 4] = lg[:, 1]
    lg[0] = 0.5
    return lg


def test_gating_equal_jax():
    lg, k = _logits(), 3
    want, want_cap = jax.jit(lambda x: (jmoe._topk_gates(x, k),
                                        jmoe.top_k_gating(x, k, 3)))(
        jnp.asarray(lg))
    got = tmoe._topk_gates(torch.from_numpy(lg), k)
    for name, w, g in zip(('probs', 'gates', 'idx', 'aux'), want, got):
        if name == 'idx':
            np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    # ties to the lower expert: row 0 picks experts 0..k-1, and a row
    # whose top two are columns 1 and 4 (equal) lists 1 first
    assert got[2][0].tolist() == list(range(k))
    tied = [r for r in got[2].tolist() if 1 in r and 4 in r]
    assert tied and all(r.index(4) == r.index(1) + 1 for r in tied)
    idx = np.array(want[2])
    for cap in (1, 3):
        np.testing.assert_array_equal(
            tmoe.limit_by_capacity(torch.from_numpy(idx), 6, cap).numpy(),
            _np(jmoe.limit_by_capacity(jnp.asarray(idx), 6, cap)))
    got = tmoe.top_k_gating(torch.from_numpy(lg), k, 3)
    assert float(got[0].sum()) < lg.shape[0] * k        # routings dropped
    for w, g in zip(want_cap, got):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6, atol=1e-6)


def _ragged_inputs(T, H, M, E, k, seed, empty=()):
    rng = _rng(seed)
    tokens = rng.normal(size=(T, H)).astype(np.float32)
    lg = rng.normal(size=(T, E)).astype(np.float32)
    lg[:, list(empty)] = -1e9                 # experts no token picks
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    idx = np.argsort(-lg, axis=1)[:, :k].astype(np.int32)
    ws = [(0.2 * rng.normal(size=s)).astype(np.float32)
          for s in ((E, H, M), (E, H, M), (E, M, H))]
    return tokens, idx, gates, ws


@pytest.mark.parametrize('empty', [(), (0, 3, 5)], ids=['all', 'empty'])
def test_ragged_expert_apply_equal_jax(empty):
    E = 6
    tokens, idx, gates, ws = _ragged_inputs(11, 16, 24, E, 2, 1, empty)
    want = jax.jit(lambda *a: jmoe.ragged_expert_apply(*a, E))(
        *map(jnp.asarray, (tokens, idx, gates, *ws)))
    got = tmoe.ragged_expert_apply(
        *map(torch.from_numpy, (tokens, idx, gates, *ws)), E)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_grouped_matmul_plain_and_rules():
    rng = _rng(2)
    x = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 5, 3)).astype(np.float32))
    off = torch.tensor([0, 0, 4, 4, 7], dtype=torch.int32)
    y = ops.moe_grouped_matmul(x, w, off)
    np.testing.assert_allclose(y[:4].numpy(), (x[:4] @ w[1]).numpy(), **TOL)
    np.testing.assert_allclose(y[4:].numpy(), (x[4:] @ w[3]).numpy(), **TOL)
    empty = ops.moe_grouped_matmul(x[:0], w, torch.zeros(5,
                                                         dtype=torch.int32))
    assert empty.shape == (0, 3)
    for bad in ([0, 2, 1, 4, 7], [0, 0, 4, 4, 6]):
        with pytest.raises(ValueError, match='nondecreasing'):
            ops.moe_grouped_matmul(x, w, torch.tensor(bad,
                                                      dtype=torch.int32))
    with pytest.raises(TypeError, match='share a dtype'):
        ops.moe_grouped_matmul(x, w.double(), off)
    # under a gradient: the autograd Function, on CPU tensors over the
    # plain backward (dw[e] = x_e^T dy_e, zero for the empty experts)
    ops.moe_grouped_matmul(x, w.requires_grad_(), off).sum().backward()
    for e, (a, b) in enumerate(((0, 0), (0, 4), (4, 4), (4, 7))):
        np.testing.assert_allclose(
            w.grad[e].numpy(),
            x[a:b].sum(0)[:, None].expand(5, 3).numpy(), **TOL)
    with pytest.raises(ValueError, match='CUDA device'):
        x1.moe_grouped_matmul(x, w.detach(), off)
    # the skinny path while R <= 8 E: every decode shape of the slice;
    # past it float32 takes the CUDA-core tiles
    assert [x1.path(R, E, K, N, torch.float32, True)
            for R, E, K, N in ((6, 64, 2048, 1408), (48, 64, 1408, 2048),
                               (3072, 64, 2048, 1408), (16, 8, 4096, 14336),
                               (1024, 8, 14336, 4096))] == [
        'skinny', 'skinny', 'tiled', 'skinny', 'tiled']


# (R, E, K, N, dtype, 16-byte-aligned pointers) -> the route
X1_ROUTES = {
    # bf16 prefills at full width: 512 tokens at b1 and b8, top 6 over
    # 64 experts (gate / up, then down), top 2 over Mixtral's 8
    'moe_b1_gate_up': ((3072, 64, 2048, 1408, 'bfloat16', True),
                       'tensor_core'),
    'moe_b1_down': ((3072, 64, 1408, 2048, 'bfloat16', True), 'tensor_core'),
    'moe_b8_gate_up': ((24576, 64, 2048, 1408, 'bfloat16', True),
                       'tensor_core'),
    'mixtral_b1_gate_up': ((1024, 8, 4096, 14336, 'bfloat16', True),
                           'tensor_core'),
    'mixtral_b8_down': ((8192, 8, 14336, 4096, 'bfloat16', True),
                        'tensor_core'),
    # N a multiple of 8 but not of 16 or of the 256-column strip
    'n_of_8': ((700, 6, 64, 72, 'bfloat16', True), 'tensor_core'),
    # past the skinny bound but not for the tensor cores
    'float32_prefill': ((3072, 64, 2048, 1408, 'float32', True), 'tiled'),
    'float32_mixtral': ((1024, 8, 4096, 14336, 'float32', True), 'tiled'),
    'k_not_of_8': ((700, 6, 37, 64, 'bfloat16', True), 'tiled'),
    'n_not_of_8': ((700, 6, 64, 100, 'bfloat16', True), 'tiled'),
    'unaligned': ((3072, 64, 2048, 1408, 'bfloat16', False), 'tiled'),
    'odd_bf16': ((5 * 100, 6, 37, 100, 'bfloat16', True), 'tiled'),
    # decode: within the bound (bf16 E, float32 8 E), aligned or not
    'decode_b1': ((6, 64, 2048, 1408, 'bfloat16', True), 'skinny'),
    'decode_b8': ((48, 64, 1408, 2048, 'bfloat16', True), 'skinny'),
    'mixtral_decode_b1': ((2, 8, 4096, 14336, 'bfloat16', False), 'skinny'),
    # Mixtral's b8 decode, 2 rows an expert: the tensor cores beat the
    # skinny path there
    'mixtral_decode_b8': ((16, 8, 14336, 4096, 'bfloat16', True),
                          'tensor_core'),
    'at_the_bound': ((x1.SKINNY_MEAN_ROWS[torch.bfloat16] * 64, 64, 2048,
                      1408, 'bfloat16', True), 'skinny'),
    'past_the_bound': ((x1.SKINNY_MEAN_ROWS[torch.bfloat16] * 64 + 1, 64,
                        2048, 1408, 'bfloat16', True), 'tensor_core'),
    'float32_decode': ((48, 64, 2048, 1408, 'float32', False), 'skinny'),
    'float32_mixtral_decode_b8': ((16, 8, 14336, 4096, 'float32', True),
                                  'skinny'),
}


@pytest.mark.parametrize('case', list(X1_ROUTES))
def test_grouped_matmul_route(case):
    """`path()`'s three routes by shape, dtype and alignment alone."""
    (R, E, K, N, dtype, aligned), want = X1_ROUTES[case]
    dt = getattr(torch, dtype)
    # the table's premise: only rows within the skinny bound are skinny
    assert (R <= x1.SKINNY_MEAN_ROWS[dt] * E) == (want == 'skinny')
    assert x1.path(R, E, K, N, dt, aligned) == want


def test_grouped_matmul_cpu_takes_the_plain_version():
    """A bf16 product of prefill shape on CPU tensors: the plain version
    (each expert's rows times its weight in float32, rounded once), no
    kernel launch on any route."""
    rng = _rng(5)
    E, K, N = 2, 16, 8
    off = torch.tensor([0, 7, 20], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(20, K)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(E, K, N)).astype(np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    assert x1.path(20, E, K, N, torch.bfloat16, True) == 'tensor_core'
    before = dict(x1.PATH_LAUNCHES), ops.LAUNCHES['moe_grouped_matmul']
    y = ops.moe_grouped_matmul(xb, wb, off)
    assert (dict(x1.PATH_LAUNCHES), ops.LAUNCHES['moe_grouped_matmul']) \
        == before
    want = torch.cat([xb[:7].float() @ wb[0].float(),
                      xb[7:].float() @ wb[1].float()]).bfloat16()
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

# name: (dispatch_mode, forward(dropless=), shared experts, k,
# capacity_factor)
LAYER = {'dropless_shared_k2': ('dense', True, 1, 2, 1.25),
         'dense_drops_k1': ('dense', False, 0, 1, 0.5),
         'dense_shared_k3': ('dense', False, 2, 3, 0.75),
         'ragged_k3': ('ragged', False, 0, 3, 1.25),
         'ragged_shared_k1': ('ragged', False, 1, 1, 1.25)}


@pytest.mark.parametrize('case', list(LAYER))
def test_moe_layer_equal_jax(case):
    mode, dropless, shared, k, cf = LAYER[case]
    H, M, E = 32, 48, 5
    with _numpy_init(3):
        jl = jmoe.MoELayer(H, M, num_experts=E, top_k=k, capacity_factor=cf,
                           num_shared_experts=shared, return_aux=True,
                           dispatch_mode=mode)
    tl = tmoe.MoELayer(H, M, num_experts=E, top_k=k, capacity_factor=cf,
                       num_shared_experts=shared, return_aux=True,
                       dispatch_mode=mode, device='cpu')
    io.load_jax_state(tl, {k_: _np(v) for k_, v in jl.state_dict().items()})
    x = _rng(4).normal(size=(2, 9, H)).astype(np.float32)
    want, waux = jax.jit(lambda m, a: m(a, dropless=dropless))(
        jl, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tl(torch.from_numpy(x), dropless=dropless)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    assert float(tl.aux_loss) == float(aux)
    if case == 'dense_drops_k1':
        # the capacity drops routings here: the dropless result differs
        with torch.no_grad():
            full, _ = tl(torch.from_numpy(x), dropless=True)
        assert not torch.allclose(full, got, atol=1e-3)


def test_auto_dispatch_warns_at_16_experts():
    with pytest.warns(UserWarning, match="dispatch_mode='ragged'"):
        layer = tmoe.MoELayer(8, 8, num_experts=16, device='cpu')
    assert layer.dispatch_mode == 'dense'
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tmoe.MoELayer(8, 8, num_experts=15, device='cpu')


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, port model, JAX state) of moe_tiny, made once."""
    with _numpy_init(0):
        jm = JaxMoE(jax_tiny())
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = MoEForCausalLM(moe_tiny(), device='cpu')
    io.load_jax_state(tm, state)
    return jm, tm, state


def _ids(seed, B, S=6, V=256):
    return _rng(seed).integers(3, V, (B, S)).astype(np.int32)


def test_uncached_logits_and_aux_equal_jax():
    """The dense dispatch ('auto' at 4 experts); the dropless uncached
    forward is held in test_mixtral_converter_equal_jax."""
    jm, tm, _ = _models()
    ids = _ids(1, 2, 12)
    want, waux = jax.jit(lambda m, x: m(x))(jm, jnp.asarray(ids))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_state_round_trips():
    jm, tm, state = _models()
    names = set(io.jax_state_dict(tm))
    assert names == set(state)
    assert {n for n in names if n.endswith('aux_loss')} == {
        'layers.L0.moe.aux_loss', 'layers.L1.moe.aux_loss'}
    with torch.no_grad():
        tm(torch.from_numpy(_ids(2, 1)))      # the buffers move
    back = MoEForCausalLM(moe_tiny(), device='cpu', seed=5)
    io.load_jax_state(back, io.jax_state_dict(tm))
    for k, v in tm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert float(back.layers[0].moe.aux_loss) > 0
    # the JAX model takes the port's state back
    with _numpy_init(1):
        jm2 = JaxMoE(jax_tiny())
    jm2.set_state_dict({k: jnp.asarray(v)
                        for k, v in io.jax_state_dict(tm).items()})
    for k, v in jm2.state_dict().items():
        np.testing.assert_array_equal(_np(v), io.jax_state_dict(tm)[k])


def _jax_generate(jm, ids, **kw):
    """JAX generate under one jax.jit, the mask a constant."""
    am = kw.pop('attention_mask', None)
    am = None if am is None else jnp.asarray(am)
    return np.asarray(jax.jit(lambda x: jm.generate(
        x, attention_mask=am, **kw))(jnp.asarray(ids)))


# name: (left-padded attention mask and an eos, int8 KV caches); batch 2
GREEDY = {'b2_padded_eos': (True, False), 'b2_kv8': (False, True)}


@functools.lru_cache(maxsize=None)
def _greedy_case(case):
    """(ids (2, 7), generate kwargs, the JAX package's output), once."""
    jm, tm, _ = _models()
    padded, kv8 = GREEDY[case]
    ids = _ids(12, 2, 7)
    kw = dict(max_new_tokens=9, kv_cache_int8=kv8)
    if padded:
        am = np.ones_like(ids)
        am[0, :3] = 0
        ids = ids * am
        kw['attention_mask'] = am
        free = tm.generate(torch.from_numpy(ids), max_new_tokens=9,
                           attention_mask=torch.from_numpy(am))
        kw['eos_token_id'] = int(free[0, 7 + 3])   # the padded row emits it
    return ids, kw, _jax_generate(jm, ids, **dict(kw))


@pytest.mark.parametrize('case', ['b1'] + list(GREEDY))
def test_greedy_generate_token_equal_jax(case):
    """b1 is the padded case's full-length row alone: the JAX package
    holds a row of a left-padded batch equal to its solo run
    (tests/test_model_zoo.py)."""
    _, tm, _ = _models()
    ids, kw, want = _greedy_case('b2_padded_eos' if case == 'b1' else case)
    kw = dict(kw)
    if case == 'b1':
        ids, want = ids[1:], want[1:]
        del kw['attention_mask']
    elif 'attention_mask' in kw:
        kw['attention_mask'] = torch.from_numpy(kw['attention_mask'])
    got = tm.generate(torch.from_numpy(ids), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == 'b2_padded_eos':
        row = got[0, 7:].tolist()
        first = row.index(kw['eos_token_id'])
        assert first < 8 and set(row[first:]) == {kw['eos_token_id']}


def test_decode_engine_bucketed_equal_jax():
    """The full-length 7-token row left-padded to the 16 bucket decodes
    the JAX model's stream of it, its eos included."""
    _, tm, _ = _models()
    ids, kw, want = _greedy_case('b2_padded_eos')
    eng = DecodeEngine(tm, max_new_tokens=kw['max_new_tokens'],
                       eos_token_id=kw['eos_token_id'], buckets=(4, 16))
    got = eng.generate(torch.from_numpy(ids[1:]))
    np.testing.assert_array_equal(got.numpy(), want[1:])
    assert eng.stats()['prefill_forwards'] == 1


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

# tests/test_decode.py's batched speculative MoE model (its own draft)
SPEC_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                num_key_value_heads=2, num_experts=2, num_shared_experts=0,
                top_k=1, max_position_embeddings=64)


@functools.lru_cache(maxsize=None)
def _spec_models(kind):
    """(JAX target, JAX draft, port target, port draft): 'self' is
    SPEC_CFG as its own draft; 'layer' is moe_tiny with a draft of its
    first layer (its embedding, final norm and head)."""
    if kind == 'self':
        with _numpy_init(2):
            jm = JaxMoE(JaxConfig(**SPEC_CFG))
        tm = MoEForCausalLM(MoEConfig(**SPEC_CFG), device='cpu')
        io.load_jax_state(tm, {k: _np(v) for k, v in jm.state_dict().items()})
        return jm, jm, tm, tm
    jm, tm, state = _models()
    dstate = {k: v for k, v in state.items() if '.L1.' not in k}
    with _numpy_init(4):
        jd = JaxMoE(jax_tiny(num_hidden_layers=1))
    jd.set_state_dict({k: jnp.asarray(v) for k, v in dstate.items()})
    td = MoEForCausalLM(moe_tiny(num_hidden_layers=1), device='cpu')
    io.load_jax_state(td, dstate)
    return jm, jd, tm, td


def _row_windows(windows, max_new_tokens):
    """Per row, the accepted counts of the windows it ran while it still
    needed tokens (no eos), from each window's per-row counts."""
    rows = []
    for b in range(len(windows[0])):
        n, mine = 0, []
        for m in windows:
            if n < max_new_tokens:
                mine.append(int(m[b]))
                n += int(m[b]) + 1
        rows.append(mine)
    return rows


def _accepted(windows, max_new_tokens):
    """Accepted proposals over the rows, as the port's loops count them."""
    return sum(map(sum, _row_windows(windows, max_new_tokens)))


def _windows(windows, max_new_tokens):
    """Windows until the last row needs no more tokens."""
    return max(map(len, _row_windows(windows, max_new_tokens)))


MNT, K = 9, 3


@functools.lru_cache(maxsize=None)
def _jax_spec(kind):
    """The JAX package's batched speculative decoding (its
    generate_speculative at batch 2; the loop its DecodeEngine shares)
    with each window's per-row accepted counts recorded: (tokens (2, 5 +
    MNT), the windows' counts)."""
    jm, jd, _, _ = _spec_models(kind)
    ids = jnp.asarray(_ids(32, 2, 5, jm.config.vocab_size))
    seen = []
    window = jengine._spec_window_batched

    def record(*a, **kw):
        out = window(*a, **kw)
        seen.append(np.asarray(out[2]))
        return out

    with mock.patch.object(jengine, '_spec_window_batched', record):
        out = jgen.generate_speculative(jm, jd, ids, max_new_tokens=MNT,
                                        num_draft_tokens=K)
    return np.asarray(out), seen


@pytest.mark.parametrize('kind', ['self', 'layer'])
@pytest.mark.parametrize('B', [1, 2])
def test_speculative_equal_jax_with_equal_accepts(kind, B):
    """Batch 2 against the JAX run; batch 1 (the port's one-read-a-window
    loop) against its first row, which the JAX package holds equal to a
    solo run (tests/test_decode.py)."""
    want, seen = _jax_spec(kind)
    want, seen = want[:B], [m[:B] for m in seen]
    _, _, tm, td = _spec_models(kind)
    ids = torch.from_numpy(want[:, :5])
    got = tgen.generate_speculative(tm, td, ids, max_new_tokens=MNT,
                                    num_draft_tokens=K)
    np.testing.assert_array_equal(got.numpy(), want)
    eng = DecodeEngine(tm, max_new_tokens=MNT)
    np.testing.assert_array_equal(
        eng.generate_speculative(td, ids, num_draft_tokens=K).numpy(), want)
    s = eng.stats()['spec']
    assert s['accepted'] == _accepted(seen, MNT)
    assert s['windows'] == _windows(seen, MNT)
    if kind == 'self':
        assert s['accept_rate'] == 1.0
    else:
        assert 0 < s['accepted'] < s['proposed']


def test_speculative_sampled_paths():
    _, _, tm, td = _spec_models('layer')
    ids = torch.from_numpy(_ids(40, 1))
    greedy = tm.generate(ids, max_new_tokens=8)
    for seed in range(2):
        assert torch.equal(tgen.generate_speculative_sampled(
            tm, td, ids, max_new_tokens=8, temperature=1.0, top_k=1,
            rng_key=seed), greedy)
    assert torch.equal(tgen.generate_speculative_sampled(
        tm, td, ids, max_new_tokens=8, temperature=0.0), greedy)
    kw = dict(max_new_tokens=10, temperature=0.9, num_draft_tokens=3)
    a = tgen.generate_speculative_sampled(tm, td, ids, rng_key=7, **kw)
    assert torch.equal(a, tgen.generate_speculative_sampled(
        tm, td, ids, rng_key=torch.Generator().manual_seed(7), **kw))
    assert not torch.equal(a, tgen.generate_speculative_sampled(
        tm, td, ids, rng_key=8, **kw))


# ---------------------------------------------------------------------------
# the Mixtral converter and fused_moe
# ---------------------------------------------------------------------------

MIXTRAL = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, num_local_experts=4,
               num_experts_per_tok=2, rms_norm_eps=1e-5, rope_theta=1e6,
               max_position_embeddings=128, router_aux_loss_coef=0.02,
               hidden_act='silu', sliding_window=None,
               tie_word_embeddings=False)


def _mixtral_state(cfg, seed=5):
    """A seeded HF-named Mixtral state dict (numpy, (out, in) Linears)."""
    rng = _rng(seed)
    H, M, V = cfg['hidden_size'], cfg['intermediate_size'], cfg[
        'vocab_size']
    D = H // cfg['num_attention_heads']
    kv = cfg['num_key_value_heads'] * D

    def w(*shape):
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    sd = {'model.embed_tokens.weight': w(V, H), 'lm_head.weight': w(V, H),
          'model.norm.weight': 1 + w(H)}
    for i in range(cfg['num_hidden_layers']):
        p = f'model.layers.{i}.'
        sd.update({p + 'self_attn.q_proj.weight': w(H, H),
                   p + 'self_attn.k_proj.weight': w(kv, H),
                   p + 'self_attn.v_proj.weight': w(kv, H),
                   p + 'self_attn.o_proj.weight': w(H, H),
                   p + 'self_attn.rotary_emb.inv_freq': w(D // 2),
                   p + 'block_sparse_moe.gate.weight': w(
                       cfg['num_local_experts'], H),
                   p + 'input_layernorm.weight': 1 + w(H),
                   p + 'post_attention_layernorm.weight': 1 + w(H)})
        for e in range(cfg['num_local_experts']):
            q = p + f'block_sparse_moe.experts.{e}.'
            sd.update({q + 'w1.weight': w(M, H), q + 'w3.weight': w(M, H),
                       q + 'w2.weight': w(H, M)})
    return sd


@functools.lru_cache(maxsize=None)
def _mixtral_models():
    """(JAX, port) models converted from one seeded Mixtral state, made
    once (nothing trains them in place)."""
    jcfg = jconvert.hf_mixtral_config(MIXTRAL)
    tcfg = tconvert.hf_mixtral_config(MIXTRAL)
    sd = _mixtral_state(MIXTRAL)
    with _numpy_init(5):
        jm = jconvert.from_hf_mixtral(sd, jcfg)
    tm = tconvert.from_hf_mixtral(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg, device='cpu')
    return jm, tm


def test_mixtral_converter_equal_jax():
    jcfg = jconvert.hf_mixtral_config(MIXTRAL)
    tcfg = tconvert.hf_mixtral_config(MIXTRAL)
    assert vars(tcfg) == vars(jcfg)
    assert tcfg.dispatch_mode == 'ragged' and tcfg.num_shared_experts == 0
    sd = _mixtral_state(MIXTRAL)
    jm, tm = _mixtral_models()
    want = {k: _np(v) for k, v in jm.state_dict().items()}
    got = io.jax_state_dict(tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the uncached forward, dropless (dispatch_mode 'ragged')
    ids = _ids(6, 2, 10, 64)
    wl, waux = jax.jit(lambda m, x: m(x))(jm, jnp.asarray(ids))
    with torch.no_grad():
        tl, aux = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tl.numpy(), _np(wl), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    bf = tconvert.from_hf_mixtral(sd, tcfg, dtype='bfloat16', device='cpu')
    assert bf.layers[0].moe.experts.w_down.dtype == torch.bfloat16


def test_mixtral_converted_model_gradients_equal_jax():
    """The converted model trains dropless: its loss (NLL + the
    router's aux loss, aux_loss_weight 0.01) and every parameter's
    gradient against jax.grad of the JAX converted model's loss."""
    jm, tm = _mixtral_models()
    ids = _ids(8, 2, 11, 64)
    value, grads = jax.jit(jautograd.value_and_grad(
        lambda m, x: m.loss(x)))(jm, jnp.asarray(ids))
    want = {io.port_name(k): _np(v) for k, v in grads.state_dict().items()
            if v is not None}
    tm.zero_grad(set_to_none=True)
    loss = tm.loss(torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(value), **TOL)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **TOL)
    tm.zero_grad(set_to_none=True)


def test_mixtral_converter_refusals():
    for bad, match in ((dict(hidden_act='gelu'), 'hidden_act'),
                       (dict(sliding_window=4096), 'sliding_window'),
                       (dict(tie_word_embeddings=True), 'tie_word')):
        with pytest.raises(ValueError, match=match):
            tconvert.hf_mixtral_config(dict(MIXTRAL, **bad))
    sd = _mixtral_state(MIXTRAL)
    sd['model.layers.0.block_sparse_moe.experts.9.w1.weight'] = np.zeros(1)
    with pytest.raises(ValueError, match='unconverted'):
        tconvert.from_hf_mixtral(sd, tconvert.hf_mixtral_config(MIXTRAL),
                                 device='cpu')
    with pytest.raises(NotImplementedError, match='transformers'):
        tconvert.from_hf_mixtral_pretrained('mixtral')


def _fused_moe_inputs(quant, dtype):
    rng = _rng(7)
    B, S, d, dff, E = 2, 5, 16, 24, 4
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    gate = rng.normal(size=(B, S, E)).astype(np.float32)
    w1 = (0.3 * rng.normal(size=(E, d, 2 * dff))).astype(np.float32)
    w2 = (0.3 * rng.normal(size=(E, dff, d))).astype(np.float32)
    kw = dict(ffn2_bias=(0.1 * rng.normal(size=(E, d))).astype(np.float32),
              moe_topk=2)
    if quant:
        s1 = np.abs(w1).max(1) / 127.0
        s2 = np.abs(w2).max(1) / 127.0
        w1 = np.round(w1 / s1[:, None]).astype(np.int8)
        w2 = np.round(w2 / s2[:, None]).astype(np.int8)
        kw.update(ffn1_scale=s1.astype(np.float32),
                  ffn2_scale=s2.astype(np.float32),
                  quant_method='weight_only_int8')
    return x, gate, w1, w2, kw


@pytest.mark.parametrize('quant,dtype', [(False, 'float32'),
                                         (True, 'float32'),
                                         (False, 'bfloat16')])
def test_fused_moe_equal_jax(quant, dtype):
    x, gate, w1, w2, kw = _fused_moe_inputs(quant, dtype)
    jx = jnp.asarray(x).astype(dtype)
    want = jax.jit(lambda a: jinc.fused_moe(a, gate, w1, w2, **kw))(jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = tinc.fused_moe(tx, torch.from_numpy(gate), torch.from_numpy(w1),
                         torch.from_numpy(w2), **tkw)
    assert got.dtype == tx.dtype
    # bf16: the expert products round to bf16 in both, in another order
    tol = TOL if dtype == 'float32' else dict(rtol=2 ** -6, atol=2 ** -6)
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want.astype(jnp.float32)), **tol)


def test_fused_moe_refusals():
    x, gate, w1, w2, _ = _fused_moe_inputs(False, 'float32')
    args = [torch.from_numpy(a) for a in (x, gate, w1, w2)]
    with pytest.raises(NotImplementedError, match='quant_method'):
        tinc.fused_moe(*args, quant_method='w4a8')
    with pytest.raises(ValueError, match='ffn1_scale'):
        tinc.fused_moe(*args, quant_method='weight_only_int8')
    with pytest.raises(NotImplementedError, match='ffn1_bias'):
        tinc.fused_moe(*args, ffn1_bias=torch.zeros(4, 48))


# ---------------------------------------------------------------------------
# parity refusals
# ---------------------------------------------------------------------------

def test_parity_refusals():
    _, tm, _ = _models()
    if not torch.cuda.is_available():
        # entry points run on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match='no CUDA device'):
            MoEForCausalLM(moe_tiny())
    with pytest.raises(NotImplementedError, match='block_tables'):
        ServingEngine(tm)
    llama = LlamaForCausalLM(llama_tiny(), device='cpu')
    with pytest.raises(NotImplementedError, match='block_tables.*draft'):
        ServingEngine(llama, draft=tm)
    for quantize in (tm.quantize_weights, functools.partial(
            quantize_matmul_weights, tm, min_features=1)):
        with pytest.raises(NotImplementedError,
                           match='QuantizedExpertWeight.*B4'):
            quantize()
    assert tm.layers[0].moe.experts.w_up.dtype == torch.float32
