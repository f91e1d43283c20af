"""The port's int8-KV serving path against the JAX package's, on the same
weights and inputs.

- `quantize_kv_row` / `dequantize_kv_row`: codes and scales bit-equal to
  the JAX package's (the JAX side runs eagerly: under `jax.jit` XLA may
  turn the division by 127 into a multiplication and move a scale by one
  ulp).
- The plain version of K8q (the int8 modes of the paged-attention
  kernel, per-row and per-(kv head, dim) scales, MHA and GQA) against
  the Pallas `paged_decode_attention` in interpret mode, float32, one
  `jax.jit` per case.
- `ServingEngine(kv_cache_dtype='int8')` on a tiny GQA Llama: greedy
  streams token-equal to the JAX int8 engine, with a pool tight enough
  to preempt, and equal to the port's own uninterrupted int8 streams.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.generation import (
    dequantize_kv_row as jax_dequantize_kv_row)
from paddle_tpu.models.generation import (
    quantize_kv_row as jax_quantize_kv_row)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged)
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models.generation import (QuantPagedKVCache,
                                                dequantize_kv_row,
                                                quantize_kv_row)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.ops.hopper import paged_attention as t_paged

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


# float32 on both sides; the two differ only in summation order (the
# tolerance of tests/test_paged_attention.py for the Pallas kernel)
PAGED_TOL = dict(rtol=2e-4, atol=2e-4)
CFG = dict(vocab_size=96, hidden_size=64, layers=2)


@functools.lru_cache(maxsize=None)
def _models():
    pt.seed(0)
    jm = JaxLlama(jax_tiny(**CFG))
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


class TestQuantizeKvRow:
    def test_codes_and_scales_bit_equal(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32)
        x[0, 1] = 0.0                       # an all-zero row: scale 1e-6/127
        x[1, 2, 0, :4] = [127.0, -63.5, 0.5, -0.5]   # half-way codes
        x[1, 2, 0, 4:] = 0.25
        x[2, 3, 1] *= 1e4                    # a wide row
        want_q, want_s = jax_quantize_kv_row(jnp.asarray(x))
        got_q, got_s = quantize_kv_row(torch.from_numpy(x))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        want = jax_dequantize_kv_row(want_q, want_s, jnp.float32)
        got = dequantize_kv_row(got_q, got_s, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # rounding is half to even, as jnp.round: 63.5 -> 64, 0.5 -> 0
        assert got_q[1, 2, 0, :4].tolist() == [127, -64, 0, 0]


def _int8_case(seed, B, Hq, Hkv, D, BS, NB, MAXB, lens, rowscale,
               holes=()):
    """Seeded int8 pools with per-row (NB, Hkv, BS) or per-(head, dim)
    (Hkv, D) scales, shuffled page tables; `holes` are -1 entries."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    kc, vc = (rng.integers(-127, 128, (NB, Hkv, BS, D)).astype(np.int8)
              for _ in range(2))
    sshape = (NB, Hkv, BS) if rowscale else (Hkv, D)
    ks, vs = (rng.uniform(0.002, 0.03, sshape).astype(np.float32)
              for _ in range(2))
    tbl = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB) \
        if NB >= B * MAXB else rng.integers(0, NB, (B, MAXB))
    tbl = tbl.astype(np.int32)
    for r, c in holes:
        tbl[r, c] = -1
    return q, kc, vc, tbl, np.asarray(lens, np.int32), ks, vs


@jax.jit
def _jax_paged_q8(q, kc, vc, tbl, lens, ks, vs):
    return jax_paged(q, kc, vc, tbl, lens, k_scale=ks, v_scale=vs)


class TestPagedInt8Plain:
    @pytest.mark.parametrize('rowscale', [True, False],
                             ids=['row-scales', 'head-dim-scales'])
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
    def test_matches_pallas_kernel(self, case, rowscale):
        q, kc, vc, tbl, lens, ks, vs = _int8_case(**case, rowscale=rowscale)
        want = np.asarray(_jax_paged_q8(q, kc, vc, tbl, lens, ks, vs))
        got = ops.paged_decode_attention(
            *[torch.from_numpy(a) for a in (q, kc, vc, tbl, lens)],
            k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        np.testing.assert_allclose(got.numpy(), want, **PAGED_TOL)
        for b in np.flatnonzero(lens == 0):
            assert not got[b].any(), 'a count-0 row must return zeros'

    def test_scale_layouts_checked(self):
        q, kc, vc, tbl, lens, ks, vs = _int8_case(
            3, 2, 4, 2, 16, 8, 8, 2, [10, 16], rowscale=True)
        t = [torch.from_numpy(a) for a in (q, kc, vc, tbl, lens)]
        with pytest.raises(ValueError, match='need k_scale'):
            ops.paged_decode_attention(*t)
        with pytest.raises(ValueError, match='per row'):
            ops.paged_decode_attention(*t, k_scale=torch.ones(3, 16),
                                       v_scale=torch.ones(3, 16))
        with pytest.raises(TypeError, match='int8 pages'):
            ops.paged_decode_attention(
                t[0], t[1].float(), t[2].float(), t[3], t[4],
                k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        with pytest.raises(ValueError, match='CUDA'):
            t_paged.paged_decode_attention(*t, k_scale=torch.from_numpy(ks),
                                           v_scale=torch.from_numpy(vs))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 96, (n,)).astype(np.int32) for n in lens]


def _drive(engine, prompts):
    rids = [engine.submit(p) for p in prompts]
    engine.run()
    return [np.asarray(engine.result(r)) for r in rids]


KW = dict(max_slots=3, block_size=4, max_new_tokens=12, decode_window=4,
          buckets=(8, 16, 32), kv_cache_dtype='int8')


PROMPTS = _prompts(6, (5, 17, 9, 30, 3, 12))


@pytest.fixture(scope='module')
def int8_runs():
    """Each int8 engine run of this module, made once per module and
    shared by the cases that need it (the preempting case compares with
    the port's run over the full pool): run(kind, num_blocks) ->
    (engine, outputs), kind 'jax' or 'port'."""
    jm, tm = _models()
    memo = {}

    def run(kind, num_blocks):
        if (kind, num_blocks) not in memo:
            kw = dict(KW, num_blocks=num_blocks)
            engine = (JaxEngine(jm, **kw) if kind == 'jax'
                      else ServingEngine(tm, **kw))
            memo[kind, num_blocks] = engine, _drive(engine, PROMPTS)
        return memo[kind, num_blocks]

    return run


@pytest.mark.parametrize('num_blocks', [14, None], ids=['preempt', 'full'])
def test_int8_streams_equal_jax_engine(int8_runs, num_blocks):
    """Token-equal to the JAX int8 engine; with 13 usable 4-token pages
    for 3 slots the pool preempts, and the preempted streams equal the
    port's own uninterrupted ones (a re-prefill rewrites the same int8
    bytes)."""
    je, want = int8_runs('jax', num_blocks)
    te, got = int8_runs('port', num_blocks)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f'request {i}')
    assert te.preemption_count == je.stats()['preemptions']
    assert (te.preemption_count > 0) == (num_blocks is not None)
    assert te.allocator.in_use() == 0
    if num_blocks is not None:
        _, whole = int8_runs('port', None)
        for i, (w, g) in enumerate(zip(whole, got)):
            np.testing.assert_array_equal(g, w, err_msg=f'request {i}')


def test_int8_pools_and_bytes_per_page():
    tm = _models()[1]
    te = ServingEngine(tm, max_slots=2, block_size=4, max_new_tokens=3,
                       max_context_len=32, kv_cache_dtype='int8')
    pc = te._pages[0]
    assert isinstance(pc, QuantPagedKVCache)
    assert pc.kp.dtype == torch.int8 and pc.ks.dtype == torch.float32
    assert tuple(pc.kp.shape[1:]) == (2, 4, 16)
    assert tuple(pc.ks.shape) == tuple(pc.kp.shape[:3])
    # per layer: int8 K and V (Hkv 2 x BS 4 x D 16) plus their float32
    # row scales (2 x 4 each)
    per_layer = 2 * 2 * 4 * 16 + 2 * 2 * 4 * 4
    assert te.allocator.stats()['bytes_per_page'] == 2 * per_layer
    bf = ServingEngine(tm, max_slots=2, block_size=4, max_new_tokens=3,
                       max_context_len=32, kv_cache_dtype='bfloat16')
    assert bf._pages[0].kp.dtype == torch.bfloat16
    with pytest.raises(ValueError, match='kv_cache_dtype'):
        ServingEngine(tm, kv_cache_dtype='float16')
