"""The port's captured decode bodies (`inference/graphs.py`) on the CPU,
where a runner calls its body directly over the same static buffers a
CUDA graph would replay: ServingEngine.warmup and DecodeEngine.warmup
against the JAX package's warm-up contract and streams, and the
runner's buffer handling.

The JAX engines compile once per geometry (~3 s for a serving window,
~2 s for a decode loop on one core), so each runs one small geometry:
a 1-layer GQA Llama (vocab 64, hidden 32, 4 / 2 heads), weights drawn
with numpy (`_numpy_init`: the JAX initializer's eager random ops
compile per shape) and carried into the port.
"""
import contextlib
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.aot import geometry as jgeometry
from paddle_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
from paddle_tpu_torch.inference import graphs
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


CFG = dict(vocab_size=64, hidden_size=32, layers=1, heads=4, kv_heads=2,
           intermediate_size=64, max_pos=64)
# two slots, 4-token pages, windows of 2: each request's budget of 2
# tokens is one window, so the JAX engine compiles one admission step
# (bucket 8) and the port's window graph replays once per admission wave
KW = dict(max_slots=2, block_size=4, max_new_tokens=2, decode_window=2,
          max_context_len=16, buckets=(8,))
REPORT_KEYS = {'geometries', 'seconds', 'traces', 'persistent_cache_dir',
               'costs_loaded'}


@contextlib.contextmanager
def _numpy_init(seed):
    rng = np.random.default_rng(seed)

    def normal(init, shape, dtype):
        return jnp.asarray((rng.normal(size=shape) * init.std
                            + init.mean).astype(np.dtype(dtype)))

    with mock.patch.object(jinit.Normal, '__call__', normal):
        yield


@functools.lru_cache(maxsize=None)
def _models():
    with _numpy_init(0):
        jm = JaxLlama(jax_tiny(**CFG))
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(lens=(5, 7, 3, 6)):
    rng = np.random.default_rng(len(lens))
    return [rng.integers(3, 64, n).astype(np.int32) for n in lens]


def test_warmup_report_and_the_geometries_the_config_implies():
    jm, tm = _models()
    eng = ServingEngine(tm, **KW)
    # the JAX package enumerates one serve_window for this config beside
    # its admission steps (which the port runs eagerly)
    jwin = [g for g in jgeometry.for_serving_engine(JaxEngine(jm, **KW))
            if g.kind == 'serve_window']
    assert [g.to_dict() for g in eng.geometries()] == \
        [g.to_dict() for g in jwin]
    report = eng.warmup()
    assert set(report) == REPORT_KEYS
    assert report['geometries'] == 1
    assert report['traces'] == 2           # greedy and sampled windows
    assert eng.warmup(geometries=jwin)['traces'] == 0   # kept
    assert eng.stats()['graphs']['captures'] == 2
    # a speculative engine's plain windows carry the verify's token
    spec = ServingEngine(tm, draft=tm, num_draft_tokens=2, **KW)
    assert spec.warmup(geometries=[{'kind': 'serve_window', 'window': 2}])[
        'traces'] == 2
    assert {k[2] for k in spec._graphs.entries} == {True}
    with pytest.raises(ValueError, match='decode_window'):
        eng.warmup(geometries=[graphs.Geometry('serve_window', window=3)])
    with pytest.raises(NotImplementedError, match='A9b'):
        eng.warmup(geometries=[graphs.Geometry('serve_step', window=2,
                                               bucket=8)])


def test_warmup_refuses_artifacts_and_requests_in_flight():
    _, tm = _models()
    eng = ServingEngine(tm, **dict(KW, max_new_tokens=6))
    with pytest.raises(NotImplementedError, match='persisted'):
        eng.warmup(artifact='/nonexistent')
    eng.submit(_prompts()[0])
    eng.step()
    with pytest.raises(RuntimeError, match='in flight'):
        eng.warmup()
    eng.run()
    assert eng.warmup()['traces'] == 1      # the sampled window
    dec = DecodeEngine(tm, max_new_tokens=3)
    with pytest.raises(NotImplementedError, match='persisted'):
        dec.warmup(artifact='/nonexistent')
    with pytest.raises(ValueError, match='geometries'):
        dec.warmup()
    with pytest.raises(NotImplementedError, match='A9b'):
        dec.warmup(geometries=[dict(kind='decode_spec', batch=1,
                                    prompt_len=4, max_new_tokens=3,
                                    num_draft_tokens=2)])


def test_streams_after_warmup_equal_the_jax_engine():
    """Greedy streams after warmup() equal the JAX engine's (and its
    warm-up leaves nothing behind: admission waves replay the warmed
    window over new rows). Sampled streams are the port's own hash, so
    they are held to an engine that never warmed, in another batch
    order."""
    jm, tm = _models()
    prompts = _prompts()
    want = JaxEngine(jm, **KW).serve(prompts)
    eng = ServingEngine(tm, **KW)
    eng.warmup()
    got = eng.serve(prompts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert eng.stats()['graphs']['captures'] == 2
    assert eng.allocator.in_use() == 0

    def sampled(warm, order):
        e = ServingEngine(tm, **dict(KW, max_new_tokens=5))
        if warm:
            e.warmup()
        rids = {i: e.submit(prompts[i], temperature=0.9, top_k=20,
                            seed=7 + i) for i in order}
        e.run()
        return [e.result(rids[i]) for i in range(len(prompts))]

    a = sampled(True, range(4))
    b = sampled(False, (3, 1, 2, 0))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    greedy = ServingEngine(tm, **dict(KW, max_new_tokens=5)).serve(prompts)
    assert any(not np.array_equal(x, y) for x, y in zip(a, greedy))


def test_runner_buffers_pools_and_kept_logits():
    _, tm = _models()
    # the runner: static inputs copied in, outputs of the body, state
    # tensors held by address
    runner = graphs.GraphRunner('cpu')
    state = torch.zeros(3)
    static = dict(x=torch.zeros(3))

    def body():
        state.add_(static['x'])
        return static['x'] * 2

    g = runner.capture('k', body, static, [state])
    g.load(x=np.arange(3, dtype=np.float32))
    assert torch.equal(g.run(), torch.tensor([0., 2., 4.]))
    g.load(x=torch.ones(3))
    assert torch.equal(g.run(2), torch.tensor([2., 2., 2.]))
    assert torch.equal(state, torch.tensor([2., 3., 4.]))
    g.check_state([state])
    with pytest.raises(RuntimeError, match='not the ones'):
        g.check_state([state.clone()])
    assert runner.get('k') is g and runner.get('other') is None
    g2 = runner.capture('k2', body, static, [state])
    runner.drop(lambda key: key == 'k')
    assert runner.get('k') is None and runner.get('k2') is g2
    # a weight replaced after the capture drops the runner's graphs
    lin = torch.nn.Linear(2, 2)
    runner = graphs.GraphRunner('cpu', modules=[lin])
    g = runner.capture('k', body, static, [state])
    lin.weight.data.mul_(2)                          # in place: kept
    assert runner.get('k') is g
    lin.weight = torch.nn.Parameter(lin.weight.detach().clone())
    assert runner.get('k') is None
    runner.capture('k', body, static, [state])
    lin.register_buffer('extra', torch.zeros(1))
    assert runner.get('k') is None

    # the engine: pools and the carried logits are its own tensors
    eng = ServingEngine(tm, **dict(KW, max_new_tokens=6))
    pools = [t.data_ptr() for pc in eng._pages for t in pc]
    logits_ptr = eng._last_logits.data_ptr()
    eng.submit(_prompts()[1])
    eng.step()
    graph = eng._window_graph(False)
    assert [t.data_ptr() for pc in eng._pages for t in pc] == pools
    assert eng._last_logits.data_ptr() == logits_ptr
    assert eng._last_logits.data_ptr() != graph.outputs[1].data_ptr()
    kept = eng._last_logits.clone()
    live = np.array([True, False])
    graph.load(**dict(eng._window_inputs(live, False),
                      ctx=np.array([3, 0], np.int32)))
    graph.run()
    assert torch.equal(eng._last_logits, kept)
    assert not torch.equal(graph.outputs[1], kept)
    eng._pages = tm.init_paged_cache(eng.allocator.num_blocks,
                                     eng.block_size)
    with pytest.raises(RuntimeError, match='not the ones'):
        eng.step()


def test_decode_engine_warmup_equals_the_jax_decode_engine():
    jm, tm = _models()
    ids = np.stack([_prompts()[1][:6], _prompts()[3]])
    want = np.asarray(JaxDecodeEngine(jm, max_new_tokens=4,
                                      buckets=(8,)).generate(
        jnp.asarray(ids)))
    eng = DecodeEngine(tm, max_new_tokens=4, buckets=(8,))
    geos = graphs.for_decode_engine(eng, [6], batch_sizes=(2,))
    assert [g.to_dict() for g in geos] == [
        g.to_dict() for g in jgeometry.for_decode_engine(
            JaxDecodeEngine(jm, max_new_tokens=4, buckets=(8,)), [6],
            batch_sizes=(2,))]
    report = eng.warmup(geometries=geos)
    assert set(report) == REPORT_KEYS and report['traces'] == 1
    assert eng.stats()['decode_forwards'] == 0
    runner = tgen._decode_graphs(eng, tm).runner
    n = runner.captures
    got = eng.generate(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert runner.captures == n                  # the warmed geometry
    assert eng.stats()['decode_forwards'] == 3


def test_generate_keeps_one_geometry_and_releases_it():
    """A model's generate keeps the buffers of the last geometry it
    decoded, shared by its sampling variants; a DecodeEngine keeps its
    warmed geometries beside that one; `release_graphs` / `release` free
    them; a replaced weight captures anew."""
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
    tm.load_state_dict(_models()[1].state_dict())
    ids = torch.from_numpy(np.stack([_prompts()[1][:6], _prompts()[3]]))
    store = tgen._decode_graphs(tm, tm)
    greedy = tm.generate(ids, max_new_tokens=3)
    tm.generate(ids, max_new_tokens=3, temperature=0.8, top_k=5)
    assert len(store.buffers) == 1 and len(store.runner.entries) == 2
    caches = store.buffers[next(iter(store.buffers))]['caches']
    tm.generate(ids[:1], max_new_tokens=3)           # another geometry
    assert len(store.buffers) == 1 and len(store.runner.entries) == 1
    assert store.buffers[next(iter(store.buffers))]['caches'] is not caches
    tm.lm_head = torch.nn.Parameter(tm.lm_head.detach().clone())
    n = store.runner.captures
    assert torch.equal(tm.generate(ids, max_new_tokens=3), greedy)
    assert store.runner.captures == n + 1
    tm.release_graphs()
    assert not store.buffers and not store.runner.entries
    assert tgen._decode_graphs(tm, tm) is not store

    eng = DecodeEngine(tm, max_new_tokens=3, buckets=(8,))
    eng.warmup(geometries=graphs.for_decode_engine(eng, [6],
                                                   batch_sizes=(2,)))
    est = tgen._decode_graphs(eng, tm)
    eng.generate(ids[:1])
    eng.generate(ids[:1, :3])
    eng.generate(torch.cat([ids, ids]))
    assert len(est.buffers) == 2 and len(est.pinned) == 1
    assert [g[0] for g in est.buffers] == [2, 4]
    eng.release()
    assert not est.buffers and not est.pinned
