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
from paddle_tpu_torch.inference import serving as tserving
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
    # the JAX package's enumeration for this config: an admission step
    # per bucket (8 and 16), the window, a standalone prefill per bucket
    jall = jgeometry.for_serving_engine(JaxEngine(jm, **KW))
    assert [g.to_dict() for g in eng.geometries()] == \
        [g.to_dict() for g in jall]
    jwin = [g for g in jall if g.kind == 'serve_window']
    report = eng.warmup()
    assert set(report) == REPORT_KEYS
    assert report['geometries'] == 5
    # the prefill of each bucket at 1 and 2 rows, the greedy and the
    # sampled window
    assert report['traces'] == 6
    assert eng.warmup(geometries=jwin)['traces'] == 0   # kept
    assert eng.stats()['graphs']['captures'] == 6
    assert sorted(eng.stats()['graphs']['keys']) == sorted(map(str, [
        ('serve_prefill', b, r, 'target') for b in (8, 16) for r in (1, 2)]
        + [('serve_window', False, False), ('serve_window', True, False)]))
    # a speculative engine's plain windows carry the verify's token
    spec = ServingEngine(tm, draft=tm, num_draft_tokens=2, **KW)
    assert spec.warmup(geometries=[{'kind': 'serve_window', 'window': 2}])[
        'traces'] == 2
    assert {k[2] for k in spec._graphs.entries} == {True}
    with pytest.raises(ValueError, match='decode_window'):
        eng.warmup(geometries=[graphs.Geometry('serve_window', window=3)])
    # an admission step captures the prefill of its bucket and the window
    fresh = ServingEngine(tm, **KW)
    assert fresh.warmup(geometries=[graphs.Geometry(
        'serve_step', window=2, bucket=8)])['traces'] == 4
    with pytest.raises(NotImplementedError, match='migration'):
        eng.warmup(geometries=[graphs.Geometry('serve_export', ctx=8)])
    with pytest.raises(ValueError, match='unknown'):
        eng.warmup(geometries=[dict(kind='decode', batch=1, prompt_len=4,
                                    max_new_tokens=2)])


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
    # the sampled window, the bucket-8 prefill at 2 rows and the
    # bucket-16 ones: the run captured the rest
    assert eng.warmup()['traces'] == 4
    dec = DecodeEngine(tm, max_new_tokens=3)
    with pytest.raises(NotImplementedError, match='persisted'):
        dec.warmup(artifact='/nonexistent')
    with pytest.raises(ValueError, match='geometries'):
        dec.warmup()
    # decode_spec needs the draft, as in the JAX engine; with it the
    # speculative window is captured
    spec = [dict(kind='decode_spec', batch=1, prompt_len=4,
                 max_new_tokens=3, num_draft_tokens=2)]
    with pytest.raises(ValueError, match='draft'):
        dec.warmup(geometries=spec)
    assert dec.warmup(geometries=spec, draft=tm)['traces'] == 1
    assert dec.stats()['verify_forwards'] == 0


@pytest.fixture(scope='module')
def jax_streams():
    """The JAX engine's greedy streams of `_prompts()` under KW."""
    jm, _ = _models()
    return [np.asarray(w) for w in JaxEngine(jm, **KW).serve(_prompts())]


def test_streams_after_warmup_equal_the_jax_engine(jax_streams):
    """Greedy streams after warmup() equal the JAX engine's (and its
    warm-up leaves nothing behind: admission waves replay the warmed
    prefills and window over new rows). Sampled streams are the port's
    own hash, so they are held to an engine that never warmed, in
    another batch order."""
    jm, tm = _models()
    prompts = _prompts()
    want = jax_streams
    eng = ServingEngine(tm, **KW)
    eng.warmup()
    got = eng.serve(prompts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert eng.stats()['graphs']['captures'] == 6      # all warmed
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


# chunked prefill and the prefix cache, 4-token chunks
CHUNKED = dict(KW, prefix_cache=True, prefill_chunk=4)


def test_chunked_prefix_engine_warms_every_kind(jax_streams):
    """A chunked, prefix-caching engine: geometries() equal the JAX
    package's whole enumeration (its chunk steps among them); warmup()
    captures every kind, and the streams then serve without a capture:
    greedy ones equal to the JAX engine's (the chunks of a 1-layer
    model write the monolithic prefill's K/V rows), sampled ones to an
    engine that never warmed."""
    jm, tm = _models()
    eng = ServingEngine(tm, **CHUNKED)
    want = jgeometry.for_serving_engine(JaxEngine(jm, **CHUNKED))
    assert [g.to_dict() for g in eng.geometries()] == \
        [g.to_dict() for g in want]
    assert {g.kind for g in want} == {'serve_step', 'serve_window',
                                      'serve_prefill', 'serve_chunk_step'}
    report = eng.warmup()
    assert report['geometries'] == len(want)
    n = eng.stats()['graphs']['captures']
    assert any(k.startswith("('serve_chunk'")
               for k in eng.stats()['graphs']['keys'])
    got = eng.serve(_prompts())
    for w, g in zip(jax_streams, got):
        np.testing.assert_array_equal(g, w)
    assert eng.stats()['prefix']['chunk_steps'] > 0
    # a 10-token prompt, then one sharing its first two pages: a hit
    # that shrinks the prefill
    base = np.random.default_rng(5).integers(3, 64, 10).astype(np.int32)
    prompts = [base] + _prompts() + [np.concatenate([base[:8], [9, 9, 9]])]
    jobs = dict(temperature=0.9, top_k=20, seed=3)

    def sampled(e):
        rids = [e.submit(p, **jobs) for p in prompts]
        e.run()
        return [e.result(r) for r in rids]

    a = sampled(eng)
    assert eng.stats()['graphs']['captures'] == n
    assert eng.stats()['prefix']['hits'] > 0
    for x, y in zip(a, sampled(ServingEngine(tm, **CHUNKED))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('kv', [None, 'int8'])
def test_captured_bodies_at_max_slots_equal_the_direct_bodies(kv):
    """The captured admission prefill, chunk and draft chunk at
    max_slots rows (a dummy row past the group; a chunk with one
    copy-on-write pair beside a (0, 0) one, and pad columns past its
    ctx bucket) leave the pools (past the scratch page) and the carried
    logits bit-equal to the direct bodies at the group's width."""
    _, tm = _models()
    eng = ServingEngine(tm, **dict(CHUNKED, max_slots=3, kv_cache_dtype=kv,
                                   max_context_len=32, buckets=(8, 16)),
                        draft=tm, num_draft_tokens=2)
    gen = torch.Generator().manual_seed(0)
    for pc in eng._pages + eng._dpages:
        for f in pc:
            f.copy_(torch.randint(-100, 100, f.shape, generator=gen)
                    if f.dtype == torch.int8 else
                    torch.randn(f.shape, generator=gen))
    pools = [[type(pc)(*(f.clone() for f in pc)) for pc in p]
             for p in (eng._pages, eng._dpages)]
    logits = eng._last_logits.clone()
    rng = np.random.default_rng(1)
    S, MAXB = 3, eng.max_blocks_per_seq

    def rows(width, n):
        return dict(ids=np.zeros((S, width), np.int64),
                    btabs=np.zeros((S, MAXB), np.int32),
                    slots=np.full((S,), S, np.int64),
                    **{k: np.zeros((S,), np.int64) for k in n})

    def t(a, n=2):
        return torch.from_numpy(a[:n])

    pre = rows(8, ['real_len'])
    for i, (n, tab, slot) in enumerate(((5, [1, 2], 2), (7, [3, 4], 0))):
        pre['ids'][i, :n] = rng.integers(3, 64, n)
        pre['real_len'][i], pre['slots'][i] = n, slot
        pre['btabs'][i, :2] = tab
    ch = rows(8, ['chunk_len', 'start', 'cow_src', 'cow_dst'])
    for i, (n, st, tab, slot) in enumerate(((6, 5, [1, 2, 6], 1),
                                           (3, 12, [3, 5, 7, 8], S))):
        ch['ids'][i, :n] = rng.integers(3, 64, n)
        ch['chunk_len'][i], ch['start'][i], ch['slots'][i] = n, st, slot
        ch['btabs'][i, :len(tab)] = tab
    ch['cow_src'][1], ch['cow_dst'][1] = 4, 5
    with torch.no_grad():
        last, _ = tserving._prefill_kv(tm, pools[0], t(pre['ids']),
                                       t(pre['real_len']), t(pre['btabs']))
        logits[[2, 0]] = last
        tserving._prefill_kv(tm, pools[1], t(pre['ids']),
                             t(pre['real_len']), t(pre['btabs']))
        last, _ = tserving._chunk_kv(
            tm, pools[0], t(ch['ids']), t(ch['chunk_len']), t(ch['start']),
            t(ch['btabs']), 16, t(ch['cow_src']), t(ch['cow_dst']))
        logits[1] = last[0]
        tserving._chunk_kv(tm, pools[1], t(ch['ids']), t(ch['chunk_len']),
                           t(ch['start']), t(ch['btabs']), 16,
                           t(ch['cow_src']), t(ch['cow_dst']))
    for draft in (False, True):
        eng._replay(eng._prefill_graph(8, S, draft), draft, pre)
        eng._replay(eng._chunk_graph(8, 16, S, draft), draft, ch)
    for got, want in zip((eng._pages, eng._dpages), pools):
        for pa, pb in zip(got, want):
            for a, b in zip(pa, pb):
                assert torch.equal(a[1:], b[1:])
    assert torch.equal(eng._last_logits, logits)


def test_fused_decode_step_replays_equal_jax():
    """fused_multi_transformer_decode_step through its captured step,
    3 steps over float32 caches, against the JAX package's step; one
    geometry kept (other caches capture anew), the full-cache check on
    the host before the replay, release_graphs frees it."""
    import jax

    from paddle_tpu.incubate.nn import functional as JF
    from paddle_tpu_torch.incubate.nn import functional as TF

    L, E, H, F_, B, S, T = 2, 32, 4, 64, 2, 6, 10
    rng = np.random.default_rng(2)

    def n(*shape, std=0.2):
        return (std * rng.normal(size=shape)).astype(np.float32)

    ws = dict(ln_scales=[1 + n(E, std=0.1) for _ in range(L)],
              ln_biases=[n(E, std=0.1) for _ in range(L)],
              qkv_weights=[n(3, H, E // H, E) for _ in range(L)],
              qkv_biases=[n(3 * E, std=0.1) for _ in range(L)],
              linear_weights=[n(E, E) for _ in range(L)],
              linear_biases=[None] * L,
              ffn_ln_scales=[1 + n(E, std=0.1) for _ in range(L)],
              ffn_ln_biases=[None] * L,
              ffn1_weights=[n(E, F_) for _ in range(L)],
              ffn1_biases=[n(F_, std=0.1) for _ in range(L)],
              ffn2_weights=[n(F_, E) for _ in range(L)],
              ffn2_biases=[None] * L)
    caches = [n(2, B, H, T, E // H) for _ in range(L)]
    xs = n(3, B, 1, E, std=1.0)
    kw = dict(norm_type='rmsnorm', activation='silu')
    jw = {k: [None if a is None else jax.numpy.asarray(a) for a in v]
          for k, v in ws.items()}
    tw = {k: [None if a is None else torch.from_numpy(a) for a in v]
          for k, v in ws.items()}
    jc = [jax.numpy.asarray(c) for c in caches]
    tc = [torch.from_numpy(c.copy()) for c in caches]
    TF.release_graphs()
    for i in range(3):
        jx, jc = JF.fused_multi_transformer_decode_step(
            jax.numpy.asarray(xs[i]), **jw, cache_kvs=jc, time_step=S + i,
            **kw)
        tx, tc2 = TF.fused_multi_transformer_decode_step(
            torch.from_numpy(xs[i]), **tw, cache_kvs=tc, time_step=S + i,
            **kw)
        assert all(a is b for a, b in zip(tc2, tc))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    runner = TF._FMT_RUNNERS[torch.device('cpu')]
    assert runner.captures == 1 and len(runner.entries) == 1
    kept = [c.clone() for c in tc]
    other = [c.clone() for c in tc]
    TF.fused_multi_transformer_decode_step(
        torch.from_numpy(xs[0]), **tw, cache_kvs=other, time_step=S + 3,
        **kw)
    assert runner.captures == 2 and len(runner.entries) == 1
    assert all(torch.equal(a, b) for a, b in zip(tc, kept))
    assert not torch.equal(other[0][:, :, :, S + 3], tc[0][:, :, :, S + 3])
    with pytest.raises(ValueError, match='cache is full'):
        TF.fused_multi_transformer_decode_step(
            torch.from_numpy(xs[0]), **tw, cache_kvs=tc, time_step=T, **kw)
    TF.release_graphs()
    assert not TF._FMT_RUNNERS and not runner.entries


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
