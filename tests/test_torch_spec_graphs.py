"""The port's captured speculative windows on the CPU, where a runner
calls its body directly over the same static buffers a CUDA graph would
replay (`inference/graphs.py`):

- `ServingEngine.geometries()` and `graphs.for_decode_engine(...,
  spec_draft_tokens=)` equal to the JAX package's enumeration
  (`paddle_tpu.aot.geometry`) for the same configuration; nothing is
  compiled;
- `warmup` of both engines: report keys, capture counts greedy and
  sampled, the kinds that stay eager refused, `decode_spec` with and
  without `draft=`;
- greedy and sampled serving streams through the graph route equal to
  an engine whose speculative windows run `_spec_window` directly, over
  bf16 and int8 pools, and one window's outputs and pools bit-equal to
  the direct body's on cloned state;
- the sampled batch-1 stream of `generate_speculative_sampled` equal to
  its window run directly from the same generator, which it leaves where
  the direct loop does;
- a replaced draft weight dropping the speculative graphs.

The JAX-equality tests of greedy speculation (`test_torch_speculative.py`)
run through the same route. Tiny float32 Llamas (vocab 64, hidden 32);
equalities are exact.
"""
import functools

import numpy as np
import pytest
import torch

from paddle_tpu.aot import geometry as jgeometry
from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
from paddle_tpu_torch.inference import graphs
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


V = 64
CFG = dict(vocab_size=V, hidden_size=32, layers=2, heads=4, kv_heads=2,
           intermediate_size=64, max_pos=64)
K = 2
# three slots, 4-token pages, windows of 2; buckets 8 / 16 / 32 (and the
# next power of two past them) give a four-step ctx ladder
KW = dict(max_slots=3, block_size=4, max_new_tokens=6, decode_window=2,
          max_context_len=32, buckets=(8, 16, 32), num_draft_tokens=K)
REPORT_KEYS = {'geometries', 'seconds', 'traces', 'persistent_cache_dir',
               'costs_loaded'}
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95)


@functools.lru_cache(maxsize=None)
def _models():
    """(target, draft): the draft is the target's first layer under its
    embedding, final norm and head."""
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu', seed=0)
    td = LlamaForCausalLM(llama_tiny(**dict(CFG, layers=1)), device='cpu',
                          seed=1)
    td.load_state_dict({k: v for k, v in tm.state_dict().items()
                        if '.layers.1.' not in k})
    return tm, td


def _prompts(lens=(5, 9, 3, 7)):
    rng = np.random.default_rng(len(lens))
    return [rng.integers(3, V, n).astype(np.int32) for n in lens]


def _dicts(geos, kind):
    return [g.to_dict() for g in geos if g.kind == kind]


@pytest.mark.parametrize('extra,lens,mnt', [
    ({}, None, None),
    (dict(prefix_cache=True), [5, 9], None),
    (dict(prefill_chunk=8, buckets=(16, 32)), [3, 20], [4, 6])])
def test_geometries_equal_the_jax_enumeration(extra, lens, mnt):
    tm, td = _models()
    eng = ServingEngine(tm, draft=td, **dict(KW, **extra))
    got = eng.geometries(prompt_lens=lens, max_new_tokens=mnt)
    # the JAX package's enumeration reads the same configuration
    # attributes off the engine; of its kinds the port captures the
    # speculative window (the fused admission steps run eagerly)
    want = jgeometry.for_serving_engine(eng, prompt_lens=lens,
                                        max_new_tokens=mnt)
    assert _dicts(got, 'serve_spec_window') == \
        _dicts(want, 'serve_spec_window')
    assert len(_dicts(got, 'serve_spec_window')) >= 2
    # the plain window a speculative engine's chunk steps run
    assert _dicts(got, 'serve_window') == (
        [{'kind': 'serve_window', 'window': 2}] if extra else [])
    assert [g.to_dict() for g in ServingEngine(tm, **dict(
        KW, num_draft_tokens=4)).geometries()] == [
        {'kind': 'serve_window', 'window': 2}]
    dec = DecodeEngine(tm, max_new_tokens=5, buckets=(8, 16))
    for kw in (dict(spec_draft_tokens=[2, 3]),
               dict(spec_draft_tokens=[2], spec_batch_sizes=(1, 3),
                    batch_sizes=(2,), max_new_tokens=[4, 7])):
        assert [g.to_dict() for g in graphs.for_decode_engine(
            dec, [5, 8, 6], **kw)] == [
            g.to_dict() for g in jgeometry.for_decode_engine(
                dec, [5, 8, 6], **kw)]


def test_warmup_captures_the_speculative_geometries():
    tm, td = _models()
    eng = ServingEngine(tm, draft=td, **KW)
    geos = eng.geometries()
    report = eng.warmup()
    assert set(report) == REPORT_KEYS
    assert report['geometries'] == len(geos) == 4
    assert report['traces'] == 8               # each greedy and sampled
    assert sorted(eng._graphs.entries) == sorted(
        ('serve_spec_window', K, c, s) for c in (8, 16, 32, 64)
        for s in (False, True))
    assert eng.warmup()['traces'] == 0          # kept
    assert len(eng.stats()['graphs']['reserved_bytes']) == 8
    with pytest.raises(ValueError, match='num_draft_tokens'):
        eng.warmup(geometries=[graphs.Geometry('serve_spec_window', spec=3,
                                               ctx=8)])
    with pytest.raises(ValueError, match='speculative engine'):
        ServingEngine(tm, **KW).warmup(
            geometries=[dict(kind='serve_spec_window', spec=K, ctx=8)])
    for kind, params in (('serve_step', dict(window=2, bucket=8)),
                         ('serve_prefill', dict(bucket=8)),
                         ('serve_chunk_step', dict(window=2, chunk=8,
                                                   bucket=16)),
                         ('serve_spec_step', dict(spec=K, bucket=8,
                                                  ctx=16))):
        with pytest.raises(NotImplementedError, match='A9b'):
            eng.warmup(geometries=[graphs.Geometry(kind, **params)])

    dec = DecodeEngine(tm, max_new_tokens=5, buckets=(8,))
    geos = graphs.for_decode_engine(dec, [6], batch_sizes=(2,),
                                    spec_draft_tokens=[K],
                                    spec_batch_sizes=(1, 2))
    with pytest.raises(ValueError, match='draft'):
        dec.warmup(geometries=geos)
    report = dec.warmup(geometries=geos, draft=td)
    assert set(report) == REPORT_KEYS
    assert (report['geometries'], report['traces']) == (3, 3)
    assert dec.stats()['decode_forwards'] == 0
    store = tgen._decode_graphs(dec, tm)
    assert len(store.pinned) == 3
    n = store.captures()
    ids = torch.from_numpy(np.stack(_prompts((6, 6)))).long()
    dec.generate_speculative(td, ids, num_draft_tokens=K)
    dec.generate_speculative(td, ids[:1], num_draft_tokens=K)
    assert store.captures() == n                 # the warmed windows
    dec.release()
    assert not store.buffers and not store.spec_runners


class _DirectSpec(ServingEngine):
    """The eager reference: each speculative window runs `_spec_window`
    directly on the engine's own pools over fresh tensors of its inputs
    (no captured buffers)."""

    def _spec_graph(self, ctx_bucket, sampled):
        eng = self

        class Direct:
            def check_state(self, state):
                pass

            def load(self, **inputs):
                self.t = {k: torch.as_tensor(v).clone()
                          for k, v in inputs.items()}

            def run(self):
                t = self.t
                return tserving._spec_window(
                    eng.model, eng.draft, eng._pages, eng._dpages,
                    t['last_logits'], t['forced_tok'], t['forced'],
                    t['btab'], t['ctx'], t['live'], t['budget'],
                    k=eng.spec_window, ctx_bucket=ctx_bucket,
                    eos_token_id=eng.eos_token_id,
                    sampling=(tuple(t[k] for k in ('temp', 'topk', 'topp',
                                                   'seed', 'plen'))
                              if sampled else None))

        return Direct()


def _serve(engine, jobs):
    """Two requests, one step, then the rest (admitted while they
    decode); outputs in submission order."""
    rids = [engine.submit(p, **kw) for p, kw in jobs[:2]]
    engine.step()
    rids += [engine.submit(p, **kw) for p, kw in jobs[2:]]
    engine.run()
    return [np.asarray(engine.result(r)) for r in rids]


@pytest.mark.parametrize('kv', ['bfloat16', 'int8'])
def test_serving_streams_through_the_graph_route_equal_the_direct_window(kv):
    tm, td = _models()
    prompts = _prompts()
    jobs = [(p, dict(SAMPLED, seed=i) if i % 2 else {})
            for i, p in enumerate(prompts)]
    kw = dict(KW, kv_cache_dtype=kv, eos_token_id=None)
    eng = ServingEngine(tm, draft=td, **kw)
    eng.warmup()
    got = _serve(eng, jobs)
    ref = _DirectSpec(tm, draft=td, **kw)
    want = _serve(ref, jobs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sg, sw = eng.stats()['spec'], ref.stats()['spec']
    assert sg == sw and 0 < sg['accepted'] < sg['proposed']
    assert eng.stats()['graphs']['captures'] == 8      # all warmed

    # one window mid-serving: the route's outputs and both pools equal
    # the direct body's on cloned state, bit for bit
    eng = ServingEngine(tm, draft=td, **kw)
    for p, s in jobs[:3]:
        eng.submit(p, **s)
    eng.step()
    eng._ensure_window_pages()
    live = np.ones(3, bool)
    for sampled in (False, True):
        inputs = eng._window_inputs(live, sampled, True)
        t = {k: torch.as_tensor(v).clone() for k, v in inputs.items()}
        pages = [type(pc)(*(f.clone() for f in pc))
                 for pc in eng._pages + eng._dpages]
        L = len(eng._pages)
        want = tserving._spec_window(
            tm, td, pages[:L], pages[L:], t['last_logits'], t['forced_tok'],
            t['forced'], t['btab'], t['ctx'], t['live'], t['budget'], k=K,
            ctx_bucket=16, eos_token_id=None,
            sampling=(tuple(t[k] for k in ('temp', 'topk', 'topp', 'seed',
                                           'plen')) if sampled else None))
        graph = eng._spec_graph(16, sampled)
        graph.load(**inputs)
        for a, b in zip(graph.run(), want):
            assert torch.equal(a, b)
        for pa, pb in zip(eng._pages + eng._dpages, pages):
            for a, b in zip(pa, pb):
                assert torch.equal(a, b)
        graph.check_state(tserving._pool_tensors(eng._pages + eng._dpages))
        with pytest.raises(RuntimeError, match='not the ones'):
            graph.check_state(tserving._pool_tensors(eng._pages + pages[L:]))


@torch.no_grad()
def _direct_sampled(tm, td, ids, n, k, cfg, gen):
    """generate_speculative_sampled's loop with `_sampled_window` called
    directly on fresh caches, drawing from `gen` itself."""
    S = ids.shape[1]
    caches = tm.init_cache(1, S + n + k + 1)
    dcaches = td.init_cache(1, S + n + k + 1)
    p_last = tgen._sampled_prefill(tm, caches, ids, cfg)
    tgen._sampled_prefill(td, dcaches, ids, cfg)
    c_host = int(torch.multinomial(p_last, 1, generator=gen))
    coins = torch.Generator().manual_seed(int(torch.randint(
        0, 2 ** 31 - 1, (1,), generator=gen)))
    out, L = [], S
    while len(out) < n:
        d, pd, pt = tgen._sampled_window(
            tm, td, caches, dcaches, torch.tensor([[c_host]]),
            torch.tensor([L]), gen, k, cfg)
        acc, nxt = tgen._sampled_commit(d, pt.double(), pd.double(), k,
                                        coins)
        out += [c_host] + acc
        c_host, L = nxt, L + 1 + len(acc)
    return out[:n]


def test_sampled_b1_stream_equals_the_direct_window():
    tm, td = _models()
    ids = torch.from_numpy(_prompts((7,))[0][None]).long()
    cfg = dict(SAMPLED)
    gen = torch.Generator().manual_seed(5)
    want = _direct_sampled(tm, td, ids, 10, 3, cfg, gen)
    kw = dict(max_new_tokens=10, num_draft_tokens=3, **cfg)
    store = tgen._decode_graphs(tm, tm)
    got = tgen.generate_speculative_sampled(tm, td, ids, rng_key=5, **kw)
    assert got[0, 7:].tolist() == want
    n = store.captures()
    # replayed, not captured again; the caller's generator ends where
    # the direct loop leaves it
    caller = torch.Generator().manual_seed(5)
    got = tgen.generate_speculative_sampled(tm, td, ids, rng_key=caller,
                                            **kw)
    assert got[0, 7:].tolist() == want and store.captures() == n
    assert torch.equal(caller.get_state(), gen.get_state())
    tm.release_graphs()


def test_a_replaced_draft_weight_drops_the_speculative_graphs():
    tm, _ = _models()
    td = LlamaForCausalLM(llama_tiny(**dict(CFG, layers=1)), device='cpu')
    td.load_state_dict(_models()[1].state_dict())
    eng = ServingEngine(tm, draft=td, **KW)
    eng.warmup()
    n = eng._graphs.captures
    key = ('serve_spec_window', K, 8, False)
    assert eng._graphs.get(key) is not None
    ids = torch.from_numpy(np.stack(_prompts((6, 6)))).long()
    dec = DecodeEngine(tm, max_new_tokens=5, buckets=(8,))
    dec.warmup(geometries=graphs.for_decode_engine(
        dec, [6], batch_sizes=(2,), spec_draft_tokens=[K],
        spec_batch_sizes=(2,)), draft=td)
    store = tgen._decode_graphs(dec, tm)
    m = store.captures()
    first = dec.generate_speculative(td, ids, num_draft_tokens=K)
    dec.generate(ids)
    assert store.captures() == m
    td.lm_head = torch.nn.Parameter(td.lm_head.detach().flip(1).clone())
    assert eng._graphs.get(key) is None and not eng._graphs.entries
    eng.serve(_prompts()[:2])
    assert eng._graphs.captures > n
    got = dec.generate_speculative(td, ids, num_draft_tokens=K)
    assert store.captures() == m + 1
    # lossless whatever the draft: the target's own tokens
    assert torch.equal(got, first)
    # the decode step's graph watches the target alone: kept
    dec.generate(ids)
    assert store.captures() == m + 1
