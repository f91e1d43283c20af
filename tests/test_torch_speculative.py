"""Speculative decoding in the port against the JAX package, on the same
weights and inputs (float32, CPU).

- `_commit_window` and `_speculative_accept_dists` equal to the JAX
  package's (the commit exactly, the distributions within 1e-6), and
  the rejection-sampling identity within 1e-6.
- Greedy `generate_speculative` token-equal to the JAX package's (k 1,
  3, 5; a batch of 3 with eos; int8 KV caches at batch 1 and 2; a
  weight-only int8 draft) and to the port's own `generate`;
  `DecodeEngine.generate_speculative` equal to the same JAX runs (the
  JAX engine runs the same loops), with exact forward counts; a
  self-draft accepts every proposal.
- Sampled: the host commit's and the serving window's first token follow
  the target's filtered distribution (4000 draws, every count within 5
  standard deviations, none outside the support); top_k=1 is greedy;
  temperature 0 is the greedy path; a seed reproduces its stream.
- `ServingEngine(draft=, num_draft_tokens=)` over float32 and int8 pools
  with prefix caching, chunked prefill, eos and a preempting pool:
  streams token-equal to the JAX engine's with equal `stats()['spec']`,
  prefix and preemption counts (each JAX run made once per module), and
  to the port's non-speculative engine; a self-draft accepts every
  proposal through every admission path; sampled rows reproducible by
  seed, independent of batch and slot, and equal after preemption.

The draft is the target's first layer under its embedding, final norm
and head, so proposals are accepted in part.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


V = 96
CFG = dict(vocab_size=V, hidden_size=64, layers=2)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX target, JAX draft, port target, port draft)."""
    pt.seed(0)
    jm = JaxLlama(jax_tiny(**CFG))
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    jd = JaxLlama(jax_tiny(**dict(CFG, layers=1)))
    dstate = {k: v for k, v in state.items() if '.L1.' not in k}
    jd.set_state_dict({k: jnp.asarray(v) for k, v in dstate.items()})
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
    td = LlamaForCausalLM(llama_tiny(**dict(CFG, layers=1)), device='cpu')
    io.load_jax_state(tm, state)
    io.load_jax_state(td, dstate)
    return jm, jd, tm, td


def _ids(seed, B, S=6):
    return np.random.default_rng(seed).integers(3, V, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the commit rule and the acceptance identity
# ---------------------------------------------------------------------------

def test_commit_rule_and_accept_dists_equal_jax():
    rng = np.random.default_rng(0)
    k = 4
    for _ in range(50):
        d = rng.integers(0, 3, (k,))          # a small vocabulary: ties
        t = rng.integers(0, 3, (k + 1,))
        c = int(rng.integers(0, 3))
        assert tgen._commit_window(c, d, t, k) == jgen._commit_window(
            c, d, t, k)
    for trial in range(5):
        p_t = rng.dirichlet(np.ones(16) * (0.3 + trial)).astype(np.float32)
        p_d = rng.dirichlet(np.ones(16) * (0.4 + trial % 3)).astype(
            np.float32)
        p_d[trial] = 0.0                      # a token the draft never takes
        p_d /= p_d.sum()
        want = jgen._speculative_accept_dists(jnp.asarray(p_t),
                                              jnp.asarray(p_d))
        got = tgen._speculative_accept_dists(torch.tensor(p_t),
                                             torch.tensor(p_d))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        accept, residual = (g.double().numpy() for g in got)
        out = p_d * accept + (p_d * (1 - accept)).sum() * residual
        np.testing.assert_allclose(out, p_t, atol=1e-6)


# ---------------------------------------------------------------------------
# generate_speculative and DecodeEngine
# ---------------------------------------------------------------------------

# name: (batch, k, max_new_tokens, eos, int8 KV, weight-only int8 draft)
GREEDY = {'k1': (1, 1, 12, False, False, False),
          'k3': (1, 3, 12, False, False, False),
          'k5': (1, 5, 12, False, False, False),
          'batched_eos': (3, 4, 14, True, False, False),
          'int8_kv': (1, 3, 12, False, True, False),
          'int8_kv_batched': (2, 3, 10, False, True, False),
          'int8_draft': (1, 4, 12, False, False, True)}


@functools.lru_cache(maxsize=None)
def _greedy_case(case):
    """(ids, eos id or None, the JAX package's generate_speculative
    output) of a GREEDY case, made once per module."""
    jm, jd, tm, _ = _models()
    B, k, mnt, eos, kv8, qdraft = GREEDY[case]
    ids = _ids(len(case), B)
    eos_id = None
    if eos:
        # a token the stream of row 0 really emits
        eos_id = int(tm.generate(torch.from_numpy(ids).long(),
                                 max_new_tokens=mnt)[0, ids.shape[1] + 4])
    if qdraft:
        jd = jm.quantize_weights(8)
    want = np.asarray(jgen.generate_speculative(
        jm, jd, jnp.asarray(ids), max_new_tokens=mnt, num_draft_tokens=k,
        eos_token_id=eos_id, kv_cache_int8=kv8))
    return ids, eos_id, want


@pytest.mark.parametrize('case', list(GREEDY))
def test_generate_speculative_equal_jax(case):
    _, _, tm, td = _models()
    B, k, mnt, eos, kv8, qdraft = GREEDY[case]
    ids, eos_id, want = _greedy_case(case)
    tids = torch.from_numpy(ids).long()
    if qdraft:
        td = tm.quantize_weights(8)
    got = tgen.generate_speculative(tm, td, tids, max_new_tokens=mnt,
                                    num_draft_tokens=k, eos_token_id=eos_id,
                                    kv_cache_int8=kv8)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tm.generate(tids, max_new_tokens=mnt, eos_token_id=eos_id,
                        kv_cache_int8=kv8)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if eos:
        assert (got[0, ids.shape[1] + 4:] == eos_id).all()


# the JAX engine's generate_speculative runs the same host loops as the
# JAX package's generate_speculative (engine.py `_spec_loop_host_b1` /
# `_spec_loop_host_batched`), so the engine is held to those outputs
@pytest.mark.parametrize('case', ['k3', 'batched_eos'])
def test_decode_engine_speculative_equal_jax(case):
    _, _, tm, td = _models()
    B, k, mnt, eos, _kv8, _q = GREEDY[case]
    ids, eos_id, want = _greedy_case(case)
    eng = DecodeEngine(tm, max_new_tokens=mnt, eos_token_id=eos_id)
    got = eng.generate_speculative(td, torch.from_numpy(ids).long(),
                                   num_draft_tokens=k)
    np.testing.assert_array_equal(got.numpy(), want)
    s = eng.stats()
    w = s['spec']['windows']
    assert 0 < s['spec']['accepted'] < s['spec']['proposed'] <= k * B * w
    assert (s['prefill_forwards'], s['draft_prefill_forwards'],
            s['verify_forwards'], s['draft_decode_forwards'],
            s['decode_forwards']) == (1, 1, w, (k + 1) * w, 0)


def test_self_draft_accepts_every_proposal():
    _, _, tm, _ = _models()
    for B in (1, 2):
        ids = torch.from_numpy(_ids(20 + B, B)).long()
        eng = DecodeEngine(tm, max_new_tokens=12)
        got = eng.generate_speculative(tm, ids, num_draft_tokens=4)
        assert torch.equal(got, tm.generate(ids, max_new_tokens=12))
        assert eng.stats()['spec']['accept_rate'] == 1.0


def test_refusals():
    _, _, tm, td = _models()
    ids = torch.from_numpy(_ids(3, 2)).long()
    with pytest.raises(ValueError, match='multi-token prompt'):
        tgen.generate_speculative(tm, td, ids[:1, :1], kv_cache_int8=True)
    with pytest.raises(ValueError, match='num_draft_tokens'):
        DecodeEngine(tm).generate_speculative(td, ids, num_draft_tokens=0)
    with pytest.raises(NotImplementedError, match='batch-1'):
        tgen.generate_speculative_sampled(tm, td, ids, temperature=1.0)
    with pytest.raises(ValueError, match='one device'):
        tgen.generate_speculative(
            tm, types.SimpleNamespace(device=torch.device('meta')), ids)

    class NoWritePos(torch.nn.Module):
        device = torch.device('cpu')

        def forward(self, input_ids, caches=None, cache_index=None):
            raise AssertionError('refused before any forward')

    with pytest.raises(NotImplementedError, match='kv_write_pos'):
        tgen.generate_speculative(NoWritePos(), NoWritePos(), ids)


# ---------------------------------------------------------------------------
# sampled speculation: the law
# ---------------------------------------------------------------------------

N_DRAWS = 4000


def _law_check(tokens, p):
    counts = np.bincount(np.asarray(tokens), minlength=len(p))
    assert counts[p == 0].sum() == 0, 'a filtered token was emitted'
    sd = np.sqrt(N_DRAWS * p * (1 - p))
    z = np.abs(counts - N_DRAWS * p) / np.maximum(sd, 1e-12)
    assert z[p > 0].max() < 5, (z.max(), int(np.argmax(z)))


def _dists(top_k):
    """A target and a draft distribution over V tokens, both filtered to
    their top_k (the target's and the draft's supports differ)."""
    rng = np.random.default_rng(top_k)
    lt, ld = (torch.tensor(rng.standard_normal((1, V)) * 2) for _ in
              range(2))
    return (torch.softmax(tgen.filter_logits(x, top_k), -1)[0]
            for x in (lt, ld))


@pytest.mark.parametrize('top_k', [0, 20])
def test_host_commit_follows_target_law(top_k):
    """generate_speculative_sampled's window rule at k = 1: x ~ pd, then
    the first token out (x accepted, or the resample) has law pt."""
    p_t, p_d = _dists(top_k)
    props = torch.Generator().manual_seed(1)
    coins = torch.Generator().manual_seed(2)
    firsts = []
    for _ in range(N_DRAWS):
        x = torch.multinomial(p_d, 1, generator=props)
        acc, nxt = tgen._sampled_commit(x, torch.stack([p_t, p_t]),
                                        p_d[None], 1, coins)
        firsts.append(acc[0] if acc else nxt)
    _law_check(firsts, p_t.numpy())


@pytest.mark.parametrize('top_k', [0, 20])
def test_serving_accept_follows_target_law(top_k):
    """The serving window's device rule at k = 1 over 4000 seeds: the
    proposal drawn by the hashed Gumbel-max from the draft's logits, the
    hashed accept coin, the hashed residual resample."""
    rng = np.random.default_rng(top_k + 1)
    lt, ld = (torch.tensor(rng.standard_normal(V) * 2, dtype=torch.float32)
              for _ in range(2))
    n = N_DRAWS
    samp = (torch.ones(n), torch.full((n,), top_k), torch.ones(n),
            torch.arange(n), torch.zeros(n, dtype=torch.int64))
    gen0 = torch.zeros(n, dtype=torch.int64)
    x, p_d = tserving._sample_rows_dist(
        ld.expand(n, V), *samp[:3],
        tserving._row_keys(samp[3], gen0 + 1, tserving._SUB_PROPOSE))
    m, nxt = tserving._spec_accept(x[:, None], p_d[:, None],
                                   lt.expand(n, 2, V), samp, gen0)
    p_t = tserving._filtered_dist(lt[None], *(s[:1] for s in samp[:3]))[0]
    _law_check(torch.where(m == 1, x, nxt).numpy(), p_t.double().numpy())
    assert 0 < int(m.sum()) < n


def test_sampled_generate_paths():
    _, _, tm, td = _models()
    ids = torch.from_numpy(_ids(4, 1)).long()
    greedy = tm.generate(ids, max_new_tokens=8)
    # top_k = 1 keeps the argmax alone: every seed is the greedy stream
    for seed in range(3):
        assert torch.equal(tgen.generate_speculative_sampled(
            tm, td, ids, max_new_tokens=8, temperature=1.0, top_k=1,
            rng_key=seed), greedy)
    assert torch.equal(tgen.generate_speculative_sampled(
        tm, td, ids, max_new_tokens=8, temperature=0.0), greedy)
    kw = dict(max_new_tokens=12, temperature=0.9, num_draft_tokens=3)
    a = tgen.generate_speculative_sampled(tm, td, ids, rng_key=7, **kw)
    assert torch.equal(a, tgen.generate_speculative_sampled(
        tm, td, ids, rng_key=torch.Generator().manual_seed(7), **kw))
    assert not torch.equal(a, tgen.generate_speculative_sampled(
        tm, td, ids, rng_key=8, **kw))
    eos = int(a[0, 6 + 3])
    b = tgen.generate_speculative_sampled(tm, td, ids, rng_key=7,
                                          eos_token_id=eos, **kw)
    first = int(np.nonzero(b[0, 6:].numpy() == eos)[0][0])
    assert (b[0, 6 + first:] == eos).all() and b.shape == a.shape


# ---------------------------------------------------------------------------
# ServingEngine(draft=)
# ---------------------------------------------------------------------------

def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, V, n).astype(np.int32)


SYS = _prompt(100, 24)                  # a system prompt of 3 full pages
SHARED = [np.concatenate([SYS, _prompt(s, n)])
          for s, n in ((1, 5), (2, 3), (3, 9))] + [
    SYS.copy(), np.concatenate([SYS, _prompt(4, 6)])]
LONG = [_prompt(10 + s, 25) for s in range(2)]
# 7 usable pages for 2 slots of up to 6: the top-ups preempt
BASE = dict(max_slots=2, block_size=8, max_context_len=64, num_blocks=8,
            max_new_tokens=8, decode_window=4, buckets=(16, 64),
            prefix_cache=True, prefill_chunk=8, num_draft_tokens=3)
CASES = {'float32': dict(eos_token_id=None),
         'int8': dict(kv_cache_dtype='int8')}
SPEC = ('windows', 'proposed', 'accepted')
PREFIX = ('hits', 'misses', 'hit_tokens', 'chunked_admissions',
          'chunk_steps', 'cow_pages')


def _serve(engine, prompts, late=2, **submit):
    """Two requests, one step, then the rest (admitted while they
    decode); outputs in submission order."""
    rids = [engine.submit(p, **submit) for p in prompts[:late]]
    engine.step()
    rids += [engine.submit(p, **submit) for p in prompts[late:]]
    engine.run()
    return [np.asarray(engine.result(r)) for r in rids]


@functools.lru_cache(maxsize=None)
def _case_kw(name):
    kw = dict(BASE, **CASES[name])
    if name == 'float32':
        # an eos the first stream emits
        plain = dict(kw)
        plain.pop('num_draft_tokens')
        out = _serve(ServingEngine(_models()[2], **plain), SHARED[:1])[0]
        kw['eos_token_id'] = int(out[len(SHARED[0]) + 3])
    return kw


@pytest.fixture(scope='module')
def runs():
    """run(kind, case) -> (engine, outputs), made once per module; kind
    'jax', 'port' or 'plain' (the port without a draft)."""
    jm, jd, tm, td = _models()
    memo = {}

    def run(kind, name):
        if (kind, name) not in memo:
            kw = dict(_case_kw(name))
            if kind == 'jax':
                engine = JaxEngine(jm, draft=jd, **kw)
            elif kind == 'port':
                engine = ServingEngine(tm, draft=td, **kw)
            else:
                kw.pop('num_draft_tokens')
                engine = ServingEngine(tm, **kw)
            memo[kind, name] = engine, _serve(engine, SHARED + LONG)
        return memo[kind, name]

    return run


@pytest.mark.parametrize('case', list(CASES))
def test_serving_streams_and_counts_equal_jax(runs, case):
    je, want = runs('jax', case)
    te, got = runs('port', case)
    _pe, plain = runs('plain', case)
    for i, (w, g, p) in enumerate(zip(want, got, plain)):
        np.testing.assert_array_equal(g, w, err_msg=f'request {i}')
        np.testing.assert_array_equal(g, p, err_msg=f'request {i}')
    js, ts = je.stats(), te.stats()
    assert {k: ts['spec'][k] for k in SPEC} == {k: js['spec'][k]
                                                for k in SPEC}
    assert {k: ts['prefix'][k] for k in PREFIX} == {k: js['prefix'][k]
                                                    for k in PREFIX}
    assert ts['preemptions'] == js['preemptions'] > 0
    assert 0 < ts['spec']['accepted'] < ts['spec']['proposed']
    assert ts['prefix']['hits'] and ts['prefix']['chunked_admissions']
    assert te.allocator.in_use() == 0
    # the draft's forwards: k + 1 one-token steps a window
    assert (ts['spec']['draft_forwards']['decode']
            == 4 * ts['spec']['windows'] == 4 * ts['spec']['verify_forwards'])
    assert ts['spec']['kv_cache_dtype'] == js['spec']['kv_cache_dtype']


@pytest.mark.parametrize('kv', [None, 'int8'])
def test_serving_self_draft_accepts_every_proposal(kv):
    """A self-draft through prefix hits (the draft reads the shared pages
    its earlier owner wrote), chunked admissions and the draft's catch-up
    after chunk steps' plain windows. decode_window = k + 1 and budgets
    that are multiples of it: no speculative window is cut short."""
    _, _, tm, _ = _models()
    kw = dict(BASE, kv_cache_dtype=kv, decode_window=4,
              max_new_tokens=12, num_blocks=40)
    e = ServingEngine(tm, draft=tm, **kw)
    got = _serve(e, SHARED + LONG)
    s = e.stats()
    assert s['spec']['accept_rate'] == 1.0 and s['spec']['windows'] > 0
    assert s['prefix']['hits'] and s['prefix']['chunked_admissions']
    assert s['spec']['draft_forwards']['chunk'] > s['chunk_forwards']
    kw.pop('num_draft_tokens')
    want = _serve(ServingEngine(tm, **kw), SHARED + LONG)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


SAMPLED = dict(temperature=1.0, top_k=40, top_p=0.95)


def test_serving_sampled_rows():
    """Sampled speculative rows: reproducible by seed, independent of
    batch and slot, equal after preemption; greedy rows beside them are
    the greedy-only streams."""
    _, _, tm, td = _models()
    kw = dict(max_slots=3, block_size=8, max_context_len=64,
              max_new_tokens=12, decode_window=4, buckets=(16, 64),
              num_draft_tokens=3)

    def serve(jobs, **extra):
        e = ServingEngine(tm, draft=td, **dict(kw, **extra))
        rids = [e.submit(p, **s) for p, s in jobs]
        e.run()
        return e, [np.asarray(e.result(r)) for r in rids]

    sampled = [(_prompt(30 + s, 20), dict(SAMPLED, seed=s))
               for s in range(3)]
    greedy = [(_prompt(40 + s, 20), {}) for s in range(2)]
    _e, alone = serve(sampled[2:])
    e, mixed = serve(sampled + greedy)
    _e, again = serve(sampled + greedy)
    _e, rev = serve((sampled + greedy)[::-1])
    _e, gonly = serve(greedy)
    # 7 usable 8-token pages for 3 slots of up to 4: the top-ups preempt
    tight, tmixed = serve(sampled + greedy, num_blocks=8)
    assert e.stats()['spec']['accepted'] > 0
    assert tight.preemption_count > 0 and tight.allocator.in_use() == 0
    np.testing.assert_array_equal(mixed[2], alone[0])
    for runs_ in (again, rev[::-1], tmixed):
        for x, y in zip(mixed, runs_):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(mixed[3:], gonly):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(mixed[0][20:], serve(
        [(sampled[0][0], dict(SAMPLED, seed=9))])[1][0][20:])
