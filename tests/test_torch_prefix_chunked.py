"""Prefix caching, chunked prefill and per-row write offsets in the port
against the JAX package, on the same weights and inputs.

- `cached_attention` with per-row `kv_write_pos` (multi-token chunks and
  single-token steps) over float32, bf16 (also under float32 q),
  `RowQuantKVCache` and `QuantKVCache` caches against the JAX function
  (one `jax.jit` per case): outputs within 1e-5 in float32 and 2e-2 in
  bf16 (the two sum in different orders), written rows and codes
  exact, row scales within one ulp.
- `BlockAllocator`: the same operation scripts on both allocators give
  the same return values, refcounts, availability and prefix stats
  after every operation, errors included (LRU harvest order, CoW,
  over-free).
- `prompt_page_hashes`: the JAX package's digests byte for byte.
- `ServingEngine` with `prefix_cache` / `prefill_chunk` over a tiny GQA
  Llama (the JAX weights loaded): greedy streams token-equal to the JAX
  engine's, with equal prefix and chunk counts, and no page held after
  the drain. Each engine run is made once per module (`runs`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import BlockAllocator as JaxAllocator
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.serving import (
    prompt_page_hashes as jax_page_hashes)
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import cached_attention as jax_cached_attention
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import (BlockAllocator, ServingEngine,
                                        prompt_page_hashes)
from paddle_tpu_torch.models.generation import QuantKVCache, RowQuantKVCache
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           cached_attention, llama_tiny)

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


CFG = dict(vocab_size=96, hidden_size=64, layers=2)
TOL = {'float32': dict(rtol=1e-5, atol=1e-5),
       'bfloat16': dict(rtol=2e-2, atol=2e-2)}


@functools.lru_cache(maxsize=None)
def _models():
    pt.seed(0)
    jm = JaxLlama(jax_tiny(**CFG))
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


# ---------------------------------------------------------------------------
# cached_attention with per-row write offsets
# ---------------------------------------------------------------------------

def _cache_pair(kind, rng, B, L, Hkv, D):
    """The same pre-filled cache for both sides: (jax cache, port cache,
    the dtype q / k / v take)."""
    shape = (B, L, Hkv, D)
    if kind in ('float32', 'bfloat16', 'bf16-cache'):
        ck = rng.standard_normal(shape, np.float32)
        cv = rng.standard_normal(shape, np.float32)
        cdt = 'float32' if kind == 'float32' else 'bfloat16'
        jdt, tdt = jnp.dtype(cdt), getattr(torch, cdt)
        return ((jnp.asarray(ck, jdt), jnp.asarray(cv, jdt)),
                (torch.tensor(ck).to(tdt), torch.tensor(cv).to(tdt)),
                'bfloat16' if kind == 'bfloat16' else 'float32')
    codes = [rng.integers(-127, 128, shape).astype(np.int8)
             for _ in range(2)]
    if kind == 'rowquant':
        scales = [rng.uniform(0.005, 0.02, shape[:3]).astype(np.float32)
                  for _ in range(2)]
        fields = codes + scales
        return (jgen.RowQuantKVCache(*map(jnp.asarray, fields)),
                RowQuantKVCache(*map(torch.tensor, fields)), 'float32')
    scales = [rng.uniform(0.005, 0.02, (Hkv, D)).astype(np.float32)
              for _ in range(2)]
    fields = codes + scales
    return (jgen.QuantKVCache(*map(jnp.asarray, fields)),
            QuantKVCache(*map(torch.tensor, fields)), 'float32')


@pytest.mark.parametrize('S', [5, 1], ids=['chunk', 'one-token'])
# 'bf16-cache': a bf16 cache under float32 q / k / v (bf16 pages of a
# float32 model, which the chunk path gathers as they are)
@pytest.mark.parametrize('kind', ['float32', 'bfloat16', 'bf16-cache',
                                  'rowquant', 'quant'])
def test_cached_attention_per_row_offsets(kind, S):
    rng = np.random.default_rng(3)
    B, L, H, Hkv, D = 3, 24, 4, 2, 16
    jcache, tcache, dt = _cache_pair(kind, rng, B, L, Hkv, D)
    wp = np.asarray([3, 17, 0] if S == 1 else [3, 10, 0], np.int32)
    q, k, v = (rng.standard_normal((B, S, h, D), np.float32)
               for h in (H, Hkv, Hkv))
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)

    jout, jnew = jax.jit(
        lambda q, k, v, c, w: jax_cached_attention(q, k, v, c, 0,
                                                   kv_write_pos=w))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jcache, jnp.asarray(wp))
    tout, tnew = cached_attention(
        *(torch.tensor(x).to(tdt) for x in (q, k, v)), tcache, 0,
        kv_write_pos=torch.tensor(wp))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), **TOL[dt])
    # every field of the cache (written rows, codes) exactly, but a row
    # scale: under jax.jit XLA may turn the division by 127 into a
    # multiplication and move it by one ulp (test_torch_kvquant_serving
    # holds the eager scales bit-equal); a QuantKVCache keeps its scales
    # (no recalibration)
    for i, (jf, tf) in enumerate(zip(jnew, tnew)):
        if kind == 'rowquant' and i >= 2:
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf),
                                       rtol=2e-7, atol=0)
        else:
            np.testing.assert_array_equal(tf.float().numpy(),
                                          np.asarray(jf, np.float32))
    if kind == 'quant':
        np.testing.assert_array_equal(tnew[2].numpy(),
                                      np.asarray(jcache[2]))


# ---------------------------------------------------------------------------
# BlockAllocator
# ---------------------------------------------------------------------------

H = [bytes([i]) * 16 for i in range(8)]      # stand-in chain hashes

SCRIPTS = {
    'share_free_revive': [
        ('alloc', 3), ('register', 1, H[1]), ('register', 2, H[2]),
        ('share', [1, 2]), ('free', [1, 2, 3]), ('free', [1, 2]),
        ('match', [H[1], H[2], H[3]]), ('share', [1, 2]), ('alloc', 2),
        ('free', [2, 1]), ('free', [3, 4])],
    'lru_harvest_oldest_first': [
        ('alloc', 5), *[('register', p, H[p]) for p in range(1, 6)],
        ('free', [3]), ('free', [1]), ('free', [5, 4]), ('free', [2]),
        ('alloc', 4), ('match', [H[1]]), ('match', [H[2]]),
        ('match', [H[4]]), ('alloc', 1), ('match', [H[2]]),
        ('free', [6, 7, 5, 3, 1])],
    'cow_keeps_source': [
        ('alloc', 2), ('register', 1, H[1]), ('share', [1]),
        ('cow', 1), ('free', [1]), ('free', [1]), ('match', [H[1]]),
        ('alloc', 4), ('free', [2, 3])],
    'first_writer_wins': [
        ('alloc', 2), ('register', 1, H[5]), ('register', 2, H[5]),
        ('free', [1, 2]), ('match', [H[5]]), ('alloc', 7)],
    'refusals': [
        ('alloc', 2), ('free', [1]), ('free', [1]), ('free', [0]),
        ('free', [2, 2]), ('share', [1]), ('register', 1, H[1]),
        ('cow', 1), ('alloc', 8), ('alloc', -1), ('free', [2])],
}


def _apply(alloc, op):
    """One operation; its result or the name of what it raised."""
    name, *args = op
    try:
        if name == 'register':
            return alloc.register_prefix(*args)
        if name == 'match':
            return alloc.match_prefix(*args)
        return getattr(alloc, name)(*args)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__


def _books(alloc):
    s = alloc.stats()
    return (s, [alloc.refcount(p) for p in range(alloc.num_blocks)],
            alloc.available(), alloc.in_use(), alloc.cached(),
            alloc.shared())


@pytest.mark.parametrize('script', list(SCRIPTS))
def test_allocator_books_equal_jax(script):
    j, t = JaxAllocator(8, 4), BlockAllocator(8, 4)
    for bpp in (j, t):
        bpp.bytes_per_page = 100
    for i, op in enumerate(SCRIPTS[script]):
        got, want = _apply(t, op), _apply(j, op)
        assert got == want, f'op {i} {op}: {got} != {want}'
        assert _books(t) == _books(j), f'after op {i} {op}'


@pytest.mark.parametrize('n,bs', [(0, 4), (7, 4), (16, 4), (33, 8),
                                  (64, 16)])
def test_prompt_page_hashes_equal_jax(n, bs):
    prompt = np.random.default_rng(n).integers(0, 32000, n).astype(np.int32)
    got = prompt_page_hashes(prompt, bs)
    assert got == jax_page_hashes(prompt, bs)
    assert len(got) == n // bs


# ---------------------------------------------------------------------------
# the ServingEngine against the JAX engine
# ---------------------------------------------------------------------------

def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 96, n).astype(np.int32)


SYS = _prompt(100, 24)                  # a system prompt of 3 full pages
SHARED = [np.concatenate([SYS, _prompt(s, n)])
          for s, n in ((1, 5), (2, 3), (3, 9))] + [SYS.copy(),
                                                   np.concatenate(
                                                       [SYS, _prompt(4, 6)])]
LONG = [_prompt(10 + s, 25) for s in range(4)]
# one geometry for every case, so the JAX engines share their compiles:
# 7 usable pages for 2 slots of up to 6 (the preempting case's pool)
BASE = dict(max_slots=2, block_size=8, max_context_len=64, num_blocks=8,
            max_new_tokens=8, decode_window=4, buckets=(16, 64))

CASES = {
    # the full-coverage prompt (SYS alone) copies its boundary page
    'prefix': dict(kw=dict(prefix_cache=True), prompts=SHARED,
                   mnt=[6, 8, 5, 6, 7]),
    'chunked': dict(kw=dict(prefill_chunk=8), prompts=LONG,
                    mnt=[8, 5, 8, 6]),
    # the top-ups preempt, cached pages are harvested, a hit too short
    # to pay is skipped
    'both_preempting': dict(kw=dict(prefix_cache=True, prefill_chunk=8),
                            prompts=SHARED + LONG[:2], mnt=[8] * 7),
    'int8_both': dict(kw=dict(prefix_cache=True, prefill_chunk=8,
                              kv_cache_dtype='int8'),
                      prompts=SHARED[:4] + LONG[:2], mnt=[7] * 6),
}
COUNTS = ('hits', 'misses', 'hits_skipped', 'hit_tokens',
          'chunked_admissions', 'chunk_steps', 'cow_pages', 'shares',
          'evictions', 'cached_pages', 'indexed_pages')


@pytest.fixture(scope='module')
def runs():
    """run(kind, case) -> (engine, outputs), made once per module; kind
    'jax' or 'port'."""
    jm, tm = _models()
    memo = {}

    def run(kind, name):
        if (kind, name) not in memo:
            case = CASES[name]
            kw = dict(BASE, **case['kw'])
            engine = (JaxEngine(jm, **kw) if kind == 'jax'
                      else ServingEngine(tm, **kw))
            rids = [engine.submit(p, m)
                    for p, m in zip(case['prompts'], case['mnt'])]
            engine.run()
            memo[kind, name] = engine, [np.asarray(engine.result(r))
                                        for r in rids]
        return memo[kind, name]

    return run


@pytest.mark.parametrize('case', list(CASES))
def test_streams_and_counts_equal_jax_engine(runs, case):
    je, want = runs('jax', case)
    te, got = runs('port', case)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f'request {i}')
    js, ts = je.stats()['prefix'], te.stats()['prefix']
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert te.preemption_count == je.stats()['preemptions']
    assert te.allocator.in_use() == 0 and je.allocator.in_use() == 0
    kw = CASES[case]['kw']
    if kw.get('prefix_cache'):
        assert ts['hits'] > 0 and ts['hit_tokens'] > 0
        assert ts['cow_pages'] > 0          # the full-coverage prompt
    if kw.get('prefill_chunk'):
        assert ts['chunked_admissions'] > 0
    if case == 'both_preempting':
        assert te.preemption_count > 0 and ts['hits_skipped'] > 0
        assert ts['evictions'] > 0


def test_default_engine_unchanged_and_refusals():
    """Both features default off (a plain engine counts no chunk step),
    and what the port does not take raises."""
    tm = _models()[1]
    te = ServingEngine(tm, **BASE)
    assert te.prefix_cache is False and te.prefill_chunk is None
    out = te.serve(LONG[:2])
    s = te.stats()
    assert s['chunk_forwards'] == 0 and s['prefix']['chunk_steps'] == 0
    assert s['prefill_tokens'] == 50 and len(out[0]) == 25 + 8
    with pytest.raises(ValueError, match='prefill_chunk'):
        ServingEngine(tm, prefill_chunk=0, **BASE)
    for knob, feature in (('max_queue', 'load shedding'),
                          ('mesh', 'tensor parallelism'),
                          ('journal', 'telemetry')):
        with pytest.raises(NotImplementedError, match=feature):
            ServingEngine(tm, **{knob: 1}, **BASE)
    with pytest.raises(TypeError, match='unexpected'):
        ServingEngine(tm, no_such_knob=1, **BASE)
    with pytest.raises(NotImplementedError, match='deadline'):
        te.submit(LONG[0], deadline_s=1.0)
    with pytest.raises(NotImplementedError):
        te.snapshot()
