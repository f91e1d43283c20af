"""Per-request sampling in the port's ServingEngine.

The port draws with its own counter-based hash, never the JAX package's
threefry stream, so sampled tokens are held to properties within the
port and to the JAX package's distribution:

- `filter_logits_batched` equal to the JAX package's (the same entries
  dropped, the kept ones unchanged), and each row's sampling
  distribution within 1e-6 of its `_filtered_dist`;
- 4000 draws of one fixed row (over 4000 seeds, and over 4000
  generated-token indices of one seed) against the JAX package's
  `_filtered_dist`: every token's count within 5 standard deviations
  of its expectation, none outside the filtered support;
- the engine: the same seed reproduces a stream and another seed
  diverges; a stream does not depend on its batch or slot; a stream
  resumed after preemption is the uninterrupted one; greedy rows beside
  sampled ones are the greedy-only streams; `submit` refuses bad
  parameters with `InvalidSamplingParams` before queueing anything.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import _filtered_dist as jax_dist
from paddle_tpu.models.generation import (
    filter_logits_batched as jax_filter)
from paddle_tpu_torch.inference import InvalidSamplingParams, ServingEngine
from paddle_tpu_torch.inference.serving import (_SUB_PROPOSE, _filtered,
                                                _row_keys, _sample_rows)
from paddle_tpu_torch.models.generation import filter_logits_batched
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


V = 96
KW = dict(max_slots=3, block_size=8, max_context_len=64, max_new_tokens=12,
          decode_window=4, buckets=(16, 64))
SAMPLED = dict(temperature=1.0, top_k=40, top_p=0.95)


@functools.lru_cache(maxsize=None)
def _model():
    return LlamaForCausalLM(llama_tiny(vocab_size=V, hidden_size=64,
                                       layers=2), device='cpu', seed=0)


def _prompt(seed, n=10):
    return np.random.default_rng(seed).integers(3, V, n).astype(np.int32)


def _serve(jobs, **kw):
    """jobs: (prompt, sampling kwargs); returns (engine, outputs in job
    order)."""
    engine = ServingEngine(_model(), **dict(KW, **kw))
    rids = [engine.submit(p, **s) for p, s in jobs]
    engine.run()
    return engine, [np.asarray(engine.result(r)) for r in rids]


def test_filter_logits_batched_equal_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((7, 50)) * 3).astype(np.float32)
    top_k = np.asarray([0, 1, 5, 50, 100, 3, -2], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 1.0, 0.3, 0.95, 0.7], np.float32)
    want = np.asarray(jax.jit(jax_filter)(logits, top_k, top_p))
    got = filter_logits_batched(torch.tensor(logits), torch.tensor(top_k),
                                torch.tensor(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)],
                                  want[~np.isinf(want)])
    temp = np.asarray([0.0, 0.5, 1.0, 2.0, 0.8, 1.3, 0.7], np.float32)
    np.testing.assert_allclose(
        torch.softmax(_filtered(*map(torch.tensor, (logits, temp, top_k,
                                                    top_p))), -1).numpy(),
        np.asarray(jax.jit(jax_dist)(logits, temp, top_k, top_p)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('over', ['seeds', 'indices'])
def test_draws_follow_the_jax_distribution(over):
    N = 4000
    rng = np.random.default_rng(1)
    row = (rng.standard_normal(V) * 2).astype(np.float32)
    temp, top_k, top_p = 0.8, 30, 0.9
    p = np.asarray(jax.jit(jax_dist)(
        row[None], jnp.asarray([temp]), jnp.asarray([top_k]),
        jnp.asarray([top_p])))[0].astype(np.float64)
    n = torch.arange(N)
    seed, gen = (n, torch.zeros(N)) if over == 'seeds' else (
        torch.full((N,), 7), n)
    toks = _sample_rows(torch.tensor(row).expand(N, V),
                        torch.full((N,), temp), torch.full((N,), top_k),
                        torch.full((N,), top_p),
                        _row_keys(seed, gen, _SUB_PROPOSE))
    counts = np.bincount(toks.numpy(), minlength=V)
    assert counts[p == 0].sum() == 0
    sd = np.sqrt(N * p * (1 - p))
    z = np.abs(counts - N * p) / np.maximum(sd, 1e-12)
    assert z[p > 0].max() < 5, (z.max(), int(np.argmax(z)))


def test_same_seed_reproduces_other_seed_diverges():
    p = _prompt(1)
    _e, (a,) = _serve([(p, dict(SAMPLED, seed=7))])
    _e, (b,) = _serve([(p, dict(SAMPLED, seed=7))])
    _e, (c,) = _serve([(p, dict(SAMPLED, seed=8))])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[10:], c[10:])
    # the default seed is the rid
    _e, (d,) = _serve([(p, dict(SAMPLED))])
    _e, (e,) = _serve([(p, dict(SAMPLED, seed=0))])
    np.testing.assert_array_equal(d, e)


def test_stream_independent_of_batch_and_slot():
    jobs = [(_prompt(s), dict(SAMPLED, seed=s)) for s in range(4)]
    _e, alone = _serve(jobs[3:])
    _e, batched = _serve(jobs)          # slot 0 of a later admission wave
    _e, reordered = _serve(jobs[::-1])  # slot 0 of the first wave
    np.testing.assert_array_equal(batched[3], alone[0])
    for x, y in zip(batched, reordered[::-1]):
        np.testing.assert_array_equal(x, y)


def test_resumed_after_preemption_equals_uninterrupted():
    jobs = [(_prompt(s, 20), dict(SAMPLED, seed=s)) for s in range(3)]
    _e, want = _serve(jobs)
    # 7 usable 8-token pages for 3 slots of up to 4: top-ups preempt
    tight, got = _serve(jobs, num_blocks=8)
    assert tight.preemption_count > 0
    assert tight.allocator.in_use() == 0
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_greedy_rows_beside_sampled_rows():
    greedy = [(_prompt(10 + s), {}) for s in range(3)]
    sampled = [(_prompt(20 + s), dict(SAMPLED, seed=s)) for s in range(3)]
    _e, want = _serve(greedy)
    _e, mixed = _serve([j for pair in zip(greedy, sampled) for j in pair])
    for x, y in zip(mixed[::2], want):
        np.testing.assert_array_equal(x, y)


def test_submit_refuses_bad_parameters_early():
    engine = ServingEngine(_model(), temperature=0.7, **KW)
    for bad in (dict(temperature=-0.1), dict(top_p=0.0),
                dict(top_p=1.01)):
        with pytest.raises(InvalidSamplingParams):
            engine.submit(_prompt(0), **bad)
    with pytest.raises(InvalidSamplingParams):
        # refused before the prompt is looked at
        engine.submit(object(), temperature=-1.0)
    assert len(engine.queue) == 0 and engine.submit(_prompt(0)) == 0
    rid = engine.submit(_prompt(0), top_k=10 ** 6)
    req = engine._live[rid]
    assert req.top_k == V and req.temperature == 0.7
    assert engine._live[engine.submit(_prompt(0), top_k=-5)].top_k == 0
