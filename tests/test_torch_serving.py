"""The port's ServingEngine against the JAX package's, on the same
weights.

Both engines serve the same seeded prompts over a tiny GQA Llama
(llama_tiny(vocab_size=96, hidden_size=64, layers=2): 4 query heads, 2
kv heads) whose JAX weights are loaded into the port. Greedy streams
must be token-equal per request — with mixed prompt lengths, an eos
that really occurs, priorities, per-request budgets, and a pool small
enough to force preemption — and every page returns to the pool.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import (BlockAllocator, OutOfBlocks,
                                        Request, RequestQueue, ServingEngine)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


CFG = dict(vocab_size=96, hidden_size=64, layers=2)


@functools.lru_cache(maxsize=None)
def _models():
    pt.seed(0)
    jm = JaxLlama(jax_tiny(**CFG))
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 96, (n,)).astype(np.int32) for n in lens]


def _drive(engine, jobs):
    """Submit (prompt, max_new_tokens, priority) jobs, run to the end,
    collect outputs in submission order."""
    rids = [engine.submit(p, m, priority=pr) for p, m, pr in jobs]
    engine.run()
    return [np.asarray(engine.result(r)) for r in rids]


def _frequent_token(outs, jobs):
    """A token the port engine emits mid-stream in its run without eos
    (so an eos run really stops early somewhere)."""
    gen = np.concatenate([o[len(p) + 2:] for o, (p, _m, _r) in
                          zip(outs, jobs)])
    vals, counts = np.unique(gen, return_counts=True)
    return int(vals[np.argmax(counts)])


CASES = {
    # a pool of 13 usable 4-token pages for 3 slots: preemption
    'preempt': dict(kw=dict(max_slots=3, block_size=4, num_blocks=14,
                            max_new_tokens=12, decode_window=4,
                            buckets=(8, 16, 32)),
                    lens=(5, 17, 9, 30, 3, 12), mnt=(None,) * 6,
                    prio=(0,) * 6, preempt=True),
    # full pool; per-request budgets and priorities
    'priorities': dict(kw=dict(max_slots=2, block_size=8, max_new_tokens=9,
                               decode_window=3, max_context_len=64,
                               buckets=(16, 32)),
                       lens=(7, 22, 3, 15, 11), mnt=(9, 4, 9, 1, 6),
                       prio=(0, 1, 0, 2, 0), preempt=False),
}


def _jobs(case):
    return list(zip(_prompts(len(case['lens']), case['lens']), case['mnt'],
                    case['prio']))


@pytest.fixture(scope='module')
def engine_runs():
    """Each engine run of this module's cases, made once per module and
    shared by the cases that need it (an eos case picks its eos from the
    port's run without one): run(kind, case name, eos) -> (engine,
    outputs), kind 'jax' or 'port'."""
    jm, tm = _models()
    memo = {}

    def run(kind, name, eos=None):
        if (kind, name, eos) not in memo:
            case = CASES[name]
            kw = dict(case['kw'], eos_token_id=eos)
            engine = (JaxEngine(jm, **kw) if kind == 'jax'
                      else ServingEngine(tm, **kw))
            memo[kind, name, eos] = engine, _drive(engine, _jobs(case))
        return memo[kind, name, eos]

    return run


@pytest.mark.parametrize('case', list(CASES), ids=list(CASES))
@pytest.mark.parametrize('eos', [False, True], ids=['no-eos', 'eos'])
def test_streams_equal_jax_engine(engine_runs, case, eos):
    jobs = _jobs(CASES[case])
    token = (_frequent_token(engine_runs('port', case)[1], jobs) if eos
             else None)
    je, want = engine_runs('jax', case, token)
    te, got = engine_runs('port', case, token)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f'request {i}')
    if eos:
        stopped = [np.any(g[len(p):-1] == token)
                   for g, (p, _m, _r) in zip(got, jobs)]
        assert any(stopped), 'eos never stopped a stream early'
    assert te.allocator.in_use() == 0
    assert te.preemption_count == je.stats()['preemptions']
    assert (te.preemption_count > 0) == CASES[case]['preempt']
    s = te.stats()
    assert s['finished'] == len(jobs) and s['in_flight'] == 0
    assert s['blocks']['in_use'] == 0


class TestEngineApi:
    def test_result_handover_and_validation(self):
        te = ServingEngine(_models()[1], max_slots=2, block_size=4,
                           max_new_tokens=3, decode_window=2,
                           max_context_len=32)
        rid = te.submit(np.arange(3, 8))
        assert te.result(rid) is None             # still pending
        te.run()
        out = te.result(rid)
        assert out.shape == (8,) and np.array_equal(out[:5], np.arange(3, 8))
        with pytest.raises(KeyError):
            te.result(rid)                        # handed over once
        with pytest.raises(ValueError, match='max_context_len'):
            te.submit(np.zeros(31, np.int32))
        with pytest.raises(ValueError, match='empty'):
            te.submit(np.zeros(0, np.int32))
        # the page pool is sized from the model's device arrays
        per_layer = 2 * 2 * 4 * 16 * 4            # k+v, Hkv, BS, D, f32
        assert te.allocator.stats()['bytes_per_page'] == 2 * per_layer


class TestBlockAllocator:
    def test_round_trip_and_lifo_reuse(self):
        a = BlockAllocator(9, 16)
        first = a.alloc(4)
        assert first == [1, 2, 3, 4]              # page 0 is reserved
        a.free(first[1:3])
        assert a.alloc(2) == [3, 2]               # most recently freed first
        assert a.in_use() == 4 and a.available() == 4

    def test_exhaustion_and_double_free_raise(self):
        a = BlockAllocator(5, 16)
        pages = a.alloc(3)
        with pytest.raises(OutOfBlocks, match='need 2 page'):
            a.alloc(2)
        assert a.available() == 1                 # nothing half-allocated
        a.free(pages)
        with pytest.raises(ValueError, match='not all currently allocated'):
            a.free(pages[:1])
        with pytest.raises(ValueError):
            a.free([0])
        with pytest.raises(ValueError, match='num_blocks'):
            BlockAllocator(1, 16)


def test_request_queue_priority_then_fifo():
    q = RequestQueue()
    reqs = [Request(i, [1], 1, p) for i, p in enumerate((0, 2, 0, 2, 1))]
    for r in reqs:
        q.push(r)
    assert [r.rid for r in q] == [1, 3, 4, 0, 2]
    assert [q.pop().rid for _ in range(5)] == [1, 3, 4, 0, 2]


def test_engine_runs_on_the_models_device():
    tm = _models()[1]
    te = ServingEngine(tm, max_slots=1, block_size=4, max_new_tokens=2,
                       max_context_len=16)
    assert te.device == torch.device('cpu')
    assert all(t.device == te.device for pc in te._pages for t in pc)
