"""Captured serving and decode bodies: one CUDA graph per geometry,
replayed (counterpart of the JAX package's compiled dispatches and `aot`
warm-up).

The JAX engines run a decode window, a decode step, a speculative
propose / verify window, an admission prefill, a chunked-prefill chunk
and a fused-inference decode step each as one compiled dispatch
(`jax.jit`), compiled once per geometry. Run as Python code, the same
bodies pay the host time of their few hundred launches on every call. A
`GraphRunner` captures such a body once per geometry key into a CUDA
graph and replays it. It holds, per key:

  - the static input buffers the body reads (each call copies its new
    inputs into them: `Graph.load`);
  - the state tensors the body writes in place (page pools, caches),
    whose addresses the graph holds: `Graph.check_state` raises when a
    caller hands in other tensors;
  - the graph, and the output tensors the body returned at capture.
    A replay overwrites them: a caller that keeps an output past the
    next replay copies it out.

Bodies are inference: they run, and are captured, without autograd.

Capture rules. The body runs once eagerly on the runner's side stream
(its allocations, the decode kernels' per-stream split counters and the
kernels' launch plans then exist), then once more while that stream is
captured. Every replay runs on the same stream, in order, so the split
counters the graph holds (`ops/hopper/decode_attention.py` keys them by
device and stream) are never shared with another stream. Graphs of one
runner share one memory pool. The Python launch counters (`ops.LAUNCHES`
and the per-path counts of K10 / K11, X1 and flash attention) move only
while Python runs the body: the runner restores them after a capture and
adds the capture's increase on every replay, so the counts a run shows
are the launches it made. A failed capture raises; nothing falls back
to the eager body.

On a CPU device nothing is captured: the body runs directly over the
same static buffers, so the buffer handling is the same on both.

A graph also holds the addresses of the weights it read. A runner
built over `modules` reads their parameters' and buffers' addresses on
every lookup: when one was replaced after a capture (`module.to(dtype)`,
`load_state_dict(assign=True)`, a requantisation into new tensors), its
graphs are dropped and the next lookup captures anew over the new
weights. A graph replays the code it captured: a check that swaps a
kernel for its plain version runs the bodies directly (a runner off the
card), not through graphs captured before the swap.

`Geometry` is the port's copy of the JAX package's geometry record
(`paddle_tpu/aot/geometry.py`): the serving kinds a
`ServingEngine.warmup` captures (`for_serving_engine` enumerates them as
the JAX package does) and the `decode` and `decode_spec` kinds of
`DecodeEngine.warmup`.
"""
from __future__ import annotations

import contextlib
import time
import weakref

import torch

from ..ops import _build
from ..ops.hopper import flash_attention, moe_grouped_matmul, quant_matmul
from .engine import bucket_length


class Geometry:
    """One captured dispatch shape: `kind` and a params dict of
    primitives (the JAX package's names). Kinds the port captures:

      serve_window  window (ServingEngine: its decode window, every
                    sampling and carry variant its config implies)
      serve_step    window, bucket (an admission step: the prefill of
                    `bucket`-token rows, then the decode window)
      serve_prefill bucket (an admission prefill alone; on a
                    speculative engine the draft's too)
      serve_chunk_step
                    window, chunk, bucket (a chunked / continuation
                    prefill step: a `chunk`-bucket chunk over prefixes
                    gathered to the `bucket` of the farthest end, then
                    the decode window; on a speculative engine the
                    draft's chunk and its catch-up chunks too)
      serve_spec_step
                    spec, bucket, ctx (ServingEngine(draft=): an
                    admission prefill of both models, then the
                    speculative window of `ctx`)
      serve_spec_window
                    spec, ctx (ServingEngine(draft=): a speculative
                    propose / verify window of `spec` draft tokens whose
                    verify gathers `ctx` positions, greedy and sampled)
      decode        batch, prompt_len, max_new_tokens (DecodeEngine:
                    the decode step of a generate call)
      decode_spec   batch, prompt_len, max_new_tokens, num_draft_tokens
                    (DecodeEngine: the window of a generate_speculative
                    call)
    """

    __slots__ = ('kind', 'params')

    def __init__(self, kind, **params):
        self.kind = str(kind)
        self.params = params

    def to_dict(self):
        return {'kind': self.kind, **self.params}

    def __repr__(self):
        return f'Geometry({self.to_dict()})'


def geometry_parts(g):
    """(kind, params) of a geometry: the port's `Geometry`, the JAX
    package's (any object with `kind` and `params`), or a dict with a
    'kind' key."""
    if isinstance(g, dict):
        d = dict(g)
        return d.pop('kind'), d
    return g.kind, dict(g.params)


def for_decode_engine(engine, prompt_lens, batch_sizes=(1,),
                      max_new_tokens=None, spec_draft_tokens=None,
                      spec_batch_sizes=(1,)):
    """The `decode` geometries a DecodeEngine serves for the declared
    prompt lengths, batch sizes and budgets (None: the engine's): one
    per (batch, bucket, padded or exact) of each budget, as the JAX
    package enumerates them; with `spec_draft_tokens` (k values) also a
    `decode_spec` geometry per (spec batch size, k, budget, prompt
    length): speculative prompts are not bucketed, so every declared
    length is its own geometry."""
    mnts = (max_new_tokens if isinstance(max_new_tokens, (list, tuple))
            else [max_new_tokens])
    out = []
    for B in batch_sizes:
        for mnt in mnts:
            budget = engine.max_new_tokens if mnt is None else int(mnt)
            seen = set()
            for L in prompt_lens:
                b = bucket_length(int(L), engine.buckets)
                if (b, int(L) == b) in seen:
                    continue
                seen.add((b, int(L) == b))
                out.append(Geometry('decode', batch=int(B),
                                    prompt_len=int(L),
                                    max_new_tokens=budget))
    for B in (spec_batch_sizes if spec_draft_tokens else ()):
        for k in spec_draft_tokens:
            for mnt in mnts:
                budget = engine.max_new_tokens if mnt is None else int(mnt)
                out.extend(Geometry('decode_spec', batch=int(B),
                                    prompt_len=int(L),
                                    max_new_tokens=budget,
                                    num_draft_tokens=int(k))
                           for L in prompt_lens)
    return out


def bucket_ladder(lo, hi, buckets):
    """The buckets the lengths lo..hi fall in, in order, each once."""
    out, v = [], lo
    while v <= hi:
        b = bucket_length(v, buckets)
        out.append(b)
        v = b + 1
    return out


def for_serving_engine(engine, prompt_lens=None, max_new_tokens=None):
    """The geometries a (monolithic) ServingEngine dispatches, as the JAX
    package enumerates them: an admission step per prefill bucket of the
    declared admission lengths (`prompt_lens`, default 1..
    max_context_len; with `prefill_chunk` only those up to the chunk)
    and the decode window; on a speculative engine instead an admission
    step per (bucket, reachable verify ctx bucket) and the speculative
    window per ctx bucket of the ladder live contexts climb (up to the
    largest prompt plus the largest `max_new_tokens` budget, within
    max_context_len, less one); the standalone prefill of each bucket;
    with `prefill_chunk` or `prefix_cache`, a chunk step per reachable
    (chunk bucket, end bucket) pair."""
    W = engine.decode_window
    buckets_of = engine.buckets
    lens = [int(L) for L in (range(1, engine.max_context_len + 1)
                             if prompt_lens is None else prompt_lens)]
    chunk = engine.prefill_chunk
    spec = engine.spec_window
    mono = lens if chunk is None else [L for L in lens if L <= chunk]
    buckets = []
    for L in mono:
        b = bucket_length(L, buckets_of)
        if b not in buckets:
            buckets.append(b)
    if spec is None:
        out = [Geometry('serve_step', window=W, bucket=b) for b in buckets]
        out.append(Geometry('serve_window', window=W))
    else:
        k = int(spec)
        mnts = (max_new_tokens if isinstance(max_new_tokens, (list, tuple))
                else [max_new_tokens])
        budget = max(engine.max_new_tokens if m is None else int(m)
                     for m in mnts)
        m_hi = min(max(lens) + budget, engine.max_context_len) - 1
        ladder = bucket_ladder(min(lens) + k + 1, m_hi + k + 1, buckets_of)
        out = []
        # an admitted row is live in its own step: the verify bucket
        # starts at its own length's
        for Sb in buckets:
            lmin = min(L for L in mono if bucket_length(L, buckets_of) == Sb)
            floor = bucket_length(lmin + k + 1, buckets_of)
            out.extend(Geometry('serve_spec_step', spec=k, bucket=Sb, ctx=c)
                       for c in ladder if c >= floor)
        out.extend(Geometry('serve_spec_window', spec=k, ctx=c)
                   for c in ladder)
    out.extend(Geometry('serve_prefill', bucket=b) for b in buckets)
    if (chunk is not None or engine.prefix_cache) and lens:
        max_end = max(lens)
        ends = bucket_ladder(1, max_end, buckets_of)
        max_take = (min(chunk, max_end) if chunk is not None
                    else max(1, max_end - engine.block_size))
        cb_max = bucket_length(max_take, buckets_of)
        # an equal pair is only a start-0 chunked admission's first
        # chunk, whose take is the whole chunk
        out.extend(Geometry('serve_chunk_step', window=W, chunk=cb, bucket=sb)
                   for cb in ends if cb <= cb_max for sb in ends
                   if cb < sb or (chunk is not None and max_end > chunk
                                  and cb == sb == cb_max))
    return out


def warmup_report(geometries, seconds, captures):
    """The JAX package's warm-up report keys: `traces` counts the graphs
    captured (CUDA graphs cannot be persisted, so no cache directory and
    no cost table)."""
    return {'geometries': geometries, 'seconds': round(seconds, 3),
            'traces': captures, 'persistent_cache_dir': None,
            'costs_loaded': 0}


def _counters():
    """The Python launch counters a replay must advance."""
    return (_build.LAUNCHES, quant_matmul.PATH_LAUNCHES,
            moe_grouped_matmul.PATH_LAUNCHES,
            moe_grouped_matmul.DX_PATH_LAUNCHES,
            moe_grouped_matmul.DW_PATH_LAUNCHES,
            flash_attention.FLASH_PATH_LAUNCHES)


def _read_counters():
    return [dict(c) for c in _counters()]


def _restore_counters(saved):
    for c, s in zip(_counters(), saved):
        c.update(s)


def tensor_ptrs(modules):
    """The addresses of the parameters and buffers of `modules` (read
    off each submodule's own tables: ~0.4 ms for a 32-layer Llama's 291
    tensors on one CPU core)."""
    return tuple(t.data_ptr() for m in modules for mod in m.modules()
                 for table in (mod._parameters, mod._buffers)
                 for t in table.values() if t is not None)


class Graph:
    """One captured body (see the module docstring): `static` input
    buffers, the `state` tensors' addresses, the outputs, and on the
    card the CUDA graph with the launch counts one replay makes."""

    def __init__(self, body, static, state, generator):
        self.body = body
        self.static = static
        self.state_ptrs = [t.data_ptr() for t in state]
        self.generator = generator
        self.graph = None
        self.stream = None
        self.outputs = None
        self.increments = None
        self.capture_s = 0.0
        self.reserved_bytes = 0

    def load(self, **inputs):
        """Copy new inputs (tensors or numpy arrays) into the static
        buffers of the same names."""
        for name, value in inputs.items():
            buf = self.static[name]
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(value)
            buf.copy_(value)

    def check_state(self, state):
        """Raise unless `state` are the tensors captured (by address)."""
        ptrs = [t.data_ptr() for t in state]
        if ptrs != self.state_ptrs:
            raise RuntimeError(
                'the state tensors (page pools / caches) are not the ones '
                'this graph captured: a captured body writes only the '
                'tensors it was captured with')

    def run(self, n=1):
        """Run the body n times (replays on the card, direct calls on the
        CPU) and return its outputs of the last."""
        if self.graph is None:
            with torch.no_grad():
                for _ in range(n):
                    self.outputs = self.body()
            return self.outputs
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for _ in range(n):
                self.graph.replay()
        cur.wait_stream(self.stream)
        for c, inc in zip(_counters(), self.increments):
            for name, v in inc.items():
                c[name] += n * v
        return self.outputs


class GraphRunner:
    """Captured bodies of one engine (or one owner of generate's steps),
    by geometry key, on `device`, over the weights of `modules` (held
    weakly: a runner kept beside its model does not keep it alive; see
    the module docstring). Graphs stay until `drop` or `release`."""

    def __init__(self, device, modules=()):
        self.device = torch.device(device)
        self.on_card = self.device.type == 'cuda'
        self._modules = [weakref.ref(m) for m in modules]
        self.entries = {}
        self.captures = 0
        self._weights = None
        self._pool = None
        self._stream = None

    @property
    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key):
        """The graph of `key`, or None. Every graph is dropped first when
        a weight of the runner's modules is no longer the tensor its
        graphs captured."""
        self._check_weights()
        return self.entries.get(key)

    def capture(self, key, body, static, state=(), generator=None):
        """Capture `body` (no arguments: it closes over `static` and the
        `state` tensors; returns its outputs) under `key`. On the card:
        one eager run on the side stream, then the capture, with the
        launch counters restored and `generator` (a torch.Generator the
        body draws from) registered with the graph. The static buffers
        must hold inputs the body may run on (a dummy batch)."""
        self._check_weights()
        if not self.entries:
            # a pool whose graphs are all gone cannot take a capture
            # again (the allocator frees it): start another
            self._pool = None
        g = Graph(body, static, list(state), generator)
        t0 = time.perf_counter()
        if self.on_card:
            self._capture(g)
        g.capture_s = time.perf_counter() - t0
        self.captures += 1
        self.entries[key] = g
        return g

    def _check_weights(self):
        weights = tensor_ptrs(m() for m in self._modules)
        if weights != self._weights:
            self.entries.clear()
            self._weights = weights

    def drop(self, pred):
        """Drop the graphs whose key satisfies `pred` (their buffers go
        with them unless the caller keeps them)."""
        for key in [k for k in self.entries if pred(k)]:
            del self.entries[key]

    def release(self):
        """Drop every graph, and with the last of them the memory pool
        they shared: the allocator frees its blocks (at
        `torch.cuda.empty_cache()` or when an allocation needs them)."""
        self.entries.clear()

    def _capture(self, g):
        saved = _read_counters()
        dev = self.device
        reserved0 = torch.cuda.memory_reserved(dev)
        cur = torch.cuda.current_stream(dev)
        self.stream.wait_stream(cur)
        try:
            with torch.cuda.stream(self.stream), torch.no_grad():
                g.body()                      # eager: allocations, plans
                graph = torch.cuda.CUDAGraph()
                if g.generator is not None:
                    graph.register_generator_state(g.generator)
                before = _read_counters()
                graph.capture_begin(pool=self.pool)
                try:
                    g.outputs = g.body()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
                g.increments = [
                    {k: v - b[k] for k, v in c.items() if v != b[k]}
                    for c, b in zip(_read_counters(), before)]
            cur.wait_stream(self.stream)
        finally:
            _restore_counters(saved)
        g.graph, g.stream = graph, self.stream
        g.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved0

    def stats(self):
        """Captured geometries: count, and per kept graph its key,
        capture seconds and reserved bytes (the card's memory_reserved
        increase over its capture)."""
        return {'captures': self.captures, 'kept': len(self.entries),
                'keys': [str(k) for k in self.entries],
                'capture_s': [round(g.capture_s, 4)
                              for g in self.entries.values()],
                'reserved_bytes': [g.reserved_bytes
                                   for g in self.entries.values()]}


__all__ = ['Geometry', 'Graph', 'GraphRunner', 'bucket_ladder',
           'for_decode_engine',
           'for_serving_engine', 'geometry_parts', 'tensor_ptrs',
           'warmup_report']
