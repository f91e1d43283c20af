"""Captured decode bodies: one CUDA graph per geometry, replayed
(counterpart of the JAX package's compiled windows and `aot` warm-up).

The JAX engines run a decode window or a decode step as one compiled
dispatch (`jax.jit`), compiled once per geometry. The port runs the same
bodies eagerly as Python code, so every decode forward pays the host
time of its few hundred launches. A `GraphRunner` captures such a body
once per geometry key into a CUDA graph and replays it. It holds, per
key:

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
(`paddle_tpu/aot/geometry.py`): the `serve_window` kind a
`ServingEngine.warmup` captures and the `decode` kind of
`DecodeEngine.warmup`.
"""
from __future__ import annotations

import contextlib
import time
import weakref

import torch

from ..ops import _build
from ..ops.hopper import flash_attention, moe_grouped_matmul, quant_matmul


class Geometry:
    """One captured dispatch shape: `kind` and a params dict of
    primitives. Kinds the port captures:

      serve_window  window (ServingEngine: its decode window, every
                    sampling and carry variant its config implies)
      decode        batch, prompt_len, max_new_tokens (DecodeEngine:
                    the decode step of a generate call)
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
                      max_new_tokens=None):
    """The `decode` geometries a DecodeEngine serves for the declared
    prompt lengths, batch sizes and budgets (None: the engine's): one
    per (batch, bucket, padded or exact) of each budget, as the JAX
    package enumerates them."""
    from .engine import bucket_length

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
        """Captured geometries: count, capture seconds and reserved bytes
        (the card's memory_reserved increase over each capture)."""
        return {'captures': self.captures, 'kept': len(self.entries),
                'capture_s': [round(g.capture_s, 4)
                              for g in self.entries.values()],
                'reserved_bytes': [g.reserved_bytes
                                   for g in self.entries.values()]}


__all__ = ['Geometry', 'Graph', 'GraphRunner', 'for_decode_engine',
           'geometry_parts', 'tensor_ptrs', 'warmup_report']
