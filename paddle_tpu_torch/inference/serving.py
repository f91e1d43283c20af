"""ServingEngine — continuous batching over a paged KV-cache block pool
(counterpart of the core scheduler of paddle_tpu/inference/serving.py).

  1. `BlockAllocator` owns a pool of fixed-size KV pages shared by all
     in-flight requests: a free list of page ids, reused LIFO, page 0
     reserved as the scratch page that inactive rows write to. The page
     pools are allocated once per engine and never resized; allocation
     is id bookkeeping only.

  2. `ServingEngine.step()` is one scheduler iteration over a fixed-slot
     batch (`max_slots` rows): admit queued requests into free slots
     (their prompts prefill into freshly allocated pages, grouped by
     prompt-length bucket), make sure every live slot owns the pages
     its next window can write, then decode `decode_window` tokens for
     every slot — each step one model call over the paged pools, whose
     attention is the paged-decode kernel on the card — and read the
     emitted tokens back once per window.

  3. Preemption: when the pool runs dry, the lowest-priority (then
     youngest) in-flight request is evicted; its pages are freed and it
     goes back to the queue with its generated prefix, and later resumes
     by re-prefilling prompt + prefix. Greedy decoding makes the resumed
     stream the uninterrupted one.

  4. int8 KV (`kv_cache_dtype='int8'`): the pools hold int8 codes with a
     float32 scale per written row (`QuantPagedKVCache`); a row's codes
     and scale are a pure function of its values, so a re-prefill after
     preemption rewrites the same bytes and greedy streams stay the
     uninterrupted ones. The admission prefill writes into a
     `RowQuantKVCache` with the same per-row rule and attends its rows
     dequantized; its bytes and scales are copied into the pages as
     they are. Decode steps run the paged kernel's per-row int8 mode.

Greedy decoding only. Per request, `result(rid)` is what the JAX
engine returns: the prompt, then `max_new_tokens` tokens, padded with
eos after an early stop. Sampling, prefix caching, chunked prefill,
speculative decoding, tensor parallelism, deadlines and load shedding,
snapshot/restore, telemetry and AOT are not ported yet.
"""
from __future__ import annotations

import heapq
import itertools
import time

import numpy as np
import torch

from ..models.generation import QuantPagedKVCache, RowQuantKVCache
from .engine import DEFAULT_BUCKETS, bucket_length


class OutOfBlocks(RuntimeError):
    """The block pool cannot satisfy an allocation (need/have in the
    message). The ServingEngine catches it and preempts."""


class RequestFailed(RuntimeError):
    """Raised by `result()` for a request that could not be served (its
    window could not get pages even after every other request was
    preempted). Carries `rid`, `reason` and the underlying `error`."""

    def __init__(self, rid, reason, error=None):
        super().__init__(f'request {rid} failed: {reason}')
        self.rid = rid
        self.reason = reason
        self.error = error


def _ceil_div(a, b):
    return -(-a // b)


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV-cache pages.

    Page 0 is reserved as the scratch page, so usable capacity is
    num_blocks - 1 and every handed-out id is >= 1. Freed ids are reused
    LIFO (most recently freed first — deterministic)."""

    def __init__(self, num_blocks, block_size):
        num_blocks = int(num_blocks)
        if num_blocks < 2:
            raise ValueError(
                f'num_blocks must be >= 2 (page 0 is the reserved '
                f'scratch page), got {num_blocks}')
        self.num_blocks = num_blocks
        self.block_size = int(block_size)
        # LIFO stack, low ids on top: the first allocs hand out 1, 2, ...
        self._free = list(range(num_blocks - 1, 0, -1))
        self._held: set = set()
        self.alloc_count = 0
        self.free_count = 0
        self.high_water = 0
        # device bytes one page costs across all layers (k + v), set by
        # the owning engine from its pools
        self.bytes_per_page = None

    @property
    def usable(self):
        return self.num_blocks - 1

    def available(self):
        return len(self._free)

    def in_use(self):
        return len(self._held)

    def utilization(self):
        return len(self._held) / max(self.usable, 1)

    def alloc(self, n):
        """n page ids, or OutOfBlocks (the pool is untouched on
        failure)."""
        n = int(n)
        if n < 0:
            raise ValueError(f'cannot allocate {n} pages')
        if n > len(self._free):
            raise OutOfBlocks(
                f'need {n} page(s), {len(self._free)} free '
                f'({len(self._held)}/{self.usable} in use)')
        pages = [self._free.pop() for _ in range(n)]
        self._held.update(pages)
        self.alloc_count += n
        self.high_water = max(self.high_water, len(self._held))
        return pages

    def free(self, pages):
        """Return pages to the free list. Freeing a page that is not held
        (double free, foreign id, the scratch page) raises."""
        pages = list(pages)
        if len(set(pages)) != len(pages) or not self._held.issuperset(pages):
            raise ValueError(f'pages {pages} are not all currently '
                             f'allocated (double-free or foreign id)')
        self._held.difference_update(pages)
        self._free.extend(pages)
        self.free_count += len(pages)

    def stats(self):
        s = {'num_blocks': self.num_blocks, 'block_size': self.block_size,
             'in_use': self.in_use(), 'free': self.available(),
             'utilization': round(self.utilization(), 4),
             'high_water': self.high_water, 'allocs': self.alloc_count,
             'frees': self.free_count}
        if self.bytes_per_page:
            bpp = int(self.bytes_per_page)
            s.update(bytes_per_page=bpp, bytes_total=self.num_blocks * bpp,
                     bytes_in_use=self.in_use() * bpp,
                     bytes_high_water=self.high_water * bpp)
        return s


class Request:
    """One serving request. `generated` accumulates committed tokens
    across admissions (a preempted request keeps its prefix and resumes
    by re-prefill over prompt + prefix). Terminal states: `finished`
    (`result` holds the output ids) and `failed` (`reason`, `error`)."""

    __slots__ = ('rid', 'prompt', 'max_new_tokens', 'priority', 'generated',
                 'seq', 'state', 'admit_seq', 'reason', 'error', 'result')

    def __init__(self, rid, prompt, max_new_tokens, priority):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.generated: list = []
        self.seq = None          # arrival order, stamped by RequestQueue
        self.admit_seq = None    # last admission order (preemption ties)
        self.state = 'queued'
        self.reason = None
        self.error = None
        self.result = None

    @property
    def remaining(self):
        return self.max_new_tokens - len(self.generated)

    @property
    def context_len(self):
        return len(self.prompt) + len(self.generated)


class RequestQueue:
    """Admission queue: higher `priority` first, FIFO within a priority.
    A preempted request keeps its arrival seq, so it resumes ahead of
    later arrivals of the same priority."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, req):
        if req.seq is None:
            req.seq = next(self._seq)
        if req.state != 'preempted':
            req.state = 'queued'
        heapq.heappush(self._heap, (-req.priority, req.seq, req))

    def peek(self):
        return self._heap[0][2] if self._heap else None

    def pop(self):
        return heapq.heappop(self._heap)[2]

    def __len__(self):
        return len(self._heap)

    def __iter__(self):
        """Requests in pop order."""
        return (r for _, _, r in sorted(self._heap))


# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------

def _pool_quant(pages):
    """Whether the page pools are int8 (QuantPagedKVCache: per-row scale
    pools ride with the pages)."""
    return isinstance(pages[0], QuantPagedKVCache)


def _tmp_cache(model, pages, K, Sb):
    """The throwaway contiguous cache of an admission prefill, in the
    pools' quantization: (k, v) pairs of the model's dtype for float
    pools; a RowQuantKVCache for int8 pools, so the prefill writes rows
    with the pools' per-row rule and attends exactly the int8 values a
    paged decode step will."""
    if _pool_quant(pages):
        _, Hkv, _, D = pages[0].kp.shape
        dev = pages[0].kp.device

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        return [RowQuantKVCache(z((K, Sb, Hkv, D), torch.int8),
                                z((K, Sb, Hkv, D), torch.int8),
                                z((K, Sb, Hkv), torch.float32),
                                z((K, Sb, Hkv), torch.float32))
                for _ in pages]
    return model.init_cache(K, Sb)


def _pool_scatter(pc, tmp_entry, pflat, sflat):
    """Write one layer's contiguous temp-cache rows into its page pool at
    the flat (page, slot) targets, in place. Int8 pools take the int8
    bytes and the per-row scales as they are: no second quantization."""
    n = pflat.shape[0]
    if isinstance(pc, QuantPagedKVCache):
        kq, vq, ks, vs = tmp_entry
        rows, srows = (n,) + tuple(kq.shape[2:]), (n,) + tuple(ks.shape[2:])
        pc.kp[pflat, :, sflat, :] = kq.reshape(rows)
        pc.vp[pflat, :, sflat, :] = vq.reshape(rows)
        pc.ks[pflat, :, sflat] = ks.reshape(srows)
        pc.vs[pflat, :, sflat] = vs.reshape(srows)
        return
    k, v = tmp_entry
    rows = (n,) + tuple(k.shape[2:])
    pc.kp[pflat, :, sflat, :] = k.reshape(rows).to(pc.kp.dtype)
    pc.vp[pflat, :, sflat, :] = v.reshape(rows).to(pc.vp.dtype)


def _prefill_kv(model, pages, ids, real_len, btabs):
    """Batched admission prefill into pages: run the model once over the
    RIGHT-padded prompts ids (K, Sb) with a throwaway contiguous cache
    (causal masked attention — pad rows come after the real tokens, so
    real rows never see them), then scatter every K/V row into its
    request's pages: row s of request b lands in page
    btabs[b, s // BS] slot s % BS; pad rows land on the scratch page 0.
    Returns (each request's last-token logits (K, V), pages)."""
    K, Sb = ids.shape
    tmp = _tmp_cache(model, pages, K, Sb)
    logits, tmp = model(ids, caches=tmp, cache_index=0)
    rl = real_len.long()
    last = logits[torch.arange(K, device=ids.device), (rl - 1).clamp_min(0)]
    bs = pages[0].kp.shape[2]
    maxb = btabs.shape[1]
    s = torch.arange(Sb, device=ids.device)
    blk = (s // bs).clamp(max=maxb - 1)
    page = torch.where(s[None, :] < rl[:, None], btabs[:, blk].long(), 0)
    pflat = page.reshape(-1)
    sflat = (s % bs).expand(K, Sb).reshape(-1)
    for t, pc in zip(tmp, pages):
        _pool_scatter(pc, t, pflat, sflat)
    return last, pages


def _window(model, pages, last_logits, btab, ctx, live, budget, *, window,
            eos_token_id):
    """One greedy decode window for the whole fixed-slot batch: per step,
    choose every slot's next token from the carried logits (argmax),
    then step the model over the paged caches (per-row write positions
    ctx, attention through the block tables) and advance the committed
    length of the rows that committed. Rows freeze when they hit eos,
    burn their budget, or were never live: frozen rows still ride
    through the forward but commit nothing. Returns (tokens (SLOTS,
    window), last_logits, pages)."""
    pad_tok = eos_token_id if eos_token_id is not None else 0
    finished = ~live
    toks = []
    for t in range(window):
        tok = last_logits.float().argmax(-1)
        frozen = finished | (t >= budget)
        tok = torch.where(frozen, pad_tok, tok)
        commit = ~frozen
        if eos_token_id is not None:
            finished = finished | (commit & (tok == eos_token_id))
        logits, pages = model(tok[:, None], caches=pages, kv_write_pos=ctx,
                              block_tables=btab)
        ctx = ctx + commit.to(ctx.dtype)
        last_logits = logits[:, -1, :]
        toks.append(tok)
    return torch.stack(toks, 1), last_logits, pages


class ServingEngine:
    """Continuous-batching greedy serving over one model.

        engine = ServingEngine(model, max_slots=8, max_new_tokens=64,
                               eos_token_id=2)
        rid = engine.submit(prompt_ids)          # 1-D int array
        engine.run()                             # drain queue + batch
        out = engine.result(rid)                 # (S + max_new,) ids

        outs = engine.serve(list_of_prompts)     # submit + run + collect

    Runs on the model's device. The model must take `block_tables` and
    `kv_write_pos` in its cached forward (the Llama family does).
    `kv_cache_dtype`: None (the model's dtype), 'bfloat16', or 'int8'
    (int8 pages with per-row scales)."""

    def __init__(self, model, max_slots=8, block_size=16, num_blocks=None,
                 max_context_len=None, max_new_tokens=32, decode_window=8,
                 eos_token_id=None, buckets=None, kv_cache_dtype=None):
        if getattr(model.config, 'sliding_window', None) is not None:
            raise NotImplementedError(
                'sliding-window models are not paged-servable yet')
        kv_dtypes = {'int8': torch.int8, torch.int8: torch.int8,
                     'bfloat16': torch.bfloat16,
                     torch.bfloat16: torch.bfloat16}
        if kv_cache_dtype is not None and kv_cache_dtype not in kv_dtypes:
            raise ValueError(
                f"kv_cache_dtype must be None, 'int8', or 'bfloat16', got "
                f"{kv_cache_dtype!r}")
        self.kv_cache_dtype = (None if kv_cache_dtype is None
                               else kv_dtypes[kv_cache_dtype])
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_new_tokens = int(max_new_tokens)
        self.decode_window = int(decode_window)
        if self.decode_window < 1 or self.max_slots < 1:
            raise ValueError('decode_window and max_slots must be >= 1')
        self.eos_token_id = (int(eos_token_id) if eos_token_id is not None
                             else None)
        self.buckets = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        if max_context_len is None:
            max_context_len = int(getattr(model.config,
                                          'max_position_embeddings', 2048))
        self.max_context_len = int(max_context_len)
        self.max_blocks_per_seq = _ceil_div(self.max_context_len,
                                            self.block_size)
        if num_blocks is None:
            # every slot can hold a max-length request, plus the scratch
            # page; pass a smaller pool to exercise preemption
            num_blocks = self.max_slots * self.max_blocks_per_seq + 1
        self.allocator = BlockAllocator(num_blocks, self.block_size)
        self.queue = RequestQueue()

        # device state, allocated once
        self._pages = model.init_paged_cache(num_blocks, self.block_size,
                                             dtype=self.kv_cache_dtype)
        self._last_logits = torch.zeros(
            (self.max_slots, model.config.vocab_size),
            dtype=model.cache_dtype(), device=self.device)
        # one page across every layer and every pool field (an int8
        # pool's scale rows included)
        self.allocator.bytes_per_page = sum(
            f[0].numel() * f.element_size() for pc in self._pages
            for f in pc)

        # host-authoritative per-slot state (uploaded each window)
        self._slot_req: list = [None] * self.max_slots
        self._slot_pages: list = [[] for _ in range(self.max_slots)]
        self._btab = np.zeros((self.max_slots, self.max_blocks_per_seq),
                              np.int32)
        self._ctx = np.zeros((self.max_slots,), np.int32)
        self._budget = np.zeros((self.max_slots,), np.int32)

        # every submitted request is in `_live` (queued / running /
        # preempted) or `_terminal` (finished / failed, popped by
        # result())
        self._rid = 0
        self._live: dict = {}
        self._terminal: dict = {}
        self.counts = {'finished': 0, 'failed': 0}
        self._admit_seq = itertools.count()
        self.preemption_count = 0
        self.steps = 0
        # model calls, by kind: what the kernels' launch counts follow
        # (a decode forward runs the paged-attention kernel once per
        # layer; every forward runs 2 * layers + 1 RMSNorms)
        self.prefill_forwards = 0
        self.decode_forwards = 0
        self._tokens_out = 0
        self._serve_time = 0.0

    # -- bookkeeping -------------------------------------------------------

    def in_flight(self):
        return sum(r is not None for r in self._slot_req)

    def stats(self):
        return {
            'tokens_generated': self._tokens_out,
            'tokens_per_s': (self._tokens_out / self._serve_time
                             if self._serve_time > 0 else 0.0),
            'serve_time_s': self._serve_time,
            'steps': self.steps,
            'prefill_forwards': self.prefill_forwards,
            'decode_forwards': self.decode_forwards,
            'in_flight': self.in_flight(),
            'queue_depth': len(self.queue),
            'preemptions': self.preemption_count,
            **self.counts,
            'blocks': self.allocator.stats(),
        }

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens=None, priority=0):
        """Queue one request; returns its id for `result()`. A request
        that can never fit (longer than max_context_len, or more pages
        than the whole pool) is refused here."""
        mnt = (self.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        if mnt < 1:
            raise ValueError('max_new_tokens must be >= 1')
        plen = int(np.size(prompt))
        if plen == 0:
            raise ValueError('empty prompt')
        total = plen + mnt
        if total > self.max_context_len:
            raise ValueError(
                f'prompt + max_new_tokens = {total} exceeds '
                f'max_context_len {self.max_context_len}')
        if _ceil_div(total, self.block_size) > self.allocator.usable:
            raise ValueError(
                f'request needs {_ceil_div(total, self.block_size)} '
                f'pages but the pool only has {self.allocator.usable} '
                f'usable — grow num_blocks')
        req = Request(self._rid, prompt, mnt, priority)
        self._rid += 1
        self._live[req.rid] = req
        self.queue.push(req)
        return req.rid

    def result(self, rid):
        """The outcome of a request, handed over once: the
        (prompt + max_new_tokens) ids when finished; raises
        RequestFailed when it failed; None while it is still pending;
        KeyError for an unknown or already retrieved rid."""
        req = self._terminal.pop(rid, None)
        if req is None:
            if rid in self._live:
                return None
            raise KeyError(rid)
        if req.state == 'finished':
            return req.result
        raise RequestFailed(rid, req.reason, error=req.error)

    def serve(self, prompts, max_new_tokens=None):
        """Submit + run + collect, in submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        self.run()
        return [self.result(r) for r in rids]

    def run(self, max_steps=None):
        """Step until queue and batch drain (or max_steps)."""
        steps = 0
        while len(self.queue) or self.in_flight():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    @torch.no_grad()
    def step(self):
        """One iteration: admit queued requests into free slots, top up
        pages for the coming window (preempting if the pool is dry),
        prefill the admitted prompts into their pages, decode one window
        over all slots, then commit tokens and retire finished rows from
        the one host read of the window. Returns the requests that
        finished this step."""
        t0 = time.perf_counter()
        try:
            return self._step_impl()
        finally:
            self.steps += 1
            self._serve_time += time.perf_counter() - t0

    def _step_impl(self):
        groups = self._admit()
        if not self.in_flight():
            return []
        self._ensure_window_pages()
        if not self.in_flight():
            return []
        for Sb, group in groups:
            # the top-up may have preempted a request admitted this step
            group = [(s, r) for s, r in group if self._slot_req[s] is r]
            if group:
                self._prefill_group(Sb, group)
        W = self.decode_window
        dev = self.device
        live = np.asarray([r is not None for r in self._slot_req])
        toks, self._last_logits, self._pages = _window(
            self.model, self._pages, self._last_logits,
            torch.as_tensor(self._btab, device=dev),
            torch.as_tensor(self._ctx, device=dev),
            torch.as_tensor(live, device=dev),
            torch.as_tensor(self._budget, device=dev),
            window=W, eos_token_id=self.eos_token_id)
        self.decode_forwards += W
        tokens = toks.cpu().numpy()        # the one host read per window
        finished = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            take = min(W, req.remaining)
            committed = []
            for t in range(take):
                tok = int(tokens[slot, t])
                committed.append(tok)
                if self.eos_token_id is not None and tok == self.eos_token_id:
                    break
            req.generated.extend(committed)
            self._ctx[slot] += len(committed)
            # the next window's budget is the current remaining, so a row
            # can never commit past its max_new_tokens on the device
            self._budget[slot] = req.remaining
            self._tokens_out += len(committed)
            if (req.remaining == 0
                    or (self.eos_token_id is not None and committed
                        and committed[-1] == self.eos_token_id)):
                self._finish(slot, req)
                finished.append(req)
        return finished

    # -- internals ---------------------------------------------------------

    def _free_slots(self):
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admit(self):
        """Fill free slots from the queue head (priority order: a head
        that cannot get its pages waits, nothing barges past it). Returns
        this step's admissions grouped by prefill bucket, largest group
        first."""
        if not len(self.queue):
            return []
        free = self._free_slots()
        placed = []
        a = self.allocator
        while free and len(self.queue):
            req = self.queue.peek()
            need = _ceil_div(req.context_len, self.block_size)
            if need > a.available():
                break
            self.queue.pop()
            slot = free.pop(0)
            self._place(slot, req, a.alloc(need))
            placed.append((slot, req))
        by_bucket: dict = {}
        for slot, req in placed:
            Sb = bucket_length(req.context_len, self.buckets)
            by_bucket.setdefault(Sb, []).append((slot, req))
        return sorted(by_bucket.items(), key=lambda kv: -len(kv[1]))

    def _place(self, slot, req, pages):
        """Arm a slot (host bookkeeping; `_prefill_group` moves the KV)."""
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        self._btab[slot] = 0
        self._btab[slot, :len(pages)] = pages
        self._ctx[slot] = req.context_len
        self._budget[slot] = req.remaining
        req.state = 'running'
        req.admit_seq = next(self._admit_seq)

    def _prefill_group(self, Sb, group):
        """Prefill one admission group (one bucket) into its pages and
        commit each request's next-token logits to its slot's row."""
        dev = self.device
        ids = np.zeros((len(group), Sb), np.int64)
        real_len = np.zeros((len(group),), np.int64)
        btabs = np.zeros((len(group), self.max_blocks_per_seq), np.int32)
        for i, (slot, req) in enumerate(group):
            toks = np.concatenate([req.prompt,
                                   np.asarray(req.generated, np.int32)])
            ids[i, :len(toks)] = toks                         # RIGHT-pad
            real_len[i] = len(toks)
            btabs[i] = self._btab[slot]
        last, self._pages = _prefill_kv(
            self.model, self._pages, torch.as_tensor(ids, device=dev),
            torch.as_tensor(real_len, device=dev),
            torch.as_tensor(btabs, device=dev))
        self.prefill_forwards += 1
        slots = torch.as_tensor([s for s, _r in group], device=dev)
        self._last_logits[slots] = last.to(self._last_logits.dtype)

    def _ensure_window_pages(self):
        """Every live slot must own pages covering the positions the
        coming window can write (ctx .. ctx + min(window, remaining)). A
        dry pool preempts the lowest-priority / youngest request until
        the top-up fits (the needy slot may evict itself). A slot whose
        top-up still fails once it is the only request left is
        unservable: that request fails alone."""
        a = self.allocator
        for slot in range(self.max_slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            target = _ceil_div(
                int(self._ctx[slot]) + min(self.decode_window,
                                           req.remaining),
                self.block_size)
            while (self._slot_req[slot] is req
                   and target > len(self._slot_pages[slot])):
                try:
                    new = a.alloc(target - len(self._slot_pages[slot]))
                except OutOfBlocks as e:
                    others = any(r is not None and s != slot
                                 for s, r in enumerate(self._slot_req))
                    if others and self._preempt_one():
                        continue
                    self._clear_slot(slot)
                    self._retire(
                        req, 'failed',
                        reason=f'unservable: window page top-up failed '
                               f'after maximal preemption ({e})',
                        error=e)
                    break
                pages = self._slot_pages[slot]
                self._btab[slot, len(pages):len(pages) + len(new)] = new
                pages.extend(new)

    def _preempt_one(self):
        """Evict the lowest-priority (then youngest) in-flight request
        back to the queue with its generated prefix. Returns False when
        nothing is in flight."""
        victims = [(req.priority, -req.admit_seq, slot)
                   for slot, req in enumerate(self._slot_req)
                   if req is not None]
        if not victims:
            return False
        _, _, slot = min(victims)
        self._demote(slot, self._slot_req[slot])
        return True

    def _demote(self, slot, req):
        self._clear_slot(slot)
        req.state = 'preempted'
        self.preemption_count += 1
        self.queue.push(req)

    def _retire(self, req, state, reason=None, error=None, result=None):
        """Move a request to its terminal state ('finished' / 'failed')
        and park it for one `result()` retrieval."""
        req.state = state
        req.reason = reason
        req.error = error
        if result is not None:
            req.result = result
        self.counts[state] += 1
        self._live.pop(req.rid, None)
        self._terminal[req.rid] = req

    def _finish(self, slot, req):
        pad = self.eos_token_id if self.eos_token_id is not None else 0
        gen = (req.generated
               + [pad] * (req.max_new_tokens - len(req.generated)))
        out = np.concatenate([req.prompt, np.asarray(gen, req.prompt.dtype)])
        self._clear_slot(slot)
        self._retire(req, 'finished', result=out)

    def _clear_slot(self, slot):
        self.allocator.free(self._slot_pages[slot])
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._btab[slot] = 0
        self._ctx[slot] = 0
        self._budget[slot] = 0


__all__ = ['ServingEngine', 'BlockAllocator', 'RequestQueue', 'Request',
           'OutOfBlocks', 'RequestFailed']
