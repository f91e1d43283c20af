"""ServingEngine — continuous batching over a paged KV-cache block pool
(counterpart of the core scheduler of paddle_tpu/inference/serving.py).

  1. `BlockAllocator` owns a pool of fixed-size KV pages shared by all
     in-flight requests: a free list of page ids, reused LIFO, page 0
     reserved as the scratch page that inactive rows write to, and a
     refcount per held page. The page pools are allocated once per
     engine and never resized; allocation is id bookkeeping only.

  2. `ServingEngine.step()` is one scheduler iteration over a fixed-slot
     batch (`max_slots` rows): admit queued requests into free slots
     (their prompts prefill into freshly allocated pages, grouped by
     prompt-length bucket), advance every slot that is mid chunked
     prefill by one chunk, make sure every decoding slot owns the pages
     its next window can write, then decode `decode_window` tokens for
     every slot — each step one model call over the paged pools, whose
     attention is the paged-decode kernel on the card — and read the
     emitted tokens back once per window.

  3. Per-request sampling: `submit(temperature=, top_k=, top_p=, seed=)`
     (engine defaults: greedy). The window chooses each row's token
     under its own parameters, uploaded as (SLOTS,) tensors: argmax for
     temperature 0, else Gumbel-max over the row's filtered, tempered
     logits, with uniforms hashed on the device from (request seed,
     generated-token index, vocab id). A row's draw depends on nothing
     else — not its batch, slot, preemption or how many windows ran —
     so a resumed request replays the uninterrupted stream. The hash
     is the port's own: sampled streams do not equal the JAX engine's
     (threefry) draws, only their distribution does.

  4. Prefix caching (`prefix_cache=True`): a page holding a full block
     of prompt tokens is indexed under the chain hash of the prompt up
     to it (`prompt_page_hashes`); a later prompt with the same leading
     pages shares them (refcount + 1) and prefills only the rest. A
     page whose last holder leaves stays indexed on an LRU of cached
     pages, harvested oldest first only when the free list is dry. A
     prompt every cached page covers recomputes its last token into a
     copy-on-write copy of the boundary page.

  5. Chunked prefill (`prefill_chunk=N`): a context longer than N past
     its prefix hit prefills N tokens per step, each chunk one forward
     over the row's prefix gathered out of its pages with per-row write
     offsets (`kv_write_pos`, the plain masked attention), its new rows
     scattered back; the slot rides the step's window frozen on the
     scratch page until its last chunk commits its logits, and decodes
     its first window in that same step.

  6. Preemption: when the pool runs dry, the lowest-priority (then
     youngest) in-flight request is evicted; its page references are
     dropped (a shared or indexed page outlives it) and it goes back to
     the queue with its generated prefix, and later resumes by
     re-prefilling prompt + prefix (its prompt pages can hit the cache).
     The resumed stream is the uninterrupted one.

  7. int8 KV (`kv_cache_dtype='int8'`): the pools hold int8 codes with a
     float32 scale per written row (`QuantPagedKVCache`); a row's codes
     and scale are a pure function of its values, so a re-prefill after
     preemption rewrites the same bytes and streams stay the
     uninterrupted ones. Every multi-token forward (the admission
     prefill, a chunk over a gathered prefix) writes into a
     `RowQuantKVCache` with the same per-row rule and attends its rows
     dequantized; its bytes and scales are copied into the pages as
     they are. Decode steps run the paged kernel's per-row int8 mode.

  8. Speculative decoding (`draft=`, `num_draft_tokens=k`): every step
     without a chunk runs a propose / verify window instead of a decode
     window. The draft keeps its own page pools under the same block
     tables (one allocator serves both) and proposes k tokens in k + 1
     one-token paged steps; the target verifies each row's (k + 1)
     tokens in one forward over its pages gathered into a contiguous
     cache; greedy rows accept the longest prefix the target's argmax
     agrees with, sampled rows run the rejection-sampling coin (a
     uniform from the same device-side hash) and resample the residual;
     only the committed rows' target K/V are scattered back. The
     verify's next choice is carried on the request (`spec_next`), so a
     chunk step's window and a resumed request commit it first. Greedy
     streams equal the non-speculative engine's; rows whose tokens a
     chunk step's plain window committed catch the draft's pages up
     before the next speculative window.

  9. The compiled dispatches: every device body of a step is captured
     as a CUDA graph once per geometry and replayed over the pools it
     captured (`inference/graphs.py`): the admission prefill of each
     bucket (the target's, and the draft's KV-only one), the chunk
     forward of each (chunk bucket, bucket of the farthest end) pair
     (the target's, and the draft's, which also runs its catch-up),
     the decode window (greedy or sampled, with or without the carried
     token of a speculative engine) and the speculative window (greedy
     or sampled, per verify ctx bucket, writing the draft's pools too).
     The admission and chunk bodies run at a fixed width per graph,
     the group's row count rounded up to a power of two (at most
     max_slots; the JAX package's run max_slots rows always, which
     makes a lone admission pay for the whole batch): rows past the
     group are dummies (length 0 on the scratch page, slot index SLOTS,
     which commits no logits) and a row with no copy on write carries
     the pair (0, 0). A warm-up captures every width.
     The slots, window, k, table width, eos and pool dtype are the
     engine's. Each body's inputs are uploaded into its graph's
     buffers; the prefill and chunk bodies commit logits into the
     engine's carried-logits buffer, and the windows' carried logits
     are copied out into it. A first use mid-serving, or `warmup()`
     before the first request, captures over an all-dummy batch on the
     scratch page of every pool, so it touches no live page. A
     `serve_step` is the prefill of its bucket then the window, a
     `serve_spec_step` both models' prefills then the speculative
     window, a `serve_chunk_step` the chunk then the window.

Per request, `result(rid)` is what the JAX engine returns: the prompt,
then `max_new_tokens` tokens, padded with eos after an early stop.
Deadlines, load shedding, snapshot/restore, tensor parallelism,
telemetry, the fault seams and persisted AOT artifacts are not ported
yet: their arguments and methods raise NotImplementedError.
"""
from __future__ import annotations

import functools
import hashlib
import heapq
import inspect
import itertools
import time

import numpy as np
import torch

from ..models.generation import (QuantPagedKVCache, RowQuantKVCache,
                                 filter_logits_batched)
from .engine import DEFAULT_BUCKETS, bucket_length
from .graphs import (GraphRunner, bucket_ladder, for_serving_engine,
                     geometry_parts, warmup_report)


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


class InvalidSamplingParams(ValueError):
    """`submit()` refused a request's sampling parameters (temperature
    < 0, top_p outside (0, 1]) before copying its prompt. top_k is
    clamped to the vocabulary instead."""


def _ceil_div(a, b):
    return -(-a // b)


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV-cache pages, with a
    refcount per held page and a prefix index.

    Page 0 is reserved as the scratch page, so usable capacity is
    num_blocks - 1 and every handed-out id is >= 1. Freed ids are reused
    LIFO (most recently freed first — deterministic).

    Prefix caching: `register_prefix` binds a held page that holds a
    full block of prompt-token KV to its chain hash (first writer wins);
    `match_prefix` walks a prompt's chain hashes to the longest indexed
    run; `share` takes one more reference on each of those pages. A page
    whose last reference is freed stays indexed on an LRU of cached
    pages; `alloc` harvests that LRU oldest first only once the free
    list is dry, so caching never shrinks the allocatable pool. `cow`
    hands a writer a fresh page for a shared one (the caller copies the
    rows and keeps its reference on the source until the copy ran)."""

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
        self._ref: dict = {}             # held page -> refcount
        self._index: dict = {}           # chain hash -> page
        self._hash_of: dict = {}         # indexed page -> chain hash
        # refcount-0 indexed pages, oldest first (insertion order)
        self._cached: dict = {}
        self.alloc_count = 0
        self.free_count = 0
        self.high_water = 0
        self.cow_count = 0
        self.prefix_shares = 0
        self.prefix_evictions = 0
        # device bytes one page costs across all layers (k + v), set by
        # the owning engine from its pools
        self.bytes_per_page = None

    @property
    def usable(self):
        return self.num_blocks - 1

    def available(self):
        """Pages an alloc can hand out: the free list and the cached
        refcount-0 prefix pages."""
        return len(self._free) + len(self._cached)

    def in_use(self):
        return len(self._ref)

    def cached(self):
        return len(self._cached)

    def shared(self):
        """Held pages with more than one reference."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, page):
        return self._ref.get(page, 0)

    def utilization(self):
        return len(self._ref) / max(self.usable, 1)

    def alloc(self, n):
        """n page ids, or OutOfBlocks (the pool is untouched on
        failure). When the free list alone cannot cover n, cached prefix
        pages are unindexed oldest first to make up the rest."""
        n = int(n)
        if n < 0:
            raise ValueError(f'cannot allocate {n} pages')
        if n > self.available():
            raise OutOfBlocks(
                f'need {n} page(s), {self.available()} free '
                f'({len(self._ref)}/{self.usable} in use)')
        harvest = max(0, n - len(self._free))
        for p in list(itertools.islice(self._cached, harvest)):
            self._unindex(p)
            del self._cached[p]
            self._free.append(p)
        self.prefix_evictions += harvest
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.alloc_count += n
        self.high_water = max(self.high_water, len(self._ref))
        return pages

    def free(self, pages):
        """Drop one reference per listed page. A page's last reference
        returns it to the free list, or to the cached LRU when it is
        indexed. Dropping more references than are held (double free,
        foreign id, the scratch page) raises, and nothing changes."""
        pages = list(pages)
        drops: dict = {}
        for p in pages:
            drops[p] = drops.get(p, 0) + 1
        if any(self._ref.get(p, 0) < k for p, k in drops.items()):
            raise ValueError(f'pages {pages} are not all currently '
                             f'allocated (double-free or foreign id)')
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p]:
                continue
            del self._ref[p]
            if p in self._hash_of:
                self._cached[p] = None           # LRU tail (newest)
            else:
                self._free.append(p)
        self.free_count += len(pages)

    def match_prefix(self, hashes):
        """Pages of the longest indexed leading run of `hashes` (held or
        cached now: `share` them before any other alloc)."""
        pages = []
        for h in hashes:
            p = self._index.get(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def share(self, pages):
        """One more reference on each page: held pages count up, cached
        ones come off the LRU. A free page raises (nothing changes)."""
        pages = list(pages)
        for p in pages:
            if p not in self._ref and p not in self._cached:
                raise ValueError(
                    f'page {p} is neither held nor cached — cannot share')
        for p in pages:
            if p in self._cached:
                del self._cached[p]
                self._ref[p] = 1
            else:
                self._ref[p] += 1
        self.prefix_shares += len(pages)
        self.high_water = max(self.high_water, len(self._ref))
        return pages

    def register_prefix(self, page, h):
        """Bind chain hash `h` to held `page`, whose full block of
        prompt-token KV is written. First writer wins: a bound hash
        keeps its page, and this one stays unindexed. Returns whether
        the binding was made."""
        if page not in self._ref:
            raise ValueError(f'page {page} is not allocated')
        if h in self._index:
            return False
        self._index[h] = page
        self._hash_of[page] = h
        return True

    def cow(self, page):
        """A fresh page for a writer of held `page`. The caller keeps its
        reference on `page` until the rows are copied: freed before, an
        indexed source could be harvested and overwritten first."""
        if page not in self._ref:
            raise ValueError(f'page {page} is not allocated — cannot CoW')
        new = self.alloc(1)[0]
        self.cow_count += 1
        return new

    def _unindex(self, page):
        h = self._hash_of.pop(page, None)
        if h is not None and self._index.get(h) == page:
            del self._index[h]

    def stats(self):
        s = {'num_blocks': self.num_blocks, 'block_size': self.block_size,
             'in_use': self.in_use(), 'free': self.available(),
             'utilization': round(self.utilization(), 4),
             'high_water': self.high_water, 'allocs': self.alloc_count,
             'frees': self.free_count}
        prefix = {'shared_pages': self.shared(),
                  'cached_pages': len(self._cached),
                  'indexed_pages': len(self._hash_of),
                  'cow_pages': self.cow_count,
                  'shares': self.prefix_shares,
                  'evictions': self.prefix_evictions}
        if self.bytes_per_page:
            bpp = int(self.bytes_per_page)
            s.update(bytes_per_page=bpp, bytes_total=self.num_blocks * bpp,
                     bytes_in_use=self.in_use() * bpp,
                     bytes_high_water=self.high_water * bpp)
            prefix.update(bytes_shared=prefix['shared_pages'] * bpp,
                          bytes_cached=prefix['cached_pages'] * bpp,
                          bytes_cow=prefix['cow_pages'] * bpp)
        s['prefix'] = prefix
        return s


# the JAX package's salt: equal prompts give equal digests in both
_PREFIX_SALT = b'paddle_tpu.prefix.v1'


def prompt_page_hashes(prompt, block_size):
    """Chain hashes of the full pages of `prompt`: one 16-byte blake2b
    digest per `block_size` int32 tokens, each over the previous digest
    and the page's bytes, so hash k stands for the whole prompt through
    page k."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    n = len(prompt) // block_size
    raw = np.ascontiguousarray(prompt[:n * block_size]).tobytes()
    step = 4 * block_size
    out = []
    h = _PREFIX_SALT
    for i in range(n):
        h = hashlib.blake2b(h + raw[i * step:(i + 1) * step],
                            digest_size=16).digest()
        out.append(h)
    return out


class Request:
    """One serving request. `generated` accumulates committed tokens
    across admissions (a preempted request keeps its prefix and resumes
    by re-prefill over prompt + prefix). `temperature` / `top_k` /
    `top_p` / `sample_seed` are its sampling parameters (temperature 0:
    greedy). `spec_next` is a speculative window's carried next token
    (the verify's choice, a rejection's resample included): the next
    window of either kind commits it first, and it survives preemption,
    so a resumed stream is the uninterrupted one. Terminal states:
    `finished` (`result` holds the output ids) and `failed` (`reason`,
    `error`)."""

    __slots__ = ('rid', 'prompt', 'max_new_tokens', 'priority', 'generated',
                 'seq', 'state', 'admit_seq', 'reason', 'error', 'result',
                 'temperature', 'top_k', 'top_p', 'sample_seed',
                 'page_hashes', 'spec_next')

    def __init__(self, rid, prompt, max_new_tokens, priority,
                 temperature=0.0, top_k=0, top_p=1.0, sample_seed=None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.sample_seed = int(rid if sample_seed is None else sample_seed)
        self.generated: list = []
        self.page_hashes = None  # the prompt's chain hashes, when needed
        self.spec_next = None
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

    def context(self):
        """Prompt + generated ids (what a re-prefill runs over)."""
        return np.concatenate([self.prompt,
                               np.asarray(self.generated, np.int32)])


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
# Sampling
# ---------------------------------------------------------------------------

# A sampled token's randomness is a hash of (request seed, generated-token
# index, sub-stream, vocab id), computed on the device in int64 tensors
# that hold 32-bit values: no generator state, so a resumed request
# re-derives exactly the uniforms of its uninterrupted run.
_SUB_PROPOSE = 0        # choosing a token (decode windows, draft proposals)
_SUB_ACCEPT = 1         # a speculative proposal's accept coin
_SUB_RESAMPLE = 2       # the resample after a speculative rejection
_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """x * c mod 2**32 for x in [0, 2**32) and a 32-bit constant c, in
    partial products below 2**49 (no int64 overflow)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """murmur3's 32-bit finalizer: a bijection with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _row_keys(seed, gen, sub):
    """One 32-bit key per row: the request seed (B,), then the row's
    generated-token index (B,), then the sub-stream id folded in."""
    k = _mix32((seed.to(torch.int64) ^ 0x9E3779B9) & _M32)
    k = _mix32(k ^ (gen.to(torch.int64) & _M32))
    return _mix32(k ^ int(sub))


def _gumbel(keys, V):
    """(B, V) standard Gumbel noise: a uniform in (0, 1) hashed from each
    row's key and the vocab id, then -log(-log(u))."""
    v = torch.arange(V, device=keys.device, dtype=torch.int64)
    h = _mix32(_mix32(keys[:, None] ^ _mul32(v, 0x9E3779B1)))
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _uniform(keys):
    """One uniform in (0, 1) per row key (the speculative accept coin)."""
    return ((_mix32(keys) >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _filtered(logits, temp, topk, topp):
    """Each row's logits in float32 over its temperature (rows with
    temperature 0 use 1: their choice is the argmax), then its top-k /
    nucleus filter."""
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    return filter_logits_batched(logits.float() / safe_t[:, None], topk,
                                 topp)


def _filtered_dist(logits, temp, topk, topp):
    """Each row's filtered, tempered sampling distribution (rows with
    temperature 0 use 1; their distribution is never consumed)."""
    return torch.softmax(_filtered(logits, temp, topk, topp), -1)


def _sample_rows_dist(logits, temp, topk, topp, keys):
    """Each row's next token: argmax where temp == 0, else Gumbel-max
    over its filtered, tempered logits (a draw from their softmax); and
    that softmax, from the same filter pass (a speculative proposal
    needs both)."""
    greedy = logits.float().argmax(-1)
    f = _filtered(logits, temp, topk, topp)
    sampled = (f + _gumbel(keys, f.shape[-1])).argmax(-1)
    return torch.where(temp > 0, sampled, greedy), torch.softmax(f, -1)


def _sample_rows(logits, temp, topk, topp, keys):
    """The token of `_sample_rows_dist`."""
    return _sample_rows_dist(logits, temp, topk, topp, keys)[0]


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


def _pool_scatter(pc, tmp_entry, pflat, sflat, take=None):
    """Write one layer's contiguous temp-cache rows into its page pool at
    the flat (page, slot) targets, in place. `take` (K, S) first picks
    row b's temp-cache columns take[b] (a chunk scatters only the rows
    it wrote). Int8 pools take the int8 bytes and the per-row scales as
    they are: no second quantization."""
    if take is not None:
        rows = torch.arange(take.shape[0], device=take.device)[:, None]
        tmp_entry = [f[rows, take] for f in tmp_entry]
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


def _pool_gather(pages, btabs, start, L):
    """Each row's committed prefix [0, start[b]) gathered out of its pages
    into a contiguous temp cache of length L (columns past start read the
    scratch page and are never attended). Float pools give (k, v) pairs
    of the pools' dtype; int8 pools their bytes and per-row scales as a
    RowQuantKVCache, so a continuation attends exactly the values a
    paged decode step would."""
    K, maxb = btabs.shape
    bs = pages[0].kp.shape[2]
    s = torch.arange(L, device=btabs.device)
    page = btabs.long()[:, (s // bs).clamp(max=maxb - 1)]
    page = torch.where(s[None, :] < start[:, None], page, 0)       # (K, L)
    slot = (s % bs).expand(K, L)
    if _pool_quant(pages):
        return [RowQuantKVCache(pc.kp[page, :, slot], pc.vp[page, :, slot],
                                pc.ks[page, :, slot], pc.vs[page, :, slot])
                for pc in pages]
    return [(pc.kp[page, :, slot], pc.vp[page, :, slot]) for pc in pages]


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


def _commit_rows(last_logits, last, slots):
    """Row i of `last` (K, V) into row slots[i] of the carried logits
    `last_logits` (SLOTS, V), in place. Rows whose slot index is SLOTS
    (dummy rows, chunks that do not end their context) write nothing:
    the JAX body drops them with an out-of-range scatter, which on the
    card would be a device assert, so each slot row selects its source
    row instead."""
    S, K = last_logits.shape[0], last.shape[0]
    hit = (slots.long()[None, :]
           == torch.arange(S, device=slots.device)[:, None])       # (S, K)
    src = (hit.long() * torch.arange(K, device=slots.device)).sum(1)
    last_logits.copy_(torch.where(hit.any(1)[:, None],
                                  last[src].to(last_logits.dtype),
                                  last_logits))


def _prefill_body(model, pages, last_logits, static):
    """`_prefill_kv` over a captured admission prefill's static buffers
    (ids, real_len, btabs at the graph's row width; dummy rows have
    length 0 and land on the scratch page), then each row's next-token
    logits into its slot's row of `last_logits` (None for the draft,
    whose logits are never kept)."""
    last, _ = _prefill_kv(model, pages, static['ids'], static['real_len'],
                          static['btabs'])
    if last_logits is not None:
        _commit_rows(last_logits, last, static['slots'])


def _chunk_kv(model, pages, ids, chunk_len, start, btabs, ctx_bucket,
              cow_src, cow_dst):
    """Chunked / continuation prefill into pages: row b owns positions
    [0, start[b]) in its pages (an earlier chunk's, or shared prefix
    pages) and appends its chunk ids[b, :chunk_len[b]] at positions
    start[b] + i, none past `ctx_bucket`. The copy-on-write pairs
    (K,) run first (page cow_dst[b] := cow_src[b] over every pool
    field, int8 scale rows included; a row with no copy carries (0, 0),
    a self-copy of the scratch page), so the gather and the scatter
    both see the private copies the block tables already name. Then
    each row's prefix is gathered into a contiguous cache of ctx_bucket
    positions and one throwaway column, the chunk runs with per-row
    write offsets (`kv_write_pos`: causal within the chunk, every
    prefix row visible; pad columns past ctx_bucket land on the
    throwaway column, which no real query attends: the JAX body drops
    them), and only the chunk's rows are scattered back (pad columns to
    the scratch page). Returns (each row's last-token logits (K, V),
    pages)."""
    K, Cb = ids.shape
    for pc in pages:
        for f in pc:
            f[cow_dst] = f[cow_src]
    tmp = _pool_gather(pages, btabs, start, ctx_bucket + 1)
    logits, tmp = model(ids, caches=tmp, kv_write_pos=start)
    cl = chunk_len.long()
    last = logits[torch.arange(K, device=ids.device), (cl - 1).clamp_min(0)]
    bs = pages[0].kp.shape[2]
    maxb = btabs.shape[1]
    i = torch.arange(Cb, device=ids.device)
    wpos = start.long()[:, None] + i[None, :]                       # (K, Cb)
    page = torch.gather(btabs.long(), 1, (wpos // bs).clamp(max=maxb - 1))
    page = torch.where(i[None, :] < cl[:, None], page, 0)
    pflat, sflat = page.reshape(-1), (wpos % bs).reshape(-1)
    take = wpos.clamp(max=ctx_bucket)
    for t, pc in zip(tmp, pages):
        _pool_scatter(pc, t, pflat, sflat, take=take)
    return last, pages


def _chunk_body(model, pages, last_logits, static, *, ctx_bucket):
    """`_chunk_kv` over a captured chunk's static buffers (the graph's
    row width; dummy rows have length 0 and a (0, 0) copy), then the
    logits of the rows whose chunk ends their context into their
    slots' rows of `last_logits` (the others carry slot index SLOTS;
    None for the draft)."""
    last, _ = _chunk_kv(model, pages, static['ids'], static['chunk_len'],
                        static['start'], static['btabs'], ctx_bucket,
                        static['cow_src'], static['cow_dst'])
    if last_logits is not None:
        _commit_rows(last_logits, last, static['slots'])


def _window(model, pages, last_logits, btab, ctx, live, budget, *, window,
            eos_token_id, sampling=None, forced_tok=None, forced=None):
    """One decode window for the whole fixed-slot batch: per step,
    choose every slot's next token from the carried logits, then step
    the model over the paged caches (per-row write positions ctx,
    attention through the block tables) and advance the committed
    length of the rows that committed. `sampling` None is greedy
    (argmax) for every row; else (temp, topk, topp, seed, plen) (SLOTS,)
    tensors, and each row chooses by `_sample_rows` keyed on its seed
    and generated-token index ctx - plen. `forced` (SLOTS,) bool marks
    the rows of a speculative engine that carry the verify's next
    choice `forced_tok` (SLOTS,): they commit it as their first token
    instead of choosing. Rows freeze when they hit eos, burn their
    budget, or were never live: frozen rows still ride through the
    forward but commit nothing. Returns (tokens (SLOTS, window),
    last_logits, pages)."""
    pad_tok = eos_token_id if eos_token_id is not None else 0
    finished = ~live
    toks = []
    for t in range(window):
        if sampling is None:
            tok = last_logits.float().argmax(-1)
        else:
            temp, topk, topp, seed, plen = sampling
            tok = _sample_rows(last_logits, temp, topk, topp,
                               _row_keys(seed, ctx - plen, _SUB_PROPOSE))
        if forced is not None and t == 0:
            tok = torch.where(forced, forced_tok, tok)
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


def _pool_tensors(pages):
    """Every tensor of the page pools (each layer's fields)."""
    return [f for pc in pages for f in pc]


def _window_sampling(static):
    """The sampling vectors of a captured window's static buffers, or
    None when its geometry is greedy."""
    if 'temp' not in static:
        return None
    return tuple(static[k] for k in ('temp', 'topk', 'topp', 'seed', 'plen'))


def _window_body(model, pages, static, *, window, eos_token_id):
    """`_window` over a captured window's static buffers: the sampling
    vectors when the geometry samples, the carried token when it has
    one. Returns (tokens (SLOTS, window), last_logits)."""
    sampling = _window_sampling(static)
    forced = {}
    if 'forced' in static:
        forced = dict(forced_tok=static['forced_tok'],
                      forced=static['forced'])
    toks, last, _ = _window(model, pages, static['last_logits'],
                            static['btab'], static['ctx'], static['live'],
                            static['budget'], window=window,
                            eos_token_id=eos_token_id, sampling=sampling,
                            **forced)
    return toks, last


def _spec_accept(drafts, pd, tlg, sampling, gen0):
    """The per-row commit rule of a speculative window over its verify
    logits tlg (K, k + 1, V) float32 and proposals drafts (K, k): greedy
    rows accept the longest prefix the target's argmax agrees with and
    carry its choice at the first disagreement. Sampled rows
    (`sampling` as in `_window`, pd (K, k, V) the draft's distributions,
    gen0 (K,) each row's generated-token index at the window's first
    token) accept proposal i when its coin, hashed from (seed, gen0 + i
    + 1), falls under min(1, pt / pd), and carry a resample from the
    normalised residual (pt - pd)+ at the first rejection (after a full
    accept pd pads with 0, so the residual is pt's bonus distribution).
    Returns (accepted count m (K,), next token (K,))."""
    K, k = drafts.shape
    rows = torch.arange(K, device=tlg.device)
    tchoice = tlg.argmax(-1)                                 # (K, k + 1)
    greedy_acc = drafts == tchoice[:, :k]
    if sampling is None:
        m = torch.cumprod(greedy_acc.long(), 1).sum(1)
        return m, tchoice[rows, m]
    temp, topk, topp, seed, _plen = sampling
    V = tlg.shape[-1]
    pt = _filtered_dist(tlg.reshape(K * (k + 1), V),
                        *(x.repeat_interleave(k + 1)
                          for x in (temp, topk, topp))).view(K, k + 1, V)
    px_t = torch.gather(pt[:, :k], 2, drafts[:, :, None])[..., 0]
    px_d = torch.gather(pd, 2, drafts[:, :, None])[..., 0]
    idx = gen0[:, None] + torch.arange(1, k + 1, device=tlg.device)
    u = _uniform(_row_keys(seed[:, None].expand(K, k), idx, _SUB_ACCEPT))
    samp_acc = u < torch.clamp(px_t / torch.clamp(px_d, min=1e-30),
                               max=1.0)
    acc = torch.where((temp > 0)[:, None], samp_acc, greedy_acc)
    m = torch.cumprod(acc.long(), 1).sum(1)
    pt_m = pt[rows, m]
    pd_m = torch.cat([pd, pd.new_zeros(K, 1, V)], 1)[rows, m]
    res = torch.clamp(pt_m - pd_m, min=0.0)
    rs = res.sum(-1, keepdim=True)
    res = torch.where(rs > 0, res / torch.clamp(rs, min=1e-30), pt_m)
    keys = _row_keys(seed, gen0 + m + 1, _SUB_RESAMPLE)
    sampled_next = (torch.log(res) + _gumbel(keys, V)).argmax(-1)
    return m, torch.where(temp > 0, sampled_next, tchoice[rows, m])


def _spec_window(target, draft, pages, dpages, last_logits, forced_tok,
                 forced, btab, ctx, live, budget, *, k, ctx_bucket,
                 eos_token_id, sampling=None):
    """One speculative propose / verify / commit window over the
    fixed-slot batch:

      1. candidate 0: the carried next token where `forced` (the
         verify's earlier choice, a rejection's resample included), else
         each row's choice off `last_logits`;
      2. the draft proposes k tokens in k + 1 one-token steps through
         its own pools under the same block tables and offsets ctx + i
         (the last step writes the k-th proposal's KV row), each
         proposal chosen under the row's sampling parameters;
      3. the target verifies each row's k + 1 tokens in one forward over
         its pages gathered into a contiguous cache of `ctx_bucket`
         positions (per-row write offsets, the plain masked attention);
      4. `_spec_accept`; the commit count m + 1 clamped by the row's
         budget, cut after its first eos, 0 for rows not live;
      5. only the committed rows' target K/V are scattered back into the
         pages (the rest to the scratch page), so the pages hold what a
         non-speculative engine would have written.

    The gathered verify cache is a temporary of the window (inside a
    capture, of the runner's memory pool, which every ctx bucket's
    graph shares). Returns (candidates (K, k + 1), commit counts (K,),
    next tokens (K,), last_logits): a row's committed tokens are its
    first commit-count candidates; its next token is the one the host
    carries on the request. The pools are written in place."""
    K = last_logits.shape[0]
    gen0 = None
    if sampling is None:
        cand0 = last_logits.float().argmax(-1)
    else:
        temp, topk, topp, seed, plen = sampling
        gen0 = ctx.long() - plen
        cand0 = _sample_rows(last_logits, temp, topk, topp,
                             _row_keys(seed, gen0, _SUB_PROPOSE))
    cand0 = torch.where(forced, forced_tok, cand0)
    tok, toks, pds = cand0, [], []
    for i in range(k + 1):
        dlogits, dpages = draft(tok[:, None], caches=dpages,
                                kv_write_pos=ctx + i, block_tables=btab)
        if i == k:
            break
        if sampling is None:
            tok = dlogits[:, -1].float().argmax(-1)
        else:
            tok, pd = _sample_rows_dist(
                dlogits[:, -1], temp, topk, topp,
                _row_keys(seed, gen0 + i + 1, _SUB_PROPOSE))
            pds.append(pd)
        toks.append(tok)
    drafts = torch.stack(toks, 1)                            # (K, k)
    window_ids = torch.cat([cand0[:, None], drafts], 1)      # (K, k + 1)
    tmp = _pool_gather(pages, btab, ctx, ctx_bucket)
    tlogits, tmp = target(window_ids, caches=tmp, kv_write_pos=ctx)
    tlg = tlogits.float()
    m, next_tok = _spec_accept(drafts, torch.stack(pds, 1) if pds else None,
                               tlg, sampling, gen0)
    nc = torch.minimum(m + 1, budget.long())
    if eos_token_id is not None:
        iseos = window_ids == eos_token_id
        first = iseos.long().argmax(1)
        nc = torch.where(iseos.any(1) & (first < nc), first + 1, nc)
    nc = torch.where(live, nc, 0)
    bs = pages[0].kp.shape[2]
    maxb = btab.shape[1]
    i = torch.arange(k + 1, device=ctx.device)
    wpos = ctx.long()[:, None] + i[None, :]                  # (K, k + 1)
    page = torch.gather(btab.long(), 1, (wpos // bs).clamp(max=maxb - 1))
    page = torch.where(i[None, :] < nc[:, None], page, 0)
    pflat, sflat = page.reshape(-1), (wpos % bs).reshape(-1)
    take = wpos.clamp(max=ctx_bucket - 1)
    for t, pc in zip(tmp, pages):
        _pool_scatter(pc, t, pflat, sflat, take=take)
    rows = torch.arange(K, device=ctx.device)
    last = tlg[rows, (nc - 1).clamp_min(0)]
    last_logits = torch.where(live[:, None], last.to(last_logits.dtype),
                              last_logits)
    return window_ids, nc, next_tok, last_logits


def _spec_window_body(target, draft, pages, dpages, static, *, k,
                      ctx_bucket, eos_token_id):
    """`_spec_window` over a captured speculative window's static
    buffers."""
    return _spec_window(target, draft, pages, dpages, static['last_logits'],
                        static['forced_tok'], static['forced'],
                        static['btab'], static['ctx'], static['live'],
                        static['budget'], k=k, ctx_bucket=ctx_bucket,
                        eos_token_id=eos_token_id,
                        sampling=_window_sampling(static))


# the JAX engine's arguments the port does not take yet, by feature
_UNPORTED = dict.fromkeys(('max_queue', 'admit_watermark', 'shed_policy'),
                          'load shedding')
_UNPORTED.update(dict.fromkeys(('mesh', 'tp'), 'tensor parallelism'))
_UNPORTED.update(dict.fromkeys(
    ('postmortem_dir', 'ops_port', 'ops_host', 'watchdog', 'slo_rules',
     'ts_interval_s', 'metrics_registry', 'journal'), 'telemetry'))


class ServingEngine:
    """Continuous-batching serving over one model.

        engine = ServingEngine(model, max_slots=8, max_new_tokens=64,
                               eos_token_id=2, prefix_cache=True,
                               prefill_chunk=256)
        rid = engine.submit(prompt_ids)          # 1-D int array
        rid2 = engine.submit(ids, temperature=0.8, top_p=0.95, seed=7)
        engine.run()                             # drain queue + batch
        out = engine.result(rid)                 # (S + max_new,) ids

        outs = engine.serve(list_of_prompts)     # submit + run + collect

    Runs on the model's device. The model must take `block_tables` and
    `kv_write_pos` in its cached forward (the Llama family does).
    `kv_cache_dtype`: None (the model's dtype), 'bfloat16', or 'int8'
    (int8 pages with per-row scales). `temperature` / `top_k` / `top_p`
    are the defaults of `submit`. `prefix_cache` shares the pages of
    equal prompt prefixes; `prefill_chunk` prefills long contexts that
    many tokens per step (both off by default). `draft` (a model of the
    same vocabulary on the same device) turns on speculative decoding
    with `num_draft_tokens` proposals a window."""

    def __init__(self, model, max_slots=8, block_size=16, num_blocks=None,
                 max_context_len=None, max_new_tokens=32, decode_window=8,
                 temperature=0.0, top_k=0, top_p=1.0, eos_token_id=None,
                 buckets=None, prefix_cache=False, prefill_chunk=None,
                 kv_cache_dtype=None, draft=None, num_draft_tokens=4,
                 **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f'ServingEngine got an unexpected keyword '
                                f'argument {name!r}')
            if value is not None:
                raise NotImplementedError(
                    f'{_UNPORTED[name]} ({name}=) is not ported yet')
        for m_, role in ((model, 'model'), (draft, 'draft')):
            if m_ is not None and 'block_tables' not in inspect.signature(
                    m_.forward).parameters:
                raise NotImplementedError(
                    f'{type(m_).__name__} lacks block_tables in its cached '
                    f'forward: paged serving needs the Llama-family '
                    f'cached_attention; use DecodeEngine for this {role}')
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
        self.draft = draft
        self.spec_window = None
        if draft is not None:
            self.spec_window = int(num_draft_tokens)
            if self.spec_window < 1:
                raise ValueError('num_draft_tokens must be >= 1')
            if draft.device != model.device:
                raise ValueError(
                    f'the draft is on {draft.device}, the model on '
                    f'{model.device}: both serve from one device')
            if getattr(draft.config, 'sliding_window', None) is not None:
                raise NotImplementedError(
                    'sliding-window models are not paged-servable yet')
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_new_tokens = int(max_new_tokens)
        self.decode_window = int(decode_window)
        if self.decode_window < 1 or self.max_slots < 1:
            raise ValueError('decode_window and max_slots must be >= 1')
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = (int(eos_token_id) if eos_token_id is not None
                             else None)
        self.buckets = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        self.prefix_cache = bool(prefix_cache)
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError('prefill_chunk must be >= 1 (or None)')
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
        # the draft's pools share the target's page ids (same num_blocks
        # and block_size, the same block tables): one allocator serves
        # both. The draft's logits are never kept.
        self._dpages = (None if draft is None else draft.init_paged_cache(
            num_blocks, self.block_size, dtype=self.kv_cache_dtype))
        # the carried next-token logits: engine-owned, written in place
        # (prefill and chunk rows, the window's output copied in)
        self._last_logits = torch.zeros(
            (self.max_slots, model.config.vocab_size),
            dtype=model.cache_dtype(), device=self.device)
        # the captured windows, one per geometry, over the weights of both
        # models: a replaced weight of either drops them
        self._graphs = GraphRunner(
            self.device,
            modules=[model] + ([draft] if draft is not None else []))
        # one page across every layer and every pool field (an int8
        # pool's scale rows included), the draft's pools' too
        self.allocator.bytes_per_page = sum(
            f[0].numel() * f.element_size()
            for pc in self._pages + (self._dpages or []) for f in pc)

        # host-authoritative per-slot state (uploaded each window)
        S = self.max_slots
        self._slot_req: list = [None] * S
        self._slot_pages: list = [[] for _ in range(S)]
        self._btab = np.zeros((S, self.max_blocks_per_seq), np.int32)
        self._ctx = np.zeros((S,), np.int32)
        self._budget = np.zeros((S,), np.int32)
        self._temp = np.zeros((S,), np.float32)
        self._topk = np.zeros((S,), np.int64)
        self._topp = np.ones((S,), np.float32)
        self._seed = np.zeros((S,), np.int64)
        self._plen = np.zeros((S,), np.int64)
        # prefill progress: None = decoding; an int = the context tokens
        # already in pages (the slot is mid chunked / continuation
        # prefill and rides the window frozen on the scratch page).
        # `_cow_pending` is the (src, dst) page copy its first chunk
        # makes; the slot holds a reference on src until then.
        self._pfill: list = [None] * S
        self._cow_pending: list = [None] * S
        # how much of each slot's context the DRAFT's pages hold (<=
        # _ctx): tokens a chunk step's plain window commits bypass the
        # draft, and the next speculative or chunk step catches it up
        # (without that it would propose against missing KV, and the
        # accept rate would collapse without any error)
        self._dctx = np.zeros((S,), np.int64)

        # every submitted request is in `_live` (queued / running /
        # preempted) or `_terminal` (finished / failed, popped by
        # result())
        self._rid = 0
        self._live: dict = {}
        self._terminal: dict = {}
        self.counts = {'finished': 0, 'failed': 0}
        self.prefix_counts = {'hits': 0, 'misses': 0, 'hits_skipped': 0,
                              'hit_tokens': 0, 'chunked_admissions': 0,
                              'chunk_steps': 0}
        self._admit_seq = itertools.count()
        self.preemption_count = 0
        self.steps = 0
        # model calls, by kind: what the kernels' launch counts follow
        # (a decode forward runs the paged-attention kernel once per
        # layer; every forward runs 2 * layers + 1 RMSNorms; prefill and
        # chunk forwards attend through the plain masked path)
        self.prefill_forwards = 0
        self.chunk_forwards = 0
        self.decode_forwards = 0
        self.verify_forwards = 0         # a speculative window's (k + 1)
        self.prefill_tokens = 0          # context tokens run through them
        # the draft's forwards, by kind (its one-token steps run the
        # paged-attention kernel, k + 1 per speculative window)
        self.draft_forwards = {'prefill': 0, 'chunk': 0, 'decode': 0}
        self.spec_counts = {'windows': 0, 'proposed': 0, 'accepted': 0}
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
            'chunk_forwards': self.chunk_forwards,
            'decode_forwards': self.decode_forwards,
            'prefill_tokens': self.prefill_tokens,
            'in_flight': self.in_flight(),
            'queue_depth': len(self.queue),
            'preemptions': self.preemption_count,
            **self.counts,
            'prefix': {'enabled': self.prefix_cache,
                       'prefill_chunk': self.prefill_chunk,
                       **self.prefix_counts,
                       **self.allocator.stats()['prefix']},
            # accept_rate: accepted draft tokens over proposed ones (None
            # before the first window)
            'spec': {'enabled': self.draft is not None,
                     'num_draft_tokens': self.spec_window,
                     'kv_cache_dtype': (
                         str(self.kv_cache_dtype).replace('torch.', '')
                         if self.kv_cache_dtype else None),
                     **self.spec_counts,
                     'accept_rate': (
                         self.spec_counts['accepted']
                         / self.spec_counts['proposed']
                         if self.spec_counts['proposed'] else None),
                     'verify_forwards': self.verify_forwards,
                     'draft_forwards': dict(self.draft_forwards)},
            'blocks': self.allocator.stats(),
            'graphs': self._graphs.stats(),
        }

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens=None, priority=0,
               deadline_s=None, temperature=None, top_k=None, top_p=None,
               seed=None):
        """Queue one request; returns its id for `result()`. Sampling
        parameters default to the engine's; `seed` (default: the rid)
        keys the request's random stream. Refused here, before the
        prompt is copied: temperature < 0 or top_p outside (0, 1]
        (InvalidSamplingParams), and a request that can never fit
        (longer than max_context_len, or more pages than the whole
        pool). top_k clamps to the vocabulary (<= 0 keeps all)."""
        if deadline_s is not None:
            raise NotImplementedError('deadlines (deadline_s=) are not '
                                      'ported yet')
        temperature = (self.temperature if temperature is None
                       else float(temperature))
        if temperature < 0:
            raise InvalidSamplingParams(
                f'temperature must be >= 0 (0 = greedy), got {temperature}')
        top_p = self.top_p if top_p is None else float(top_p)
        if not 0.0 < top_p <= 1.0:
            raise InvalidSamplingParams(
                f'top_p must be in (0, 1], got {top_p}')
        top_k = self.top_k if top_k is None else int(top_k)
        top_k = max(0, min(top_k, int(self.model.config.vocab_size)))
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
        req = Request(self._rid, prompt, mnt, priority,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      sample_seed=self._rid if seed is None else int(seed))
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

    def snapshot(self, *args):
        raise NotImplementedError('snapshot / restore is not ported yet')

    restore = snapshot

    def geometries(self, prompt_lens=None, max_new_tokens=None):
        """The geometries this engine's config implies, exactly as the
        JAX package enumerates them (`aot.geometry.for_serving_engine`,
        here `graphs.for_serving_engine`): `prompt_lens` are the
        admission context lengths the deployment declares (default
        every length up to max_context_len), `max_new_tokens` its
        budgets (default the engine's). `warmup` captures each."""
        return for_serving_engine(self, prompt_lens=prompt_lens,
                                  max_new_tokens=max_new_tokens)

    @torch.no_grad()
    def warmup(self, artifact=None, geometries=None):
        """Capture every geometry (default: `geometries()`) before the
        first request: the decode window greedy and sampled (on a
        speculative engine with the carried token) for `serve_window`;
        the admission prefill of its bucket (the draft's too on a
        speculative engine) for `serve_prefill`, and with the window for
        `serve_step`; the chunk of its (chunk, bucket) pair and the
        window for `serve_chunk_step`, on a speculative engine with the
        draft's chunk and its catch-up chunks (every chunk bucket up to
        bucket(decode_window)) at that bucket; the speculative window
        of its ctx bucket greedy and sampled for `serve_spec_window`,
        and with both models' prefills of its bucket for
        `serve_spec_step` (with the catch-up chunks at ctx when the
        engine chunks or caches prefixes). Each prefill and chunk is
        captured at every row width (`_row_width`). Returns the JAX
        package's report (`traces`: the graphs captured now). Raises
        RuntimeError while requests are in flight, as the JAX engine does;
        ValueError for a geometry enumerated for another window or k, a
        speculative kind on a plain engine, or an unknown kind;
        NotImplementedError for `artifact=` (a CUDA graph cannot be
        persisted) and for the KV-migration kinds (not ported). A
        geometry not warmed is captured at its first use."""
        if artifact is not None:
            raise NotImplementedError(
                'warmup(artifact=): a CUDA graph cannot be persisted; '
                'warmup() captures the geometries in this process')
        if self.in_flight():
            raise RuntimeError(
                f'cannot warm a ServingEngine with {self.in_flight()} '
                f'request(s) in flight: drain the batch (run()) before '
                f'warmup')
        geometries = list(self.geometries() if geometries is None
                          else geometries)
        t0 = time.perf_counter()
        n0 = self._graphs.captures
        for g in geometries:
            self._warm(*geometry_parts(g))
        return warmup_report(len(geometries), time.perf_counter() - t0,
                             self._graphs.captures - n0)

    def _warm(self, kind, params):
        """Capture the graphs of one geometry (see `warmup`)."""
        if int(params.get('window', self.decode_window)) \
                != self.decode_window:
            raise ValueError(
                f'geometry {params} was enumerated for another '
                f'decode_window; the engine has {self.decode_window}')
        if 'spec' in params:
            if self.draft is None:
                raise ValueError(
                    f'geometry {params} needs a speculative engine '
                    f'(construct with draft=...)')
            if int(params['spec']) != self.spec_window:
                raise ValueError(
                    f'geometry {params} was enumerated for '
                    f'num_draft_tokens {params["spec"]}; the engine has '
                    f'{self.spec_window}')
        if kind in ('serve_export', 'serve_import'):
            raise NotImplementedError(
                f'geometry kind {kind!r}: KV migration is not ported yet')
        if kind not in ('serve_window', 'serve_step', 'serve_prefill',
                        'serve_chunk_step', 'serve_spec_step',
                        'serve_spec_window'):
            raise ValueError(f'unknown serving geometry kind {kind!r}')
        for R in self._row_widths():
            if kind in ('serve_step', 'serve_prefill', 'serve_spec_step'):
                self._prefill_graph(int(params['bucket']), R)
                if self.draft is not None:
                    self._prefill_graph(int(params['bucket']), R, draft=True)
            if kind == 'serve_chunk_step':
                Cb, Sb = int(params['chunk']), int(params['bucket'])
                self._chunk_graph(Cb, Sb, R)
                if self.draft is not None:
                    self._chunk_graph(Cb, Sb, R, draft=True)
        if kind == 'serve_chunk_step' and self.draft is not None:
            self._warm_catchup(int(params['bucket']))
        if kind in ('serve_window', 'serve_step', 'serve_chunk_step'):
            for sampled in (False, True):
                self._window_graph(sampled)
        if kind in ('serve_spec_step', 'serve_spec_window'):
            for sampled in (False, True):
                self._spec_graph(int(params['ctx']), sampled)
            if self.prefill_chunk is not None or self.prefix_cache:
                self._warm_catchup(int(params['ctx']))

    def _warm_catchup(self, Sb):
        """The draft's catch-up chunks at ctx bucket `Sb`: a row's hole
        is at most one decode window, so every chunk bucket up to
        bucket(decode_window), at every row width."""
        for Cb in bucket_ladder(1, self.decode_window, self.buckets):
            for R in self._row_widths():
                self._chunk_graph(Cb, Sb, R, draft=True)

    def _window_inputs(self, live, sampled, forced=None):
        """A window's inputs from the host state: the carried logits,
        the slots' tables and committed lengths (rows not `live` frozen
        on the scratch page at 0), budgets, and the sampling vectors
        when it samples; on a speculative engine (or `forced`) the
        carried tokens, which the window commits first."""
        inputs = dict(last_logits=self._last_logits,
                      btab=np.where(live[:, None], self._btab, 0),
                      ctx=np.where(live, self._ctx, 0), live=live,
                      budget=self._budget)
        if sampled:
            inputs.update(temp=self._temp, topk=self._topk, topp=self._topp,
                          seed=self._seed, plen=self._plen)
        if forced is None:
            forced = self.draft is not None
        if forced:
            inputs.update(zip(('forced_tok', 'forced'),
                              self._forced_state()))
        return inputs

    def _window_static(self, sampled, forced):
        """A captured window's static buffers, zeroed: an all-frozen
        dummy batch (every row not live, its table on the scratch
        page), with the sampling vectors when `sampled` and the carried
        tokens when `forced`."""
        S, dev, z = self.max_slots, self.device, self._zeros
        static = dict(last_logits=torch.zeros_like(self._last_logits),
                      btab=z(S, self.max_blocks_per_seq, dtype=torch.int32),
                      ctx=z(S, dtype=torch.int32),
                      live=z(S, dtype=torch.bool),
                      budget=z(S, dtype=torch.int32))
        if sampled:
            static.update(temp=z(S, dtype=torch.float32),
                          topk=z(S, dtype=torch.int64),
                          topp=torch.ones(S, device=dev),
                          seed=z(S, dtype=torch.int64),
                          plen=z(S, dtype=torch.int64))
        if forced:
            static.update(forced_tok=z(S, dtype=torch.int64),
                          forced=z(S, dtype=torch.bool))
        return static

    def _zeros(self, *shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _slot_index(self, R):
        """(R,) slot indices all SLOTS: every row commits nothing."""
        return torch.full((R,), self.max_slots, dtype=torch.int64,
                          device=self.device)

    def _role(self, draft):
        """(model, its pools, the carried logits its bodies commit to:
        None for the draft)."""
        if draft:
            return self.draft, list(self._dpages), None
        return self.model, list(self._pages), self._last_logits

    def _body_state(self, pages, logits):
        return _pool_tensors(pages) + ([] if logits is None else [logits])

    def _row_width(self, n):
        """The rows a captured admission prefill or chunk runs for `n`
        real ones: the next power of two, at most max_slots (the rest
        are dummies). The JAX bodies run max_slots rows always; a
        narrower graph keeps a lone admission from paying for the
        whole batch."""
        return min(self.max_slots, 1 << max(0, n - 1).bit_length())

    def _row_widths(self):
        """Every row width `_row_width` gives, ascending."""
        return sorted({self._row_width(n)
                       for n in range(1, self.max_slots + 1)})

    def _prefill_graph(self, Sb, R, draft=False):
        """The captured admission prefill of `Sb`-token rows at R rows
        (a `_row_width`), of the target (its rows' next-token logits
        committed to their slots in the engine's carried logits) or of
        the `draft` (KV only), captured now when it is not yet, over an
        all-dummy batch (every row of length 0, so the eager run before
        the capture writes the scratch page alone)."""
        key = ('serve_prefill', int(Sb), int(R),
               'draft' if draft else 'target')
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        static = dict(ids=self._zeros(R, int(Sb)), real_len=self._zeros(R),
                      btabs=self._zeros(R, self.max_blocks_per_seq,
                                        dtype=torch.int32),
                      slots=self._slot_index(R))
        model, pages, logits = self._role(draft)
        body = functools.partial(_prefill_body, model, pages, logits, static)
        return self._graphs.capture(key, body, static,
                                    self._body_state(pages, logits))

    def _chunk_graph(self, Cb, Sb, R, draft=False):
        """The captured chunk forward of `Cb`-bucket chunks over
        prefixes gathered at ctx bucket `Sb`, at R rows (a
        `_row_width`), of the target (the logits of rows that end their
        context committed) or of the `draft` (its chunk leg and its
        catch-up), captured now when it is not yet, over an all-dummy
        batch (every row of length 0 at 0 with a (0, 0) copy: the
        scratch page alone)."""
        key = ('serve_chunk', int(Cb), int(Sb), int(R),
               'draft' if draft else 'target')
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        static = dict(ids=self._zeros(R, int(Cb)), chunk_len=self._zeros(R),
                      start=self._zeros(R),
                      btabs=self._zeros(R, self.max_blocks_per_seq,
                                        dtype=torch.int32),
                      slots=self._slot_index(R), cow_src=self._zeros(R),
                      cow_dst=self._zeros(R))
        model, pages, logits = self._role(draft)
        body = functools.partial(_chunk_body, model, pages, logits, static,
                                 ctx_bucket=int(Sb))
        return self._graphs.capture(key, body, static,
                                    self._body_state(pages, logits))

    def _replay(self, graph, draft, inputs):
        """Check the graph's state is the engine's, upload `inputs`, and
        replay it."""
        _, pages, logits = self._role(draft)
        graph.check_state(self._body_state(pages, logits))
        graph.load(**inputs)
        return graph.run()

    def _window_graph(self, sampled, forced=None):
        """The captured decode window of `sampled` (else greedy), with
        the carried token when `forced` (default: on a speculative
        engine, whose chunk steps run this window), captured now when it
        is not yet, over an all-frozen dummy batch, so the eager run
        before the capture writes page 0 alone."""
        forced = self.draft is not None if forced is None else bool(forced)
        key = ('serve_window', bool(sampled), forced)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        static = self._window_static(sampled, forced)
        pages = list(self._pages)
        body = functools.partial(
            _window_body, self.model, pages, static,
            window=self.decode_window, eos_token_id=self.eos_token_id)
        return self._graphs.capture(key, body, static,
                                    _pool_tensors(pages))

    def _spec_graph(self, ctx_bucket, sampled):
        """The captured speculative window whose verify gathers
        `ctx_bucket` positions, `sampled` or greedy, captured now when it
        is not yet, over an all-frozen dummy batch, so the eager run
        before the capture writes page 0 of both pools alone. Its state
        is the target's and the draft's pools."""
        key = ('serve_spec_window', self.spec_window, int(ctx_bucket),
               bool(sampled))
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        static = self._window_static(sampled, True)
        pages, dpages = list(self._pages), list(self._dpages)
        body = functools.partial(
            _spec_window_body, self.model, self.draft, pages, dpages, static,
            k=self.spec_window, ctx_bucket=int(ctx_bucket),
            eos_token_id=self.eos_token_id)
        return self._graphs.capture(key, body, static,
                                    _pool_tensors(pages + dpages))

    @torch.no_grad()
    def step(self):
        """One iteration: admit queued requests into free slots, advance
        every mid-prefill slot one chunk, top up pages for the coming
        window (preempting if the pool is dry), prefill the admitted
        prompts into their pages, decode one window over all slots, then
        commit tokens and retire finished rows from the one host read of
        the window. Returns the requests that finished this step."""
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
        # every slot mid prefill advances one chunk; a slot whose last
        # chunk runs now decodes its first window in this same step, so
        # the top-up below must already cover it
        chunk_rows = []
        for slot, req in enumerate(self._slot_req):
            p = self._pfill[slot]
            if req is None or p is None:
                continue
            take = req.context_len - p
            if self.prefill_chunk is not None:
                take = min(take, self.prefill_chunk)
            chunk_rows.append((slot, req, p, take))
            self._pfill[slot] = (None if p + take >= req.context_len
                                 else p + take)
        self._ensure_window_pages()
        if not self.in_flight():
            return []
        for Sb, group in groups:
            # the top-up may have preempted a request admitted this step
            group = [(s, r) for s, r in group if self._slot_req[s] is r]
            if group:
                self._prefill_group(Sb, group)
        chunk_rows = [row for row in chunk_rows
                      if self._slot_req[row[0]] is row[1]]
        if chunk_rows:
            self._chunk_group(chunk_rows)
        W = self.decode_window
        # slots mid prefill ride the window frozen on the scratch page
        live = np.asarray([r is not None and p is None
                           for r, p in zip(self._slot_req, self._pfill)])
        sampled = bool((self._temp[live] > 0).any())
        if self.draft is not None and not chunk_rows:
            return self._spec_step(live, sampled)
        graph = self._window_graph(sampled)
        graph.check_state(_pool_tensors(self._pages))
        graph.load(**self._window_inputs(live, sampled))
        toks, last = graph.run()
        # the graph's outputs are overwritten by its next replay
        self._last_logits.copy_(last)
        self.decode_forwards += W
        tokens = toks.cpu().numpy()        # the one host read per window
        finished = []
        for slot, req in enumerate(self._slot_req):
            if req is None or not live[slot]:
                continue
            take = min(W, req.remaining)
            committed = []
            for t in range(take):
                tok = int(tokens[slot, t])
                committed.append(tok)
                if self.eos_token_id is not None and tok == self.eos_token_id:
                    break
            # the carried token (if any) was this window's first commit
            req.spec_next = None
            if self._commit(slot, req, committed):
                finished.append(req)
        return finished

    def _spec_step(self, live, sampled):
        """A speculative step's window (every slot decoding): the draft's
        pages caught up first, then the captured `_spec_window` of the
        ctx bucket that holds the farthest row's k + 1 writes (the
        catch-up gathers to the same bucket), its inputs uploaded into
        the graph's buffers, and one host read of its candidates,
        commit counts and next tokens together."""
        k = self.spec_window
        max_ctx = int(np.where(live, self._ctx, 0).max())
        ctx_bucket = bucket_length(max_ctx + k + 1, self.buckets)
        catchup = self._draft_catchup_rows()
        if catchup:
            # at the window's ctx bucket, which holds every row's end
            self._draft_advance(catchup, ctx_bucket)
        graph = self._spec_graph(ctx_bucket, sampled)
        graph.check_state(_pool_tensors(self._pages + self._dpages))
        graph.load(**self._window_inputs(live, sampled, True))
        cand, nc, nxt, last = graph.run()
        # the graph's outputs are overwritten by its next replay
        self._last_logits.copy_(last)
        self.verify_forwards += 1
        self.draft_forwards['decode'] += k + 1
        self.spec_counts['windows'] += 1
        host = torch.cat([cand, nc[:, None], nxt[:, None]], 1).cpu().numpy()
        finished = []
        for slot, req in enumerate(self._slot_req):
            if req is None or not live[slot]:
                continue
            take = int(host[slot, k + 1])
            req.spec_next = int(host[slot, k + 2])
            # the draft's steps wrote every committed position's KV
            self._dctx[slot] += take
            self.spec_counts['proposed'] += k
            self.spec_counts['accepted'] += max(0, take - 1)
            if self._commit(slot, req, [int(t) for t in host[slot, :take]]):
                finished.append(req)
        return finished

    def _commit(self, slot, req, committed):
        """Append a window's committed tokens to the request and its
        slot; retire it when it is done. Returns whether it finished."""
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
            return True
        return False

    # -- internals ---------------------------------------------------------

    def _free_slots(self):
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admit(self):
        """Fill free slots from the queue head (priority order: a head
        that cannot get its pages waits, nothing barges past it). With
        the prefix cache, a head shares the cached pages of its prompt's
        leading blocks and allocates the rest. A prefix hit, or a
        context longer than `prefill_chunk`, goes to the chunk path;
        the rest are returned grouped by prefill bucket, largest group
        first."""
        if not len(self.queue):
            return []
        free = self._free_slots()
        placed = []
        a = self.allocator
        bs = self.block_size
        while free and len(self.queue):
            req = self.queue.peek()
            total_pages = _ceil_div(req.context_len, bs)
            hit = []
            skipped = False
            if self.prefix_cache:
                if req.page_hashes is None:
                    req.page_hashes = prompt_page_hashes(req.prompt, bs)
                hit = a.match_prefix(req.page_hashes)
            if hit:
                # taken only when it shrinks the prefill to a smaller
                # bucket (a short hit saves little and costs a gather);
                # a skipped hit leaves the pages cached
                suffix = req.context_len - min(len(hit) * bs,
                                               req.context_len - 1)
                if (bucket_length(suffix, self.buckets)
                        >= bucket_length(req.context_len, self.buckets)):
                    self.prefix_counts['hits_skipped'] += 1
                    hit, skipped = [], True
            # at least the last context token is recomputed (its logits
            # seed the decode): a hit covering every token backs off one,
            # into the boundary page, which the slot then copies on write
            start = min(len(hit) * bs, req.context_len - 1)
            cow = len(hit) * bs > start
            need = total_pages - len(hit) + int(cow)
            # cached pages the hit revives stop being allocatable
            revive = sum(1 for p in hit if a.refcount(p) == 0)
            if need > a.available() - revive:
                break
            self.queue.pop()
            pages = a.share(hit)
            if cow:
                # the slot's table names the copy; its reference on the
                # source page is kept until the copy has run
                pages = hit[:-1] + [a.cow(hit[-1])]
            pages = pages + a.alloc(total_pages - len(hit))
            slot = free.pop(0)
            self._place(slot, req, pages)
            if self.prefix_cache:
                if hit:
                    self.prefix_counts['hits'] += 1
                    self.prefix_counts['hit_tokens'] += start
                elif not skipped:
                    self.prefix_counts['misses'] += 1
            chunked = (self.prefill_chunk is not None
                       and req.context_len - start > self.prefill_chunk)
            if start > 0 or chunked:
                self._pfill[slot] = start
                # the draft holds the shared prefix pages so far (their
                # earlier owners wrote them); its chunks advance this
                self._dctx[slot] = start
                self._cow_pending[slot] = ((hit[-1], pages[len(hit) - 1])
                                           if cow else None)
                self.prefix_counts['chunked_admissions'] += int(chunked)
            else:
                placed.append((slot, req))
        by_bucket: dict = {}
        for slot, req in placed:
            Sb = bucket_length(req.context_len, self.buckets)
            by_bucket.setdefault(Sb, []).append((slot, req))
        return sorted(by_bucket.items(), key=lambda kv: -len(kv[1]))

    def _place(self, slot, req, pages):
        """Arm a slot (host bookkeeping; the prefill moves the KV)."""
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        self._btab[slot] = 0
        self._btab[slot, :len(pages)] = pages
        self._ctx[slot] = req.context_len
        self._budget[slot] = req.remaining
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._seed[slot] = req.sample_seed & 0xFFFFFFFF
        self._plen[slot] = len(req.prompt)
        # a monolithic admission prefills both models in this step; a
        # chunk-path one overrides this with its start (_admit)
        self._dctx[slot] = req.context_len
        req.state = 'running'
        req.admit_seq = next(self._admit_seq)

    def _prefill_group(self, Sb, group):
        """Prefill one admission group (one bucket) into its pages
        through the captured prefill of its bucket at the group's row
        width (rows past the group are dummies: length 0, slot index
        SLOTS), the draft's too on a speculative engine; each request's
        next-token logits land in its slot's row. Then index its full
        prompt pages."""
        R = self._row_width(len(group))
        ids = np.zeros((R, Sb), np.int64)
        real_len = np.zeros((R,), np.int64)
        btabs = np.zeros((R, self.max_blocks_per_seq), np.int32)
        slots = np.full((R,), self.max_slots, np.int64)
        for i, (slot, req) in enumerate(group):
            ids[i, :req.context_len] = req.context()          # RIGHT-pad
            real_len[i] = req.context_len
            btabs[i] = self._btab[slot]
            slots[i] = slot
        self.prefill_tokens += int(real_len.sum())
        inputs = dict(ids=ids, real_len=real_len, btabs=btabs, slots=slots)
        self._replay(self._prefill_graph(Sb, R), False, inputs)
        self.prefill_forwards += 1
        if self.draft is not None:
            # the draft must hold every admitted row's prompt KV, or its
            # proposals run against zeros
            self._replay(self._prefill_graph(Sb, R, draft=True), True,
                         inputs)
            self.draft_forwards['prefill'] += 1
        for slot, req in group:
            self._register_prefix_pages(slot, req, 0, req.context_len)

    def _chunk_inputs(self, rows, Cb):
        """A chunk's inputs at the row width of `rows` = (slot, req,
        progress, take), and the copy-on-write pairs it takes: each
        row's chunk ids, length, start and table; its slot where the
        chunk ends its context (else SLOTS, as for the dummy rows past
        the group); its pending copy, else (0, 0)."""
        R = self._row_width(len(rows))
        ids = np.zeros((R, Cb), np.int64)
        clen = np.zeros((R,), np.int64)
        start = np.zeros((R,), np.int64)
        btabs = np.zeros((R, self.max_blocks_per_seq), np.int32)
        slots = np.full((R,), self.max_slots, np.int64)
        cow = np.zeros((2, R), np.int64)
        pairs = []
        for i, (slot, req, p, take) in enumerate(rows):
            ids[i, :take] = req.context()[p:p + take]
            clen[i], start[i] = take, p
            btabs[i] = self._btab[slot]
            if self._pfill[slot] is None:
                slots[i] = slot
            if self._cow_pending[slot] is not None:
                cow[:, i] = self._cow_pending[slot]
                pairs.append(self._cow_pending[slot])
                self._cow_pending[slot] = None
        return dict(ids=ids, chunk_len=clen, start=start, btabs=btabs,
                    slots=slots, cow_src=cow[0], cow_dst=cow[1]), pairs

    def _chunk_group(self, rows):
        """One chunk forward over `rows` = (slot, req, progress, take)
        through the captured chunk of (chunk bucket, bucket of the
        farthest end) at their row width: the pending copy-on-write
        copies first, then the chunks; rows whose chunk completes their
        context commit their logits. On a speculative engine the
        draft's chunk follows, then every decoding row's draft catch-up.
        The copies' source references are released once the forwards
        are issued, and the chunk's full prompt pages are indexed."""
        Cb = bucket_length(max(t for _s, _r, _p, t in rows), self.buckets)
        Sb = bucket_length(max(p + t for _s, _r, p, t in rows),
                           self.buckets)
        inputs, pairs = self._chunk_inputs(rows, Cb)
        R = len(inputs['start'])
        self.prefill_tokens += int(inputs['chunk_len'].sum())
        self._replay(self._chunk_graph(Cb, Sb, R), False, inputs)
        self.chunk_forwards += 1
        if self.draft is not None:
            # the draft's pages follow the chunk path (the copies on
            # write included); then every decoding row's draft hole (the
            # previous chunk step's commits) catches up, so no hole
            # outgrows one window
            self._replay(self._chunk_graph(Cb, Sb, R, draft=True), True,
                         inputs)
            self.draft_forwards['chunk'] += 1
            for slot, _r, p, take in rows:
                self._dctx[slot] = p + take
            catchup = self._draft_catchup_rows()
            if catchup:
                self._draft_advance(catchup, bucket_length(
                    max(p + t for _s, _r, p, t in catchup), self.buckets))
        self.prefix_counts['chunk_steps'] += 1
        if pairs:
            self.allocator.free([src for src, _dst in pairs])
        for slot, req, p, take in rows:
            self._register_prefix_pages(slot, req, p, p + take)

    def _draft_catchup_rows(self):
        """Decoding slots whose draft pages lag their committed context
        (a chunk step's plain window committed tokens past the draft):
        (slot, req, draft context, hole) rows for `_draft_advance`."""
        return [(s, r, int(self._dctx[s]), int(self._ctx[s] - self._dctx[s]))
                for s, r in enumerate(self._slot_req)
                if r is not None and self._pfill[s] is None
                and self._ctx[s] > self._dctx[s]]

    def _draft_advance(self, rows, Sb):
        """One captured draft chunk at ctx bucket `Sb` appending each
        row's context tokens [start, start + take) into the draft's
        pages (no copy on write: these rows are past their prefill),
        then advance their draft context."""
        Cb = bucket_length(max(t for _s, _r, _p, t in rows), self.buckets)
        inputs, _ = self._chunk_inputs(rows, Cb)
        self._replay(self._chunk_graph(Cb, Sb, len(inputs['start']),
                                       draft=True), True, inputs)
        self.draft_forwards['chunk'] += 1
        for slot, _r, p, take in rows:
            self._dctx[slot] = p + take

    def _forced_state(self):
        """(forced_tok, forced) (SLOTS,) host arrays: the slots whose
        request carries a speculative window's next token, and it."""
        forced = np.zeros((self.max_slots,), bool)
        ftok = np.zeros((self.max_slots,), np.int64)
        for s, r in enumerate(self._slot_req):
            if r is not None and r.spec_next is not None:
                forced[s], ftok[s] = True, r.spec_next
        return ftok, forced

    def _register_prefix_pages(self, slot, req, lo, hi):
        """Index every full prompt page whose KV the forward over
        context positions [lo, hi) completed (generated tokens are the
        request's own and never index; a bound hash keeps its first
        page)."""
        if req.page_hashes is None:
            return
        pages = self._slot_pages[slot]
        bs = self.block_size
        for j in range(lo // bs, min(hi // bs, len(req.page_hashes))):
            self.allocator.register_prefix(pages[j], req.page_hashes[j])

    def _ensure_window_pages(self):
        """Every decoding slot must own pages covering the positions the
        coming window can commit (ctx .. ctx + min(window, remaining)). A
        dry pool preempts the lowest-priority / youngest request until
        the top-up fits (the needy slot may evict itself). A slot whose
        top-up still fails once it is the only request left is
        unservable: that request fails alone. Slots mid prefill own
        their pages since admission and are skipped. A speculative
        window commits up to k + 1 tokens, so the top-up covers
        max(window, k + 1) positions (the draft's writes past the
        committed ones that reach no page land on the scratch page)."""
        a = self.allocator
        adv = self.decode_window
        if self.spec_window is not None:
            adv = max(adv, self.spec_window + 1)
        for slot in range(self.max_slots):
            req = self._slot_req[slot]
            if req is None or self._pfill[slot] is not None:
                continue
            target = _ceil_div(
                int(self._ctx[slot]) + min(adv, req.remaining),
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
        """Drop the slot's page references (a shared or indexed page
        outlives it), and its pin on a copy-on-write source whose copy
        never ran."""
        self.allocator.free(self._slot_pages[slot])
        if self._cow_pending[slot] is not None:
            self.allocator.free([self._cow_pending[slot][0]])
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._btab[slot] = 0
        self._ctx[slot] = 0
        self._budget[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._seed[slot] = 0
        self._plen[slot] = 0
        self._dctx[slot] = 0
        self._pfill[slot] = None
        self._cow_pending[slot] = None


__all__ = ['ServingEngine', 'BlockAllocator', 'RequestQueue', 'Request',
           'OutOfBlocks', 'RequestFailed', 'InvalidSamplingParams',
           'prompt_page_hashes']
