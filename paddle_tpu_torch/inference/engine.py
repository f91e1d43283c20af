"""Prefill buckets and `DecodeEngine` (counterpart of
paddle_tpu/inference/engine.py).

Both engines pad a prompt to the smallest bucket that holds it, in
opposite directions: the `ServingEngine` right-pads (its admission
prefill masks the tail by the real length), `DecodeEngine` left-pads
(the prompt ends at the bucket's last row, and the pad rows in front are
excluded by a per-row window start, `kv_start`).
"""
from __future__ import annotations

import inspect
import time

import numpy as np
import torch

# powers of two: prompt lengths are padded to the smallest bucket that
# holds them
DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(seq_len, buckets=None):
    """Smallest bucket >= seq_len; past the largest bucket, the next
    power of two."""
    for b in (buckets or DEFAULT_BUCKETS):
        if b >= seq_len:
            return b
    b = 1
    while b < seq_len:
        b <<= 1
    return b


class DecodeEngine:
    """Greedy / sampled decode of whole batches for one model over a
    contiguous KV cache: a bucketed prefill, then one single-token
    forward per new token (the decode-attention kernel K7 on the card).

        engine = DecodeEngine(model, max_new_tokens=64)
        out = engine.generate(input_ids)                # ids (B, S)
        out = engine.generate_speculative(draft, ids)   # greedy, lossless

    The sampling configuration is fixed at construction. A prompt of
    length S is LEFT-padded to the bucket Sb = bucket_length(S) and
    decoded by `model.generate` with the left-padded attention mask: pad
    rows get position 0 and lie before each row's window start
    `Sb - S`, so they are never attended, at prefill or after, and the
    tokens equal an unpadded `model.generate`'s. The decode step of
    each geometry (batch, bucket, max_new_tokens) is a CUDA graph that
    the engine captures at first use and replays, over caches it keeps:
    `warmup` captures the declared geometries before the first call and
    keeps them until `release()`; of the others it keeps the last. The JAX
    engine's compile cache, trace counters, StableHLO export and
    persistent cache manage `jax.jit` and have no counterpart here.

    `generate_speculative` is greedy speculative decoding with a draft
    model (see `models.generation.generate_speculative`): its prompts
    are not padded (as in the JAX engine), and `stats()` counts its
    forwards of both models and its proposals."""

    def __init__(self, model, max_new_tokens=32, temperature=0.0, top_k=0,
                 top_p=1.0, eos_token_id=None, buckets=None):
        self.model = model
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = (int(eos_token_id) if eos_token_id is not None
                             else None)
        self.buckets = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        params = inspect.signature(model.forward).parameters
        self._supports_padding = ('positions' in params
                                  and 'kv_start' in params)
        self._forwards = dict.fromkeys(
            ('prefill', 'decode', 'verify', 'draft_prefill', 'draft_decode'),
            0)
        self.spec_counts = {'windows': 0, 'proposed': 0, 'accepted': 0}

    def stats(self):
        """Forward counts since construction and the engine's geometry
        (kind, decode budget, buckets). The model's forwards: prefill,
        decode (one-token) and verify (a speculative window's); the
        draft's: prefill and decode; `spec`: speculative windows,
        proposed and accepted draft tokens and their ratio (None before
        the first window)."""
        f = self._forwards
        sc = self.spec_counts
        return {'prefill_forwards': f['prefill'],
                'decode_forwards': f['decode'],
                'verify_forwards': f['verify'],
                'draft_prefill_forwards': f['draft_prefill'],
                'draft_decode_forwards': f['draft_decode'],
                'spec': dict(sc, accept_rate=(
                    sc['accepted'] / sc['proposed'] if sc['proposed']
                    else None)),
                'geometry': {'kind': 'contiguous',
                             'max_new_tokens': self.max_new_tokens,
                             'buckets': self.buckets}}

    @torch.no_grad()
    def warmup(self, artifact=None, geometries=None):
        """Capture the decode step of every declared `decode` geometry
        (batch, prompt_len, max_new_tokens; `graphs.for_decode_engine`
        enumerates them) by one generate call over zero ids each, before
        the first request; these calls are not counted in `stats()`.
        The engine keeps the warmed geometries' graphs and caches until
        `release()`, and besides them those of the last other geometry
        it decoded. Returns the JAX package's report (`traces`: the
        graphs captured now). `artifact=` raises NotImplementedError (a
        CUDA graph cannot be persisted), and so does the `decode_spec`
        kind (speculative decoding runs eagerly, ROADMAP A9b)."""
        from ..models.generation import _decode_graphs
        from .graphs import geometry_parts, warmup_report

        if artifact is not None:
            raise NotImplementedError(
                'warmup(artifact=): a CUDA graph cannot be persisted; '
                'pass geometries= to capture them in this process')
        if geometries is None:
            raise ValueError('warmup needs geometries=... (see '
                             'inference.graphs.for_decode_engine)')
        geometries = list(geometries)
        store = _decode_graphs(self, self.model)
        n0 = store.runner.captures
        counts = dict(self._forwards)
        t0 = time.perf_counter()
        with store.pinning():
            for g in geometries:
                kind, p = geometry_parts(g)
                if kind == 'decode_spec':
                    raise NotImplementedError(
                        'speculative decoding runs eagerly (ROADMAP A9b): '
                        'no decode_spec geometry to capture')
                if kind != 'decode':
                    raise ValueError(f'DecodeEngine geometries are of kind '
                                     f'decode, got {kind!r}')
                ids = torch.zeros((int(p['batch']), int(p['prompt_len'])),
                                  dtype=torch.int64, device=self.model.device)
                self.generate(ids, max_new_tokens=int(p['max_new_tokens']))
        self._forwards = counts
        return warmup_report(len(geometries), time.perf_counter() - t0,
                             store.runner.captures - n0)

    def release(self):
        """Free the captured decode steps and the caches this engine
        keeps."""
        from ..models.generation import release_decode_graphs

        release_decode_graphs(self)

    def generate(self, input_ids, max_new_tokens=None, rng_key=None):
        """Decode `max_new_tokens` (the engine's by default) after each
        prompt row. Returns (B, S + max_new_tokens) ids: the ORIGINAL
        prompt, not the padded one, then the new tokens. `rng_key` is a
        torch.Generator or an int seed (None: seed 0)."""
        from ..models.generation import _generate

        model = self.model
        ids = torch.as_tensor(input_ids, device=model.device)
        B, S = ids.shape
        mnt = (self.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        Sb = bucket_length(S, self.buckets)
        pad = Sb - S
        if pad and not self._supports_padding:
            raise NotImplementedError(
                f'{type(model).__name__} lacks positions/kv_start in its '
                f'cached forward, so bucketed prefill cannot mask the pad '
                f'rows; pass prompts of exactly a bucket length '
                f'{self.buckets}')
        padded, mask = ids, None
        if pad:
            padded = torch.cat([ids.new_zeros(B, pad), ids], dim=1)
            mask = (torch.arange(Sb, device=ids.device) >= pad).to(
                torch.int32).expand(B, Sb)
        out = _generate(model, self, padded, mnt, self.temperature,
                        self.top_k, self.top_p, rng_key, self.eos_token_id,
                        1, mask, False)
        self._forwards['prefill'] += 1
        self._forwards['decode'] += max(mnt - 1, 0)
        return torch.cat([ids, out[:, Sb:]], dim=1)

    def generate_speculative(self, draft, input_ids, max_new_tokens=None,
                             num_draft_tokens=4):
        """Greedy speculative decoding with `draft` proposing
        `num_draft_tokens` tokens a window: lossless against `generate`
        at temperature 0 on this engine's model alone (the engine's
        sampling configuration does not apply), its eos included.
        Batch 1 reads the host once per window; batched rows commit at
        their own rates (per-row `kv_write_pos`). Returns (B, S +
        max_new_tokens) ids."""
        from ..models.generation import (_check_speculative_pair,
                                         _eval_mode, _speculative_loop)

        model = self.model
        ids = torch.as_tensor(input_ids, device=model.device)
        B, S = ids.shape
        mnt = (self.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        k = int(num_draft_tokens)
        if k < 1:
            raise ValueError('num_draft_tokens must be >= 1')
        _check_speculative_pair(model, draft, B)
        with _eval_mode(model, draft), torch.no_grad():
            gen, counts = _speculative_loop(model, draft, ids, mnt, k,
                                            self.eos_token_id)
        f = self._forwards
        f['prefill'] += 1
        f['draft_prefill'] += 1
        f['verify'] += counts['windows']
        f['draft_decode'] += (k + 1) * counts['windows']
        for key, n in counts.items():
            self.spec_counts[key] += n
        return torch.cat([ids, torch.as_tensor(gen, dtype=ids.dtype,
                                               device=ids.device)], dim=1)


# ---------------------------------------------------------------------------
# Speculative windows and their host loops (shared with
# models/generation.py)
# ---------------------------------------------------------------------------

def _window_b1(target, draft, tcaches, dcaches, c, L, k):
    """One batch-1 speculative window at the uniform cache index L: the
    draft proposes k tokens in k + 1 one-token steps (the last writes the
    k-th proposal's own KV row), the target verifies [c, d1..dk] in one
    forward, and the greedy commit rule runs on the device as a cumprod
    (`_commit_window` is its host-side spec). Returns (drafts (k,), the
    accepted count m, the next token) as device tensors."""
    tok, toks = c, []
    for i in range(k + 1):
        logits, dcaches = draft(tok, caches=dcaches, cache_index=L + i)
        if i < k:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(c.dtype)
            toks.append(tok)
    drafts = torch.cat(toks, dim=1)[0]                       # (k,)
    window = torch.cat([c, drafts[None]], dim=1)             # (1, k + 1)
    tlogits, tcaches = target(window, caches=tcaches, cache_index=L)
    choices = torch.argmax(tlogits[0], dim=-1).to(c.dtype)   # (k + 1,)
    m = torch.cumprod((drafts == choices[:k]).long(), 0).sum()
    return drafts, m, choices[m]


def _spec_loop_host_b1(target, draft, tcaches, dcaches, input_ids,
                       max_new_tokens, k, eos_token_id):
    """Batch 1: both prefills, then one window per iteration with ONE
    host read (the window's candidate, proposals, accepted count and
    next token together); the next window's candidate stays on the
    device. Returns ([max_new_tokens ids], counts)."""
    B, S = input_ids.shape
    logits, tcaches = target(input_ids, caches=tcaches, cache_index=0)
    draft(input_ids, caches=dcaches, cache_index=0)
    c = torch.argmax(logits[:, -1], dim=-1)[:, None].to(input_ids.dtype)
    counts = {'windows': 0, 'proposed': 0, 'accepted': 0}
    out, L = [], S
    while len(out) < max_new_tokens:
        drafts, m, nxt = _window_b1(target, draft, tcaches, dcaches, c, L,
                                    k)
        host = torch.cat([c[0], drafts, m[None].to(c.dtype),
                          nxt[None]]).tolist()
        m_h = host[k + 1]
        committed = host[:m_h + 1]
        counts['windows'] += 1
        counts['proposed'] += k
        counts['accepted'] += m_h
        out.extend(committed)
        L += len(committed)
        c = nxt.view(1, 1)
        if eos_token_id is not None and eos_token_id in committed:
            break
    if eos_token_id is not None:
        if eos_token_id in out:
            out = out[:out.index(eos_token_id) + 1]
        out += [eos_token_id] * (max_new_tokens - len(out))
    return [out[:max_new_tokens]], counts


def _spec_window_batched(target, draft, tcaches, dcaches, c, wp, k):
    """A batched speculative window: rows write at their own offsets wp
    (B,) on both models (the draft's one-token steps take K7 at per-row
    lengths), and the commit rule runs per row. c (B, 1). Returns
    (drafts (B, k), m (B,), next (B,))."""
    tok, toks = c, []
    for i in range(k + 1):
        logits, dcaches = draft(tok, caches=dcaches, kv_write_pos=wp + i)
        if i < k:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(c.dtype)
            toks.append(tok)
    drafts = torch.cat(toks, dim=1)                          # (B, k)
    window = torch.cat([c, drafts], dim=1)                   # (B, k + 1)
    tlogits, tcaches = target(window, caches=tcaches, kv_write_pos=wp)
    choices = torch.argmax(tlogits, dim=-1).to(c.dtype)      # (B, k + 1)
    m = torch.cumprod((drafts == choices[:, :k]).long(), 1).sum(1)
    return drafts, m, torch.gather(choices, 1, m[:, None])[:, 0]


def _spec_loop_host_batched(target, draft, tcaches, dcaches, input_ids,
                            max_new_tokens, k, eos_token_id):
    """B > 1: rows commit at their own rates (per-row write offsets) by
    the batch-1 rule, one host read per window. Finished and full rows
    still ride through the window but commit nothing; their offset is
    held inside the cache (torch raises on a write past it, where JAX
    drops it), and what they write there is never read back. Returns
    (B lists of max_new_tokens ids, counts)."""
    B, S = input_ids.shape
    dev = input_ids.device
    logits, tcaches = target(input_ids, caches=tcaches, cache_index=0)
    draft(input_ids, caches=dcaches, cache_index=0)
    c_host = torch.argmax(logits[:, -1], dim=-1).tolist()
    counts = {'windows': 0, 'proposed': 0, 'accepted': 0}
    out = [[] for _ in range(B)]
    finished = [False] * B
    L = np.full((B,), S, np.int64)

    def row_needs(b):
        return not finished[b] and len(out[b]) < max_new_tokens

    while any(row_needs(b) for b in range(B)):
        c = torch.tensor(c_host, dtype=input_ids.dtype, device=dev)[:, None]
        wp = torch.as_tensor(np.minimum(L, S + max_new_tokens), device=dev)
        drafts, m, nxt = _spec_window_batched(target, draft, tcaches,
                                              dcaches, c, wp, k)
        host = torch.cat([drafts, m[:, None].to(drafts.dtype),
                          nxt[:, None].to(drafts.dtype)], 1).tolist()
        counts['windows'] += 1
        for b in range(B):
            if not row_needs(b):
                continue
            mb = host[b][k]
            committed = [c_host[b]] + host[b][:mb]
            c_host[b] = host[b][k + 1]
            counts['proposed'] += k
            counts['accepted'] += mb
            out[b].extend(committed)
            if eos_token_id is not None and eos_token_id in committed:
                out[b] = out[b][:out[b].index(eos_token_id) + 1]
                finished[b] = True
            L[b] += len(committed)
    pad = eos_token_id if eos_token_id is not None else 0
    return [out[b][:max_new_tokens]
            + [pad] * (max_new_tokens - len(out[b][:max_new_tokens]))
            for b in range(B)], counts
