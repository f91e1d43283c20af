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
    are not padded (as in the JAX engine), its window is a CUDA graph
    per geometry (batch, prompt length, max_new_tokens, k, the draft)
    kept as the decode step's are, and `stats()` counts its forwards of
    both models and its proposals."""

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
    def warmup(self, artifact=None, geometries=None, draft=None):
        """Capture every declared geometry before the first request
        (`graphs.for_decode_engine` enumerates them): the decode step of
        each `decode` geometry (batch, prompt_len, max_new_tokens) by one
        generate call over zero ids, the speculative window of each
        `decode_spec` geometry (the same and num_draft_tokens) over
        `draft`, which that kind needs (ValueError without it, as the
        JAX engine raises). These calls are not counted in `stats()`.
        The engine keeps the warmed geometries' graphs and caches until
        `release()`, and besides them those of the last other geometry
        it decoded. Returns the JAX package's report (`traces`: the
        graphs captured now). `artifact=` raises NotImplementedError (a
        CUDA graph cannot be persisted)."""
        from ..models.generation import (_check_speculative_pair,
                                         _decode_graphs, _eval_mode)
        from .graphs import geometry_parts, warmup_report

        if artifact is not None:
            raise NotImplementedError(
                'warmup(artifact=): a CUDA graph cannot be persisted; '
                'pass geometries= to capture them in this process')
        if geometries is None:
            raise ValueError('warmup needs geometries=... (see '
                             'inference.graphs.for_decode_engine)')
        geometries = [geometry_parts(g) for g in geometries]
        for kind, _p in geometries:
            if kind not in ('decode', 'decode_spec'):
                raise ValueError(f'DecodeEngine geometries are of kind '
                                 f'decode or decode_spec, got {kind!r}')
            if kind == 'decode_spec' and draft is None:
                raise ValueError(
                    'geometry kind decode_spec needs the draft model: '
                    'pass warmup(..., draft=draft_model)')
        if draft is not None:
            _check_speculative_pair(self.model, draft)
        store = _decode_graphs(self, self.model)
        n0 = store.captures()
        counts = dict(self._forwards)
        t0 = time.perf_counter()
        with store.pinning(), _eval_mode(self.model, draft):
            for kind, p in geometries:
                B, L = int(p['batch']), int(p['prompt_len'])
                mnt = int(p['max_new_tokens'])
                if kind == 'decode_spec':
                    store.spec_graph(self.model, draft, B, L, mnt,
                                     int(p['num_draft_tokens']), False)
                else:
                    self.generate(torch.zeros((B, L), dtype=torch.int64,
                                              device=self.model.device),
                                  max_new_tokens=mnt)
        self._forwards = counts
        return warmup_report(len(geometries), time.perf_counter() - t0,
                             store.captures() - n0)

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
        sampling configuration does not apply), its eos included. Rows
        commit at their own rates (per-row `kv_write_pos`), the host
        reads once per window, and the window replays the graph of its
        geometry (captured at first use or by `warmup`). Returns (B, S +
        max_new_tokens) ids."""
        from ..models.generation import (_check_speculative_pair,
                                         _eval_mode, _speculative_loop)

        model = self.model
        ids = torch.as_tensor(input_ids, device=model.device)
        mnt = (self.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        k = int(num_draft_tokens)
        if k < 1:
            raise ValueError('num_draft_tokens must be >= 1')
        _check_speculative_pair(model, draft)
        with _eval_mode(model, draft), torch.no_grad():
            gen, counts = _speculative_loop(model, draft, self, ids, mnt, k,
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
