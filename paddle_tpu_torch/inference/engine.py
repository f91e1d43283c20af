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

    The sampling configuration is fixed at construction. A prompt of
    length S is LEFT-padded to the bucket Sb = bucket_length(S) and
    decoded by `model.generate` with the left-padded attention mask: pad
    rows get position 0 and lie before each row's window start
    `Sb - S`, so they are never attended, at prefill or after, and the
    tokens equal an unpadded `model.generate`'s. The JAX engine's
    compile cache, trace counters, AOT export and persistent cache
    manage `jax.jit` and have no counterpart here (the port runs
    eagerly)."""

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
        self._forwards = {'prefill': 0, 'decode': 0}

    def stats(self):
        """Forward counts since construction and the engine's geometry
        (kind, decode budget, buckets)."""
        return {'prefill_forwards': self._forwards['prefill'],
                'decode_forwards': self._forwards['decode'],
                'geometry': {'kind': 'contiguous',
                             'max_new_tokens': self.max_new_tokens,
                             'buckets': self.buckets}}

    def generate(self, input_ids, max_new_tokens=None, rng_key=None):
        """Decode `max_new_tokens` (the engine's by default) after each
        prompt row. Returns (B, S + max_new_tokens) ids: the ORIGINAL
        prompt, not the padded one, then the new tokens. `rng_key` is a
        torch.Generator or an int seed (None: seed 0)."""
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
        out = model.generate(
            padded, max_new_tokens=mnt, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, rng_key=rng_key,
            eos_token_id=self.eos_token_id, attention_mask=mask)
        self._forwards['prefill'] += 1
        self._forwards['decode'] += max(mnt - 1, 0)
        return torch.cat([ids, out[:, Sb:]], dim=1)

    def generate_speculative(self, draft, input_ids, max_new_tokens=None,
                             num_draft_tokens=4):
        raise NotImplementedError(
            'speculative decoding is not ported yet (ROADMAP A3 / B1)')
