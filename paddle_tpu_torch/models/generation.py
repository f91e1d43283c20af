"""KV caches and autoregressive generation (counterpart of
paddle_tpu/models/generation.py).

The port updates caches IN PLACE (the JAX package returns new arrays):
a cached forward writes its new K/V rows (and, for an int8 cache, its
calibrated scales) into the given tensors and returns the same tensors,
so a Llama-7B-width cache is never copied.

`GenerationMixin.generate` is the JAX package's greedy / sampled decode
under `torch.no_grad()`: prefill once over a contiguous cache, then one
single-token forward per new token (the decode-attention kernel K7 on
the card). The per-token step (`_decode_step`) runs at a device
position, with the output column, the finished mask and the step count
advanced on the device: it is captured once per geometry as a CUDA graph
and replayed (`inference/graphs.py`), and the host reads the tokens
once, at the end. The speculative paths (`generate_speculative`,
`generate_speculative_sampled`, `DecodeEngine.generate_speculative`)
capture their propose / verify window the same way and read the host
once per window. The geometry's caches belong to its captured body, so
the prefill writes them in place, and they outlive the call: a model
keeps those of the last geometry it decoded, a DecodeEngine those of
the geometries it warmed and of the last one it decoded besides
(`DecodeGraphs`), until `release_graphs()` / `release()`. Its random
stream comes from a
`torch.Generator`: the same seed gives the same tokens within the port,
never the JAX package's threefry stream.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import typing
import weakref

import numpy as np
import torch

# generate's captured decode steps, one `DecodeGraphs` per owner: a
# model (its own generate calls) or a DecodeEngine
_DECODE_GRAPHS = weakref.WeakKeyDictionary()


def filter_logits(logits, top_k=0, top_p=1.0):
    """top-k, then nucleus (top-p) filtering of temperature-scaled logits:
    dropped entries become -inf. top_k <= 0 keeps all, top_k > V clamps
    to V; top_p = 1.0 keeps all."""
    V = logits.shape[-1]
    if top_k > 0:
        top_k = min(int(top_k), V)
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float('-inf'), logits)
    if top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, [-1])
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp(max=V - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float('-inf'), logits)
    return logits


def filter_logits_batched(logits, top_k, top_p):
    """Per-row `filter_logits` over (B, V) logits: top_k (B,) int and
    top_p (B,) float tensors on the logits' device, so one batch mixes
    greedy, top-k and nucleus rows. A row's top_k <= 0 keeps all and
    top_k > V clamps to V; a row's top_p == 1.0 keeps all (masked, not
    computed away: the cumulative sum's rounding must not drop a token
    of a keep-all row)."""
    V = logits.shape[-1]
    tk = top_k.to(device=logits.device, dtype=torch.int64)
    kth = torch.gather(torch.sort(logits, dim=-1).values, -1,
                       (V - tk.clamp(1, V))[:, None])
    logits = torch.where((tk > 0)[:, None] & (logits < kth), float('-inf'),
                         logits)
    tp = top_p.to(device=logits.device, dtype=torch.float32)
    sorted_desc = torch.flip(torch.sort(logits, dim=-1).values, [-1])
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < tp[:, None]).sum(-1, keepdim=True).clamp(max=V - 1)
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
    return torch.where((tp < 1.0)[:, None] & (logits < cutoff),
                       float('-inf'), logits)


def default_positions(batch, seq, cache_index=None, kv_write_pos=None,
                      device=None):
    """Token positions (batch, seq): per-row offsets when kv_write_pos
    (B,) is given, else the uniform base cache_index (0 when None)."""
    ar = torch.arange(seq, dtype=torch.int64, device=device)
    if kv_write_pos is not None:
        wp = kv_write_pos.reshape(-1).to(torch.int64)
        positions = wp[:, None] + ar[None, :]
    else:
        positions = (0 if cache_index is None else int(cache_index)) + ar[None]
    return positions.expand(batch, seq)


class QuantKVCache(typing.NamedTuple):
    """One layer's int8 contiguous KV cache: K/V codes (B, max_len, Hkv, D)
    int8 with per-(kv head, dim) float32 scales (Hkv, D), calibrated on
    the index-0 multi-token prefill and held over decode. Halves the
    cache stream of a decode step."""

    kq: torch.Tensor
    vq: torch.Tensor
    kscale: torch.Tensor
    vscale: torch.Tensor


class QuantPagedKVCache(typing.NamedTuple):
    """One layer's int8 paged KV pools (the ServingEngine's
    `kv_cache_dtype='int8'`): K/V codes (num_blocks, Hkv, block_size, D)
    int8, and each written row's float32 scale at (page, head, slot) in
    (num_blocks, Hkv, block_size) pools, computed from that row alone
    (`quantize_kv_row`). A row's bytes are then a pure function of its
    values, whenever and wherever it is written, so a re-prefill after
    preemption reproduces the pages bit for bit. Decode steps read them
    with the paged-attention kernel's per-row mode (K8q)."""

    kp: torch.Tensor
    vp: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor


class RowQuantKVCache(typing.NamedTuple):
    """One layer's contiguous int8 KV cache with per-row scales: codes
    (B, max_len, Hkv, D) int8, scales (B, max_len, Hkv) float32. The
    temporary cache of the serving engine's admission prefill over int8
    pools: rows written here quantize with the pools' per-row rule, and
    attention reads them dequantized, so the prefill sees exactly the
    values a paged decode step will."""

    kq: torch.Tensor
    vq: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor


class PagedKVCache(typing.NamedTuple):
    """One layer's paged KV pools for continuous-batching serving: K and V
    as (num_blocks, Hkv, block_size, D) pages shared by every in-flight
    request; per-request block tables map a sequence's logical block j to
    a page id. Page 0 is the reserved scratch page (inactive rows write
    there), so allocators hand out ids >= 1."""

    kp: torch.Tensor
    vp: torch.Tensor


def quantize_kv_rows(x, scale):
    """Symmetric int8 codes of new K/V rows (B, S, Hkv, D) against
    per-(head, dim) scales; rows past the calibrated range saturate."""
    q = torch.round(x.float() / scale[None, None])
    return torch.clamp(q, -127, 127).to(torch.int8)


def calibrate_kv_scale(x, margin=1.0):
    """Per-(kv head, dim) absmax scales (Hkv, D) from prefill rows
    (B, S, Hkv, D)."""
    amax = x.float().abs().amax(dim=(0, 1))
    return torch.clamp(amax * margin, min=1e-6) / 127.0


def quantize_kv_row(x):
    """Per-row symmetric int8 codes of K/V rows (..., Hkv, D): each
    (row, head) quantizes against its own absmax. Returns (codes int8
    (..., Hkv, D), scales float32 (..., Hkv)). Rounding is half to even
    (`torch.round`, as `jnp.round`), so a float32 row gives the JAX
    package's codes and scales bit for bit."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_row(q, scale, dtype):
    """Inverse of `quantize_kv_row`: codes times their per-row scales, in
    float32, cast to `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)


def _generator(rng_key, device):
    """A torch.Generator on `device`: `rng_key` itself, or one seeded
    with it (None is seed 0)."""
    if isinstance(rng_key, torch.Generator):
        return rng_key
    return torch.Generator(device=device).manual_seed(
        0 if rng_key is None else int(rng_key))


def sample_tokens(logits, temperature, top_k, top_p, generator):
    """Greedy (temperature 0: argmax) or a draw from
    softmax(filter_logits(logits / temperature)) per row."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(
        filter_logits(logits.float() / temperature, top_k, top_p), dim=-1)
    return _draw(probs, generator)


def _draw(probs, generator):
    """One draw per row of (B, V) probabilities: argmax(probs / q) over
    q ~ Exponential(1), the draw `torch.multinomial(probs, 1)` makes
    (its one-sample path), the same generator state consumed, without
    its host-side checks of the distribution (a captured step cannot
    read the device)."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(-1)


class GenerationMixin:
    """Caches and generation for a causal LM with a `config` (hidden size,
    heads, kv heads, layers) whose parameters live on one device, and a
    cached forward `self(ids, caches=..., cache_index=...) -> (logits,
    caches)`."""

    def quantize_weights(self, bits=8):
        """Weight-only quantization for serving: a new model whose 2-D
        floating projections are `nn.quant.QuantizedWeight`s (int8, or
        packed int4), served by kernels K10 / K11. Lookup tables
        (`no_quantize`, e.g. `embed_tokens`) stay; a tied head served off
        the embedding stays full precision. The original is untouched."""
        from ..quantization import quantize_matmul_weights

        return quantize_matmul_weights(self, bits=bits, min_features=1)

    def cache_dtype(self):
        """Dtype of the KV cache (the embedding table's)."""
        raise NotImplementedError

    def _kv_shape(self):
        cfg = self.config
        head_dim = getattr(cfg, 'head_dim', None) or (
            cfg.hidden_size // cfg.num_attention_heads)
        kv_heads = (getattr(cfg, 'num_key_value_heads', None)
                    or cfg.num_attention_heads)
        return kv_heads, head_dim

    def _cache_dtype(self, dtype, paged):
        dtype = dtype or self.cache_dtype()
        if dtype not in (torch.bfloat16, torch.float32) and not (
                paged and dtype == torch.int8):
            if paged:
                raise NotImplementedError(
                    f'paged KV pool dtype {dtype}: the pools are bf16, '
                    f'float32 or int8')
            raise NotImplementedError(
                f'KV cache dtype {dtype}: an int8 contiguous cache is '
                f'init_cache(..., quantized=True)')
        return dtype

    def init_cache(self, batch_size, max_len, dtype=None, quantized=False):
        """Per-layer contiguous caches of (B, max_len, kv_heads, head_dim)
        zeros on the model's device: (k, v) pairs, or with
        quantized=True `QuantKVCache`s (int8 codes, zero scales that the
        first multi-token prefill calibrates)."""
        kv_heads, head_dim = self._kv_shape()
        shape = (int(batch_size), int(max_len), kv_heads, head_dim)
        dev = self.device
        if quantized:
            def z(shape, dt):
                return torch.zeros(shape, dtype=dt, device=dev)

            return [QuantKVCache(z(shape, torch.int8), z(shape, torch.int8),
                                 z((kv_heads, head_dim), torch.float32),
                                 z((kv_heads, head_dim), torch.float32))
                    for _ in range(self.config.num_hidden_layers)]
        dtype = self._cache_dtype(dtype, paged=False)
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in range(self.config.num_hidden_layers)]

    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        """Per-layer pools of (num_blocks, kv_heads, block_size, head_dim)
        zero pages on the model's device: PagedKVCache for bf16 / float32
        pages, QuantPagedKVCache for int8 ones (with float32 per-row
        scale pools of (num_blocks, kv_heads, block_size)). Page 0 is the
        reserved scratch page, so a usable pool needs num_blocks >= 2."""
        kv_heads, head_dim = self._kv_shape()
        dtype = self._cache_dtype(dtype, paged=True)
        shape = (int(num_blocks), kv_heads, int(block_size), head_dim)
        dev = self.device

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        if dtype == torch.int8:
            return [QuantPagedKVCache(z(shape, dtype), z(shape, dtype),
                                      z(shape[:3], torch.float32),
                                      z(shape[:3], torch.float32))
                    for _ in range(self.config.num_hidden_layers)]
        return [PagedKVCache(z(shape, dtype), z(shape, dtype))
                for _ in range(self.config.num_hidden_layers)]

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0, top_k=0,
                 top_p=1.0, rng_key=None, eos_token_id=None, num_beams=1,
                 length_penalty=0.0, attention_mask=None,
                 kv_cache_int8=False):
        """Greedy (temperature 0) or sampled decode; returns (B, S +
        max_new_tokens) ids, the prompt first. `rng_key` is a
        torch.Generator or an int seed (None: seed 0). With
        `eos_token_id`, a finished row emits eos from then on.
        `attention_mask` (B, S) 0/1 marks LEFT-padded prompts of unequal
        length: positions count each row's real tokens and pad rows are
        never attended. kv_cache_int8=True decodes over an int8 cache
        (`QuantKVCache`) whose scales calibrate on the prompt, so the
        prompt needs two tokens or more. The model keeps the captured
        decode step and the caches of the last geometry it decoded
        (`DecodeGraphs`) until another geometry or `release_graphs`."""
        return _generate(self, self, input_ids, max_new_tokens, temperature,
                         top_k, top_p, rng_key, eos_token_id, num_beams,
                         attention_mask, kv_cache_int8)

    def release_graphs(self):
        """Free the captured decode steps and the caches that this
        model's generate keeps (its `DecodeGraphs`)."""
        release_decode_graphs(self)

    def _generate_sample(self, input_ids, max_new_tokens, temperature, top_k,
                         top_p, rng_key, eos_token_id, attention_mask,
                         kv_cache_int8, graphs):
        B, S = input_ids.shape
        if kv_cache_int8 and S < 2:
            raise ValueError(
                'kv_cache_int8 needs a multi-token prompt: the per-head '
                'scales calibrate on the prefill rows')
        if 'kv_write_pos' not in inspect.signature(self.forward).parameters:
            raise NotImplementedError(
                f'{type(self).__name__} lacks kv_write_pos in its cached '
                f'forward: the decode step writes at a device position')
        dev = input_ids.device
        gen = _generator(rng_key, dev)
        extra, mask = {}, 'none'
        if attention_mask is not None:
            am = attention_mask.to(torch.int32)
            # pad rows clip to position 0; they are masked out anyway
            prompt_pos = torch.clamp(torch.cumsum(am, dim=1) - 1, min=0)
            real_len = am.sum(dim=1).to(torch.int32)
            kvalid = torch.cat(
                [am, torch.ones(B, max_new_tokens, dtype=torch.int32,
                                device=dev)], dim=1)
            extra = dict(positions=prompt_pos, kvalid=kvalid)
            mask = 'masked'
            # a left-padded mask is the window [S - real_len, now]: with
            # kv_start the decode steps keep the decode-attention kernel.
            # A right-padded or holed mask keeps the masked path.
            amn = am.cpu().numpy()
            rl = amn.sum(axis=1)
            left_contig = bool((amn == (np.arange(S)[None, :]
                                        >= (S - rl)[:, None])).all())
            if (left_contig and 'kv_start'
                    in inspect.signature(self.forward).parameters):
                extra['kv_start'] = (S - real_len).to(torch.int32)
                mask = 'kv_start'
        sampling = dict(temperature=float(temperature), top_k=int(top_k),
                        top_p=float(top_p), eos_token_id=eos_token_id)
        if max_new_tokens <= 1:
            # no decode step: a throwaway cache for the prefill alone
            bufs = _decode_buffers(self, B, S, max_new_tokens,
                                   kv_cache_int8)
            _decode_start(self, bufs, input_ids, extra, gen, **sampling)
            return torch.cat([input_ids,
                              bufs['out'].to(input_ids.dtype)], dim=1)
        graph = graphs.graph(self, B, S, max_new_tokens, kv_cache_int8,
                             mask, sampling)
        bufs = graph.static
        for t in _cache_tensors(bufs['caches']):
            t.zero_()          # the geometry's caches, as a fresh call's
        _decode_start(self, bufs, input_ids, extra, gen, **sampling)
        if graph.generator is not None:
            graph.generator.set_state(gen.get_state())
        graph.run(max_new_tokens - 1)
        if graph.generator is not None:
            gen.set_state(graph.generator.get_state())
        return torch.cat([input_ids, bufs['out'].to(input_ids.dtype)], dim=1)


def _generate(model, owner, input_ids, max_new_tokens, temperature, top_k,
              top_p, rng_key, eos_token_id, num_beams, attention_mask,
              kv_cache_int8):
    """`GenerationMixin.generate` of `model`, its decode steps captured
    in the `DecodeGraphs` of `owner` (the model itself, or the
    DecodeEngine that calls it)."""
    ids = torch.as_tensor(input_ids, device=model.device)
    if attention_mask is not None:
        attention_mask = torch.as_tensor(attention_mask, device=model.device)
        # an all-ones mask (equal-length batches) is no mask
        if bool(attention_mask.all()):
            attention_mask = None
    if attention_mask is not None:
        if 'kvalid' not in inspect.signature(model.forward).parameters:
            raise NotImplementedError(
                f'{type(model).__name__} does not support attention_mask '
                f'generation (cached forward lacks positions/kvalid)')
    if num_beams > 1:
        raise NotImplementedError(
            'beam search (num_beams > 1) is not ported yet (ROADMAP B1)')
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model._generate_sample(
                ids, max_new_tokens, temperature, top_k, top_p, rng_key,
                eos_token_id, attention_mask, kv_cache_int8,
                _decode_graphs(owner, model))
    finally:
        model.train(was_training)


def _cache_tensors(caches):
    return [t for c in caches for t in c]


def _decode_buffers(model, B, S, max_new_tokens, kv_cache_int8):
    """The buffers of one generate geometry: contiguous caches of S +
    max_new_tokens positions, the last chosen tokens `tok` (B,), the
    output `out` (B, max_new_tokens), the `finished` mask, the `step`
    count (1,) (the column of `tok` in `out`) and, for calls with an
    attention mask, each row's real length, its attendable rows `kvalid`
    and (left-padded) its window start `kv_start`. All zeros: a step may
    run on them as they are."""
    dev = model.device

    def z(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return dict(caches=model.init_cache(B, S + max_new_tokens,
                                        quantized=kv_cache_int8),
                tok=z(B), out=z(B, max_new_tokens),
                finished=z(B, dtype=torch.bool), step=z(1),
                real_len=z(B, dtype=torch.int32),
                kvalid=z(B, S + max_new_tokens, dtype=torch.int32),
                kv_start=z(B, dtype=torch.int32))


def _decode_start(model, bufs, input_ids, extra, generator, temperature,
                  top_k, top_p, eos_token_id):
    """The eager start of a generate call over a geometry's buffers:
    prefill the prompt into its caches, choose the first token into
    `tok` and column 0 of `out`, and reset `finished`, `step` and the
    mask rows."""
    logits, _ = model(input_ids, caches=bufs['caches'], cache_index=0,
                      **extra)
    if bufs['out'].shape[1] == 0:
        return
    tok = sample_tokens(logits[:, -1, :], temperature, top_k, top_p,
                        generator).to(torch.int64)
    bufs['tok'].copy_(tok)
    bufs['out'][:, 0] = tok
    bufs['finished'].copy_(tok == eos_token_id if eos_token_id is not None
                           else torch.zeros_like(bufs['finished']))
    bufs['step'].zero_()
    if 'kvalid' in extra:
        bufs['kvalid'].copy_(extra['kvalid'])
        bufs['real_len'].copy_(extra['kvalid'][:, :input_ids.shape[1]]
                               .sum(1))
    if 'kv_start' in extra:
        bufs['kv_start'].copy_(extra['kv_start'])


def _decode_step(model, caches, tok, out, finished, step, *, S,
                 real_len=None, kvalid=None, kv_start=None, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, generator=None):
    """One decode step of generate, in place on its buffers and with no
    host read: the forward of the last chosen tokens `tok` (B,) at the
    device position S + step (per-row write offsets over the caches;
    rope positions real_len + step under a mask), then the next token,
    chosen from its logits as `sample_tokens` chooses, into `tok` and
    column step + 1 of `out` (a finished row emits eos from then on), and
    `step` advanced. generate captures it once per geometry and replays
    it; called directly it is the eager reference."""
    B = tok.shape[0]
    extra = {}
    if kvalid is not None:
        extra = dict(positions=(real_len + step)[:, None], kvalid=kvalid)
        if kv_start is not None:
            extra['kv_start'] = kv_start
    logits, _ = model(tok[:, None], caches=caches,
                      kv_write_pos=(S + step).expand(B), **extra)
    nxt = sample_tokens(logits[:, -1, :], temperature, top_k, top_p,
                        generator).to(tok.dtype)
    if eos_token_id is not None:
        nxt = torch.where(finished, eos_token_id, nxt)
        finished |= nxt == eos_token_id
    step += 1
    out.scatter_(1, step.expand(B)[:, None], nxt[:, None])
    tok.copy_(nxt)


class DecodeGraphs:
    """generate's captured decode steps and generate_speculative's
    captured windows of one owner (a model's own calls, or a
    DecodeEngine's), with the buffers of each geometry. A decode
    geometry is the batch, prompt length, max_new_tokens, an int8 cache
    or not and the cache dtype; a speculative one adds k and the draft
    (held weakly). The graphs of one geometry (its mask modes and
    sampling configurations) share its caches. Decode steps share one
    runner's memory pool; the windows over each draft have a runner of
    their own, which watches the draft's weights beside the model's.
    Beside the pinned geometries (those used under `pinning`: a
    DecodeEngine's warmed ones) the last one used is kept, an earlier
    one dropped with its graphs when another comes; `release` drops
    them all. A decode geometry holds its caches, 2 L B (S + N) Hkv D
    elements of the cache dtype (int8 ones with their per-(head, dim)
    scales), a (B, S + N) int32 mask and a few (B,) vectors; a
    speculative one both models' caches of S + N + k + 1 positions; the
    pools hold one step's or window's activations."""

    def __init__(self, runner):
        self.runner = runner
        self.spec_runners = weakref.WeakKeyDictionary()
        self.buffers = {}
        self.pinned = set()
        self._pin = False

    @contextlib.contextmanager
    def pinning(self):
        """Pin every geometry used inside: it stays until `release`."""
        self._pin = True
        try:
            yield
        finally:
            self._pin = False

    def _buffers(self, geo, make):
        """The buffers of `geo`, made now (after the unpinned geometries
        are dropped) when there are none; pinned under `pinning`."""
        bufs = self.buffers.get(geo)
        if bufs is None:
            for old in [g for g in self.buffers if g not in self.pinned]:
                self._drop(old)
            bufs = self.buffers[geo] = make()
        if self._pin:
            self.pinned.add(geo)
        return bufs

    def graph(self, model, B, S, max_new_tokens, kv_cache_int8, mask,
              sampling):
        """The captured decode step of one generate call: its geometry's
        buffers, and the graph of its mask mode and sampling
        configuration, captured now when there is none (a sampled step
        with a generator of its own, registered with the graph; generate
        hands it the caller's state before the replays and takes it back
        after)."""
        geo = (B, S, max_new_tokens, bool(kv_cache_int8),
               model.cache_dtype())
        bufs = self._buffers(geo, lambda: _decode_buffers(
            model, B, S, max_new_tokens, kv_cache_int8))
        key = (geo, mask, tuple(sorted(sampling.items())))
        graph = self.runner.get(key)
        if graph is None:
            gen = (None if sampling['temperature'] == 0.0
                   else torch.Generator(device=model.device))
            body = functools.partial(_step_body, weakref.ref(model), bufs, S,
                                     mask, sampling, gen)
            graph = self._capture(self.runner, key, body, bufs,
                                  bufs['caches'], gen)
        return graph

    def spec_graph(self, model, draft, B, S, max_new_tokens, k,
                   kv_cache_int8, sampling=None):
        """The captured speculative window of one generate_speculative
        call (greedy), or with `sampling` ((name, value) pairs of
        temperature, top_k and top_p) of a batch-1 sampled one, whose
        proposals draw from a generator of its own registered with the
        graph: its geometry's buffers, and the graph, captured now when
        there is none in the draft's runner."""
        from ..inference.graphs import GraphRunner

        geo = ('spec', B, S, max_new_tokens, k, bool(kv_cache_int8),
               model.cache_dtype(), weakref.ref(draft))
        bufs = self._buffers(geo, lambda: _spec_buffers(
            model, draft, B, S, max_new_tokens, k, kv_cache_int8))
        runner = self.spec_runners.get(draft)
        if runner is None:
            runner = self.spec_runners[draft] = GraphRunner(
                self.runner.device, modules=[model, draft])
        key = (geo, sampling)
        graph = runner.get(key)
        if graph is None:
            gen = (None if sampling is None
                   else torch.Generator(device=model.device))
            body = functools.partial(_spec_body, weakref.ref(model),
                                     weakref.ref(draft), bufs, k, sampling,
                                     gen)
            graph = self._capture(runner, key, body, bufs,
                                  bufs['caches'] + bufs['dcaches'], gen)
        return graph

    @staticmethod
    def _capture(runner, key, body, bufs, caches, gen):
        # the run that goes eagerly before the capture starts where a
        # fresh call's would (a call's replays leave a decode step at N
        # - 1, one more would write past `out`)
        for name, t in bufs.items():
            if name not in ('caches', 'dcaches'):
                t.zero_()
        return runner.capture(key, body, bufs, _cache_tensors(caches), gen)

    def _runners(self):
        return [self.runner, *self.spec_runners.values()]

    def captures(self):
        """Graphs captured so far, decode steps and windows."""
        return sum(r.captures for r in self._runners())

    def _drop(self, geo):
        for runner in self._runners():
            runner.drop(lambda key: key[0] == geo)
        del self.buffers[geo]
        self.pinned.discard(geo)

    def release(self):
        """Drop every graph and every geometry's buffers."""
        for runner in self._runners():
            runner.release()
        self.spec_runners.clear()
        self.buffers.clear()
        self.pinned.clear()


def _decode_graphs(owner, model):
    """The `DecodeGraphs` of `owner` (created on first use; it lives as
    long as the owner)."""
    from ..inference.graphs import GraphRunner

    store = _DECODE_GRAPHS.get(owner)
    if store is None:
        store = _DECODE_GRAPHS[owner] = DecodeGraphs(
            GraphRunner(model.device, modules=[model]))
    return store


def release_decode_graphs(owner):
    """Free the captured decode steps and caches `owner` keeps."""
    store = _DECODE_GRAPHS.pop(owner, None)
    if store is not None:
        store.release()


def _step_body(model_ref, bufs, S, mask, sampling, generator):
    """A captured step's body: `_decode_step` over the geometry's
    buffers, with the mask rows of its mask mode (the model held weakly,
    so its graphs do not keep it alive)."""
    rows = {}
    if mask != 'none':
        rows = dict(real_len=bufs['real_len'], kvalid=bufs['kvalid'])
    if mask == 'kv_start':
        rows['kv_start'] = bufs['kv_start']
    return _decode_step(model_ref(), bufs['caches'], bufs['tok'],
                        bufs['out'], bufs['finished'], bufs['step'], S=S,
                        generator=generator, **rows, **sampling)


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

def _check_speculative_pair(target, draft):
    """What every speculative entry point refuses up front: a draft on
    another device than the target, and a model whose cached forward
    lacks per-row write offsets (the windows write at device
    positions)."""
    if draft.device != target.device:
        raise ValueError(
            f'the draft is on {draft.device}, the target on '
            f'{target.device}: speculative decoding runs both on one '
            f'device')
    for m_ in (target, draft):
        if 'kv_write_pos' not in inspect.signature(m_.forward).parameters:
            raise NotImplementedError(
                f'{type(m_).__name__} does not support speculative '
                f'decoding (cached forward lacks kv_write_pos): its '
                f'windows write at device positions')


class _eval_mode:
    """Both models in eval mode for the call (dropout would break the
    greedy losslessness and differ between draft and verify); the ones
    that were training are put back after."""

    def __init__(self, *models):
        self.models = models

    def __enter__(self):
        self.restore = [m_ for m_ in self.models
                        if bool(getattr(m_, 'training', False))]
        for m_ in self.restore:
            m_.eval()

    def __exit__(self, *exc):
        for m_ in self.restore:
            m_.train()


def generate_speculative(target, draft, input_ids, max_new_tokens=32,
                         num_draft_tokens=4, eos_token_id=None,
                         kv_cache_int8=False):
    """Greedy speculative decoding: LOSSLESS, the tokens
    `target.generate(...)` would give, with one target forward per
    window of up to k + 1 tokens (k = num_draft_tokens) instead of one
    per token. Each window the draft proposes k tokens in k + 1
    one-token steps (the last writes the k-th proposal's own KV row),
    the target verifies [c, d1..dk] in one forward, and the longest
    draft prefix the target's argmax agrees with commits with the
    target's next choice. Rejected rows of both caches are overwritten
    by the next window (writes start at the committed length, and
    position masking hides the rows beyond it).

    Rows commit at their own rates through per-row write offsets
    (`kv_write_pos`), each row by the rule its solo `generate` follows,
    and the host reads once per window (the proposals, accepted counts
    and next tokens together). The window is captured once per geometry
    as a CUDA graph and replayed (`_spec_window`); its caches outlive
    the call, kept as `generate`'s are (`DecodeGraphs`).
    kv_cache_int8=True serves both models over int8 caches
    (`QuantKVCache`, scales calibrated at their prefills), matching
    `target.generate(..., kv_cache_int8=True)`. Returns (B, S +
    max_new_tokens) ids, eos-padded after an early stop."""
    ids = torch.as_tensor(input_ids, device=target.device)
    B, S = ids.shape
    if kv_cache_int8 and S < 2:
        raise ValueError(
            'kv_cache_int8 needs a multi-token prompt: the per-head '
            'scales calibrate on the prefill rows')
    _check_speculative_pair(target, draft)
    with _eval_mode(target, draft), torch.no_grad():
        gen, _counts = _speculative_loop(target, draft, target, ids,
                                         max_new_tokens, num_draft_tokens,
                                         eos_token_id, kv_cache_int8)
    return torch.cat([ids, torch.as_tensor(gen, dtype=ids.dtype,
                                           device=ids.device)], dim=1)


def _spec_buffers(model, draft, B, S, max_new_tokens, k, kv_cache_int8):
    """The buffers of one speculative geometry: both models' contiguous
    caches of S + max_new_tokens + k + 1 positions (room for the last
    window), and a window's inputs, each row's candidate `c` (B, 1) and
    write offset `wp` (B,). All zeros: a window may run on them as they
    are."""
    max_len = S + max_new_tokens + k + 1
    dev = model.device
    return dict(caches=model.init_cache(B, max_len, quantized=kv_cache_int8),
                dcaches=draft.init_cache(B, max_len,
                                         quantized=kv_cache_int8),
                c=torch.zeros((B, 1), dtype=torch.int64, device=dev),
                wp=torch.zeros((B,), dtype=torch.int64, device=dev))


def _spec_window(target, draft, tcaches, dcaches, c, wp, k):
    """One greedy speculative window: rows write at their own offsets wp
    (B,) on both models (the draft's one-token steps take K7 at per-row
    lengths), the draft proposes k tokens in k + 1 one-token steps (the
    last writes the k-th proposal's own KV row), the target verifies [c,
    d1..dk] in one forward, and the commit rule runs per row on the
    device as a cumprod (`_commit_window` is its host-side spec). c (B,
    1). Returns (drafts (B, k), accepted counts m (B,), next tokens
    (B,))."""
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


def _spec_body(model_ref, draft_ref, bufs, k, sampling, generator):
    """A captured speculative window's body over its geometry's buffers:
    `_spec_window` (greedy), or `_sampled_window` under `sampling` ((name,
    value) pairs of temperature, top_k, top_p) drawing from `generator`.
    The models are held weakly, so the graphs do not keep them alive."""
    target, draft = model_ref(), draft_ref()
    if sampling is None:
        return _spec_window(target, draft, bufs['caches'], bufs['dcaches'],
                            bufs['c'], bufs['wp'], k)
    return _sampled_window(target, draft, bufs['caches'], bufs['dcaches'],
                           bufs['c'], bufs['wp'], generator, k,
                           dict(sampling))


def _speculative_loop(target, draft, owner, input_ids, max_new_tokens,
                      num_draft_tokens, eos_token_id, kv_cache_int8=False):
    """The greedy speculative host loop over the geometry's captured
    window in the `DecodeGraphs` of `owner` (the target, or the
    DecodeEngine that calls it): both prefills into the geometry's
    caches, then one window per iteration over every row with one host
    read. Rows commit at their own rates by the batch-1 rule; finished
    and full rows still ride through the window but commit nothing, and
    their offset is held inside the cache (torch raises on a write past
    it, where JAX drops it): what they write there is never read back.
    Returns (B lists of max_new_tokens ids, {'windows', 'proposed',
    'accepted'})."""
    B, S = input_ids.shape
    k = int(num_draft_tokens)
    if k < 1:
        raise ValueError('num_draft_tokens must be >= 1')
    graph = _decode_graphs(owner, target).spec_graph(
        target, draft, B, S, max_new_tokens, k, kv_cache_int8)
    bufs = graph.static
    for t in _cache_tensors(bufs['caches'] + bufs['dcaches']):
        t.zero_()              # the geometry's caches, as a fresh call's
    logits, _ = target(input_ids, caches=bufs['caches'], cache_index=0)
    draft(input_ids, caches=bufs['dcaches'], cache_index=0)
    c_host = torch.argmax(logits[:, -1], dim=-1).tolist()
    counts = {'windows': 0, 'proposed': 0, 'accepted': 0}
    out = [[] for _ in range(B)]
    finished = [False] * B
    L = np.full((B,), S, np.int64)

    def row_needs(b):
        return not finished[b] and len(out[b]) < max_new_tokens

    while any(row_needs(b) for b in range(B)):
        graph.load(c=np.asarray(c_host, np.int64)[:, None],
                   wp=np.minimum(L, S + max_new_tokens))
        drafts, m, nxt = graph.run()
        host = torch.cat([drafts, m[:, None], nxt[:, None]], 1).tolist()
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


def _commit_window(c, d_row, t_row, k):
    """The greedy commit rule as a host-side reference: accept the
    longest draft prefix the target agrees with, commit [c] + that
    prefix, and take the next token from the target's own choice at the
    first disagreement (or its bonus choice after a full accept).
    Returns (committed tokens, next token). The loops run the same rule
    on the device (m = sum(cumprod(d == t[:k])), next = t[m]); this is
    the spec they are tested against."""
    d = np.asarray(d_row)
    t = np.asarray(t_row)
    agree = (d[:k] == t[:k]).astype(np.int64)
    m_acc = int(agree.cumprod().sum())
    committed = [int(c)] + [int(x) for x in d[:m_acc]]
    return committed, int(t[m_acc])


def _speculative_accept_dists(pt, pd):
    """The rejection-sampling identity: for target and draft
    distributions pt, pd (..., V) at one position, 'sample x ~ pd;
    accept with probability min(1, pt(x) / pd(x)); else resample from
    norm((pt - pd)+)' outputs exactly pt. Returns (the accept
    probability of every token, the residual distribution)."""
    accept = torch.clamp(pt / torch.clamp(pd, min=1e-30), max=1.0)
    residual = torch.clamp(pt - pd, min=0.0)
    residual = residual / torch.clamp(residual.sum(-1, keepdim=True),
                                      min=1e-30)
    return accept, residual


def generate_speculative_sampled(target, draft, input_ids,
                                 max_new_tokens=32, num_draft_tokens=4,
                                 temperature=1.0, top_k=0, top_p=1.0,
                                 rng_key=None, eos_token_id=None):
    """Sampled speculative decoding (Leviathan / Chen rejection
    sampling): the draft proposes tokens sampled at `temperature`; each
    is accepted with probability min(1, p_target / p_draft), and a
    rejection resamples from the normalised residual (p_target -
    p_draft)+. The output's law is that of sampling the target directly
    (with temperature / top_k / top_p applied to both models, the
    filtered target's). temperature 0 is the greedy, lossless
    `generate_speculative`.

    Batch 1. `rng_key` (a torch.Generator or an int seed; None is 0)
    drives the first token and the draft's proposals; the accept coins
    and resamples come from a second, independent generator seeded by
    one draw of the first. The host reads once per window (the
    proposals and both models' distributions together). The window is
    captured once per geometry and sampling configuration as a CUDA
    graph and replayed (`_sampled_window`), its caches kept as
    `generate`'s are. The streams are the port's own, never the JAX
    package's threefry draws."""
    if temperature == 0.0:
        return generate_speculative(target, draft, input_ids,
                                    max_new_tokens, num_draft_tokens,
                                    eos_token_id)
    ids = torch.as_tensor(input_ids, device=target.device)
    B, S = ids.shape
    if B != 1:
        raise NotImplementedError(
            'sampled speculative decoding is batch-1; loop prompts '
            'individually (greedy supports batches)')
    _check_speculative_pair(target, draft)
    with _eval_mode(target, draft), torch.no_grad():
        out = _speculative_sampled_loop(
            target, draft, ids, max_new_tokens, num_draft_tokens,
            temperature, top_k, top_p, rng_key, eos_token_id)
    return torch.cat([ids, torch.as_tensor([out], dtype=ids.dtype,
                                           device=ids.device)], dim=1)


def _sampled_dist(logits, temperature, top_k, top_p):
    """Temperature and top-k / top-p applied to both models'
    distributions: filtered entries softmax to exact 0, so they can be
    neither proposed nor resampled."""
    return torch.softmax(filter_logits(logits.float() / temperature, top_k,
                                       top_p), dim=-1)


def _sampled_prefill(m, caches, ids, cfg):
    logits, caches = m(ids, caches=caches, cache_index=0)
    return _sampled_dist(logits[:, -1, :], **cfg)


def _sampled_window(target, draft, tcaches, dcaches, c, wp, gen, k, cfg):
    """One batch-1 sampled window: the draft samples k proposals in k + 1
    one-token steps at the offsets wp + i (the last writes the k-th
    proposal's KV row), each drawn from `gen` by `_draw` (a captured
    body cannot take `torch.multinomial`'s host-side checks), then the
    target verifies [c, d1..dk] in one forward. c (1, 1), wp (1,).
    Returns (the proposals (k,), the draft's distributions at each (k,
    V), the target's (k + 1, V))."""
    tok, toks, ps = c, [], []
    for i in range(k + 1):
        logits, dcaches = draft(tok, caches=dcaches, kv_write_pos=wp + i)
        if i == k:
            break
        p = _sampled_dist(logits[:, -1], **cfg)
        tok = _draw(p, gen)[:, None]
        toks.append(tok[0, 0])
        ps.append(p[0])
    drafts = torch.stack(toks)
    tlogits, tcaches = target(torch.cat([c, drafts[None]], 1),
                              caches=tcaches, kv_write_pos=wp)
    return drafts, torch.stack(ps), _sampled_dist(tlogits[0], **cfg)


def _sampled_commit(d, pt, pd, k, coins):
    """One window's rejection-sampling commit on the host: proposal i
    is accepted with probability min(1, pt[i](d_i) / pd[i](d_i)); the
    first rejection resamples from the residual (pt - pd)+ (pt itself
    when pt <= pd everywhere), a full accept draws the bonus token from
    pt[k]. d (k,), pt (k + 1, V), pd (k, V) on the CPU in float64;
    `coins` a CPU torch.Generator. Returns (accepted proposals, next
    token)."""
    def draw(p):
        return int(torch.multinomial(p, 1, generator=coins))

    accepted = []
    for i in range(k):
        x = int(d[i])
        accept, residual = _speculative_accept_dists(pt[i], pd[i])
        if float(torch.rand((), dtype=torch.float64,
                            generator=coins)) < float(accept[x]):
            accepted.append(x)
            continue
        return accepted, draw(residual if residual.sum() > 0 else pt[i])
    return accepted, draw(pt[k])


def _speculative_sampled_loop(target, draft, input_ids, max_new_tokens,
                              num_draft_tokens, temperature, top_k, top_p,
                              rng_key, eos_token_id):
    """Both prefills into the geometry's caches (the target's own
    `DecodeGraphs`), the first token, then one captured `_sampled_window`
    per iteration and its rejection-sampling commit on the host. The
    proposals draw from the graph's generator, which takes the caller's
    state before the windows and hands it back after: the same
    `rng_key`, the same stream as the window run directly."""
    B, S = input_ids.shape
    k = int(num_draft_tokens)
    if k < 1:
        raise ValueError('num_draft_tokens must be >= 1')
    dev = input_ids.device
    cfg = dict(temperature=float(temperature), top_k=int(top_k),
               top_p=float(top_p))
    graph = _decode_graphs(target, target).spec_graph(
        target, draft, B, S, max_new_tokens, k, False, tuple(cfg.items()))
    bufs = graph.static
    for t in _cache_tensors(bufs['caches'] + bufs['dcaches']):
        t.zero_()
    gen = _generator(rng_key, dev)
    p_last = _sampled_prefill(target, bufs['caches'], input_ids, cfg)
    _sampled_prefill(draft, bufs['dcaches'], input_ids, cfg)
    c = torch.multinomial(p_last, 1, generator=gen)              # (1, 1)
    # the accept / resample coins: an independent stream, seeded by one
    # draw of the proposal stream (the exactness proof assumes the coins
    # do not correlate with the proposals)
    coins = torch.Generator().manual_seed(int(torch.randint(
        0, 2 ** 31 - 1, (1,), generator=gen, device=dev)))
    graph.generator.set_state(gen.get_state())
    c_host = int(c)
    out, L = [], S
    while len(out) < max_new_tokens:
        graph.load(c=np.array([[c_host]], np.int64),
                   wp=np.array([L], np.int64))
        drafts, pd, pt = graph.run()
        # one host read per window: proposals and both distributions
        V = pt.shape[-1]
        host = torch.cat([pt.double().reshape(-1), pd.double().reshape(-1),
                          drafts.double()]).cpu()
        accepted, nxt = _sampled_commit(
            host[-k:].long(), host[:(k + 1) * V].view(k + 1, V),
            host[(k + 1) * V:-k].view(k, V), k, coins)
        committed = [c_host] + accepted
        out.extend(committed)
        if eos_token_id is not None and eos_token_id in committed:
            out = out[:out.index(eos_token_id) + 1]
            break
        c_host = nxt
        L += len(committed)
    gen.set_state(graph.generator.get_state())
    if eos_token_id is not None and len(out) < max_new_tokens:
        out += [eos_token_id] * (max_new_tokens - len(out))
    return out[:max_new_tokens]
