"""Paddle's fused-inference ops (counterpart of
paddle_tpu/incubate/nn/functional.py): the serving-side attention
primitives and the functional decoder stack that PaddleNLP's inference
path calls.

- `masked_multihead_attention`: one decode token per row over a
  contiguous head-major cache (2, B, H, max_seq, D), written in place;
  attention is the head-major decode kernel (K9 of PERF.md) on the card.
- `block_multihead_attention`: paged-KV serving attention in both of its
  phases: a varlen causal prefill over the packed token stream (segment
  ids: the flash kernel's K5s forward at 128 tokens or more), then paged
  decode (K8 for bf16 / float32 pages, K8q's (Hkv, D) mode for int8
  pages with static scales).
- `fused_moe`: the fused serving MoE layer (top-k over precomputed
  gate logits, SwiGLU experts with a fused gate + up weight, int8 weights
  dequantized by their scales) on the dropless path of
  `distributed.moe`, whose expert products run the grouped kernel X1.
- `fused_multi_transformer` and `fused_multi_transformer_decode_step`:
  the pre/post-norm decoder stack with per-layer weight lists; prefill
  through `scaled_dot_product_attention` (K5 at 128 tokens or more),
  `time_step` decode through `masked_multihead_attention` (K9); norms
  are LayerNorm (plain PyTorch, as the JAX package has no Pallas layer
  norm) or RMSNorm (K1).

Caches are updated in place (the JAX functions return new arrays; the
decode step there donates its caches): each function returns the same
cache tensors it was given. The reference CUDA pipeline's knobs
(smooth-quant scales, beam offsets, pre-caches, dynamic cache
quantization) raise NotImplementedError, as in the JAX package. Dispatch
rules kept from it: `src_mask` / `tgt_mask` take the plain masked path,
as does a head size that is not a multiple of 8.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import ops
from ...models.llama import apply_rotary
from ...nn.functional.attention import NEG_INF, scaled_dot_product_attention
from ...nn.functional.norm import layer_norm

__all__ = ['block_multihead_attention', 'fused_dropout_add', 'fused_moe',
           'fused_multi_transformer', 'fused_multi_transformer_decode_step',
           'masked_multihead_attention']


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return torch.nn.functional.gelu(x, approximate='tanh')


ACTIVATIONS = {'gelu': _gelu, 'relu': torch.relu,
               'silu': torch.nn.functional.silu}


def fused_dropout_add(x, y, p=0.0, training=True, mode='upscale_in_train'):
    """dropout(x) + y in its inference form: p = 0 or training=False
    (where 'downscale_in_infer' scales x by 1 - p). Dropout with p > 0 in
    training is not ported and raises."""
    if p == 0.0:
        return x + y
    if training:
        raise NotImplementedError(
            'fused_dropout_add: dropout in training (p > 0, training=True) '
            'is not ported; the fused-inference ops run with training=False')
    if mode == 'downscale_in_infer':
        x = x * (1 - p)
    return x + y


def _split_qkv(x, num_heads, num_kv_heads, head_dim):
    """(T, (Hq + 2 * Hkv) * D) fused qkv -> q (T, Hq, D), k and v
    (T, Hkv, D)."""
    q_sz = num_heads * head_dim
    kv_sz = num_kv_heads * head_dim
    lead = x.shape[:-1]
    q = x[..., :q_sz].reshape(*lead, num_heads, head_dim)
    k = x[..., q_sz:q_sz + kv_sz].reshape(*lead, num_kv_heads, head_dim)
    v = x[..., q_sz + kv_sz:].reshape(*lead, num_kv_heads, head_dim)
    return q, k, v


def _rope_rows(q, k, cos, sin, neox):
    """Rotate one row per sequence: q, k (N, H, D); cos, sin (N, D / 2).
    neox=True is rotate-half; False rotates interleaved pairs (GPT-J, the
    reference's default)."""
    if neox:
        return (apply_rotary(q[:, None], cos[:, None], sin[:, None])[:, 0],
                apply_rotary(k[:, None], cos[:, None], sin[:, None])[:, 0])

    def rot(x):
        D = x.shape[-1]
        xp = x.reshape(*x.shape[:-1], D // 2, 2)
        xe, xo = xp[..., 0], xp[..., 1]
        c, sn = cos[:, None, :], sin[:, None, :]
        return torch.stack([xe * c - xo * sn, xo * c + xe * sn],
                           -1).reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


def _host_ints(x):
    """Sequence lengths as a 1-D numpy int array (one host read for a
    tensor on the card)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.reshape(np.asarray(x), (-1,))


def _row_gather(table, idx):
    """table (B, S, X)[b, idx[b]] -> (B, X)."""
    return table[torch.arange(table.shape[0], device=table.device), idx]


def _mmha(x, cache_kv, bias, src_mask, lens, rotary_tensor, neox):
    """masked_multihead_attention after its argument checks; lens (B,)
    int64 on x's device."""
    _, B, H, S, D = cache_kv.shape
    q, k, v = _split_qkv(x, H, H, D)                     # (B, H, D) each
    if bias is not None:
        b3 = torch.as_tensor(bias, device=x.device).reshape(3, H, D)
        q, k, v = q + b3[0], k + b3[1], v + b3[2]
    if rotary_tensor is not None:
        rt = torch.as_tensor(rotary_tensor, device=x.device)
        if rt.dim() != 4 or rt.shape[0] != 2:
            raise NotImplementedError(
                'rotary_tensor must be a (2, B, S, D/2) cos/sin stack (the '
                'reference CUDA layouts are kernel-internal); or pre-rotate '
                'q/k and pass rotary_tensor=None')
        q, k = _rope_rows(q, k, _row_gather(rt[0], lens),
                          _row_gather(rt[1], lens), neox)
    ck, cv = cache_kv[0], cache_kv[1]                    # (B, H, S, D)
    rows = torch.arange(B, device=x.device)
    ck[rows, :, lens] = k.to(ck.dtype)
    cv[rows, :, lens] = v.to(cv.dtype)
    counts = lens + 1
    if src_mask is None and D % 8 == 0:
        out = ops.decode_attention_headmajor(q[:, None], ck, cv, counts)[:, 0]
    else:
        logits = torch.einsum('bhd,bhsd->bhs', q.float(),
                              ck.float()) / math.sqrt(D)
        mask = torch.arange(S, device=x.device)[None, None, :] \
            < counts[:, None, None]
        logits = torch.where(mask, logits, NEG_INF)
        if src_mask is not None:
            logits = logits + torch.as_tensor(
                src_mask, device=x.device).float().reshape(B, 1, -1)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum('bhs,bhsd->bhd', p, cv.float()).to(x.dtype)
    return out.reshape(B, H * D), cache_kv


def _check_not_full(lens, S):
    if (lens >= S).any():
        raise ValueError(
            f'cache is full (sequence_length >= max_seq {S}): the new token '
            f'has nowhere to land — grow the cache')


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype='default', out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """Single-token decode MHA over a contiguous head-major cache.

    x (B, 3 * H * D): fused qkv of one new token per row; cache_kv
    (2, B, H, max_seq, D) bf16 / float32, written IN PLACE at each row's
    `sequence_lengths` (B, 1) position; bias (3 * H * D,);
    rotary_tensor (2, B, S, D / 2) cos / sin applied to q and k at each
    row's position. Returns (out (B, H * D), cache_kv), the cache being
    the tensor passed in. Attention is the head-major decode kernel (K9)
    on the card; with `src_mask` (added to the logits) or D % 8 != 0 the
    plain masked path. The JAX package's refusals are kept: the
    reference's smooth-quant / beam knobs, an int8 cache (this API has
    no scales) and a full cache raise."""
    for name, v_ in (('qkv_out_scale', qkv_out_scale),
                     ('out_shift', out_shift), ('out_smooth', out_smooth),
                     ('beam_cache_offset', beam_cache_offset)):
        if v_ is not None:
            raise NotImplementedError(
                f'{name} belongs to the reference CUDA smooth-quant/beam '
                f'pipeline and is not supported')
    if out_scale != -1:
        raise NotImplementedError('out_scale quantized output unsupported')
    if cache_kv is None:
        raise ValueError(
            'masked_multihead_attention requires cache_kv (the '
            '(2, B, H, max_seq, D) decode cache written at prefill) — '
            'there is no cache-less decode step')
    if cache_kv.dtype == torch.int8:
        raise NotImplementedError(
            'int8 cache_kv is not supported by masked_multihead_attention '
            '(no scale inputs in this API) — use block_multihead_attention '
            'with static dequant scales, or generate(kv_cache_int8=True)')
    if sequence_lengths is None:
        raise ValueError(
            'sequence_lengths is required (per-row cache write position)')
    _check_not_full(_host_ints(sequence_lengths), cache_kv.shape[3])
    lens = torch.as_tensor(sequence_lengths, device=x.device).reshape(-1) \
        .long()
    return _mmha(x, cache_kv, bias, src_mask, lens, rotary_tensor,
                 use_neox_rotary_style)


def _rope_table(rope_emb, device):
    re = torch.as_tensor(rope_emb, device=device)
    if re.dim() == 5:                                    # (2, B, S, 1, D/2)
        re = re[:, :, :, 0, :]
    if re.dim() != 4 or re.shape[0] != 2:
        raise NotImplementedError(
            'rope_emb must be (2, B, max_seq, [1,] D/2) cos/sin')
    return re


def block_multihead_attention(
        qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder,
        seq_lens_this_time, padding_offsets=None, cum_offsets=None,
        cu_seqlens_q=None, cu_seqlens_k=None, block_tables=None,
        pre_key_cache=None, pre_value_cache=None, cache_k_quant_scales=None,
        cache_v_quant_scales=None, cache_k_dequant_scales=None,
        cache_v_dequant_scales=None, qkv_out_scale=None, qkv_bias=None,
        out_shift=None, out_smooth=None, max_enc_len_this_time=None,
        max_dec_len_this_time=None, rope_emb=None, mask=None, tgt_mask=None,
        max_seq_len=-1, block_size=64, use_neox_style=False,
        use_dynamic_cachekv_quant=False, quant_round_type=1,
        quant_max_bound=127.0, quant_min_bound=-127.0, out_scale=-1,
        compute_dtype='default', num_heads=None, num_kv_heads=None):
    """Paged-KV serving attention, one phase per call.

    - PREFILL (some seq_lens_encoder > 0): the unpadded token stream
      (T, (Hq + 2 * Hkv) * D) attends causally within each sequence
      (`cu_seqlens_q` (B + 1,) prefix sums; segment ids through
      `scaled_dot_product_attention`, the flash kernel's K5s forward at
      128 tokens or more) and its K/V rows land in their pages.
    - DECODE (seq_lens_decoder > 0, one token per row): each active
      row's K/V lands in its page (rows with seq_lens_this_time 0 write
      nothing), then the paged-attention kernel (K8; K8q for int8 pages)
      attends the row's pages.

    key_cache / value_cache (max_block_num, Hkv, block_size, D) are
    updated IN PLACE; block_tables (B, MAXB). Static cache-KV int8:
    int8 caches with cache_k/v_dequant_scales of (Hkv,) or (Hkv, D)
    (rows quantize against them, rounding half to even, clipped to
    [quant_min_bound, quant_max_bound]). Returns (out, qkv, key_cache,
    value_cache). Mixed prefill + decode in one call, dynamic cache
    quantization and the reference CUDA pipeline's knobs raise, as in
    the JAX package. Both phases run eagerly (a captured decode phase is
    ROADMAP A9b)."""
    for name, v_ in (('qkv_out_scale', qkv_out_scale),
                     ('out_shift', out_shift), ('out_smooth', out_smooth),
                     ('pre_key_cache', pre_key_cache),
                     ('pre_value_cache', pre_value_cache)):
        if v_ is not None:
            raise NotImplementedError(
                f'{name} is part of the reference CUDA smooth-quant/'
                f'pre-cache pipeline and is not supported')
    if use_dynamic_cachekv_quant:
        raise NotImplementedError(
            'dynamic cache-KV quant (per-batch scales) is not supported: '
            'use static dequant scales')
    if out_scale != -1:
        raise NotImplementedError('quantized fmha output unsupported')

    NB, Hkv, BS, D = key_cache.shape
    if block_size != BS:
        raise ValueError(f'block_size={block_size} != cache page size {BS}')
    dev = qkv.device
    enc = _host_ints(seq_lens_encoder)
    dec = _host_ints(seq_lens_decoder)
    B = enc.shape[0]
    if num_kv_heads is None:
        num_kv_heads = Hkv
    if num_heads is None:
        num_heads = qkv.shape[-1] // D - 2 * num_kv_heads
    Hq = num_heads
    q, k, v = _split_qkv(qkv, Hq, num_kv_heads, D)      # (T, H*, D)
    if qkv_bias is not None:
        bq, bk, bv = _split_qkv(torch.as_tensor(qkv_bias, device=dev)[None],
                                Hq, num_kv_heads, D)
        q, k, v = q + bq[0], k + bk[0], v + bv[0]

    prefill = bool((enc > 0).any())
    decode = bool((dec > 0).any()) and not prefill
    if prefill and bool((dec > 0).any()):
        raise NotImplementedError(
            'mixed prefill+decode batches are not supported in one call; '
            'split the batch by phase')

    tbl = torch.as_tensor(block_tables, device=dev).to(torch.int32) \
        .clamp(0, NB - 1).contiguous()
    quant_cache = key_cache.dtype == torch.int8
    kds = vds = None
    if quant_cache:
        def canon_scale(s):
            s = torch.as_tensor(s, device=dev).float()
            return (s[:, None].expand(Hkv, D) if s.dim() == 1
                    else s).contiguous()

        kds = canon_scale(cache_k_dequant_scales)
        vds = canon_scale(cache_v_dequant_scales)

    def rows_for(cache, x, ds):
        if not quant_cache:
            return x.to(cache.dtype)
        qx = torch.round(x.float() / ds[None])
        return torch.clamp(qx, quant_min_bound, quant_max_bound).to(
            torch.int8)

    re = _rope_table(rope_emb, dev) if rope_emb is not None else None

    if prefill:
        # varlen causal prefill over the unpadded token stream
        cu = torch.as_tensor(cu_seqlens_q, device=dev).reshape(-1).long()
        T = q.shape[0]
        tok = torch.arange(T, device=dev)
        seg = torch.searchsorted(cu[1:], tok, right=True)
        pos = tok - cu[seg]                              # position in seq
        if re is not None:
            q, k = _rope_rows(q, k, re[0][seg, pos], re[1][seg, pos],
                              use_neox_style)
        out = scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True,
            segment_ids=seg[None].to(torch.int32))[0]  # (T, Hq, D)
        # token t of sequence b at position p lands in page
        # tbl[b, p // BS], slot p % BS
        page = tbl[seg, pos // BS].long()
        slot = pos % BS
        key_cache[page, :, slot] = rows_for(key_cache, k, kds)
        value_cache[page, :, slot] = rows_for(value_cache, v, vds)
        return out.reshape(T, Hq * D), qkv, key_cache, value_cache

    if decode:
        # one token per row: paged decode
        if q.shape[0] != B:
            raise NotImplementedError(
                f'decode expects one qkv row per batch row (got '
                f'{q.shape[0]} tokens for batch {B}); keep finished rows in '
                f'the batch with seq_lens_this_time=0')
        this = _host_ints(seq_lens_this_time)
        if ((dec + (this > 0)) > tbl.shape[1] * BS).any():
            raise ValueError(
                f'page capacity exceeded: a row needs position '
                f'{int(dec.max())} but block_tables provides only '
                f'{tbl.shape[1]} pages x {BS} slots — allocate another '
                f'page for the row')
        active = torch.as_tensor(this > 0, device=dev)
        lens = torch.as_tensor(dec, device=dev).long()   # context so far
        rows = torch.arange(B, device=dev)
        page = tbl[rows, lens // BS].long()
        slot = lens % BS
        if re is not None:
            q, k = _rope_rows(q, k, _row_gather(re[0], lens),
                              _row_gather(re[1], lens), use_neox_style)
        # finished / inactive rows keep their page contents
        for cache, x, ds in ((key_cache, k, kds), (value_cache, v, vds)):
            old = cache[page, :, slot]
            cache[page, :, slot] = torch.where(active[:, None, None],
                                               rows_for(cache, x, ds), old)
        counts = (lens + 1).to(torch.int32)
        if D % 8 == 0 and tgt_mask is None:
            out = ops.paged_decode_attention(
                q[:, None].contiguous(), key_cache, value_cache, tbl, counts,
                k_scale=kds, v_scale=vds)[:, 0]
        else:
            # the plain masked path: each row's pages gathered
            maxb = tbl.shape[1]
            g = tbl.long()

            def gather(cache, ds):
                c = cache[g].float().transpose(2, 3).reshape(
                    B, maxb * BS, Hkv, D)
                if ds is not None:
                    c = c * ds[None, None]
                return c.repeat_interleave(Hq // Hkv, dim=2)

            logits = torch.einsum('bhd,bshd->bhs', q.float(),
                                  gather(key_cache, kds)) / math.sqrt(D)
            msk = torch.arange(maxb * BS, device=dev)[None, None, :] \
                < counts[:, None, None]
            if tgt_mask is not None:
                tm = torch.as_tensor(tgt_mask, device=dev).float() \
                    .reshape(B, 1, -1)
                logits = logits + torch.nn.functional.pad(
                    tm, (0, maxb * BS - tm.shape[-1]))
            logits = torch.where(msk, logits, NEG_INF)
            p = torch.softmax(logits, dim=-1)
            out = torch.einsum('bhs,bshd->bhd', p,
                               gather(value_cache, vds)).to(qkv.dtype)
        return out.reshape(B, Hq * D), qkv, key_cache, value_cache

    raise ValueError('neither prefill (seq_lens_encoder) nor decode '
                     '(seq_lens_decoder) rows present')


def _norm_fn(norm_type, epsilon):
    if norm_type == 'layernorm':
        def norm(h, scale, bias):
            return layer_norm(h, h.shape[-1],
                              None if scale is None else scale.reshape(-1),
                              None if bias is None else bias.reshape(-1),
                              epsilon)
    elif norm_type == 'rmsnorm':
        def norm(h, scale, bias):
            out = ops.rms_norm(h, None if scale is None else scale.reshape(-1),
                               epsilon)
            return out if bias is None else out + bias
    else:
        raise ValueError(f'norm_type must be layernorm|rmsnorm, '
                         f'got {norm_type!r}')
    return norm


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights,
                            qkv_biases, linear_weights, linear_biases,
                            ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                            ffn1_biases, ffn2_weights, ffn2_biases,
                            pre_layer_norm=True, epsilon=1e-5,
                            residual_alpha=1.0, cache_kvs=None,
                            beam_offset=None, pre_caches=None,
                            seq_lens=None, rotary_embs=None,
                            time_step=None, attn_mask=None,
                            dropout_rate=0.0, rotary_emb_dims=0,
                            activation='gelu', training=False,
                            mode='upscale_in_train', trans_qkvw=True,
                            ring_id=-1, norm_type='layernorm',
                            use_neox_rotary_style=True,
                            gqa_group_size=-1, name=None):
    """The functional decoder stack: per layer, norm -> fused qkv
    ((3, H, D, E) weights) -> attention -> out projection -> residual,
    then norm -> FFN (E -> dim_feedforward -> E, `activation`) ->
    residual; pre- or post-norm.

    Without `time_step` this is the prefill: causal attention over x
    (B, S, E) (or `attn_mask`) through `scaled_dot_product_attention`,
    and, with `cache_kvs` (per-layer (2, B, H, max_seq, D)), K/V written
    into positions [0, S) in place. With `time_step`, x (B, 1, E) is one
    decode token per row: `masked_multihead_attention` at each row's
    `seq_lens` (B,) position, or at `time_step` for every row. Returns x,
    or (x, cache_kvs) with caches. norm_type 'layernorm' or 'rmsnorm'
    (the fused RMSNorm kernel; bias added after); activation 'gelu'
    (tanh approximation, as jax.nn.gelu), 'relu' or 'silu'. The JAX
    package's refusals are kept."""
    for nm, v in (('beam_offset', beam_offset), ('pre_caches', pre_caches),
                  ('rotary_embs', rotary_embs)):
        if v is not None:
            raise NotImplementedError(
                f'{nm}: use the Llama-family models for RoPE/beam serving')
    if not trans_qkvw:
        raise NotImplementedError('trans_qkvw=False unsupported')
    if gqa_group_size not in (-1, 0):
        raise NotImplementedError(
            'gqa: use the Llama family (GQA-native) models')
    if residual_alpha != 1.0:
        raise NotImplementedError('residual_alpha != 1 unsupported')
    norm = _norm_fn(norm_type, epsilon)
    if activation not in ACTIVATIONS:
        raise ValueError(f'activation must be one of {list(ACTIVATIONS)}')
    act = ACTIVATIONS[activation]
    if time_step is not None and x.shape[1] != 1:
        raise ValueError('time_step decode expects one token per row')
    if time_step is not None and cache_kvs is None:
        raise ValueError(
            'time_step decode requires cache_kvs (the per-layer '
            '(2, B, H, max_seq, D) caches written at prefill)')
    if time_step is not None and attn_mask is not None:
        raise NotImplementedError(
            'attn_mask is not applied on time_step decode steps (the '
            'cache window is positional) — drive padded decode via '
            'seq_lens instead of a mask')

    lens = None
    if time_step is not None:
        B = x.shape[0]
        if seq_lens is not None:
            host = _host_ints(seq_lens)
            lens = torch.as_tensor(seq_lens, device=x.device).reshape(-1) \
                .long().expand(B)
        else:
            host = np.full((B,), int(time_step))
            lens = torch.full((B,), int(time_step), dtype=torch.int64,
                              device=x.device)
        # every layer writes the same positions: check the caches once
        for cache in cache_kvs:
            if cache.dtype == torch.int8:
                raise NotImplementedError(
                    'int8 cache_kv is not supported by '
                    'masked_multihead_attention')
            _check_not_full(host, cache.shape[3])

    for i in range(len(qkv_weights)):
        qkv_w = qkv_weights[i]                           # (3, H, D, E)
        _, H, D, E = qkv_w.shape
        residual = x
        h = norm(x, ln_scales[i], ln_biases[i]) if pre_layer_norm else x
        cache = cache_kvs[i] if cache_kvs is not None else None
        qkv = h @ qkv_w.reshape(3 * H * D, E).t()        # (B, S, 3HD)
        if qkv_biases[i] is not None:
            qkv = qkv + qkv_biases[i].reshape(-1)
        if time_step is not None:
            attn_out, _ = _mmha(qkv[:, 0], cache, None, None, lens, None,
                                False)
            attn_out = attn_out[:, None]
        else:
            B, S = h.shape[:2]
            qkv = qkv.reshape(B, S, 3, H, D)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            attn_out = scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                is_causal=attn_mask is None).reshape(B, S, H * D)
            if cache is not None:
                cache[0, :, :, :S] = k.transpose(1, 2).to(cache.dtype)
                cache[1, :, :, :S] = v.transpose(1, 2).to(cache.dtype)
        attn_out = attn_out @ linear_weights[i]
        if linear_biases[i] is not None:
            attn_out = attn_out + linear_biases[i]
        x = fused_dropout_add(attn_out, residual, dropout_rate,
                              training=training, mode=mode)
        if not pre_layer_norm:
            x = norm(x, ln_scales[i], ln_biases[i])

        residual = x
        h = norm(x, ffn_ln_scales[i], ffn_ln_biases[i]) \
            if pre_layer_norm else x
        h = h @ ffn1_weights[i]
        if ffn1_biases[i] is not None:
            h = h + ffn1_biases[i]
        h = act(h) @ ffn2_weights[i]
        if ffn2_biases[i] is not None:
            h = h + ffn2_biases[i]
        x = fused_dropout_add(h, residual, dropout_rate, training=training,
                              mode=mode)
        if not pre_layer_norm:
            x = norm(x, ffn_ln_scales[i], ffn_ln_biases[i])
    if cache_kvs is not None:
        return x, cache_kvs
    return x


@torch.no_grad()
def fused_multi_transformer_decode_step(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, cache_kvs, time_step,
        seq_lens=None, pre_layer_norm=True, epsilon=1e-5,
        activation='gelu', norm_type='layernorm'):
    """One `time_step` decode step of `fused_multi_transformer`, with no
    gradient: every layer's (2, B, H, max_seq, D) cache is updated in
    place (PyTorch's counterpart of the JAX step's donated caches).
    Returns (x_out, cache_kvs). Runs eagerly: capturing it as a CUDA
    graph is ROADMAP A9b."""
    return fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases,
        pre_layer_norm=pre_layer_norm, epsilon=epsilon, cache_kvs=cache_kvs,
        seq_lens=seq_lens, time_step=time_step, activation=activation,
        training=False, norm_type=norm_type)


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method='None', moe_topk=2, norm_topk_prob=True):
    """Paddle's fused serving MoE over x (B, S, d): per-token top-k over
    the precomputed gate logits `gate_weight` (B, S, E) (softmax in
    float32, ties to the lower expert), renormalised over the k chosen
    with `norm_topk_prob`; SwiGLU experts with the fused gate + up
    weight `ffn1_weight` (E, d, 2 dff: its first half the gate) and
    `ffn2_weight` (E, dff, d). quant_method='weight_only_int8' takes int8
    codes dequantized by `ffn1_scale` (E, 2 dff) / `ffn2_scale` (E, d).
    The experts run the dropless path of `distributed.moe` (the grouped
    kernel X1 on the card); `ffn2_bias` (E, d) is added after it, each
    token's experts' biases weighted by its gate values. `ffn1_bias`
    (inside the activation) and other quant methods raise, as in the JAX
    package."""
    from ...distributed.moe import ragged_expert_apply

    if quant_method not in ('None', None, 'weight_only_int8'):
        raise NotImplementedError(f'quant_method={quant_method!r}')
    if quant_method == 'weight_only_int8' and (ffn1_scale is None
                                               or ffn2_scale is None):
        raise ValueError(
            "quant_method='weight_only_int8' requires ffn1_scale and "
            'ffn2_scale — raw int8 codes without scales would silently '
            'produce garbage')
    if ffn1_bias is not None:
        raise NotImplementedError(
            'ffn1_bias (inside the activation) is not supported by the '
            'ragged path; fold it into the checkpoint')
    B, S, d = x.shape
    logits = gate_weight.float().reshape(B * S, -1)
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :moe_topk], idx[:, :moe_topk]
    if norm_topk_prob:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    w1, w2 = ffn1_weight, ffn2_weight
    if ffn1_scale is not None:
        w1 = w1.float() * ffn1_scale[:, None, :]
    if ffn2_scale is not None:
        w2 = w2.float() * ffn2_scale[:, None, :]
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    half = w1.shape[-1] // 2
    out = ragged_expert_apply(
        x.reshape(B * S, d), expert_idx, gate_vals,
        w1[..., :half].contiguous(), w1[..., half:].contiguous(),
        w2.contiguous(), E)
    if ffn2_bias is not None:
        oh = (expert_idx[..., None]
              == torch.arange(E, device=x.device)).float()
        weight = (oh * gate_vals[..., None]).sum(1)              # (T, E)
        out = out + (weight @ ffn2_bias.float().reshape(E, d)).to(out.dtype)
    return out.reshape(B, S, d)
