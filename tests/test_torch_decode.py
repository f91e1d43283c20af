"""The port's decode path against the JAX package's, on the same weights
and inputs: the plain decode-attention kernel (K7) against the JAX
package's Pallas kernel in interpret mode, the int8 contiguous cache,
`generate` and `DecodeEngine`.

On the CPU the JAX package's model code takes its masked attention path
(`use_pallas()` is False there), so the whole-model comparisons hold the
port against that path, and the kernel-level cases hold the plain K7
against the Pallas kernel itself. Everything is float32; inputs come
from seeded numpy. Sampled streams are compared within the port only:
torch's generator and JAX's threefry never agree.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from paddle_tpu.models.generation import QuantKVCache as JaxQuantKVCache
from paddle_tpu.models.generation import filter_logits as jax_filter_logits
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import cached_attention as jax_cached_attention
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.ops.pallas.decode_attention import (
    decode_attention as jax_decode_attention)
from paddle_tpu.ops.pallas.decode_attention import (
    dispatch_decode_attention as jax_dispatch)
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import DecodeEngine
from paddle_tpu_torch.models.generation import (QuantKVCache,
                                                filter_logits,
                                                sample_tokens)
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           cached_attention, llama_tiny)
from paddle_tpu_torch.ops.hopper import decode_attention as t_decode
from paddle_tpu_torch.ops.hopper import paged_attention as t_paged

# float32 on both sides; the two differ only in summation order
DECODE_TOL = dict(rtol=2e-5, atol=2e-5)
CFG = dict(vocab_size=96, hidden_size=64, layers=2)


@functools.lru_cache(maxsize=None)
def _models():
    pt.seed(0)
    jm = JaxLlama(jax_tiny(**CFG))
    tm = LlamaForCausalLM(llama_tiny(**CFG), device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _decode_case(B, S, Hq, Hkv, D, int8, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    if int8:
        kc, vc = (rng.integers(-127, 128, (B, S, Hkv, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.03, (Hkv, D)).astype(np.float32)
                  for _ in range(2))
    else:
        kc, vc = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    return q, kc, vc, ks, vs


class TestDecodeAttentionPlain:
    @pytest.mark.parametrize('int8', [False, True], ids=['f32', 'int8'])
    @pytest.mark.parametrize('B,S,Hq,Hkv,D,vl,st', [
        # MHA, per-row windows
        (2, 24, 2, 2, 16, [24, 7], [0, 3]),
        # GQA 8/2, an empty window (start past valid_len), valid_len > S
        # (clamped), start 0
        (3, 40, 8, 2, 32, [50, 10, 33], [5, 12, 0]),
        # GQA 4/1, D not a multiple of 128
        (2, 17, 4, 1, 24, [17, 1], [16, 0]),
    ])
    def test_matches_pallas_kernel(self, int8, B, S, Hq, Hkv, D, vl, st):
        q, kc, vc, ks, vs = _decode_case(B, S, Hq, Hkv, D, int8, S + Hq)
        vl, st = np.asarray(vl, np.int32), np.asarray(st, np.int32)

        @jax.jit
        def ref(q, kc, vc, vl, st, ks, vs):
            return jax_decode_attention(q, kc, vc, vl, k_scale=ks,
                                        v_scale=vs, start=st)

        want = np.asarray(ref(q, kc, vc, vl, st, ks, vs))
        got = ops.decode_attention(
            *_t(q, kc, vc, vl), start=torch.from_numpy(st),
            k_scale=None if ks is None else torch.from_numpy(ks),
            v_scale=None if vs is None else torch.from_numpy(vs))
        np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
        for b in np.flatnonzero(st >= np.minimum(vl, S)):
            assert not got[b].any(), 'an empty window must return zeros'

    def test_scalar_valid_len_scale_and_no_start(self):
        q, kc, vc, _, _ = _decode_case(2, 20, 4, 2, 16, False, 1)

        @jax.jit
        def ref(q, kc, vc):
            return jax_decode_attention(q, kc, vc, 13, scale=0.3)

        want = np.asarray(ref(q, kc, vc))
        got = ops.decode_attention(*_t(q, kc, vc), 13, scale=0.3)
        np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)

    @pytest.mark.parametrize('start', [None, [6, 0]])
    def test_dispatch_composes_window_into_start(self, start):
        """A sliding window is a later per-row start, max(start,
        valid_len - window), on both sides."""
        q, kc, vc, _, _ = _decode_case(2, 30, 4, 2, 16, False, 2)
        vl = np.asarray([30, 12], np.int32)
        st = None if start is None else np.asarray(start, np.int32)

        @jax.jit
        def ref(q, kc, vc, vl, st):
            return jax_dispatch(q, kc, vc, vl, start=st, window=8)

        want = np.asarray(ref(q, kc, vc, vl, st))
        got = ops.dispatch_decode_attention(
            *_t(q, kc, vc, vl), window=8,
            start=None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)

    def test_kernel_refuses_cpu_tensors(self):
        """No silent fallback: the kernel wrapper itself never takes the
        plain path."""
        q, kc, vc, _, _ = _decode_case(1, 8, 2, 2, 16, False, 3)
        with pytest.raises(ValueError, match='CUDA'):
            t_decode.decode_attention(*_t(q, kc, vc), 4)
        with pytest.raises(ValueError, match='k_scale'):
            ops.decode_attention(*_t(q, kc.astype(np.int8),
                                     vc.astype(np.int8)), 4)


class TestSplitRule:
    """The kernel's context split (`splits`), pure Python: the blocks per
    SM are an argument (on the card they come from the occupancy
    calculator)."""

    SMS = 132

    @pytest.mark.parametrize('B,units,S,tile,bps', [
        (1, 32, 2048, 32, 4),       # b1 MHA bf16 D = 128
        (1, 8, 2048, 32, 4),        # b1 GQA 32 / 8
        (8, 32, 2048, 32, 4),       # b8 MHA
        (8, 8, 2048, 64, 3),        # b8 GQA, int8 rows of 128 bytes
        (1, 4, 32768, 32, 4),       # Qwen2's group 7 over a long cache
        (1, 32, 32768, 32, 4),
        (1, 1, 2000, 64, 2),        # one kv head: many splits
        (1, 1, 100000, 32, 8),      # capped at MAX_SPLITS
        (3, 2, 37, 64, 4),          # a cache shorter than one tile
        (2, 3, 300, 64, 4),
        (64, 64, 4096, 32, 4),      # more blocks than a wave: unsplit
        (1, 32, 95, 32, 4),         # shorter than the ring
    ])
    def test_properties(self, B, units, S, tile, bps):
        nsplit, chunk = t_decode.splits(B, units, S, tile, bps, self.SMS)
        stages = t_decode.STAGES
        # every position of [0, S) lies in exactly one split
        cover = np.zeros(S, np.int64)
        for i in range(nsplit):
            cover[i * chunk:(i + 1) * chunk] += 1
        assert (cover == 1).all() and nsplit * chunk >= S > (
            nsplit - 1) * chunk
        assert chunk % tile == 0
        assert 1 <= nsplit <= t_decode.MAX_SPLITS
        # each split fills the ring where S allows, unless that leaves
        # SMs without a block: then each SM gets one
        if S >= stages * tile and (S // (stages * tile)) * B * units >= \
                self.SMS:
            assert chunk >= stages * tile
        elif nsplit > 1 and chunk < stages * tile:
            assert nsplit * B * units <= self.SMS
        # at most MAX_SPLIT_TILES tiles a split (unless MAX_SPLITS binds)
        cap = t_decode.MAX_SPLIT_TILES
        assert chunk <= cap * tile or S > t_decode.MAX_SPLITS * cap * tile
        # within one wave of the card, or more waves of splits no smaller
        # than half the cap (unsplit when the rows and heads alone fill
        # more)
        if nsplit > 1 and nsplit * B * units > bps * self.SMS:
            assert chunk >= cap // 2 * tile

    def test_fills_the_wave(self):
        """b1 MHA at 4 blocks per SM: 16 splits of 4 tiles, 512 blocks of
        the 528 that fit. Qwen2's 4 kv heads at b1 take 32 splits of 2
        tiles (128 blocks, one per SM) rather than 21 of 3. b8 MHA: 8
        splits of 8 tiles (four waves) rather than 2 of 32, and a
        32768-position cache at b1 128 splits of 8."""
        assert t_decode.splits(1, 32, 2048, 32, 4, self.SMS) == (16, 128)
        assert t_decode.splits(1, 4, 2048, 32, 3, self.SMS) == (32, 64)
        assert t_decode.splits(8, 32, 2048, 32, 4, self.SMS) == (8, 256)
        assert t_decode.splits(1, 32, 32768, 32, 4, self.SMS) == (128, 256)


class TestPagedSplitPlan:
    """K8 / K8q's split (`paged_attention.split_plan`), pure Python: K7's
    rule over the table width MAXB * BS, with the plan's blocks per SM
    and tile as arguments (on the card they come from the occupancy
    calculator)."""

    SMS = 132

    @staticmethod
    def _plan(tile, bps, nchunk=1):
        return t_decode.Plan(bps, tile, t_decode.STAGES, 8, nchunk, 128, 0)

    @pytest.mark.parametrize('B,Hkv,MAXB,BS,tile,bps,nchunk', [
        (4, 32, 64, 16, 32, 4, 1),      # serving, Llama-7B MHA
        (4, 8, 64, 16, 32, 4, 1),       # GQA 32 / 8
        (4, 4, 64, 16, 32, 2, 1),       # Qwen2's group 7 (one chunk of 8)
        (8, 32, 32, 64, 32, 4, 1),      # block_multihead_attention
        (3, 2, 2000, 1, 64, 3, 2),      # one position a page
        (2, 1, 300, 7, 64, 4, 2),       # a block size that is no power of 2
        (1, 8, 4096, 16, 32, 4, 1),     # 65536 positions
    ])
    def test_covers_the_table_width(self, B, Hkv, MAXB, BS, tile, bps,
                                    nchunk):
        pl = self._plan(tile, bps, nchunk)
        nsplit, chunk = t_paged.split_plan(B, Hkv, MAXB, BS, pl, self.SMS)
        S = MAXB * BS
        # K7's rule over S = the table width, with the head chunks
        assert (nsplit, chunk) == t_decode.splits(
            B, Hkv * nchunk, S, tile, bps, self.SMS, t_decode.STAGES)
        # every position of the table width in exactly one split
        cover = np.zeros(S, np.int64)
        for i in range(nsplit):
            cover[i * chunk:(i + 1) * chunk] += 1
        assert (cover == 1).all()
        assert chunk % tile == 0 and 1 <= nsplit <= t_decode.MAX_SPLITS
        # a split's page ids fit the block's table in shared memory
        pages = max((min((i + 1) * chunk, S) - 1) // BS - i * chunk // BS
                    + 1 for i in range(nsplit))
        assert pages <= t_paged.TABLE_PAGES

    def test_the_counts_do_not_enter(self):
        """The split depends on the table's width alone: every argument
        is a shape (so a CUDA graph of one launch replays for any
        counts), and one width gives one split whatever its pages."""
        import inspect

        assert list(inspect.signature(t_paged.split_plan).parameters) == [
            'B', 'Hkv', 'MAXB', 'BS', 'pl', 'sms']
        pl = self._plan(32, 4)
        assert (t_paged.split_plan(4, 8, 64, 16, pl, self.SMS)
                == t_paged.split_plan(4, 8, 16, 64, pl, self.SMS))


def test_quant_kv_cache_codes_and_scales_equal_jax():
    """cached_attention over an int8 cache: after the index-0 prefill
    (which calibrates the scales) and after one decode step, codes and
    scales are bit-equal to the JAX package's, and the outputs agree."""
    rng = np.random.default_rng(4)
    B, S, T, Hq, Hkv, D = 2, 6, 10, 4, 2, 16

    def rows(n, h):
        return rng.normal(size=(B, n, h, D)).astype(np.float32)

    pre = [rows(S, Hq), rows(S, Hkv), rows(S, Hkv)]
    step = [rows(1, Hq), rows(1, Hkv), rows(1, Hkv)]
    z = np.zeros((B, T, Hkv, D), np.int8)
    zs = np.zeros((Hkv, D), np.float32)
    jcache = JaxQuantKVCache(jnp.asarray(z), jnp.asarray(z),
                             jnp.asarray(zs), jnp.asarray(zs))
    tcache = QuantKVCache(*_t(z.copy(), z.copy(), zs.copy(), zs.copy()))
    for i, (q, k, v) in enumerate((pre, step)):
        index = 0 if i == 0 else S
        # eagerly, as the JAX package's generate runs its prefill (under
        # jit, XLA may turn the division by 127 into a multiplication)
        jout, jcache = jax_cached_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, index)
        tout, tcache = cached_attention(*_t(q, k, v), tcache, index)
        for name, j, t in zip(QuantKVCache._fields, jcache, tcache):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f'{name} after step {i}')
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   **DECODE_TOL)


def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(3, CFG['vocab_size'],
                                                (B, S)).astype(np.int32)


def _jax_generate(jm, ids, **kw):
    """The JAX model's generate under one jax.jit (compiled once, where
    its eager prefill compiles every operation), the mask a constant."""
    am = kw.pop('attention_mask', None)
    am = None if am is None else jnp.asarray(am)
    return np.asarray(jax.jit(lambda x: jm.generate(
        x, attention_mask=am, **kw))(jnp.asarray(ids)))


class TestGenerate:
    @pytest.mark.parametrize('setting', ['plain', 'left_padded', 'kv8'])
    def test_greedy_token_equal_to_jax(self, setting):
        jm, tm = _models()
        ids = _prompts(3, 7, 5)
        kw = dict(max_new_tokens=10)
        if setting == 'left_padded':
            am = np.ones_like(ids)
            am[0, :4] = 0
            am[2, :1] = 0
            ids = ids * am
            kw['attention_mask'] = am
        if setting == 'kv8':
            kw['kv_cache_int8'] = True
        want = _jax_generate(jm, ids, **kw)
        if 'attention_mask' in kw:
            kw['attention_mask'] = torch.from_numpy(kw['attention_mask'])
        got = tm.generate(torch.from_numpy(ids), **kw)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_eos_token_id(self):
        jm, tm = _models()
        ids = _prompts(2, 5, 6)
        free = tm.generate(torch.from_numpy(ids), max_new_tokens=10).numpy()
        eos = int(free[0, 5 + 3])       # a token row 0 really emits
        want = _jax_generate(jm, ids, max_new_tokens=10, eos_token_id=eos)
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=10,
                          eos_token_id=eos).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[0, 5 + 3:] == eos).all(), 'a finished row emits eos'

    def test_holed_mask_takes_the_masked_path(self):
        """A mask that is not left-contiguous cannot be a window start: the
        decode steps take the masked attention, and the tokens still equal
        the JAX package's."""
        jm, tm = _models()
        ids = _prompts(2, 6, 7)
        am = np.ones_like(ids)
        am[1, 2] = 0
        want = _jax_generate(jm, ids, max_new_tokens=6, attention_mask=am)
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=6,
                          attention_mask=torch.from_numpy(am))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_unported_modes_raise(self):
        _, tm = _models()
        ids = torch.from_numpy(_prompts(1, 4, 8))
        with pytest.raises(NotImplementedError, match='beam'):
            tm.generate(ids, num_beams=2)
        with pytest.raises(ValueError, match='multi-token prompt'):
            tm.generate(ids[:, :1], kv_cache_int8=True)


class TestSampling:
    @pytest.mark.parametrize('top_k,top_p', [(0, 1.0), (3, 1.0), (0, 0.7),
                                             (5, 0.8), (200, 1.0)])
    def test_filter_logits_equal_to_jax(self, top_k, top_p):
        logits = np.random.default_rng(top_k).normal(
            size=(4, 50)).astype(np.float32) * 3
        want = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k,
                                            top_p))
        got = filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)],
                                      want[~np.isinf(want)])

    def test_same_seed_same_stream(self):
        _, tm = _models()
        ids = torch.from_numpy(_prompts(2, 5, 9))
        kw = dict(max_new_tokens=8, temperature=0.8, top_k=20, top_p=0.9)
        a = tm.generate(ids, rng_key=3, **kw)
        b = tm.generate(ids, rng_key=torch.Generator().manual_seed(3), **kw)
        c = tm.generate(ids, rng_key=4, **kw)
        assert torch.equal(a, b)
        assert not torch.equal(a, c)
        eng = DecodeEngine(tm, max_new_tokens=8, temperature=0.8, top_k=20,
                           top_p=0.9)
        assert torch.equal(eng.generate(ids, rng_key=3),
                           eng.generate(ids, rng_key=3))

    def test_draws_follow_the_filtered_distribution(self):
        """20000 draws from one row: frequencies within 0.015 of
        softmax(logits / T) over the top-k set, nothing outside it."""
        logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, 3.0]])
        T, k, n = 0.7, 4, 20000
        gen = torch.Generator().manual_seed(0)
        draws = torch.stack([sample_tokens(logits, T, k, 1.0, gen)
                             for _ in range(n)])[:, 0]
        freq = torch.bincount(draws, minlength=6).float() / n
        want = torch.softmax(filter_logits(logits / T, k), -1)[0]
        assert freq[want == 0].sum() == 0
        assert (freq - want).abs().max() < 0.015


class TestDecodeEngine:
    @pytest.mark.parametrize('S', [7, 16], ids=['padded', 'exact'])
    def test_token_equal_to_jax_engine(self, S):
        jm, tm = _models()
        ids = _prompts(2, S, S)
        want = np.asarray(JaxDecodeEngine(jm, max_new_tokens=9).generate(
            jnp.asarray(ids)))
        eng = DecodeEngine(tm, max_new_tokens=9)
        got = eng.generate(torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[:, :S].numpy().tolist() == ids.tolist(), (
            'the original prompt is echoed back')
        stats = eng.stats()
        assert (stats['prefill_forwards'], stats['decode_forwards']) == (1, 8)

    def test_padded_equals_unpadded_generate_with_eos(self):
        _, tm = _models()
        ids = torch.from_numpy(_prompts(3, 11, 12))
        free = tm.generate(ids, max_new_tokens=8)
        eos = int(free[1, 11 + 2])
        eng = DecodeEngine(tm, max_new_tokens=8, eos_token_id=eos)
        assert torch.equal(eng.generate(ids),
                           tm.generate(ids, max_new_tokens=8,
                                       eos_token_id=eos))
