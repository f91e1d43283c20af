"""The port's fused-inference ops and their kernels against the JAX
package's, on the same seeded numpy inputs.

- The plain version of K9 (`decode_attention_headmajor`: bf16, float32
  and int8 caches, GQA groups 1/2/4/8, a count of 0, a count past S)
  and of K5s (the segment-id mode of the flash forward: causal and not,
  a segment with no key, Sq != Sk) against the Pallas kernels in
  interpret mode, one `jax.jit` per case.
- `scaled_dot_product_attention` with segment ids, on both of the
  port's paths (masked below 128 queries, the flash op above).
- `masked_multihead_attention` (bias, rotary in both styles, src_mask),
  `block_multihead_attention` (varlen prefill, then decode with an
  inactive row; float32 and static-int8 pages), `fused_multi_transformer`
  in both norm types with its `decode_step`, and `FusedMultiTransformer`
  with the JAX layer's weights carried by `load_jax_state`.

On the CPU the JAX package's ops take their plain paths (`use_pallas()`
is False there); the port's take the kernels' plain versions. Float32
unless said; the tolerances are stated beside each comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu.nn.functional.attention import (
    scaled_dot_product_attention as jax_sdpa)
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash)
from paddle_tpu.ops.pallas.paged_attention import (
    decode_attention_headmajor as jax_headmajor)
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import headmajor_attention as t_hm

# Parallel test workers (pytest-xdist) share the machine's cores: one
# intra-op thread a worker keeps PyTorch's CPU ops (on tensors far too
# small to gain from more) from oversubscribing them.
torch.set_num_threads(1)


# float32 on both sides: summation order only
TOL = dict(rtol=2e-5, atol=2e-5)
# a whole decoder stack in float32 (a few layers of products)
STACK_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 outputs: one rounding step (2^-8 relative) on top
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


class TestHeadMajorPlain:
    @pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8'])
    @pytest.mark.parametrize('B,Hq,Hkv,S,D,counts', [
        (2, 2, 2, 24, 16, [24, 7]),              # MHA
        (3, 4, 2, 40, 32, [50, 0, 33]),          # count past S, count 0
        (2, 8, 2, 17, 16, [1, 17]),              # GQA 4
        (2, 8, 1, 33, 16, [0, 20]),              # GQA 8
    ], ids=['mha', 'gqa2-clamp-zero', 'gqa4', 'gqa8'])
    def test_matches_pallas_kernel(self, mode, B, Hq, Hkv, S, D, counts):
        rng = np.random.default_rng(B * 100 + Hq + S)
        q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
        ks = vs = None
        if mode == 'int8':
            kc, vc = (rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
                      for _ in range(2))
            ks, vs = (rng.uniform(0.005, 0.03, (Hkv, D)).astype(np.float32)
                      for _ in range(2))
        else:
            kc, vc = (rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
                      for _ in range(2))
        cl = np.asarray(counts, np.int32)
        jdt = jnp.bfloat16 if mode == 'bfloat16' else jnp.float32
        tdt = torch.bfloat16 if mode == 'bfloat16' else torch.float32

        @jax.jit
        def ref(q, kc, vc, cl, ks, vs):
            if mode == 'bfloat16':
                q, kc, vc = (a.astype(jdt) for a in (q, kc, vc))
            return jax_headmajor(q, kc, vc, cl, k_scale=ks, v_scale=vs,
                                 block_s=8)

        want = np.asarray(ref(q, kc, vc, cl, ks, vs).astype(jnp.float32))
        tq, tk, tv, tcl = _t(q, kc, vc, cl)
        if mode == 'bfloat16':
            tq, tk, tv = tq.to(tdt), tk.to(tdt), tv.to(tdt)
        got = ops.decode_attention_headmajor(
            tq, tk, tv, tcl, k_scale=None if ks is None else _t(ks)[0],
            v_scale=None if vs is None else _t(vs)[0])
        assert got.dtype == tdt
        tol = BF16_TOL if mode == 'bfloat16' else TOL
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
        for b in np.flatnonzero(cl == 0):
            assert not got[b].any(), 'a count-0 row must return zeros'

    def test_refusals(self):
        q = torch.zeros(1, 1, 2, 16)
        c = torch.zeros(1, 2, 8, 16)
        with pytest.raises(ValueError, match='need k_scale'):
            ops.decode_attention_headmajor(q, c.to(torch.int8),
                                           c.to(torch.int8), 3)
        with pytest.raises(TypeError, match='int8'):
            ops.decode_attention_headmajor(q, c, c, 3,
                                           k_scale=torch.ones(2, 16),
                                           v_scale=torch.ones(2, 16))
        with pytest.raises(ValueError, match='CUDA'):
            t_hm.decode_attention_headmajor(q, c, c, 3)


def _seg_case(seed, B, Sq, Sk, H, Hkv, D, qseg, kseg):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, np.asarray(qseg, np.int32), np.asarray(kseg, np.int32)


def _segments(lens):
    return np.repeat(np.arange(len(lens)), lens)


# (B, Sq, Sk, H, Hkv, D, qseg, kseg): sorted packed segments; a query
# segment (id 9) that no key has; Sq != Sk with per-side ids
SEG_CASES = {
    'packed': (2, 40, 40, 4, 2, 16,
               [_segments([10, 20, 10]), _segments([40])],
               [_segments([10, 20, 10]), _segments([40])]),
    'empty-segment': (1, 24, 24, 2, 2, 16,
                      [np.r_[np.zeros(8), np.full(8, 9), np.ones(8)]],
                      [np.r_[np.zeros(8), np.full(8, 2), np.ones(8)]]),
    'sq-ne-sk': (2, 12, 30, 4, 1, 32,
                 [np.r_[np.zeros(4), np.ones(8)]] * 2,
                 [np.r_[np.zeros(14), np.ones(16)]] * 2),
}


class TestSegmentFlashPlain:
    @pytest.mark.parametrize('causal', [True, False],
                             ids=['causal', 'full'])
    @pytest.mark.parametrize('case', list(SEG_CASES))
    def test_matches_pallas_kernel(self, case, causal):
        q, k, v, qseg, kseg = _seg_case(len(case), *SEG_CASES[case])

        @jax.jit
        def ref(q, k, v, qseg, kseg):
            return jax_flash(q, k, v, causal=causal, segment_ids=qseg,
                             kv_segment_ids=kseg, block_q=8, block_k=8)

        want = np.asarray(ref(q, k, v, qseg, kseg))
        tq, tk, tv, tqs, tks = _t(q, k, v, qseg, kseg)
        with torch.no_grad():
            got = ops.flash_attention(tq, tk, tv, causal=causal,
                                      segment_ids=tqs, kv_segment_ids=tks)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        if case == 'empty-segment':
            assert not got[0, 8:16].any(), 'an empty segment returns 0'

    @pytest.mark.parametrize('S', [40, 130], ids=['masked', 'flash'])
    def test_sdpa_segments_match_jax(self, S):
        """Below 128 queries the port takes its masked path, above it the
        flash op (the K5s plain version here); the JAX package takes its
        masked path on the CPU."""
        lens = [S // 4, S // 2, S - S // 4 - S // 2]
        q, k, v, qseg, _ = _seg_case(S, 1, S, S, 4, 2, 16,
                                     [_segments(lens)], [_segments(lens)])
        want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), is_causal=True,
                                   segment_ids=jnp.asarray(qseg)))
        with torch.no_grad():
            got = F.scaled_dot_product_attention(
                *_t(q, k, v), is_causal=True,
                segment_ids=torch.from_numpy(qseg))
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_argument_checks(self):
        q = torch.zeros(1, 8, 2, 16)
        seg = torch.zeros(1, 8, dtype=torch.int32)
        with pytest.raises(ValueError, match='requires segment_ids'):
            F.scaled_dot_product_attention(q, q, q, kv_segment_ids=seg)
        with pytest.raises(ValueError, match='kv_segment_ids'):
            F.scaled_dot_product_attention(q, q[:, :4], q[:, :4],
                                           segment_ids=seg)
        # a window is ported (K5w / K6w) and requires causal attention
        with pytest.raises(ValueError, match='causal'):
            ops.flash_attention(q, q, q, causal=False, window_size=4)


class TestMaskedMultiheadAttention:
    @pytest.mark.parametrize('neox', [False, True], ids=['gptj', 'neox'])
    @pytest.mark.parametrize('masked', [False, True],
                             ids=['kernel-path', 'src-mask'])
    def test_matches_jax(self, neox, masked):
        B, H, S, D = 3, 4, 20, 16
        rng = np.random.default_rng(int(neox) + 2 * int(masked))
        x = rng.normal(size=(B, 3 * H * D)).astype(np.float32)
        cache = rng.normal(size=(2, B, H, S, D)).astype(np.float32)
        bias = rng.normal(size=(3 * H * D,)).astype(np.float32)
        ang = rng.uniform(0, 6.28, (B, S, D // 2)).astype(np.float32)
        rot = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
        lens = np.asarray([[4], [0], [19]], np.int32)
        src = (rng.normal(size=(B, S)).astype(np.float32) if masked
               else None)
        want, wcache = JF.masked_multihead_attention(
            jnp.asarray(x), jnp.asarray(cache), bias=jnp.asarray(bias),
            src_mask=None if src is None else jnp.asarray(src),
            sequence_lengths=jnp.asarray(lens),
            rotary_tensor=jnp.asarray(rot), use_neox_rotary_style=neox)
        tcache = torch.from_numpy(cache.copy())
        got, gcache = TF.masked_multihead_attention(
            torch.from_numpy(x), tcache, bias=torch.from_numpy(bias),
            src_mask=None if src is None else torch.from_numpy(src),
            sequence_lengths=torch.from_numpy(lens),
            rotary_tensor=torch.from_numpy(rot), use_neox_rotary_style=neox)
        assert gcache is tcache, 'the cache is written in place'
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(gcache.numpy(), np.asarray(wcache), **TOL)

    def test_refusals(self):
        x = torch.zeros(1, 3 * 2 * 8)
        cache = torch.zeros(2, 1, 2, 4, 8)
        lens = torch.tensor([[1]])
        with pytest.raises(NotImplementedError, match='qkv_out_scale'):
            TF.masked_multihead_attention(x, cache, sequence_lengths=lens,
                                          qkv_out_scale=torch.ones(1))
        with pytest.raises(NotImplementedError, match='int8'):
            TF.masked_multihead_attention(x, cache.to(torch.int8),
                                          sequence_lengths=lens)
        with pytest.raises(ValueError, match='full'):
            TF.masked_multihead_attention(x, cache,
                                          sequence_lengths=torch.tensor([[4]]))
        with pytest.raises(ValueError, match='cache_kv'):
            TF.masked_multihead_attention(x, sequence_lengths=lens)


class TestBlockMultiheadAttention:
    @pytest.mark.parametrize('lens', [[5, 9, 3], [60, 50, 30]],
                             ids=['short', 'flash'])
    @pytest.mark.parametrize('int8', [False, True], ids=['f32', 'int8'])
    def test_prefill_then_decode_match_jax(self, int8, lens):
        """A varlen prefill (segment ids: the masked path below 128
        tokens, the flash op's K5s above), then one decode step with an
        inactive row; outputs and pages against the JAX op."""
        Hq, Hkv, D, BS = 4, 2, 16, 4
        B = len(lens)
        MAXB = -(-(max(lens) + 2) // BS)
        NB = B * MAXB + 3
        rng = np.random.default_rng(sum(lens) + int(int8))
        tbl = (rng.permutation(NB - 1)[:B * MAXB] + 1).reshape(B, MAXB) \
            .astype(np.int32)
        T = sum(lens)
        width = (Hq + 2 * Hkv) * D
        qkv = rng.normal(size=(T, width)).astype(np.float32)
        bias = rng.normal(size=(width,)).astype(np.float32)
        ang = rng.uniform(0, 6.28, (B, max(lens) + 2, D // 2))
        rope = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
        cdt = np.int8 if int8 else np.float32
        kc = np.zeros((NB, Hkv, BS, D), cdt)
        vc = np.zeros((NB, Hkv, BS, D), cdt)
        scales = {}
        if int8:
            scales = dict(
                cache_k_dequant_scales=rng.uniform(0.01, 0.03, (Hkv, D))
                .astype(np.float32),
                cache_v_dequant_scales=rng.uniform(0.01, 0.03, (Hkv,))
                .astype(np.float32))
        cu = np.r_[0, np.cumsum(lens)].astype(np.int32)
        enc = np.asarray(lens, np.int32)
        zeros = np.zeros(B, np.int32)

        def jax_call(qkv, kc, vc, enc, dec, this, cu=None):
            return JF.block_multihead_attention(
                jnp.asarray(qkv), jnp.asarray(kc), jnp.asarray(vc), enc,
                dec, this, cu_seqlens_q=cu, block_tables=jnp.asarray(tbl),
                qkv_bias=jnp.asarray(bias), rope_emb=jnp.asarray(rope),
                block_size=BS, num_heads=Hq, num_kv_heads=Hkv,
                **{k: jnp.asarray(s) for k, s in scales.items()})

        def port_call(qkv, kc, vc, enc, dec, this, cu=None):
            return TF.block_multihead_attention(
                torch.from_numpy(qkv), kc, vc, torch.from_numpy(enc),
                torch.from_numpy(dec), torch.from_numpy(this),
                cu_seqlens_q=None if cu is None else torch.from_numpy(cu),
                block_tables=torch.from_numpy(tbl),
                qkv_bias=torch.from_numpy(bias),
                rope_emb=torch.from_numpy(rope), block_size=BS,
                num_heads=Hq, num_kv_heads=Hkv,
                **{k: torch.from_numpy(s) for k, s in scales.items()})

        jout, _, jk, jv = jax_call(qkv, kc, vc, enc, zeros, enc, cu)
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        tout, _, gk, gv = port_call(qkv, tk, tv, enc, zeros, enc, cu)
        assert gk is tk and gv is tv, 'the pages are written in place'
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        # int8 codes: the same float32 rows round to the same codes
        for g, w in ((gk, jk), (gv, jv)):
            if int8:
                assert (np.abs(g.numpy().astype(int)
                               - np.asarray(w).astype(int)) <= 1).all()
                assert (g.numpy() == np.asarray(w)).mean() > 0.999
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        # decode: one token per row, row 1 inactive
        step = rng.normal(size=(B, width)).astype(np.float32)
        this = np.asarray([1, 0, 1], np.int32)
        jout, _, jk, jv = jax_call(step, np.asarray(gk), np.asarray(gv),
                                   zeros, enc, this)
        tout, _, gk, gv = port_call(step, gk, gv, zeros, enc, this)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for g, w in ((gk, jk), (gv, jv)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_refusals(self):
        kc = torch.zeros(4, 2, 4, 16)
        qkv = torch.zeros(2, 8 * 16)
        one = torch.ones(2, dtype=torch.int32)
        with pytest.raises(NotImplementedError, match='mixed'):
            TF.block_multihead_attention(
                qkv, kc, kc.clone(), one, one, one,
                block_tables=torch.zeros(2, 1, dtype=torch.int32),
                block_size=4)
        with pytest.raises(NotImplementedError, match='dynamic'):
            TF.block_multihead_attention(
                qkv, kc, kc.clone(), one, one * 0, one,
                use_dynamic_cachekv_quant=True, block_size=4)
        with pytest.raises(ValueError, match='page capacity'):
            TF.block_multihead_attention(
                qkv, kc, kc.clone(), one * 0, one * 4, one,
                block_tables=torch.ones(2, 1, dtype=torch.int32),
                block_size=4)


def _fmt_weights(rng, L, E, H, F, biases=True):
    D = E // H

    def n(*shape, std=0.2):
        return (std * rng.normal(size=shape)).astype(np.float32)

    def b(*shape):
        return n(*shape, std=0.1) if biases else None

    return dict(
        ln_scales=[1 + n(E, std=0.1) for _ in range(L)],
        ln_biases=[b(E) for _ in range(L)],
        qkv_weights=[n(3, H, D, E) for _ in range(L)],
        qkv_biases=[b(3 * E) for _ in range(L)],
        linear_weights=[n(E, E) for _ in range(L)],
        linear_biases=[b(E) for _ in range(L)],
        ffn_ln_scales=[1 + n(E, std=0.1) for _ in range(L)],
        ffn_ln_biases=[b(E) for _ in range(L)],
        ffn1_weights=[n(E, F) for _ in range(L)],
        ffn1_biases=[b(F) for _ in range(L)],
        ffn2_weights=[n(F, E) for _ in range(L)],
        ffn2_biases=[b(E) for _ in range(L)])


def _conv(ws, fn):
    return {k: [None if a is None else fn(a) for a in v]
            for k, v in ws.items()}


class TestFusedMultiTransformer:
    @pytest.mark.parametrize('norm_type,activation,pre', [
        ('layernorm', 'gelu', True), ('rmsnorm', 'silu', True),
        ('layernorm', 'relu', False)], ids=['ln-gelu', 'rms-silu',
                                            'post-ln-relu'])
    def test_prefill_and_decode_steps_match_jax(self, norm_type, activation,
                                                pre):
        L, E, H, F_, B, S, T = 2, 32, 4, 64, 2, 6, 12
        rng = np.random.default_rng(len(norm_type) + len(activation))
        ws = _fmt_weights(rng, L, E, H, F_)
        x = rng.normal(size=(B, S, E)).astype(np.float32)
        steps = rng.normal(size=(3, B, 1, E)).astype(np.float32)
        kw = dict(pre_layer_norm=pre, activation=activation,
                  norm_type=norm_type)
        jw, tw = _conv(ws, jnp.asarray), _conv(ws, torch.from_numpy)
        jc = [jnp.zeros((2, B, H, T, E // H)) for _ in range(L)]
        tc = [torch.zeros(2, B, H, T, E // H) for _ in range(L)]
        jx, jc = JF.fused_multi_transformer(jnp.asarray(x), **jw,
                                            cache_kvs=jc, **kw)
        with torch.no_grad():
            tx, tc2 = TF.fused_multi_transformer(torch.from_numpy(x), **tw,
                                                 cache_kvs=tc, **kw)
        assert tc2 is tc
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **STACK_TOL)
        for i, st in enumerate(steps):
            lens = np.full((B,), S + i, np.int32)
            jx, jc = JF.fused_multi_transformer_decode_step(
                jnp.asarray(st), **jw, cache_kvs=jc, time_step=S + i,
                seq_lens=jnp.asarray(lens), **kw)
            tx, _ = TF.fused_multi_transformer_decode_step(
                torch.from_numpy(st), **tw, cache_kvs=tc, time_step=S + i,
                seq_lens=torch.from_numpy(lens), **kw)
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                       **STACK_TOL, err_msg=f'step {i}')
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **STACK_TOL)

    def test_layer_with_jax_weights(self):
        """The JAX layer's state (`ln_scales.L0.w`, ...) loads into the
        port's (`ln_scales.0.w`) with every name, shape and dtype
        checked; prefill over caches, then three time_step decodes."""
        import paddle_tpu as pt

        pt.seed(3)
        E, H, F_, L, B, S, T = 32, 4, 64, 2, 2, 5, 9
        jm = JaxFMT(E, H, F_, num_layers=L)
        tm = FusedMultiTransformer(E, H, F_, num_layers=L, device='cpu')
        state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
        assert 'ln_scales.L0.w' in state and 'ln_scales.0.w' in \
            tm.state_dict()
        io.load_jax_state(tm, state)
        rng = np.random.default_rng(4)
        x = rng.normal(size=(B, S, E)).astype(np.float32)
        jc, tc = jm.gen_cache(B, T), tm.gen_cache(B, T)
        # the JAX layer under one jax.jit per call shape (an eager run
        # compiles every operation)
        jprefill = jax.jit(lambda x, c: jm(x, caches=c))
        jstep = jax.jit(lambda x, c, t: jm(x, caches=c, time_step=t))
        jx, jc = jprefill(jnp.asarray(x), jc)
        with torch.no_grad():
            tx, tc = tm(torch.from_numpy(x), caches=tc)
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                       **STACK_TOL)
            for i in range(3):
                st = rng.normal(size=(B, 1, E)).astype(np.float32)
                jx, jc = jstep(jnp.asarray(st), jc, S + i)
                tx, tc = tm(torch.from_numpy(st), caches=tc, time_step=S + i)
                np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                           **STACK_TOL)
        bad = dict(state)
        bad.pop('ffn2_biases.L1.w')
        with pytest.raises(ValueError, match='ffn2_biases.1.w'):
            io.load_jax_state(tm, bad)

    def test_refusals(self):
        w = _conv(_fmt_weights(np.random.default_rng(0), 1, 16, 2, 32),
                  torch.from_numpy)
        x = torch.zeros(1, 1, 16)
        with pytest.raises(NotImplementedError, match='rotary_embs'):
            TF.fused_multi_transformer(x, **w, rotary_embs=torch.zeros(1))
        with pytest.raises(ValueError, match='cache_kvs'):
            TF.fused_multi_transformer(x, **w, time_step=0)
        with pytest.raises(ValueError, match='norm_type'):
            TF.fused_multi_transformer(x, **w, norm_type='batchnorm')
        with pytest.raises(NotImplementedError, match='dropout'):
            TF.fused_dropout_add(x, x, p=0.1, training=True)
        assert torch.equal(TF.fused_dropout_add(
            x + 1, x, p=0.5, training=False, mode='downscale_in_infer'),
            x + 0.5)
        with pytest.raises(ValueError, match='num_layers'):
            FusedMultiTransformer(16, 2, 32, device='cpu')
