"""The port's weight-only quantization against the JAX package's: the
quantizers (bit-equal codes and scales; fp8 codes compared as bytes),
the plain versions of kernels K10 / K10f8 / K11 against the Pallas
kernels in interpret mode and against the
JAX package's default (XLA) route, `quantize_weights`, quantized states
carried across with `load_jax_state`, and generation and serving over
quantized models.

float32 throughout, inputs from seeded numpy, each tolerance stated.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn import quant as jax_nq
from paddle_tpu.ops.pallas import quant_matmul as jq
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import quant as nq
from paddle_tpu_torch.ops.hopper import quant_matmul as tq
from paddle_tpu_torch.quantization import quantize_matmul_weights

# float32 sums over the raw codes in another order: the products are
# exact in both, the sums differ by rounding
MM_TOL = dict(rtol=1e-5, atol=1e-4)
CFG = dict(vocab_size=96, hidden_size=64, layers=2)


FP8_SEED = {'e4m3': 3, 'e5m2': 5}
FP8_TORCH = {'float8_e4m3fn': torch.float8_e4m3fn,
             'float8_e5m2': torch.float8_e5m2}


def _codes(codes):
    """JAX codes as a tensor (fp8 codes through their bytes: numpy has
    no fp8 type torch reads)."""
    a = np.array(codes)
    if a.dtype.name in FP8_TORCH:
        return torch.from_numpy(a.view(np.uint8)).view(FP8_TORCH[a.dtype.name])
    return torch.from_numpy(a)


def _w(K, N, seed):
    return np.random.default_rng(seed).normal(
        scale=0.05, size=(K, N)).astype(np.float32)


class TestQuantizers:
    @pytest.mark.parametrize('K,N', [(64, 48), (65, 33), (1, 7)])
    def test_codes_and_scales_bit_equal(self, K, N):
        w = _w(K, N, K + N)
        for jfn, tfn in ((jq.quantize_weight, tq.quantize_weight),
                         (jq.quantize_weight_int4, tq.quantize_weight_int4)):
            jc, js = jfn(jnp.asarray(w))
            tc, ts = tfn(torch.from_numpy(w))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tq.unpack_int4(tc).numpy(), np.asarray(jq._unpack_int4(jc)))

    @pytest.mark.parametrize('fp8', ['e4m3', 'e5m2'])
    def test_fp8_codes_and_scales_bit_equal(self, fp8):
        """quantize_weight_fp8 in both fp8 types: codes bit-equal (as
        uint8), scales equal, on a weight with a zero column (scale 1e-12)
        and one outlier."""
        w = _w(65, 33, 3)
        w[:, 5] = 0.0
        w[7, 9] = 1.5
        jd, td = {'e4m3': (jnp.float8_e4m3fn, torch.float8_e4m3fn),
                  'e5m2': (jnp.float8_e5m2, torch.float8_e5m2)}[fp8]
        jc, js = jq.quantize_weight_fp8(jnp.asarray(w), dtype=jd)
        tc, ts = tq.quantize_weight_fp8(torch.from_numpy(w), dtype=td)
        assert tc.dtype == td
        np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                      np.asarray(jc).view(np.uint8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def test_nn_quant_surface(self):
        w = _w(33, 20, 1)
        for algo in ('weight_only_int8', 'weight_only_int4'):
            jc, js = jax_nq.weight_quantize(jnp.asarray(w), algo=algo)
            tc, ts = nq.weight_quantize(torch.from_numpy(w), algo=algo)
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            want = jax_nq.weight_dequantize(jc, js, algo=algo,
                                            out_features=33)
            got = nq.weight_dequantize(tc, ts, algo=algo, out_features=33)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for algo in ('fp8', 'weight_only_fp8', 'float8_e4m3fn'):
            jc, js = jax_nq.weight_quantize(jnp.asarray(w), algo=algo)
            tc, ts = nq.weight_quantize(torch.from_numpy(w), algo=algo)
            assert tc.dtype == torch.float8_e4m3fn
            np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                          np.asarray(jc).view(np.uint8))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(
                nq.weight_dequantize(tc, ts).numpy(),
                np.asarray(jax_nq.weight_dequantize(jc, js)))
        with pytest.raises(ValueError, match='unknown'):
            nq.weight_quantize(torch.from_numpy(w), algo='int3')


class TestQuantMatmulPlain:
    @pytest.mark.parametrize('bits', [8, 4, 'e4m3', 'e5m2'])
    @pytest.mark.parametrize('M,K,N', [(1, 64, 48), (5, 65, 33),
                                       (16, 130, 20)])
    def test_matches_pallas_kernel(self, bits, M, K, N):
        rng = np.random.default_rng(M + K + N + FP8_SEED.get(bits, bits))
        x = rng.normal(size=(M, K)).astype(np.float32)
        w = _w(K, N, K)
        if bits == 8:
            codes, scale = jq.quantize_weight(jnp.asarray(w))
            fn, plain = jq.quant_matmul, ops.quant_matmul
        elif bits in ('e4m3', 'e5m2'):
            # the Pallas kernel casts whatever codes it is given (K10f8)
            codes, scale = jq.quantize_weight_fp8(
                jnp.asarray(w), dtype=(jnp.float8_e4m3fn if bits == 'e4m3'
                                       else jnp.float8_e5m2))
            fn, plain = jq.quant_matmul, ops.quant_matmul_fp8
        else:
            codes, scale = jq.quantize_weight_int4(jnp.asarray(w))
            fn, plain = jq.quant_matmul_int4, ops.quant_matmul_int4
        # small blocks so the interpreted kernel walks several K blocks
        # and ragged tails
        want = np.asarray(jax.jit(functools.partial(
            fn, block_m=8, block_n=16, block_k=32, interpret=True))(
                jnp.asarray(x), codes, scale))
        got = plain(torch.from_numpy(x), _codes(codes),
                    torch.from_numpy(np.array(scale)))
        np.testing.assert_allclose(got.numpy(), want, **MM_TOL)

    @pytest.mark.parametrize('bits', [8, 4])
    def test_matches_default_route_at_a_larger_size(self, bits):
        rng = np.random.default_rng(bits)
        x = rng.normal(size=(24, 513)).astype(np.float32)
        w = _w(513, 384, 2)
        quant = jq.quantize_weight if bits == 8 else jq.quantize_weight_int4
        codes, scale = quant(jnp.asarray(w))
        want = np.asarray(jq.weight_only_linear(
            jnp.asarray(x), codes, scale,
            weight_dtype='int8' if bits == 8 else 'int4'))
        got = nq.weight_only_linear(
            torch.from_numpy(x), torch.from_numpy(np.array(codes)),
            weight_scale=torch.from_numpy(np.array(scale)),
            weight_dtype='int8' if bits == 8 else 'int4')
        np.testing.assert_allclose(got.numpy(), want, **MM_TOL)

    def test_no_gradient_and_no_cpu_kernel(self):
        x = torch.ones(2, 8, requires_grad=True)
        codes, scale = tq.quantize_weight(torch.ones(8, 4))
        with pytest.raises(NotImplementedError, match='no gradient'):
            ops.quant_matmul(x, codes, scale)
        with torch.no_grad():
            ops.quant_matmul(x, codes, scale)
        with pytest.raises(ValueError, match='CUDA'):
            tq.quant_matmul(x.detach(), codes, scale)
        with pytest.raises(ValueError, match='CUDA'):
            tq.quant_matmul_int4(x.detach(), *tq.quantize_weight_int4(
                torch.ones(8, 4)))


def test_quant_matmul_path_rule():
    """The rule that picks K10 / K10f8 / K11's kernel: the skinny path up
    to SKINNY_M rows whatever the dtype and shape; past it the tensor
    cores for bf16 x on shapes and pointers the 16-byte copies take, the
    CUDA cores for float32 x (TF32 would round it) and anything
    unaligned."""
    S, bf16, f32 = tq.SKINNY_M, torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        for M in (1, S):
            assert tq.path(M, 4096, 4096, dtype, True) == 'skinny'
            assert tq.path(M, 4095, 77, dtype, False) == 'skinny'
    for M in (S + 1, 2048):
        assert tq.path(M, 4096, 4096, bf16, True) == 'tensor_core'
        assert tq.path(M, 4104, 336, bf16, True) == 'tensor_core'
        assert tq.path(M, 4096, 4096, f32, True) == 'cuda_core'
        assert tq.path(M, 4100, 4096, bf16, True) == 'cuda_core'
        assert tq.path(M, 4096, 4104, bf16, True) == 'cuda_core'
        assert tq.path(M, 4095, 4096, bf16, True) == 'cuda_core'
        assert tq.path(M, 4096, 4096, bf16, False) == 'cuda_core'
    assert set(tq.PATH_LAUNCHES) == {'skinny', 'tensor_core', 'cuda_core'}


@functools.lru_cache(maxsize=None)
def _models(tie=False):
    pt.seed(0)
    jcfg = jax_tiny(**CFG)
    tcfg = llama_tiny(**CFG)
    jcfg.tie_word_embeddings = tcfg.tie_word_embeddings = tie
    jm = JaxLlama(jcfg)
    tm = LlamaForCausalLM(tcfg, device='cpu')
    io.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    return jm, tm


def _jax_state(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


@pytest.fixture(scope='module')
def jax_quantized():
    """The JAX package's quantize_weights(bits) of the untied or tied
    model, made once per module and shared by every test held against
    it: get(bits, tie=False) -> the quantized JAX model."""
    memo = {}

    def get(bits, tie=False):
        if (bits, tie) not in memo:
            memo[bits, tie] = _models(tie)[0].quantize_weights(bits)
        return memo[bits, tie]

    return get


class TestQuantizeWeights:
    @pytest.mark.parametrize('tie', [False, True], ids=['untied', 'tied'])
    @pytest.mark.parametrize('bits', [8, 4])
    def test_same_state_as_jax(self, jax_quantized, bits, tie):
        """The same parameters quantize (embedding exempt, an untied head
        quantized, a tied head full precision), to bit-equal codes and
        scales under the same names; the original model is untouched."""
        _, tm = _models(tie)
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        want = _jax_state(jax_quantized(bits, tie))
        qm = tm.quantize_weights(bits)
        got = io.jax_state_dict(qm)
        assert set(got) == set(want)
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
        assert 'model.embed_tokens' in got
        assert 'lm_head' not in got
        assert ('lm_head.codes' in got) == (not tie)
        after = tm.state_dict()
        assert set(after) == set(before)
        for k, v in before.items():
            assert torch.equal(after[k], v), k
        assert isinstance(tm.model.layers[0].mlp.up_proj, torch.nn.Parameter)

    @pytest.mark.parametrize('bits', [8, 4])
    def test_loaded_jax_quantized_state_generates_the_same(
            self, jax_quantized, bits):
        """A model the JAX package quantized loads (codes, scales) into a
        port model quantized the same way, and greedy generate is
        token-equal to the JAX model's."""
        jm, _ = _models()
        jqm = jax_quantized(bits)
        ids = np.random.default_rng(bits).integers(
            3, CFG['vocab_size'], (2, 6)).astype(np.int32)
        # the JAX generate under one jax.jit (its eager prefill compiles
        # every operation)
        want = np.asarray(jax.jit(lambda x: jqm.generate(
            x, max_new_tokens=8))(jnp.asarray(ids)))
        other = LlamaForCausalLM(llama_tiny(**CFG), device='cpu', seed=3)
        qm = other.quantize_weights(bits)
        io.load_jax_state(qm, _jax_state(jqm))
        got = qm.generate(torch.from_numpy(ids), max_new_tokens=8)
        np.testing.assert_array_equal(got.numpy(), want)
        # a float state does not load into a quantized model
        with pytest.raises(ValueError, match='missing'):
            io.load_jax_state(qm, _jax_state(jm))

    def test_min_features_and_exclude(self):
        _, tm = _models()
        qm = quantize_matmul_weights(tm, bits=8, min_features=65,
                                     exclude=('mlp',))
        names = set(io.jax_state_dict(qm))
        # only (64, 96) lm_head clears neither filter; q/k/v/o are 64 wide
        assert not any(n.endswith('.codes') for n in names)
        qm = quantize_matmul_weights(tm, bits=8, min_features=1,
                                     exclude=('mlp',))
        names = set(io.jax_state_dict(qm))
        assert 'model.layers.L0.mlp.up_proj' in names
        assert 'model.layers.L0.self_attn.q_proj.codes' in names
        with pytest.raises(ValueError, match='bits'):
            quantize_matmul_weights(tm, bits=3)


def test_serving_engine_over_quantized_models_equal_jax(jax_quantized):
    """The port's ServingEngine over a port-quantized model against the
    JAX ServingEngine over the JAX-quantized one: token-equal streams."""
    _, tm = _models()
    kw = dict(max_slots=2, block_size=4, max_new_tokens=6, decode_window=3,
              max_context_len=32, buckets=(8, 16))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, CFG['vocab_size'], n).astype(np.int32)
               for n in (5, 11, 3)]
    for bits in (8, 4):
        je = JaxEngine(jax_quantized(bits), **kw)
        te = ServingEngine(tm.quantize_weights(bits), **kw)
        jr = [je.submit(p) for p in prompts]
        tr = [te.submit(p) for p in prompts]
        je.run()
        te.run()
        for i, (a, b) in enumerate(zip(jr, tr)):
            np.testing.assert_array_equal(
                np.asarray(te.result(b)), np.asarray(je.result(a)),
                err_msg=f'bits {bits}, request {i}')
        assert te.allocator.in_use() == 0
