"""A Qwen2-style model through the port against the JAX package.

The port's HF converters (`models/convert.py`) against the JAX
package's: `hf_qwen2_config` / `hf_llama_config` on the same dicts, and
one seeded state dict of HF names through both `from_hf_qwen2`s. The
converted model (7 query heads over 1 kv head, a GQA group no kernel was
built for before, head size 16, qkv biases) is held against the JAX one
on the same weights: float32 logits, greedy `generate` (float and int8
KV caches), `DecodeEngine`, and `ServingEngine` over float and int8
pools, token-equal. On the CPU both sides take their kernels' plain
versions (the JAX package's native paths). Inputs come from seeded
numpy.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from paddle_tpu.inference.serving import ServingEngine as JaxServingEngine
from paddle_tpu.models import convert as jax_convert
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import DecodeEngine, ServingEngine
from paddle_tpu_torch.models import convert

# float32 on both sides, summation order apart (tests/test_torch_llama.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

# Qwen/Qwen2-7B's config.json (the widths chip_smoke.py serves)
QWEN2_7B = {
    'architectures': ['Qwen2ForCausalLM'], 'hidden_act': 'silu',
    'hidden_size': 3584, 'intermediate_size': 18944,
    'max_position_embeddings': 131072, 'max_window_layers': 28,
    'model_type': 'qwen2', 'num_attention_heads': 28,
    'num_hidden_layers': 28, 'num_key_value_heads': 4,
    'rms_norm_eps': 1e-06, 'rope_theta': 1000000.0,
    'sliding_window': 131072, 'tie_word_embeddings': False,
    'torch_dtype': 'bfloat16', 'use_sliding_window': False,
    'vocab_size': 152064}

# the same architecture cut to a test's size: group 7, head size 16
TINY = dict(QWEN2_7B, hidden_size=112, intermediate_size=160,
            num_attention_heads=7, num_key_value_heads=1,
            num_hidden_layers=2, vocab_size=96,
            max_position_embeddings=256)
# head size 12 (not a multiple of 8): paged decode takes the masked path
# over the gathered pages, on both sides
TINY_D12 = dict(TINY, hidden_size=84)


class _Attrs:
    """A transformers-style config object (attributes, no dict)."""

    def __init__(self, d):
        self.__dict__.update(d)


CONFIGS = {
    'qwen2-7b': (QWEN2_7B, 'qwen2'),
    'qwen2-swa': (dict(TINY, use_sliding_window=True, sliding_window=48,
                       max_window_layers=1), 'qwen2'),
    'qwen2-swa-absent': ({k: v for k, v in dict(
        TINY, use_sliding_window=True).items() if k != 'sliding_window'},
        'qwen2'),
    'qwen2-object': (_Attrs(TINY), 'qwen2'),
    'llama3': ({'vocab_size': 128256, 'hidden_size': 3072,
                'intermediate_size': 8192, 'num_hidden_layers': 28,
                'num_attention_heads': 24, 'num_key_value_heads': 8,
                'rope_theta': 500000.0, 'rms_norm_eps': 1e-05,
                'tie_word_embeddings': True,
                'rope_scaling': {'rope_type': 'llama3', 'factor': 32.0,
                                 'low_freq_factor': 1.0,
                                 'high_freq_factor': 4.0,
                                 'original_max_position_embeddings': 8192}},
               'llama'),
    'mistral': ({'vocab_size': 32000, 'hidden_size': 4096,
                 'intermediate_size': 14336, 'num_hidden_layers': 32,
                 'num_attention_heads': 32, 'num_key_value_heads': 8,
                 'sliding_window': 4096, 'rope_theta': 10000.0},
                'llama'),
}


@pytest.mark.parametrize('case', CONFIGS.values(), ids=CONFIGS.keys())
def test_hf_configs_equal_jax(case):
    hf, kind = case
    fn = f'hf_{kind}_config'
    got = dataclasses.asdict(getattr(convert, fn)(hf))
    want = dataclasses.asdict(getattr(jax_convert, fn)(hf))
    assert got == want
    if hf is QWEN2_7B:      # the published widths pass through unchanged
        assert (got['num_attention_heads'], got['num_key_value_heads'],
                got['rope_theta'], got['max_position_embeddings'],
                got['attention_bias'], got['sliding_window']) == \
            (28, 4, 1e6, 131072, True, None)


@pytest.mark.parametrize('bad', [
    {'rope_scaling': {'rope_type': 'dynamic', 'factor': 2.0}},
    {'rope_scaling': {'rope_type': 'llama3', 'factor': 8.0}},
    {'rope_scaling': {'rope_type': 'yarn'}},
    {'hidden_act': 'gelu'}], ids=['dynamic', 'llama3-keys', 'yarn', 'act'])
def test_hf_config_guards_equal_jax(bad):
    hf = dict(TINY, **bad)
    for mod in (jax_convert, convert):
        with pytest.raises(ValueError):
            mod.hf_qwen2_config(hf)


def _hf_state(cfg, seed=0):
    """A seeded state dict of HF Qwen2 names: (out, in) projections,
    nonzero qkv biases and norm weights, rotary buffers to be skipped."""
    rng = np.random.default_rng(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    D = cfg.head_dim
    nq, nkv = cfg.num_attention_heads * D, cfg.num_key_value_heads * D

    def w(*shape, std=0.08):
        return (std * rng.normal(size=shape)).astype(np.float32)

    sd = {'model.embed_tokens.weight': w(V, H, std=0.5),
          'model.norm.weight': 1 + w(H, std=0.1),
          'lm_head.weight': w(V, H)}
    for i in range(cfg.num_hidden_layers):
        p = f'model.layers.{i}.'
        for name, n_out, n_in in (('q', nq, H), ('k', nkv, H),
                                  ('v', nkv, H), ('o', H, nq)):
            sd[p + f'self_attn.{name}_proj.weight'] = w(n_out, n_in)
        for name in ('q', 'k', 'v'):
            n = nq if name == 'q' else nkv
            sd[p + f'self_attn.{name}_proj.bias'] = w(n, std=0.2)
        sd[p + 'mlp.gate_proj.weight'] = w(I, H)
        sd[p + 'mlp.up_proj.weight'] = w(I, H)
        sd[p + 'mlp.down_proj.weight'] = w(H, I)
        sd[p + 'input_layernorm.weight'] = 1 + w(H, std=0.1)
        sd[p + 'post_attention_layernorm.weight'] = 1 + w(H, std=0.1)
        sd[p + 'self_attn.rotary_emb.inv_freq'] = w(D // 2)
    return sd


@functools.lru_cache(maxsize=None)
def _models(head_dim=16):
    hf = {16: TINY, 12: TINY_D12}[head_dim]
    jcfg = jax_convert.hf_qwen2_config(hf)
    sd = _hf_state(jcfg)
    jm = jax_convert.from_hf_qwen2(dict(sd), jcfg)
    tm = convert.from_hf_qwen2(dict(sd), convert.hf_qwen2_config(hf),
                               device='cpu')
    return jm, tm


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, TINY['vocab_size'], (n,)).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize('dtype,D,decode_built,flash_built', [
    (torch.bfloat16, 80, True, True), (torch.bfloat16, 96, True, True),
    (torch.bfloat16, 256, True, True), (torch.int8, 40, True, None),
    (torch.float32, 36, True, False), (torch.float32, 200, True, True),
    (torch.bfloat16, 12, False, False), (torch.bfloat16, 264, False, False),
    (torch.float32, 132, False, False)])
def test_decode_and_flash_kernels_build_e2_shapes(dtype, D, decode_built,
                                                  flash_built):
    """The head sizes the decode kernels (K7, K8, K8q, K9) and the flash
    kernels (K5, K6) are built for since fault E2's repair; a shape
    that stays unbuilt raises NotImplementedError, not ValueError.
    Every GQA group is built (no check takes the group)."""
    from paddle_tpu_torch.ops.hopper import decode_attention, flash_attention
    checks = [(lambda: decode_attention.check_built('decode', dtype, D),
               decode_built),
              (lambda: flash_attention.check_built('flash', D), flash_built)]
    for check, built in checks:
        if built:
            check()
        elif built is not None:
            with pytest.raises(NotImplementedError, match=f'head_dim {D}'):
                check()


class TestConverter:
    def test_parameters_equal_jax(self):
        """Every parameter of the port's converted model equals the JAX
        converter's (names and values); the group is 7 and the biases
        are the state dict's."""
        jm, tm = _models()
        want = {io.port_name(k): np.asarray(v)
                for k, v in jm.state_dict().items()}
        got = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        attn = tm.model.layers[0].self_attn
        assert attn.num_heads // attn.num_kv_heads == 7
        assert float(attn.k_bias.detach().abs().max()) > 0

    def test_refusals(self):
        cfg = convert.hf_qwen2_config(TINY)
        sd = _hf_state(cfg)
        sd['model.layers.0.self_attn.extra.weight'] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match='unconverted'):
            convert.from_hf_qwen2(sd, cfg, device='cpu')
        with pytest.raises(NotImplementedError, match='transformers'):
            convert.from_hf_qwen2_pretrained('Qwen/Qwen2-7B')


class TestQwen2Model:
    def test_logits_equal_jax(self):
        jm, tm = _models()
        ids = np.stack(_prompts(1, (24, 24)))
        want = np.asarray(jax.jit(jm)(jnp.asarray(ids)))
        with torch.no_grad():
            got = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, **LOGIT_TOL)

    @pytest.mark.parametrize('kv8', [False, True], ids=['float', 'int8'])
    def test_generate_and_decode_engine_token_equal_jax(self, kv8):
        """Greedy generate over float and int8 KV caches (the K7 path at
        group 7), then DecodeEngine, each token-equal to JAX."""
        jm, tm = _models()
        ids = np.stack(_prompts(2, (9, 9)))
        # the JAX generate under one jax.jit (its eager prefill compiles
        # every operation)
        want = np.asarray(jax.jit(lambda x: jm.generate(
            x, max_new_tokens=10, kv_cache_int8=kv8))(jnp.asarray(ids)))
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=10,
                          kv_cache_int8=kv8)
        np.testing.assert_array_equal(got.numpy(), want)
        if not kv8:
            want = np.asarray(JaxDecodeEngine(jm, max_new_tokens=8)
                              .generate(jnp.asarray(ids)))
            got = DecodeEngine(tm, max_new_tokens=8).generate(
                torch.from_numpy(ids))
            np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize('head_dim', [16, 12], ids=['d16', 'd12'])
    @pytest.mark.parametrize('kv', ['float', 'int8'])
    def test_serving_engine_token_equal_jax(self, kv, head_dim):
        """ServingEngine over float pools (K8 at group 7) and int8 pools
        (K8q), token-equal to the JAX engine; no page leaks. Head size 12
        takes both sides' masked path over the gathered pages (the
        reference's dispatch for D % 8 != 0), with idle slots' table
        entries of -1 and rows of count 0 among them."""
        jm, tm = _models(head_dim)
        assert tm.model.layers[0].self_attn.head_dim == head_dim
        kw = dict(max_slots=3, block_size=4, max_new_tokens=8,
                  decode_window=4, buckets=(16,))
        if kv == 'int8':
            kw['kv_cache_dtype'] = 'int8'
        prompts = _prompts(3, (5, 14, 9, 12))
        outs = []
        for engine in (JaxServingEngine(jm, **kw), ServingEngine(tm, **kw)):
            rids = [engine.submit(p) for p in prompts]
            engine.run()
            outs.append([np.asarray(engine.result(r)) for r in rids])
        for i, (w, g) in enumerate(zip(*outs)):
            np.testing.assert_array_equal(g, w, err_msg=f'request {i}')
        assert engine.allocator.in_use() == 0
