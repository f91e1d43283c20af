"""The port's hand-written Hopper kernels against their plain versions,
on a CUDA card.

Marked `cuda`; each test skips (inside the test) when no card is
present. This file imports neither JAX nor the JAX package, so it runs
on a machine without them, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.hopper import decode_attention as k_decode
from paddle_tpu_torch.ops.hopper import flash_attention as k_flash
from paddle_tpu_torch.ops.hopper import paged_attention as k_paged
from paddle_tpu_torch.ops.hopper import quant_matmul as k_qmm
from paddle_tpu_torch.ops.hopper import rms_norm as k_rms
from paddle_tpu_torch.ops.hopper import softmax_xent as k_xent

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


# dtype -> (rtol, atol): float32 differs by summation order only; bf16
# outputs may differ by one rounding step (2^-8 relative)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -7)}


@pytest.mark.parametrize('dtype,wdtype', [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('shape', [(4, 4096), (2048, 4096), (3, 1000),
                                   (2, 5, 64)])
def test_rms_norm_kernel(card, shape, dtype, wdtype):
    rng = np.random.default_rng(shape[-1])
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=shape[-1:]))
                         .astype(np.float32))
    x, w = x.to(card, dtype), w.to(card, wdtype)
    before = _build.LAUNCHES['rms_norm']
    got, r = k_rms.rms_norm(x, w, 1e-5, return_r=True)
    got_only = k_rms.rms_norm(x, w, 1e-5)
    want, want_r = k_rms.rms_norm_plain(x, w, 1e-5, return_r=True)
    assert _build.LAUNCHES['rms_norm'] == before + 2
    rtol, atol = TOL[dtype]
    for out in (got, got_only):
        torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                                   atol=atol)
    torch.testing.assert_close(r, want_r, rtol=1e-5, atol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('Hq,Hkv,D', [(32, 32, 128), (32, 8, 128),
                                      (4, 2, 16), (8, 4, 64)])
def test_paged_kernel(card, dtype, Hq, Hkv, D):
    rng = np.random.default_rng(Hq * 100 + Hkv + D)
    B, BS, MAXB = 4, 16, 20
    NB = B * MAXB + 1
    lens = np.asarray([MAXB * BS + 7, 0, 33, 1], np.int32)
    tbl = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    tbl[2, 5] = -1
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(card, dtype) for s in ((B, 1, Hq, D), (NB, Hkv, BS, D),
                                       (NB, Hkv, BS, D))]
    args += [torch.from_numpy(tbl).to(card), torch.from_numpy(lens).to(card)]
    before = _build.LAUNCHES['paged_decode_attention']
    got = k_paged.paged_decode_attention(*args)
    want = k_paged.paged_decode_attention_plain(*args)
    assert _build.LAUNCHES['paged_decode_attention'] == before + 1
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert not got[1].any(), 'a count-0 row must return zeros'


def test_paged_kernel_refuses_unbuilt_group(card):
    q = torch.zeros(1, 1, 6, 64, device=card)
    kc = torch.zeros(2, 2, 16, 64, device=card)
    tbl = torch.zeros(1, 1, dtype=torch.int32, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match='Hq/Hkv'):
        k_paged.paged_decode_attention(q, kc, kc, tbl, lens)


def test_kernels_refuse_float16(card):
    """Only bf16 and float32 are built; float16 raises, never launches."""
    x = torch.zeros(2, 64, dtype=torch.float16, device=card)
    q = torch.zeros(1, 1, 2, 64, dtype=torch.float16, device=card)
    kc = torch.zeros(2, 2, 16, 64, dtype=torch.float16, device=card)
    tbl = torch.zeros(1, 1, dtype=torch.int32, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError, match='unsupported dtype'):
        k_rms.rms_norm(x, torch.ones(64, device=card))
    with pytest.raises(TypeError, match='unsupported dtype'):
        k_paged.paged_decode_attention(q, kc, kc, tbl, lens)
    r = torch.ones(2, 1, device=card)
    with pytest.raises(TypeError, match='unsupported dtype'):
        k_rms.rms_norm_bwd(x, torch.ones(64, device=card), r, x)
    labels = torch.zeros(2, dtype=torch.int64, device=card)
    with pytest.raises(TypeError, match='unsupported dtype'):
        k_xent.softmax_xent_fwd(x, labels)
    with pytest.raises(TypeError, match='unsupported dtype'):
        k_xent.softmax_xent_bwd(x, labels, r[:, 0], r[:, 0])
    qh = torch.zeros(1, 2, 128, 64, dtype=torch.float16, device=card)
    with pytest.raises(TypeError, match='unsupported dtype'):
        k_flash.flash_attention_fwd(qh, qh, qh, True)
    with pytest.raises(TypeError, match='unsupported dtype'):
        k_flash.flash_attention_bwd(qh, qh, qh, qh,
                                    torch.zeros(1, 2, 128, device=card), qh,
                                    True)
    assert _build.LAUNCHES == before


def test_flash_kernel_refuses_unbuilt_head_dim(card):
    q = torch.zeros(1, 2, 128, 96, device=card)
    with pytest.raises(NotImplementedError, match='head_dim 96'):
        k_flash.flash_attention_fwd(q, q, q, True)


def _randn(rng, shape, card, dtype, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape))
                            .astype(np.float32)).to(card, dtype)


@pytest.mark.parametrize('dtype,wdtype', [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('shape', [(7, 4096), (3, 1000), (2, 5, 64)])
def test_rms_norm_bwd_kernel(card, shape, dtype, wdtype):
    """Odd row counts and a width off the 16-byte vector included."""
    rng = np.random.default_rng(shape[0] * 10 + shape[-1])
    x = _randn(rng, shape, card, dtype)
    g = _randn(rng, shape, card, dtype)
    w = (1 + 0.1 * _randn(rng, shape[-1:], card, torch.float32)).to(wdtype)
    _, r = k_rms.rms_norm_plain(x, w, 1e-5, return_r=True)
    before = _build.LAUNCHES['rms_norm_bwd']
    got = k_rms.rms_norm_bwd(x, w, r, g)
    want = k_rms.rms_norm_bwd_plain(x, w, r, g)
    assert _build.LAUNCHES['rms_norm_bwd'] == before + 1
    rtol, atol = TOL[dtype]
    # dx mixes two terms of similar size: allow the bf16 step on |g*w*r|
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * 4 if dtype == torch.bfloat16
                               else atol)


def test_rms_norm_has_gradients_on_the_card(card):
    """Fault E1: RMSNorm on a CUDA tensor carried no autograd graph, so
    nothing below it got a gradient. Now x and the weight both get the
    plain version's gradients."""
    rng = np.random.default_rng(3)
    x = _randn(rng, (6, 256), card, torch.float32).requires_grad_()
    w = (1 + 0.1 * _randn(rng, (256,), card, torch.float32)).requires_grad_()
    g = _randn(rng, (6, 256), card, torch.float32)
    before = dict(_build.LAUNCHES)
    (ops.rms_norm(x, w, 1e-5) * g).sum().backward()
    assert _build.LAUNCHES['rms_norm'] == before['rms_norm'] + 1
    assert _build.LAUNCHES['rms_norm_bwd'] == before['rms_norm_bwd'] + 1
    x2 = x.detach().clone().requires_grad_()
    w2 = w.detach().clone().requires_grad_()
    (k_rms.rms_norm_plain(x2, w2, 1e-5) * g).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-5)


def test_rms_norm_without_grad_launches_forward_only(card):
    """Under no_grad (serving) ops.rms_norm launches the forward alone:
    no autograd node, and the Function's values."""
    rng = np.random.default_rng(4)
    x = _randn(rng, (5, 4096), card, torch.bfloat16)
    w = (1 + 0.1 * _randn(rng, (4096,), card, torch.float32)).requires_grad_()
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        fast = ops.rms_norm(x, w, 1e-5)
    tracked = ops.rms_norm(x, w, 1e-5)
    assert _build.LAUNCHES['rms_norm'] == before['rms_norm'] + 2
    assert fast.grad_fn is None and tracked.grad_fn is not None
    torch.testing.assert_close(fast, tracked.detach(), rtol=0, atol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('R,V', [(5, 32000), (3, 1000), (4, 517)])
def test_softmax_xent_kernels(card, dtype, R, V):
    """V = 32000 (Llama's vocab, no power-of-two tile divides it), a
    width off the 8-wide vector (517), a label out of range."""
    rng = np.random.default_rng(R * V)
    x = _randn(rng, (R, V), card, dtype, 3.0)
    labels = torch.from_numpy(rng.integers(0, V, R)).to(card)
    labels[-1] = V - 1
    g = torch.from_numpy(rng.uniform(0.5, 1.5, R).astype(np.float32)) \
        .to(card)
    before = dict(_build.LAUNCHES)
    loss, lse = k_xent.softmax_xent_fwd(x, labels)
    dx = k_xent.softmax_xent_bwd(x, labels, lse, g)
    assert _build.LAUNCHES['softmax_xent_fwd'] == \
        before['softmax_xent_fwd'] + 1
    assert _build.LAUNCHES['softmax_xent_bwd'] == \
        before['softmax_xent_bwd'] + 1
    want_loss, want_lse = k_xent.softmax_xent_fwd_plain(x, labels)
    want_dx = k_xent.softmax_xent_bwd_plain(x, labels, want_lse, g)
    # float32 statistics on both sides: summation order only
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=rtol,
                               atol=atol)
    bad = labels.clone()
    bad[0] = V
    assert k_xent.softmax_xent_fwd(x, bad)[0][0].item() > 1e29


# (B, H, Hkv, Sq, Sk, D, causal): MHA and GQA, Sq != Sk both ways
# (bottom-right causal, rows that see no key), tails of every tile size
FLASH_CASES = [
    (2, 4, 4, 128, 128, 128, True), (1, 4, 2, 200, 200, 128, True),
    (2, 4, 1, 77, 150, 64, True), (1, 2, 2, 150, 77, 64, True),
    (1, 4, 2, 96, 160, 128, False), (1, 32, 8, 256, 256, 128, True)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', FLASH_CASES,
                         ids=lambda c: 'B{}H{}/{}Sq{}Sk{}D{}{}'.format(
                             *c[:6], 'c' if c[6] else ''))
def test_flash_attention_kernels(card, dtype, case):
    B, H, Hkv, Sq, Sk, D, causal = case
    rng = np.random.default_rng(sum(case[:6]))
    q = _randn(rng, (B, Sq, H, D), card, dtype).transpose(1, 2)
    k = _randn(rng, (B, Sk, Hkv, D), card, dtype).transpose(1, 2)
    v = _randn(rng, (B, Sk, Hkv, D), card, dtype).transpose(1, 2)
    do = _randn(rng, (B, Sq, H, D), card, dtype).transpose(1, 2)
    scale = 1.0 / np.sqrt(D)
    before = dict(_build.LAUNCHES)
    out, lse = k_flash.flash_attention_fwd(q, k, v, causal, scale)
    dq, dk, dv = k_flash.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                             scale)
    assert _build.LAUNCHES['flash_attention_fwd'] == \
        before['flash_attention_fwd'] + 1
    assert _build.LAUNCHES['flash_attention_bwd'] == \
        before['flash_attention_bwd'] + 2
    want_out, want_lse = k_flash.flash_attention_fwd_plain(q, k, v, causal,
                                                           scale)
    # the backward of each side from its own forward
    want = k_flash.flash_attention_bwd_plain(q, k, v, want_out, want_lse, do,
                                             causal, scale)
    # float32: summation order only; bf16: one rounding step of the
    # outputs, and of the gradients summed over up to Sq / Sk terms
    rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                  else (2 ** -7, 2e-2))
    seen = want_lse > -1e29
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=atol)
    for name, got, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=atol, msg=name)
    if causal and Sq > Sk:
        assert not out[:, :, :Sq - Sk].any(), 'rows that see no key are 0'


def test_training_ops_differentiate_on_the_card(card):
    """The entry points carry gradients through the kernels: loss and
    gradients of a small attention + norm + loss graph against the same
    graph through the plain versions, in float32."""
    rng = np.random.default_rng(7)
    B, S, H, D, V = 2, 128, 4, 64, 1000
    x = _randn(rng, (B, S, H * D), card, torch.float32)
    w = 1 + 0.1 * _randn(rng, (H * D,), card, torch.float32)
    head = _randn(rng, (H * D, V), card, torch.float32, 0.05)
    labels = torch.from_numpy(rng.integers(0, V, (B, S))).to(card)

    def run(rms, attn, xent):
        ts = [t.detach().clone().requires_grad_() for t in (x, w, head)]
        h = rms(ts[0], ts[1])
        q = h.reshape(B, S, H, D)
        a = attn(q, q, q).reshape(B, S, H * D)
        loss = xent(a @ ts[2], labels).mean()
        loss.backward()
        return [loss.detach()] + [t.grad for t in ts]

    def plain_attn(q, k, v):
        return k_flash.flash_attention_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
            None)[0].transpose(1, 2)

    def plain_xent(logits, lab):
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lab[..., None])[..., 0])

    got = run(lambda a, b: ops.rms_norm(a, b, 1e-5),
              lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
              ops.softmax_cross_entropy)
    want = run(lambda a, b: k_rms.rms_norm_plain(a, b, 1e-5), plain_attn,
               plain_xent)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('B,S,Hq,Hkv,D', [(1, 2048, 32, 32, 128),
                                          (8, 2048, 32, 8, 128),
                                          (4, 37, 4, 2, 16),
                                          (3, 300, 8, 1, 64)])
def test_decode_attention_kernel(card, mode, B, S, Hq, Hkv, D):
    """K7 against its plain version: per-row windows with an empty one
    (start past valid_len), valid_len past S, a start below 0, in one
    split and in several (B = 1 splits the context across blocks)."""
    rng = np.random.default_rng(B * 1000 + S + Hkv + D)
    dtype = torch.float32 if mode == 'float32' else torch.bfloat16
    q = _randn(rng, (B, 1, Hq, D), card, dtype)
    ks = vs = None
    if mode == 'int8':
        kc, vc = (torch.from_numpy(rng.integers(-127, 128, (B, S, Hkv, D))
                                   .astype(np.int8)).to(card)
                  for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, (Hkv, D))
                                   .astype(np.float32)).to(card)
                  for _ in range(2))
    else:
        kc, vc = (_randn(rng, (B, S, Hkv, D), card, dtype)
                  for _ in range(2))
    vl = rng.integers(1, S + 1, B)
    st = rng.integers(0, S, B) % np.maximum(vl, 1)
    vl[0] = S + 5                                  # clamped to S
    if B > 1:
        st[1], vl[1] = S // 2, S // 3              # empty window
    if B > 2:
        st[2] = -3                                 # clipped to 0
    vl = torch.from_numpy(vl.astype(np.int32)).to(card)
    st = torch.from_numpy(st.astype(np.int32)).to(card)
    before = _build.LAUNCHES['decode_attention']
    got = k_decode.decode_attention(q, kc, vc, vl, None, ks, vs, st)
    want = k_decode.decode_attention_plain(q, kc, vc, vl, None, ks, vs, st)
    assert _build.LAUNCHES['decode_attention'] == before + 1
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if B > 1:
        assert not got[1].any(), 'an empty window must return zeros'
    # a uniform int valid_len and no start, as the model's decode step
    got = k_decode.decode_attention(q, kc, vc, S - 1, None, ks, vs)
    want = k_decode.decode_attention_plain(q, kc, vc, S - 1, None, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_decode_attention_kernel_refusals(card):
    q = torch.zeros(1, 1, 6, 64, device=card)
    kc = torch.zeros(1, 16, 2, 64, device=card)
    with pytest.raises(ValueError, match='Hq/Hkv'):
        k_decode.decode_attention(q, kc, kc, 4)
    with pytest.raises(TypeError, match='dtype'):
        k_decode.decode_attention(q[:, :, :2], kc.bfloat16(), kc.bfloat16(),
                                  4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('bits', [8, 4])
@pytest.mark.parametrize('M,K,N', [(1, 4096, 4096), (16, 4096, 11008),
                                   (8, 11008, 4096), (3, 333, 77),
                                   (40, 129, 130), (2, 4095, 4096)])
def test_quant_matmul_kernels(card, dtype, bits, M, K, N):
    """K10 / K11 against their plain versions: decode rows (M <= 16, the
    skinny path with K split across blocks), a ragged M / K / N (scalar
    tails, odd K for int4) and M > 16 (the tiled path)."""
    rng = np.random.default_rng(M * 7 + K + N + bits)
    w = _randn(rng, (K, N), card, torch.float32, 0.02)
    quant = k_qmm.quantize_weight_int4 if bits == 4 else k_qmm.quantize_weight
    codes, scale = quant(w)
    x = _randn(rng, (M, K), card, dtype)
    kern = k_qmm.quant_matmul_int4 if bits == 4 else k_qmm.quant_matmul
    plain = (k_qmm.quant_matmul_int4_plain if bits == 4
             else k_qmm.quant_matmul_plain)
    name = 'quant_matmul_int4' if bits == 4 else 'quant_matmul'
    before = _build.LAUNCHES[name]
    got = kern(x, codes, scale)
    want = plain(x, codes, scale)
    assert _build.LAUNCHES[name] == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    # float32: sums of up to 11008 products taken in another order;
    # bf16: one rounding step of the output on top
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else TOL[dtype]
    amax = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * amax)


def test_generate_on_the_card_runs_the_decode_kernels(card):
    """A tiny model's generate and DecodeEngine on the card, with bf16 and
    int8 caches and int8 / int4 weights: every decode forward launches K7
    once per layer, and a quantized model K10 / K11 for each of the
    7L + 1 projections of every forward."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cfg = llama_tiny(vocab_size=128, hidden_size=64, layers=2)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=card, seed=0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        3, 128, (2, 9))).to(card)
    for kv8 in (False, True):
        before = dict(_build.LAUNCHES)
        out = model.generate(ids, max_new_tokens=6, kv_cache_int8=kv8)
        assert out.shape == (2, 15)
        assert _build.LAUNCHES['decode_attention'] - before[
            'decode_attention'] == 5 * L
    eng = DecodeEngine(model, max_new_tokens=6)
    before = dict(_build.LAUNCHES)
    out = eng.generate(ids)
    assert torch.equal(out, model.generate(ids, max_new_tokens=6))
    assert _build.LAUNCHES['decode_attention'] - before[
        'decode_attention'] == 2 * 5 * L
    for bits, name in ((8, 'quant_matmul'), (4, 'quant_matmul_int4')):
        qm = model.quantize_weights(bits)
        before = dict(_build.LAUNCHES)
        out = qm.generate(ids, max_new_tokens=6)
        assert out.shape == (2, 15)
        assert _build.LAUNCHES[name] - before[name] == 6 * (7 * L + 1)
