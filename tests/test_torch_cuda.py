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
from paddle_tpu_torch.ops.hopper import flash_attention as k_flash
from paddle_tpu_torch.ops.hopper import paged_attention as k_paged
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
