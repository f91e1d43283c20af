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
from paddle_tpu_torch.ops.hopper import headmajor_attention as k_hm
from paddle_tpu_torch.ops.hopper import moe_grouped_matmul as k_moe
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

# (Hq, Hkv, D) the decode kernels (K7, K8, K8q, K9) took only after fault
# E2's repair: GQA groups 3, 5, 6, 7 at D = 80, 96, 128 (Llama-3.2-3B,
# Qwen2.5-14B, Qwen2-1.5B, Qwen2-7B), Qwen2-0.5B's 14 / 2 at D = 64, a
# group of 16 (two chunks of 8), D = 256 and D = 40
E2_DECODE = [(2 * g, 2, D) for g in (3, 5, 6, 7) for D in (80, 96, 128)] \
    + [(28, 4, 128), (14, 2, 64), (16, 1, 128), (4, 2, 256), (3, 1, 40)]
# (Hq, Hkv, D) of the decode kernels' (K7, K9) widest registers: 8 query
# heads per block at D = 128 (Llama-70B's 64 / 8), a group of 8 at D = 256
# (two chunks of 4) and MHA at D = 256
DECODE_WIDE = [(8, 1, 128), (16, 2, 256), (8, 8, 256)]


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
                                      (4, 2, 16), (8, 4, 64)] + E2_DECODE)
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
    """Every group is built (group 3 launches); a head size that is not
    (past 256, or not a multiple of the load width) raises
    NotImplementedError before any launch."""
    tbl = torch.zeros(1, 1, dtype=torch.int32, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    q = torch.zeros(1, 1, 6, 64, device=card)
    kc = torch.zeros(2, 2, 16, 64, device=card)
    k_paged.paged_decode_attention(q, kc, kc, tbl, lens)
    before = dict(_build.LAUNCHES)
    for D, dtype in ((264, torch.float32), (12, torch.bfloat16),
                     (132, torch.float32)):
        q = torch.zeros(1, 1, 6, D, device=card, dtype=dtype)
        kc = torch.zeros(2, 2, 16, D, device=card, dtype=dtype)
        with pytest.raises(NotImplementedError, match=f'head_dim {D}'):
            k_paged.paged_decode_attention(q, kc, kc, tbl, lens)
    assert _build.LAUNCHES == before


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
    """Head sizes that are a multiple of 8 up to 256 are built; others
    raise NotImplementedError before any launch."""
    before = dict(_build.LAUNCHES)
    for D in (100, 264):
        q = torch.zeros(1, 2, 128, D, device=card)
        with pytest.raises(NotImplementedError, match=f'head_dim {D}'):
            k_flash.flash_attention_fwd(q, q, q, True)
    assert _build.LAUNCHES == before


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
    (1, 4, 2, 96, 160, 128, False), (1, 32, 8, 256, 256, 128, True),
    # head sizes built on a padded tile after fault E2's repair: Qwen's
    # 80 and 96 (GQA 28 / 4), 40, and 256 (one block per SM)
    (1, 28, 4, 200, 200, 80, True), (2, 4, 2, 77, 150, 96, True),
    (1, 4, 1, 150, 77, 96, False), (1, 2, 2, 130, 130, 40, True),
    (1, 4, 2, 150, 150, 256, True)]


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
                                          (3, 300, 8, 1, 64),
                                          (1, 2048, 28, 4, 128)] + [
    (3, 300, Hq, Hkv, D) for Hq, Hkv, D in E2_DECODE + DECODE_WIDE])
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
    """Every group is built; a head size that is not (past 256, or a
    float32 row past 128 that is not a multiple of 8) raises
    NotImplementedError before any launch."""
    before = dict(_build.LAUNCHES)
    for D in (264, 132):
        q = torch.zeros(1, 1, 6, D, device=card)
        kc = torch.zeros(1, 16, 2, D, device=card)
        with pytest.raises(NotImplementedError, match=f'head_dim {D}'):
            k_decode.decode_attention(q, kc, kc, 4)
    assert _build.LAUNCHES == before
    q = torch.zeros(1, 1, 2, 64, device=card)
    kc = torch.zeros(1, 16, 2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match='dtype'):
        k_decode.decode_attention(q, kc, kc, 4)


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('fp8', [torch.float8_e4m3fn, torch.float8_e5m2],
                         ids=['e4m3', 'e5m2'])
@pytest.mark.parametrize('M,K,N', [(1, 3584, 18944), (8, 18944, 3584),
                                   (3, 333, 77), (40, 129, 130),
                                   (16, 4095, 4096), (2, 130, 131)])
def test_quant_matmul_fp8_kernel(card, dtype, fp8, M, K, N):
    """K10f8 against its plain version: Qwen2-7B's MLP projections at
    decode rows (the skinny path, K split across blocks), ragged M / K /
    N (scalar column tails, rows not 4-byte aligned) and M > 16 (the
    tiled path); launched by nn.quant.weight_only_linear on fp8 codes
    with the default weight_dtype."""
    from paddle_tpu_torch.nn import quant as nq
    rng = np.random.default_rng(M * 7 + K + N)
    w = _randn(rng, (K, N), card, torch.float32, 0.02)
    codes, scale = k_qmm.quantize_weight_fp8(w, dtype=fp8)
    assert codes.dtype == fp8
    x = _randn(rng, (M, K), card, dtype)
    before = dict(_build.LAUNCHES)
    got = k_qmm.quant_matmul_fp8(x, codes, scale)
    linear = nq.weight_only_linear(x, codes, weight_scale=scale)
    want = k_qmm.quant_matmul_fp8_plain(x, codes, scale)
    assert _build.LAUNCHES['quant_matmul_fp8'] == \
        before['quant_matmul_fp8'] + 2
    assert _build.LAUNCHES['quant_matmul'] == before['quant_matmul']
    assert got.dtype == dtype and got.shape == (M, N)
    torch.testing.assert_close(linear, got, rtol=0, atol=0)
    # float32: sums of up to 18944 products taken in another order (the
    # fp8 -> float32 decode is exact); bf16: one rounding step on top
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else TOL[dtype]
    amax = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * amax)


def _quantized(rng, K, N, card, codes):
    """Seeded weight (K, N) quantized to `codes` ('int8', 'int4', 'e4m3',
    'e5m2'): (codes, scale, kernel, plain version)."""
    w = _randn(rng, (K, N), card, torch.float32, 0.02)
    if codes == 'int8':
        return (*k_qmm.quantize_weight(w), k_qmm.quant_matmul,
                k_qmm.quant_matmul_plain)
    if codes == 'int4':
        return (*k_qmm.quantize_weight_int4(w), k_qmm.quant_matmul_int4,
                k_qmm.quant_matmul_int4_plain)
    fp8 = {'e4m3': torch.float8_e4m3fn, 'e5m2': torch.float8_e5m2}[codes]
    return (*k_qmm.quantize_weight_fp8(w, dtype=fp8), k_qmm.quant_matmul_fp8,
            k_qmm.quant_matmul_fp8_plain)


def _path_launches(fn):
    """fn()'s result and the PATH_LAUNCHES it added."""
    before = dict(k_qmm.PATH_LAUNCHES)
    out = fn()
    return out, {p: n - before[p] for p, n in k_qmm.PATH_LAUNCHES.items()
                 if n != before[p]}


@pytest.mark.parametrize('codes', ['int8', 'int4', 'e4m3', 'e5m2'])
@pytest.mark.parametrize('M,K,N', [(17, 4096, 4112), (100, 4104, 336),
                                   (2048, 4096, 4096), (2048, 4104, 336),
                                   (100, 64, 16)])
def test_quant_matmul_tensor_core_path(card, codes, M, K, N):
    """K10 / K10f8 / K11 on the tensor-core path (bf16 x, M past the
    skinny path, K % 8 == 0, N % 16 == 0) against the plain versions:
    ragged M (one row past the skinny path, a part tile), N not a
    multiple of the 128-column tile, K not a multiple of the 64-deep
    step, the smallest aligned shape."""
    rng = np.random.default_rng(M + K + N + len(codes))
    wq, scale, kern, plain = _quantized(rng, K, N, card, codes)
    x = _randn(rng, (M, K), card, torch.bfloat16)
    assert k_qmm.path(M, K, N, x.dtype, True) == 'tensor_core'
    got, paths = _path_launches(lambda: kern(x, wq, scale))
    assert paths == {'tensor_core': 1}
    want = plain(x, wq, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    rtol, atol = TOL[torch.bfloat16]
    amax = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * amax)


@pytest.mark.parametrize('codes', ['int8', 'int4', 'e4m3'])
@pytest.mark.parametrize('case', ['k_not_8', 'n_not_16', 'x_unaligned',
                                  'odd_k', 'float32'])
def test_quant_matmul_cuda_core_path(card, codes, case):
    """Shapes past the skinny path that the tensor cores do not take run
    the CUDA-core tiled kernel, equal to the plain versions: K % 8 != 0,
    N % 16 != 0, an x that does not start 16-byte aligned, an odd K
    (int4 pads x with a zero column), float32 x (TF32 would round it)."""
    M, K, N = {'k_not_8': (100, 4100, 336), 'n_not_16': (100, 4096, 328),
               'odd_k': (33, 4095, 256)}.get(case, (100, 4096, 336))
    dtype = torch.float32 if case == 'float32' else torch.bfloat16
    rng = np.random.default_rng(M + K + N + len(codes) + len(case))
    wq, scale, kern, plain = _quantized(rng, K, N, card, codes)
    x = _randn(rng, (M, K), card, dtype)
    if case == 'x_unaligned':
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(M, K)
        assert x.data_ptr() % 16 and x.is_contiguous()
    got, paths = _path_launches(lambda: kern(x, wq, scale))
    assert paths == {'cuda_core': 1}
    want = plain(x, wq, scale)
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else TOL[dtype]
    amax = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * amax)


def test_quant_matmul_paths_refuse_what_they_do_not_take(card):
    """launch_path forces a path for timing; the C entries refuse a shape
    or dtype their kernel does not take instead of computing garbage."""
    rng = np.random.default_rng(3)
    wq, scale, _, _ = _quantized(rng, 4100, 336, card, 'int8')
    x = _randn(rng, (100, 4100), card, torch.bfloat16)
    with pytest.raises(RuntimeError, match='tensor_core'):
        k_qmm.launch_path('tensor_core', x, wq, scale, 8)
    wq, scale, _, _ = _quantized(rng, 4096, 336, card, 'int8')
    with pytest.raises(RuntimeError, match='tensor_core'):
        k_qmm.launch_path('tensor_core', _randn(rng, (100, 4096), card,
                                                 torch.float32), wq, scale, 8)
    with pytest.raises(RuntimeError, match='skinny'):
        k_qmm.launch_path('skinny', _randn(rng, (17, 4096), card,
                                            torch.bfloat16), wq, scale, 8)


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rowscale', [True, False],
                         ids=['row-scales', 'head-dim-scales'])
@pytest.mark.parametrize('Hq,Hkv,D', [(32, 32, 128), (32, 8, 128),
                                      (4, 2, 16), (8, 1, 64)] + E2_DECODE)
def test_paged_int8_kernel(card, dtype, rowscale, Hq, Hkv, D):
    """K8q against its plain version: int8 pages with per-row (NB, Hkv,
    BS) or per-(head, dim) (Hkv, D) scales, a count past the table, a
    count-0 row, a -1 table entry."""
    rng = np.random.default_rng(Hq * 100 + Hkv + D + int(rowscale))
    B, BS, MAXB = 4, 16, 20
    NB = B * MAXB + 1
    lens = np.asarray([MAXB * BS + 7, 0, 33, 1], np.int32)
    tbl = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    tbl[2, 5] = -1
    q = _randn(rng, (B, 1, Hq, D), card, dtype)
    kc, vc = (torch.from_numpy(rng.integers(-127, 128, (NB, Hkv, BS, D))
                               .astype(np.int8)).to(card) for _ in range(2))
    sshape = (NB, Hkv, BS) if rowscale else (Hkv, D)
    ks, vs = (torch.from_numpy(rng.uniform(0.002, 0.03, sshape)
                               .astype(np.float32)).to(card)
              for _ in range(2))
    args = (q, kc, vc, torch.from_numpy(tbl).to(card),
            torch.from_numpy(lens).to(card))
    before = dict(_build.LAUNCHES)
    got = k_paged.paged_decode_attention(*args, k_scale=ks, v_scale=vs)
    want = k_paged.paged_decode_attention_plain(*args, k_scale=ks,
                                                v_scale=vs)
    assert _build.LAUNCHES['paged_decode_attention_int8'] == before[
        'paged_decode_attention_int8'] + 1
    assert _build.LAUNCHES['paged_decode_attention'] == before[
        'paged_decode_attention']
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert not got[1].any(), 'a count-0 row must return zeros'


@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('B,S,Hq,Hkv,D', [(1, 2048, 32, 32, 128),
                                          (8, 2048, 32, 32, 128),
                                          (8, 2048, 32, 8, 128),
                                          (3, 37, 4, 2, 16),
                                          (2, 300, 8, 1, 64)] + [
    (2, 300, Hq, Hkv, D) for Hq, Hkv, D in E2_DECODE + DECODE_WIDE])
def test_headmajor_kernel(card, mode, B, S, Hq, Hkv, D):
    """K9 against its plain version over (B, Hkv, S, D) caches: counts
    past S (clipped), 0, and inside the cache."""
    rng = np.random.default_rng(B * 1000 + S + Hkv + D)
    dtype = torch.float32 if mode == 'float32' else torch.bfloat16
    q = _randn(rng, (B, 1, Hq, D), card, dtype)
    ks = vs = None
    if mode == 'int8':
        kc, vc = (torch.from_numpy(rng.integers(-127, 128, (B, Hkv, S, D))
                                   .astype(np.int8)).to(card)
                  for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, (Hkv, D))
                                   .astype(np.float32)).to(card)
                  for _ in range(2))
    else:
        kc, vc = (_randn(rng, (B, Hkv, S, D), card, dtype)
                  for _ in range(2))
    cl = rng.integers(1, S + 1, B)
    cl[0] = S + 5
    if B > 1:
        cl[1] = 0
    cl = torch.from_numpy(cl.astype(np.int32)).to(card)
    before = _build.LAUNCHES['decode_attention_headmajor']
    got = k_hm.decode_attention_headmajor(q, kc, vc, cl, None, ks, vs)
    want = k_hm.decode_attention_headmajor_plain(q, kc, vc, cl, None, ks, vs)
    assert _build.LAUNCHES['decode_attention_headmajor'] == before + 1
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if B > 1:
        assert not got[1].any(), 'a count-0 row must return zeros'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
@pytest.mark.parametrize('D', [64, 128])
def test_flash_segment_kernel(card, dtype, causal, D):
    """K5s against its plain version: a packed stream of 5 sequences in
    the model's (B, S, H, D) layout (so the kernel reads strided views),
    one query segment with no key, and Sq != Sk."""
    rng = np.random.default_rng(D + int(causal))
    lens = [70, 1, 130, 33, 66]
    T = sum(lens)
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    qseg = seg.copy()
    qseg[75:90] = 99                               # no key has id 99
    H, Hkv = 4, 2

    def bshd(s, h):
        return _randn(rng, (1, s, h, D), card, dtype).transpose(1, 2)

    q, k, v = bshd(T, H), bshd(T, Hkv), bshd(T, Hkv)
    qs = torch.from_numpy(qseg[None]).to(card)
    kseg = torch.from_numpy(seg[None]).to(card)
    before = dict(_build.LAUNCHES)
    got, lse = k_flash.flash_attention_fwd(q, k, v, causal, None, qs, kseg)
    want, want_lse = k_flash.flash_attention_fwd_plain(q, k, v, causal, None,
                                                       qs, kseg)
    assert _build.LAUNCHES['flash_attention_fwd_seg'] == before[
        'flash_attention_fwd_seg'] + 1
    assert _build.LAUNCHES['flash_attention_fwd'] == before[
        'flash_attention_fwd']
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert not got[:, :, 75:90].any(), 'an empty segment returns 0'
    # Sq != Sk: the last 100 queries against every key
    got, _ = k_flash.flash_attention_fwd(q[:, :, -100:], k, v, causal, None,
                                         qs[:, -100:], kseg)
    want, _ = k_flash.flash_attention_fwd_plain(q[:, :, -100:], k, v, causal,
                                                None, qs[:, -100:], kseg)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_int8_serving_and_fused_ops_run_their_kernels(card):
    """On the card: an int8 ServingEngine launches K8q once per layer and
    decode forward (K8 never); a fused_multi_transformer decode step K9
    once per layer; a block_multihead_attention varlen prefill of 128
    tokens or more K5s once, its decode K8q once."""
    from paddle_tpu_torch.incubate.nn import functional as TF
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cfg = llama_tiny(vocab_size=128, hidden_size=64, layers=2)
    model = LlamaForCausalLM(cfg, device=card, seed=0)
    eng = ServingEngine(model, max_slots=2, block_size=4, max_new_tokens=6,
                        decode_window=3, max_context_len=64,
                        kv_cache_dtype='int8')
    before = dict(_build.LAUNCHES)
    outs = eng.serve([np.arange(3, 12), np.arange(5, 25)])
    assert all(len(o) in (15, 26) for o in outs)
    n_dec = eng.stats()['decode_forwards']
    assert _build.LAUNCHES['paged_decode_attention_int8'] - before[
        'paged_decode_attention_int8'] == 2 * n_dec
    assert _build.LAUNCHES['paged_decode_attention'] == before[
        'paged_decode_attention']
    assert eng.allocator.in_use() == 0

    rng = np.random.default_rng(1)
    E, H, L, B = 64, 4, 2, 2
    w = dict(
        ln_scales=[torch.ones(E, device=card)] * L, ln_biases=[None] * L,
        qkv_weights=[_randn(rng, (3, H, E // H, E), card, torch.float32, 0.1)
                     for _ in range(L)],
        qkv_biases=[None] * L,
        linear_weights=[_randn(rng, (E, E), card, torch.float32, 0.1)] * L,
        linear_biases=[None] * L,
        ffn_ln_scales=[torch.ones(E, device=card)] * L,
        ffn_ln_biases=[None] * L,
        ffn1_weights=[_randn(rng, (E, 128), card, torch.float32, 0.1)] * L,
        ffn1_biases=[None] * L,
        ffn2_weights=[_randn(rng, (128, E), card, torch.float32, 0.1)] * L,
        ffn2_biases=[None] * L)
    caches = [torch.zeros(2, B, H, 16, E // H, device=card)
              for _ in range(L)]
    x = _randn(rng, (B, 5, E), card, torch.float32)
    with torch.no_grad():
        TF.fused_multi_transformer(x, **w, cache_kvs=caches,
                                   norm_type='rmsnorm')
    before = dict(_build.LAUNCHES)
    out, _ = TF.fused_multi_transformer_decode_step(
        x[:, :1], **w, cache_kvs=caches, time_step=5, norm_type='rmsnorm')
    assert torch.isfinite(out).all()
    assert _build.LAUNCHES['decode_attention_headmajor'] - before[
        'decode_attention_headmajor'] == L
    assert _build.LAUNCHES['rms_norm'] - before['rms_norm'] == 2 * L

    # head size 64: the flash kernels are built for 64 and 128
    Hkv, D, BS = 2, 64, 16
    lens = [100, 60]
    NB = 20
    kc = torch.zeros(NB, Hkv, BS, D, dtype=torch.int8, device=card)
    vc = torch.zeros_like(kc)
    ds = torch.full((Hkv, D), 0.05, device=card)
    tbl = torch.arange(1, 17, dtype=torch.int32, device=card).reshape(2, 8)
    qkv = _randn(rng, (sum(lens), (H + 2 * Hkv) * D), card, torch.float32)
    enc = torch.tensor(lens, dtype=torch.int32)
    zeros = torch.zeros(2, dtype=torch.int32)
    cu = torch.tensor([0, lens[0], sum(lens)], dtype=torch.int32)
    scales = dict(cache_k_dequant_scales=ds, cache_v_dequant_scales=ds)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        TF.block_multihead_attention(qkv, kc, vc, enc, zeros, enc,
                                     cu_seqlens_q=cu, block_tables=tbl,
                                     block_size=BS, num_heads=H, **scales)
    assert _build.LAUNCHES['flash_attention_fwd_seg'] - before[
        'flash_attention_fwd_seg'] == 1
    before = dict(_build.LAUNCHES)
    step = _randn(rng, (2, (H + 2 * Hkv) * D), card, torch.float32)
    out, *_ = TF.block_multihead_attention(
        step, kc, vc, zeros, enc, torch.ones(2, dtype=torch.int32),
        block_tables=tbl, block_size=BS, num_heads=H, **scales)
    assert torch.isfinite(out).all()
    assert _build.LAUNCHES['paged_decode_attention_int8'] - before[
        'paged_decode_attention_int8'] == 1


# (B, H, Hkv, Sq, Sk, D, window): a window of 1 (each query sees itself
# alone), windows inside and past one tile, Sq != Sk both ways, GQA
WINDOW_CASES = [
    (1, 4, 2, 200, 200, 128, 1), (2, 4, 1, 150, 150, 64, 37),
    (1, 4, 4, 96, 160, 128, 70), (1, 2, 2, 160, 96, 64, 20),
    (1, 32, 8, 256, 256, 128, 100)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', WINDOW_CASES,
                         ids=lambda c: 'B{}H{}/{}Sq{}Sk{}D{}w{}'.format(*c))
def test_flash_window_kernels(card, dtype, case):
    """K5w and K6w against their plain versions, each side's backward
    from its own forward, in the model's (B, S, H, D) layout."""
    B, H, Hkv, Sq, Sk, D, w = case
    rng = np.random.default_rng(sum(case))
    q = _randn(rng, (B, Sq, H, D), card, dtype).transpose(1, 2)
    k = _randn(rng, (B, Sk, Hkv, D), card, dtype).transpose(1, 2)
    v = _randn(rng, (B, Sk, Hkv, D), card, dtype).transpose(1, 2)
    do = _randn(rng, (B, Sq, H, D), card, dtype).transpose(1, 2)
    before = dict(_build.LAUNCHES)
    out, lse = k_flash.flash_attention_fwd(q, k, v, True, None, window=w)
    grads = k_flash.flash_attention_bwd(q, k, v, out, lse, do, True, None,
                                        window=w)
    after = dict(_build.LAUNCHES)
    assert after['flash_attention_fwd_window'] == \
        before['flash_attention_fwd_window'] + 1
    assert after['flash_attention_bwd_window'] == \
        before['flash_attention_bwd_window'] + 2
    assert (after['flash_attention_fwd'], after['flash_attention_bwd']) == \
        (before['flash_attention_fwd'], before['flash_attention_bwd'])
    want_out, want_lse = k_flash.flash_attention_fwd_plain(
        q, k, v, True, None, window=w)
    want = k_flash.flash_attention_bwd_plain(q, k, v, want_out, want_lse, do,
                                             True, None, window=w)
    # as test_flash_attention_kernels: float32 summation order only; bf16
    # one rounding step of the outputs and of the gradients' sums
    rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                  else (2 ** -7, 2e-2))
    seen = want_lse > -1e29
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=atol)
    for name, got, ref in zip(('dq', 'dk', 'dv'), grads, want):
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=atol, msg=name)
    if w == 1 and Sq == Sk:
        # a window of 1: each query returns its own value row
        group = H // Hkv
        own = v.repeat_interleave(group, dim=1)
        torch.testing.assert_close(out.float(), own.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('causal,window', [(True, None), (False, None),
                                           (True, 30)],
                         ids=['causal', 'full', 'causal-window'])
@pytest.mark.parametrize('D', [64, 128])
def test_flash_segment_backward_kernel(card, dtype, causal, window, D):
    """K6s against its plain version over a packed stream of 5 sequences
    (the kernel reads strided (B, S, H, D) views), with a query segment
    no key has: its dq is 0 and its dout moves no dk or dv; segments
    with a window count under the segment key."""
    rng = np.random.default_rng(D + int(causal) + (window or 0))
    lens = [70, 1, 130, 33, 66]
    T = sum(lens)
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    qseg = seg.copy()
    qseg[75:90] = 99
    H, Hkv = 4, 2

    def bshd(h):
        return _randn(rng, (1, T, h, D), card, dtype).transpose(1, 2)

    q, k, v, do = bshd(H), bshd(Hkv), bshd(Hkv), bshd(H)
    qs = torch.from_numpy(qseg[None]).to(card)
    ks = torch.from_numpy(seg[None]).to(card)
    out, lse = k_flash.flash_attention_fwd_plain(q, k, v, causal, None, qs,
                                                 ks, window)
    before = dict(_build.LAUNCHES)
    got = k_flash.flash_attention_bwd(q, k, v, out, lse, do, causal, None,
                                      qs, ks, window)
    assert _build.LAUNCHES['flash_attention_bwd_seg'] == \
        before['flash_attention_bwd_seg'] + 2
    assert _build.LAUNCHES['flash_attention_bwd_window'] == \
        before['flash_attention_bwd_window']
    want = k_flash.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                             None, qs, ks, window)
    rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                  else (2 ** -7, 2e-2))
    for name, g, r in zip(('dq', 'dk', 'dv'), got, want):
        torch.testing.assert_close(g.float(), r.float(), rtol=rtol,
                                   atol=atol, msg=name)
    assert not got[0][:, :, 75:90].any(), 'an empty segment has dq = 0'
    do0 = do.clone()
    do0[:, :, 75:90] = 0
    again = k_flash.flash_attention_bwd(q, k, v, out, lse, do0, causal, None,
                                        qs, ks, window)
    for g, a in zip(got[1:], again[1:]):
        assert torch.equal(g, a), 'an empty segment moves no dk or dv'


def test_window_and_segment_ops_differentiate_on_the_card(card):
    """ops.flash_attention with a window, and flash_attn_unpadded, carry
    gradients through the kernels: against the same graphs through the
    plain versions, in float32."""
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.default_rng(11)
    B, S, H, Hkv, D = 2, 192, 4, 2, 64
    base = [_randn(rng, (B, S, h, D), card, torch.float32)
            for h in (H, Hkv, Hkv)]
    do = _randn(rng, (B, S, H, D), card, torch.float32)

    def grads(fn, ts):
        ts = [t.detach().clone().requires_grad_() for t in ts]
        out = fn(*ts)
        (out * do.reshape(-1)[:out.numel()].reshape(out.shape)).sum() \
            .backward()
        return [out.detach()] + [t.grad for t in ts]

    def plain_window(q, k, v):
        return k_flash.FlashAttentionFn.apply(
            *(t.cpu().transpose(1, 2) for t in (q, k, v)), True,
            1 / np.sqrt(D), None, None, 40).transpose(1, 2).to(card)

    before = dict(_build.LAUNCHES)
    got = grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                                    window_size=40), base)
    assert _build.LAUNCHES['flash_attention_fwd_window'] == \
        before['flash_attention_fwd_window'] + 1
    assert _build.LAUNCHES['flash_attention_bwd_window'] == \
        before['flash_attention_bwd_window'] + 2
    want = grads(plain_window, base)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)

    cu = torch.tensor([0, 50, 51, 192], dtype=torch.int32, device=card)
    flat = [t[0] for t in base]
    before = dict(_build.LAUNCHES)
    got = grads(lambda q, k, v: F.flash_attn_unpadded(
        q, k, v, cu, cu, 141, 141, causal=True)[0], flat)
    assert _build.LAUNCHES['flash_attention_fwd_seg'] == \
        before['flash_attention_fwd_seg'] + 1
    assert _build.LAUNCHES['flash_attention_bwd_seg'] == \
        before['flash_attention_bwd_seg'] + 2
    want = grads(lambda q, k, v: F.flash_attn_unpadded(
        q.cpu(), k.cpu(), v.cpu(), cu.cpu(), cu.cpu(), 141, 141,
        causal=True)[0].to(card), flat)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


# (dtype, head size, route) of the flash kernels' one rule: bf16 up to
# 128 on the tensor cores (D = 40 and 80 / 96 on padded tiles), float32
# and bf16 past 128 on the CUDA cores
FLASH_ROUTES = [(torch.bfloat16, D, 'tensor_core') for D in (40, 64, 80,
                                                             96, 128)] + [
    (torch.bfloat16, 256, 'cuda_core'), (torch.float32, 64, 'cuda_core'),
    (torch.float32, 128, 'cuda_core')]


@pytest.mark.parametrize('dtype,D,route', FLASH_ROUTES,
                         ids=lambda c: str(c).replace('torch.', ''))
def test_flash_route_counts(card, dtype, D, route):
    """Each flash call launches on the route `path()` names, in every
    mode: FLASH_PATH_LAUNCHES moves by 1 per forward and 2 per backward
    on that route only, and the per-kernel LAUNCHES as before."""
    assert k_flash.path(dtype, D) == route
    rng = np.random.default_rng(D)
    q = _randn(rng, (1, 150, 4, D), card, dtype).transpose(1, 2)
    k = _randn(rng, (1, 150, 2, D), card, dtype).transpose(1, 2)
    v = _randn(rng, (1, 150, 2, D), card, dtype).transpose(1, 2)
    seg = torch.zeros(1, 150, dtype=torch.int32, device=card)
    seg[:, 60:] = 1
    for mode, kw in (('', {}), ('_window', {'window': 33}),
                     ('_seg', {'qseg': seg, 'kseg': seg})):
        paths, launches = dict(k_flash.FLASH_PATH_LAUNCHES), \
            dict(_build.LAUNCHES)
        out, lse = k_flash.flash_attention_fwd(q, k, v, True, None, **kw)
        k_flash.flash_attention_bwd(q, k, v, out, lse, q, True, None, **kw)
        moved = {p: n - paths[p]
                 for p, n in k_flash.FLASH_PATH_LAUNCHES.items()}
        assert moved == {p: 3 if p == route else 0 for p in moved}, mode
        assert _build.LAUNCHES['flash_attention_fwd' + mode] == \
            launches['flash_attention_fwd' + mode] + 1
        assert _build.LAUNCHES['flash_attention_bwd' + mode] == \
            launches['flash_attention_bwd' + mode] + 2


@pytest.mark.parametrize('mode', ['causal', 'window', 'seg'])
@pytest.mark.parametrize('H,Hkv,slices', [(8, 8, None), (8, 2, None),
                                          (8, 2, 1), (8, 2, 2)])
def test_flash_tensor_core_is_deterministic(card, mode, H, Hkv, slices):
    """The tensor-core kernels give the same bits on every run: out and
    lse, and dq, dk, dv whether the dk/dv pass sums a GQA group in one
    block or adds its slices' partial sums (in a fixed order); and the
    slicings agree with each other and with the plain version."""
    rng = np.random.default_rng(H + Hkv)
    S, D = 384, 128
    q = _randn(rng, (2, S, H, D), card, torch.bfloat16).transpose(1, 2)
    k = _randn(rng, (2, S, Hkv, D), card, torch.bfloat16).transpose(1, 2)
    v = _randn(rng, (2, S, Hkv, D), card, torch.bfloat16).transpose(1, 2)
    do = _randn(rng, (2, S, H, D), card, torch.bfloat16).transpose(1, 2)
    kw = {}
    if mode == 'window':
        kw = {'window': 100}
    elif mode == 'seg':
        seg = torch.from_numpy(np.repeat(np.arange(3), [100, 200, 84])
                               .astype(np.int32)[None]).repeat(2, 1)
        kw = {'qseg': seg.to(card), 'kseg': seg.to(card)}

    def run():
        out, lse = k_flash.flash_attention_fwd(q, k, v, True, None, **kw)
        return (out, lse) + k_flash.flash_attention_bwd(
            q, k, v, out, lse, do, True, None, **kw, slices=slices)

    first, again = run(), run()
    for name, a, b in zip(('out', 'lse', 'dq', 'dk', 'dv'), first, again):
        assert torch.equal(a, b), name
    want = k_flash.flash_attention_bwd_plain(q, k, v, first[0], first[1],
                                             do, True, None, **kw)
    for name, g, r in zip(('dq', 'dk', 'dv'), first[2:], want):
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -7,
                                   atol=2e-2, msg=name)


def test_flash_tensor_core_entries_refuse_what_they_do_not_take(card):
    """The tensor-core C entries refuse float32, head sizes past 128 or
    off the multiples of 8, and a dk/dv slicing that does not divide the
    GQA group or lacks its scratch: the route is the wrapper's rule,
    never a fallback."""
    import ctypes
    lib = _build.load()
    x = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16, device=card)
    lse = torch.zeros(1, 4, 64, device=card)
    strides = (ctypes.c_longlong * 24)(*([4 * 64 * 128, 64 * 128, 128] * 8))
    stream = _build.stream_ptr(x)

    def fwd(d, dtype):
        return lib.pt_flash_attention_tc_fwd(
            x.device.index, x.data_ptr(), x.data_ptr(), x.data_ptr(),
            x.data_ptr(), lse.data_ptr(), 0, 0, strides, 1, 4, 4, 64, 64, d,
            0.1, 1, 0, dtype, stream)

    grads = [torch.empty_like(x) for _ in range(3)]
    delta = torch.empty_like(lse)

    def bwd(kv_heads, nslice, scratch):
        p = x.data_ptr()
        return lib.pt_flash_attention_tc_bwd(
            x.device.index, p, p, p, p, p, lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), scratch, scratch, 0, 0, strides,
            1, 4, kv_heads, 64, 64, 128, 0.1, 1, 0, nslice, 1, stream)

    assert fwd(128, 1) == 0
    assert fwd(128, 0) != 0          # float32
    assert fwd(136, 1) != 0          # past 128
    assert fwd(100, 1) != 0          # not a multiple of 8
    assert bwd(1, 3, lse.data_ptr()) != 0   # 3 does not divide 4
    assert bwd(1, 2, 0) != 0                # sliced without scratch
    assert bwd(4, 1, 0) == 0
    torch.cuda.synchronize()
    assert not any(g.any() for g in grads)   # zero dout: zero gradients


def _decode_inputs(rng, card, mode, B, S, Hq, Hkv, D, headmajor=False):
    """q and caches for K7 ((B, S, Hkv, D)) or K9 ((B, Hkv, S, D)) in a
    mode: bf16, float32, or int8 codes with (Hkv, D) scales (bf16 q)."""
    dtype = torch.float32 if mode == 'float32' else torch.bfloat16
    shape = (B, Hkv, S, D) if headmajor else (B, S, Hkv, D)
    q = _randn(rng, (B, 1, Hq, D), card, dtype)
    if mode != 'int8':
        return (q,) + tuple(_randn(rng, shape, card, dtype)
                            for _ in range(2)) + (None, None)
    return (q,) + tuple(
        torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        .to(card) for _ in range(2)) + tuple(
        torch.from_numpy(rng.uniform(0.005, 0.02, (Hkv, D))
                         .astype(np.float32)).to(card) for _ in range(2))


def _decode_tol(q):
    return (2e-4, 2e-4) if q.dtype == torch.float32 else (1e-2, 1e-2)


def _assert_within(got, want):
    """got against want everywhere within rtol * |want| + atol * max
    |want|, (rtol, atol) = (1e-4, 1e-5) for float32 and (2^-7, 2^-9),
    one bf16 rounding step, for bf16: a tolerance that scales with the
    outputs (chip_smoke.py's TENSOR_TOL)."""
    rtol, atol = ((1e-4, 1e-5) if want.dtype == torch.float32
                  else (2.0 ** -7, 2.0 ** -9))
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = rtol * w.abs() + atol * w.abs().max()
    assert bool((err <= bound).all()), (err.max().item(),
                                        w.abs().max().item())


def _decode_call(headmajor, q, kc, vc, vl, ks, vs, st=None, plain=False):
    """K7 (window [st, vl)) or K9 (the first vl positions), kernel or
    plain."""
    if headmajor:
        fn = (k_hm.decode_attention_headmajor_plain if plain
              else k_hm.decode_attention_headmajor)
        return fn(q, kc, vc, vl, None, ks, vs)
    fn = (k_decode.decode_attention_plain if plain
          else k_decode.decode_attention)
    return fn(q, kc, vc, vl, None, ks, vs, st)


@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('headmajor', [False, True], ids=['K7', 'K9'])
@pytest.mark.parametrize('Hq,Hkv', [(8, 8), (28, 4)])
def test_decode_attention_long_cache(card, mode, headmajor, Hq, Hkv):
    """b1 over a 32768-position cache, MHA and Qwen2's group 7: each split
    walks many ring stages. The outputs are small (a mean over ~32768
    positions), so the tolerance scales with them."""
    rng = np.random.default_rng(Hq + Hkv)
    S, D = 32768, 128
    q, kc, vc, ks, vs = _decode_inputs(rng, card, mode, 1, S, Hq, Hkv, D,
                                       headmajor)
    code = _build.dtype_code(q, 'decode_attention')
    pl = k_decode.plan(card.index or 0, code, ks is not None, Hq, Hkv, D)
    nsplit, chunk = k_decode.splits(1, Hkv * pl.nchunk, S, pl.tile,
                                    pl.blocks_per_sm,
                                    _build.sm_count(card.index or 0))
    assert chunk >= 4 * pl.tile, (nsplit, chunk)
    vl = torch.tensor([S - 7], dtype=torch.int32, device=card)
    st = None if headmajor else torch.tensor([3], dtype=torch.int32,
                                             device=card)
    got = _decode_call(headmajor, q, kc, vc, vl, ks, vs, st)
    want = _decode_call(headmajor, q, kc, vc, vl, ks, vs, st, plain=True)
    _assert_within(got, want)


@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('headmajor', [False, True], ids=['K7', 'K9'])
def test_decode_attention_windows_across_tiles_and_splits(card, mode,
                                                          headmajor):
    """Windows (K7) and counts (K9) that start and end mid-tile and
    across a split boundary of this shape's own split."""
    rng = np.random.default_rng(7)
    B, S, Hq, Hkv, D = 6, 2048, 8, 2, 128
    q, kc, vc, ks, vs = _decode_inputs(rng, card, mode, B, S, Hq, Hkv, D,
                                       headmajor)
    code = _build.dtype_code(q, 'decode_attention')
    pl = k_decode.plan(card.index or 0, code, ks is not None, Hq, Hkv, D)
    nsplit, chunk = k_decode.splits(B, Hkv * pl.nchunk, S, pl.tile,
                                    pl.blocks_per_sm,
                                    _build.sm_count(card.index or 0))
    assert nsplit > 2, (nsplit, chunk)
    t, h = pl.tile, pl.tile // 2
    ends = [2 * chunk + h + 3, chunk + 1, chunk - 1, h + 1, S - h, 2 * chunk]
    starts = [chunk - 5, chunk - 1, h - 3, h, chunk + t + 1, chunk]
    vl = torch.tensor(ends, dtype=torch.int32, device=card)
    st = torch.tensor(starts, dtype=torch.int32, device=card)
    got = _decode_call(headmajor, q, kc, vc, vl, ks, vs,
                       None if headmajor else st)
    want = _decode_call(headmajor, q, kc, vc, vl, ks, vs,
                        None if headmajor else st, plain=True)
    rtol, atol = _decode_tol(q)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('headmajor', [False, True], ids=['K7', 'K9'])
def test_decode_attention_repeats_bitwise_across_geometries(card, mode,
                                                            headmajor):
    """Launches of one stream back to back: a split geometry, two others
    (another split, another group), the first again. The counters reset
    themselves, every output holds against the plain version, and the
    first geometry's two outputs are the same bits (the splits combine
    in split order)."""
    rng = np.random.default_rng(11)
    shapes = [(1, 2048, 32, 32, 128), (2, 700, 28, 4, 128),
              (3, 300, 8, 1, 64)]
    cases = []
    for B, S, Hq, Hkv, D in shapes:
        q, kc, vc, ks, vs = _decode_inputs(rng, card, mode, B, S, Hq, Hkv,
                                           D, headmajor)
        vl = torch.from_numpy(rng.integers(S // 2, S + 1, B)
                              .astype(np.int32)).to(card)
        cases.append((q, kc, vc, vl, ks, vs))
    outs = [_decode_call(headmajor, *c) for c in cases + cases[:1]]
    assert torch.equal(outs[0], outs[-1])
    rtol, atol = _decode_tol(cases[0][0])
    for c, got in zip(cases, outs):
        want = _decode_call(headmajor, *c, plain=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
    q = cases[0][0]
    key = (q.device.index, _build.stream_ptr(q))
    assert not k_decode._COUNTERS[key].any()


@pytest.mark.parametrize('mode', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('headmajor', [False, True], ids=['K7', 'K9'])
def test_decode_attention_in_a_cuda_graph(card, mode, headmajor):
    """One launch captured in a CUDA graph and replayed twice (new
    query and lengths copied in between) equals the eager call."""
    rng = np.random.default_rng(13)
    B, S, Hq, Hkv, D = 2, 2048, 32, 8, 128
    q, kc, vc, ks, vs = _decode_inputs(rng, card, mode, B, S, Hq, Hkv, D,
                                       headmajor)
    vl = torch.tensor([S - 3, 900], dtype=torch.int32, device=card)
    _decode_call(headmajor, q, kc, vc, vl, ks, vs)        # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _decode_call(headmajor, q, kc, vc, vl, ks, vs)
    for n in (1500, 37):
        q.copy_(_randn(rng, q.shape, card, q.dtype))
        vl.copy_(torch.tensor([n, S], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = _decode_call(headmajor, q, kc, vc, vl, ks, vs)
        assert torch.equal(out, want)


@pytest.mark.parametrize('headmajor', [False, True], ids=['K7', 'K9'])
def test_decode_attention_graph_replays_after_its_counters_grow(card,
                                                                headmajor):
    """A graph captured on a stream, then that stream's counter buffer
    outgrown (as a larger geometry launched on it would): the replay
    still finds its counters (the old buffer is kept) and equals the
    eager call, and so does an eager launch on the stream's new
    buffer."""
    rng = np.random.default_rng(19)
    B, S, Hq, Hkv, D = 2, 2048, 32, 8, 128
    q, kc, vc, ks, vs = _decode_inputs(rng, card, 'bfloat16', B, S, Hq, Hkv,
                                       D, headmajor)
    vl = torch.tensor([S - 5, 1100], dtype=torch.int32, device=card)
    want = _decode_call(headmajor, q, kc, vc, vl, ks, vs)
    side = torch.cuda.Stream(card)
    key = (q.device.index, side.cuda_stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _decode_call(headmajor, q, kc, vc, vl, ks, vs)
    old = k_decode._COUNTERS[key]
    with torch.cuda.stream(side):
        k_decode._counters(q.device, side.cuda_stream, old.numel() + 1)
        grown = k_decode._COUNTERS[key]
        filler = [torch.full((old.numel(),), 3, dtype=torch.int32,
                             device=card) for _ in range(8)]
        for _ in range(2):
            graph.replay()
        eager = _decode_call(headmajor, q, kc, vc, vl, ks, vs)
    torch.cuda.synchronize()
    assert grown is not old and grown.numel() > old.numel()
    assert any(b is old for b in k_decode._OUTGROWN)
    assert torch.equal(out, want) and torch.equal(eager, want)
    assert not old.any() and not grown.any()
    del filler


@pytest.mark.parametrize('mode', ['bfloat16', 'int8'])
def test_decode_attention_on_two_streams(card, mode):
    """Split launches on two streams at once, many times over: each
    stream has its own counters, so every output equals the eager one
    of the default stream."""
    rng = np.random.default_rng(23)
    cases = [_decode_inputs(rng, card, mode, 1, 4096, 32, 8, 128)
             for _ in range(2)]
    vls = [torch.tensor([n], dtype=torch.int32, device=card)
           for n in (4000, 2500)]
    want = [_decode_call(False, q, kc, vc, vl, ks, vs)
            for (q, kc, vc, ks, vs), vl in zip(cases, vls)]
    streams = [torch.cuda.Stream(card) for _ in cases]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, ((q, kc, vc, ks, vs), vl, st) in enumerate(
                zip(cases, vls, streams)):
            with torch.cuda.stream(st):
                outs[i].append(_decode_call(False, q, kc, vc, vl, ks, vs))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i])


@pytest.mark.parametrize('headmajor', [False, True], ids=['K7', 'K9'])
def test_decode_attention_is_one_kernel(card, headmajor):
    """A split call launches one CUDA kernel (the last split combines):
    counted by the profiler (a trace that comes back empty, as the
    profiler's now and then does, is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(17)
    q, kc, vc, ks, vs = _decode_inputs(rng, card, 'bfloat16', 1, 2048, 32,
                                       32, 128, headmajor)
    vl = torch.tensor([2000], dtype=torch.int32, device=card)
    _decode_call(headmajor, q, kc, vc, vl, ks, vs)
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _decode_call(headmajor, q, kc, vc, vl, ks, vs)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')
                   for _ in range(e.count)]
        if kernels:
            break
    assert len(kernels) == 1 and 'decode_kernel' in kernels[0], kernels


# K8 / K8q modes: (q dtype, pool) with pool 'float' (q's dtype), 'row'
# (int8, (NB, Hkv, BS) scales) or 'hd' (int8, (Hkv, D) scales)
PAGED_MODES = [(torch.bfloat16, 'float'), (torch.float32, 'float'),
               (torch.bfloat16, 'row'), (torch.float32, 'row'),
               (torch.bfloat16, 'hd'), (torch.float32, 'hd')]
# (Hq, Hkv, D): groups 1, 3, 7, 8, 16 at head sizes 40 (int8 rows not
# 16-byte aligned), 64, 80, 96, 128, 256 (chunks of 4 heads)
PAGED_SHAPES = [(2, 2, 64), (6, 2, 80), (28, 4, 128), (16, 2, 96),
                (16, 1, 256), (8, 1, 128), (3, 3, 256), (7, 1, 64),
                (3, 1, 40)]


def _paged_inputs(rng, card, dtype, pool, B, Hq, Hkv, D, BS, width):
    """q, pools, table, counts and scales over a table `width` positions
    wide: pages shuffled and shared between rows, a -1 entry and one past
    the pool inside row 2's count, row 0's count past the table, row 1's
    count 0 (the rows there are)."""
    maxb = -(-width // BS)
    NB = max(2, B * maxb // 2 + 3)
    tbl = rng.integers(0, NB, (B, maxb)).astype(np.int32)
    lens = rng.integers(1, maxb * BS + 1, B).astype(np.int32)
    lens[0] = maxb * BS + 9
    if B > 1:
        tbl[1] = tbl[0][::-1]                # pages shared between rows
        lens[1] = 0
    if B > 2:
        tbl[2, maxb // 3] = -1
        tbl[2, maxb // 2] = NB + 5           # clamped to the last page
    q = _randn(rng, (B, 1, Hq, D), card, dtype)
    ks = vs = None
    if pool == 'float':
        kc, vc = (_randn(rng, (NB, Hkv, BS, D), card, dtype)
                  for _ in range(2))
    else:
        kc, vc = (torch.from_numpy(rng.integers(-127, 128, (NB, Hkv, BS, D))
                                   .astype(np.int8)).to(card)
                  for _ in range(2))
        sshape = (NB, Hkv, BS) if pool == 'row' else (Hkv, D)
        ks, vs = (torch.from_numpy(rng.uniform(0.002, 0.03, sshape)
                                   .astype(np.float32)).to(card)
                  for _ in range(2))
    return (q, kc, vc, torch.from_numpy(tbl).to(card),
            torch.from_numpy(lens).to(card), ks, vs)


def _paged_call(q, kc, vc, tbl, lens, ks, vs, plain=False):
    fn = (k_paged.paged_decode_attention_plain if plain
          else k_paged.paged_decode_attention)
    return fn(q, kc, vc, tbl, lens, None, ks, vs)


@pytest.mark.parametrize('dtype,pool', PAGED_MODES,
                         ids=lambda m: str(m).replace('torch.', ''))
@pytest.mark.parametrize('BS', [1, 16, 64])
@pytest.mark.parametrize('Hq,Hkv,D', PAGED_SHAPES)
def test_paged_split_kernel(card, dtype, pool, BS, Hq, Hkv, D):
    """K8 / K8q on the decode template against the plain version: tiles
    that cross pages (BS 1 and 16) or lie inside one (64), splits over a
    2000-position table, every scale mode, one launch counted under its
    key."""
    rng = np.random.default_rng(Hq * 1000 + Hkv * 100 + D + BS)
    args = _paged_inputs(rng, card, dtype, pool, 3, Hq, Hkv, D, BS, 2000)
    key = ('paged_decode_attention' if pool == 'float'
           else 'paged_decode_attention_int8')
    before = dict(_build.LAUNCHES)
    got = _paged_call(*args)
    assert _build.LAUNCHES[key] == before[key] + 1
    assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
    want = _paged_call(*args, plain=True)
    rtol, atol = _decode_tol(args[0])
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert not got[1].any(), 'a count-0 row must return zeros'


@pytest.mark.parametrize('dtype,pool', PAGED_MODES,
                         ids=lambda m: str(m).replace('torch.', ''))
def test_paged_kernel_serving_shapes(card, dtype, pool):
    """The serving burst's shapes (Llama-7B's 32 heads at BS = 16 over a
    2048-position table, block_multihead_attention's BS = 64) with
    counts that end mid-tile and mid-page, against the plain version,
    with the output's own scale (chip_smoke.py's TENSOR_TOL)."""
    rng = np.random.default_rng(5)
    for BS in (16, 64):
        q, kc, vc, tbl, lens, ks, vs = _paged_inputs(
            rng, card, dtype, pool, 4, 32, 32, 128, BS, 2048)
        lens.copy_(torch.tensor([2048 + 3, 0, 517, 33], dtype=torch.int32))
        got = _paged_call(q, kc, vc, tbl, lens, ks, vs)
        want = _paged_call(q, kc, vc, tbl, lens, ks, vs, plain=True)
        _assert_within(got, want)


@pytest.mark.parametrize('dtype,pool', PAGED_MODES,
                         ids=lambda m: str(m).replace('torch.', ''))
def test_paged_kernel_is_one_kernel_and_repeats_bitwise(card, dtype, pool):
    """A split call launches one CUDA kernel (the last split combines),
    counted in a CUDA graph of the call; repeated calls, with another
    geometry launched in between on the same stream, are the same bits;
    the stream's counters are left at zero."""
    rng = np.random.default_rng(29)
    args = _paged_inputs(rng, card, dtype, pool, 2, 32, 8, 128, 16, 2048)
    other = _paged_inputs(rng, card, dtype, pool, 3, 28, 4, 128, 64, 700)
    first = _paged_call(*args)
    _paged_call(*other)
    assert torch.equal(first, _paged_call(*args))
    torch.cuda.synchronize()
    key = (args[0].device.index, _build.stream_ptr(args[0]))
    assert not k_decode._COUNTERS[key].any()
    assert _build.kernels_per_call(lambda: _paged_call(*args), card) == 1


def test_kernels_per_call_counts_what_a_call_enqueues(card):
    """The graph count behind the one-kernel checks: a K7 call is one
    kernel, two calls are two, an elementwise op is one."""
    rng = np.random.default_rng(43)
    q, kc, vc, ks, vs = _decode_inputs(rng, card, 'bfloat16', 1, 2048, 32,
                                       8, 128)
    vl = torch.tensor([2000], dtype=torch.int32, device=card)

    def two():
        _decode_call(False, q, kc, vc, vl, ks, vs)
        _decode_call(False, q, kc, vc, vl, ks, vs)
    assert _build.kernels_per_call(
        lambda: _decode_call(False, q, kc, vc, vl, ks, vs), card) == 1
    assert _build.kernels_per_call(two, card) == 2
    assert _build.kernels_per_call(lambda: q.mul_(1.0), card) == 1


@pytest.mark.parametrize('dtype,pool', PAGED_MODES[:3],
                         ids=lambda m: str(m).replace('torch.', ''))
def test_paged_kernel_in_a_cuda_graph(card, dtype, pool):
    """One launch captured in a CUDA graph and replayed (new query, new
    counts, a new table entry copied in between) equals the eager call:
    the split comes from the table width, not the counts."""
    rng = np.random.default_rng(31)
    q, kc, vc, tbl, lens, ks, vs = _paged_inputs(rng, card, dtype, pool, 2,
                                                 32, 8, 128, 16, 2048)
    _paged_call(q, kc, vc, tbl, lens, ks, vs)          # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _paged_call(q, kc, vc, tbl, lens, ks, vs)
    for n, page in ((1500, 3), (37, 0)):
        q.copy_(_randn(rng, q.shape, card, q.dtype))
        lens.copy_(torch.tensor([n, 2048], dtype=torch.int32))
        tbl[1, 5] = page
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, _paged_call(q, kc, vc, tbl, lens, ks, vs))


def test_paged_graph_replays_after_its_counters_grow(card):
    """A K8 graph captured on a stream, then that stream's counter buffer
    outgrown: the replay still finds its counters (the old buffer is
    kept) and equals the eager call, and so does an eager launch on the
    new buffer."""
    rng = np.random.default_rng(37)
    args = _paged_inputs(rng, card, torch.bfloat16, 'float', 2, 32, 8, 128,
                         16, 2048)
    want = _paged_call(*args)
    side = torch.cuda.Stream(card)
    key = (card.index or 0, side.cuda_stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _paged_call(*args)
    old = k_decode._COUNTERS[key]
    with torch.cuda.stream(side):
        k_decode._counters(args[0].device, side.cuda_stream, old.numel() + 1)
        grown = k_decode._COUNTERS[key]
        filler = [torch.full((old.numel(),), 3, dtype=torch.int32,
                             device=card) for _ in range(8)]
        for _ in range(2):
            graph.replay()
        eager = _paged_call(*args)
    torch.cuda.synchronize()
    assert grown is not old and any(b is old for b in k_decode._OUTGROWN)
    assert torch.equal(out, want) and torch.equal(eager, want)
    assert not old.any() and not grown.any()
    del filler


@pytest.mark.parametrize('dtype,pool', PAGED_MODES[::2],
                         ids=lambda m: str(m).replace('torch.', ''))
def test_paged_kernel_past_the_staged_table(card, dtype, pool):
    """A table 140000 positions wide at one position a page: each split
    spans more pages than a block stages in shared memory, so its copies
    read their page ids from the table."""
    rng = np.random.default_rng(47)
    q, kc, vc, tbl, lens, ks, vs = _paged_inputs(rng, card, dtype, pool, 1,
                                                 2, 1, 64, 1, 140000)
    pl = k_paged.plan(card.index or 0, _build.dtype_code(q, 'paged'),
                      {'float': k_paged.NO_SCALE, 'row': k_paged.ROW_SCALE,
                       'hd': k_paged.HEAD_DIM_SCALE}[pool], 2, 1, 64)
    nsplit, chunk = k_paged.split_plan(1, 1, 140000, 1, pl,
                                       _build.sm_count(card.index or 0))
    assert chunk > k_paged.TABLE_PAGES, (nsplit, chunk)
    lens.fill_(139990)
    got = _paged_call(q, kc, vc, tbl, lens, ks, vs)
    want = _paged_call(q, kc, vc, tbl, lens, ks, vs, plain=True)
    _assert_within(got, want)


def test_paged_plan_does_not_spill(card):
    """Every paged instantiation the shapes above reach: no spilled
    bytes, and at least one block an SM."""
    for dtype, pool in PAGED_MODES:
        mode = {'float': k_paged.NO_SCALE, 'row': k_paged.ROW_SCALE,
                'hd': k_paged.HEAD_DIM_SCALE}[pool]
        code = _build.dtype_code(torch.empty(0, dtype=dtype), 'paged')
        for Hq, Hkv, D in PAGED_SHAPES + [(32, 32, 128), (32, 8, 128),
                                          (4, 2, 16), (2, 1, 32)]:
            pl = k_paged.plan(card.index or 0, code, mode, Hq, Hkv, D)
            assert pl.local_bytes == 0 and pl.blocks_per_sm >= 1, (
                dtype, pool, Hq, Hkv, D, pl)


@pytest.mark.parametrize('wdtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('R', [1, 7, 2048])
@pytest.mark.parametrize('N', [4096, 3584, 4104, 100])
def test_rms_norm_bf16_rows(card, wdtype, R, N):
    """K1's bf16 forward: the row kernel at 2048 rows (N a multiple of 8,
    a warp a row in registers; 4104 leaves lanes idle), a block a row at
    1 and 7 rows and on the scalar path (N = 100), with and without r,
    against the plain version: one bf16 rounding step of y, r within
    1e-5."""
    rng = np.random.default_rng(R * 7 + N)
    x = _randn(rng, (R, N), card, torch.bfloat16, 2.0)
    w = (1 + 0.1 * _randn(rng, (N,), card, torch.float32)).to(wdtype)
    want, want_r = k_rms.rms_norm_plain(x, w, 1e-6, return_r=True)
    before = _build.LAUNCHES['rms_norm']
    got = k_rms.rms_norm(x, w, 1e-6)
    got_r, r = k_rms.rms_norm(x, w, 1e-6, return_r=True)
    assert _build.LAUNCHES['rms_norm'] == before + 2
    assert torch.equal(got, got_r)
    for out in (got, got_r):
        torch.testing.assert_close(out.float(), want.float(),
                                   rtol=2 ** -7, atol=2 ** -7)
    torch.testing.assert_close(r, want_r, rtol=1e-5, atol=0)


def test_rms_norm_bf16_unaligned_rows_take_the_scalar_path(card):
    """A bf16 x that is not 16-byte aligned (a view one element in), in a
    batch the row kernel would take if it were aligned, still agrees with
    the plain version."""
    rng = np.random.default_rng(41)
    base = _randn(rng, (300 * 4096 + 1,), card, torch.bfloat16)
    x = base[1:].view(300, 4096)
    w = 1 + 0.1 * _randn(rng, (4096,), card, torch.float32)
    got = k_rms.rms_norm(x, w, 1e-6)
    want = k_rms.rms_norm_plain(x, w, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -7)



def _plain_kernels():
    """Every decode-path kernel swapped for its plain version."""
    import contextlib
    from unittest import mock

    stack = contextlib.ExitStack()
    for mod, name in ((k_rms, 'rms_norm'), (k_decode, 'decode_attention'),
                      (k_paged, 'paged_decode_attention'),
                      (k_qmm, 'quant_matmul'), (k_moe, 'moe_grouped_matmul')):
        stack.enter_context(mock.patch.object(mod, name,
                                              getattr(mod, name + '_plain')))
    return stack


def _spec_models(card):
    """A float32 2-layer target and a draft of its first layer (its
    embedding, final norm and head), on the card."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cfg = llama_tiny(vocab_size=128, hidden_size=64, layers=2)
    target = LlamaForCausalLM(cfg, device=card, seed=0)
    draft = LlamaForCausalLM(llama_tiny(vocab_size=128, hidden_size=64,
                                        layers=1), device=card, seed=1)
    own = target.state_dict()
    draft.load_state_dict({k: own[k] for k in draft.state_dict()})
    return target, draft


def test_speculative_generate_runs_the_decode_kernels(card):
    """generate_speculative and DecodeEngine.generate_speculative on the
    card (float32, 2 layers): tokens equal to generate and to the run
    through the plain versions; the draft's one-token steps launch K7
    once per layer, k + 1 a window (none in a prefill or verify), K1
    2L + 1 a forward of either model, K10 7L + 1 a forward of an int8
    draft."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.generation import generate_speculative

    target, draft = _spec_models(card)
    k, n = 3, 10
    for B, kv8, qdraft in ((1, False, False), (3, False, False),
                           (1, True, False), (1, False, True)):
        ids = torch.from_numpy(np.random.default_rng(B).integers(
            3, 128, (B, 9))).to(card)
        d = draft.quantize_weights(8) if qdraft else draft
        kw = dict(max_new_tokens=n, num_draft_tokens=k, kv_cache_int8=kv8)
        before = dict(_build.LAUNCHES)
        out = generate_speculative(target, d, ids, **kw)
        got = {name: _build.LAUNCHES[name] - before[name]
               for name in before}
        # the draft's one-token steps alone launch K7 (1 layer, k + 1 a
        # window): the windows, and from them every other count
        w, rest = divmod(got['decode_attention'], k + 1)
        assert w > 0 and rest == 0
        assert got['rms_norm'] == 5 * (1 + w) + 3 * (1 + (k + 1) * w)
        assert got['quant_matmul'] == (8 * (1 + (k + 1) * w) if qdraft
                                       else 0)
        assert got['paged_decode_attention'] == 0
        assert torch.equal(out, target.generate(ids, max_new_tokens=n,
                                                kv_cache_int8=kv8))
        with _plain_kernels():
            assert torch.equal(out, generate_speculative(target, d, ids,
                                                         **kw))
        if not kv8:
            eng = DecodeEngine(target, max_new_tokens=n)
            assert torch.equal(out, eng.generate_speculative(
                d, ids, num_draft_tokens=k))
            assert eng.stats()['spec']['windows'] == w


@pytest.mark.parametrize('kv', [None, 'int8'])
def test_speculative_serving_runs_the_paged_kernels(card, kv):
    """ServingEngine(draft=) on the card (float32, 2 layers, prefix cache
    and chunked prefill on): streams equal to the non-speculative
    engine's and to the run through the plain versions; K8 (K8q over int8
    pools) launches once per layer of every one-token forward, the
    draft's k + 1 a window beside the target's decode window; K1 2L + 1
    a forward of either model; a self-draft accepts every proposal."""
    from paddle_tpu_torch.inference import ServingEngine

    target, draft = _spec_models(card)
    rng = np.random.default_rng(7)
    system = rng.integers(3, 128, 24)
    prompts = [np.concatenate([system, rng.integers(3, 128, n)])
               for n in (5, 9, 3)] + [rng.integers(3, 128, 30)]
    kw = dict(max_slots=2, block_size=8, max_context_len=64,
              max_new_tokens=12, decode_window=4, buckets=(16, 64),
              kv_cache_dtype=kv, prefix_cache=True, prefill_chunk=8)
    kernel = ('paged_decode_attention_int8' if kv
              else 'paged_decode_attention')

    def serve(d):
        eng = ServingEngine(target, draft=d, num_draft_tokens=3, **kw)
        before = dict(_build.LAUNCHES)
        outs = eng.serve(prompts)
        got = {name: _build.LAUNCHES[name] - before[name]
               for name in before}
        return eng.stats(), outs, got

    want = ServingEngine(target, **kw).serve(prompts)
    for d, Ld in ((draft, 1), (target, 2)):
        s, outs, got = serve(d)
        sp = s['spec']
        assert all(np.array_equal(a, b) for a, b in zip(outs, want))
        assert sp['windows'] > 0 and s['prefix']['hits'] > 0
        assert got[kernel] == 2 * s['decode_forwards'] + Ld * 4 * sp[
            'windows']
        n_t = (s['prefill_forwards'] + s['chunk_forwards']
               + s['decode_forwards'] + sp['verify_forwards'])
        assert got['rms_norm'] == 5 * n_t + (2 * Ld + 1) * sum(
            sp['draft_forwards'].values())
        assert got['decode_attention'] == 0
        if d is target:
            assert sp['accept_rate'] == 1.0
    with _plain_kernels():
        _s, plain, got = serve(draft)
    assert all(np.array_equal(a, b) for a, b in zip(plain, want))
    assert not any(got.values())


# ---------------------------------------------------------------------------
# X1: the grouped expert product of the dropless MoE layer
# ---------------------------------------------------------------------------

def _routing(rng, T, E, k, empty=()):
    """Expert offsets (E + 1,) int32 of T tokens' top-k choices over
    random router logits; experts in `empty` receive no rows."""
    lg = rng.normal(size=(T, E))
    lg[:, list(empty)] = -np.inf
    idx = np.argsort(-lg, axis=1)[:, :k].reshape(-1)
    counts = np.bincount(idx, minlength=E)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _x1_inputs(card, rng, T, E, k, K, N, dtype, empty=()):
    off = _routing(rng, T, E, k, empty)
    R = int(off[-1])
    x = _randn(rng, (R, K), card, dtype)
    w = (0.02 * torch.from_numpy(rng.normal(size=(E, K, N)).astype(
        np.float32))).to(card, dtype)
    return x, w, torch.from_numpy(off).to(card)


# float32: sums of up to 14336 products in another order; bf16: one
# rounding of the float32 sum on top
X1_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -7)}
# (T, E, k, K, N): the 64-expert model's decode at batch 1 and 8 (gate /
# up, then down) and its 512-token prefill; Mixtral-8x7B's decode at
# batch 1 and 8 and a 512-token prefill
X1_SHAPES = [(1, 64, 6, 2048, 1408), (8, 64, 6, 2048, 1408),
             (8, 64, 6, 1408, 2048), (512, 64, 6, 2048, 1408),
             (1, 8, 2, 4096, 14336), (8, 8, 2, 14336, 4096),
             (512, 8, 2, 4096, 14336)]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('T,E,k,K,N', X1_SHAPES)
def test_moe_grouped_matmul_kernel(card, T, E, k, K, N, dtype):
    rng = np.random.default_rng(T + E + K)
    x, w, off = _x1_inputs(card, rng, T, E, k, K, N, dtype)
    before = dict(k_moe.PATH_LAUNCHES)
    got = k_moe.moe_grouped_matmul(x, w, off)
    took = [p for p, n in k_moe.PATH_LAUNCHES.items() if n != before[p]]
    assert took == [k_moe.path(x.shape[0], E, K, N, dtype, True)]
    if T == 512:    # the prefills: bf16 on the tensor cores
        assert took == ['tensor_core' if dtype == torch.bfloat16
                        else 'tiled']
    want = k_moe.moe_grouped_matmul_plain(x, w, off)
    rtol, atol = X1_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * want.abs().max().item())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('p', ['skinny', 'tiled', 'tensor_core'])
@pytest.mark.parametrize('T,E,k,K,N,empty', [
    (5, 6, 2, 37, 100, (1, 4)),         # no 16-byte rows, a column tail
    (40, 6, 3, 600, 72, (0,)),          # K past a staged chunk
    (3, 11, 1, 64, 64, (2, 3, 5, 6, 7, 8, 9))])   # most experts empty
def test_moe_grouped_matmul_paths_and_empty_experts(card, p, T, E, k, K, N,
                                                    empty, dtype):
    rng = np.random.default_rng(K + N)
    x, w, off = _x1_inputs(card, rng, T, E, k, K, N, dtype, empty)
    if p == 'tensor_core' and (dtype != torch.bfloat16 or K % 8 or N % 8):
        with pytest.raises(ValueError, match='tensor-core path takes'):
            k_moe.launch_path(p, x, w, off)
        return
    got = k_moe.launch_path(p, x, w, off)
    want = k_moe.moe_grouped_matmul_plain(x, w, off)
    rtol, atol = X1_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * want.abs().max().item())
    # bitwise repeatable: no atomics
    assert torch.equal(got, k_moe.launch_path(p, x, w, off))


# (rows per expert, K, N) for the tensor-core route's 128-row tiles (64
# rows a warpgroup): an expert with 1 row, one whose rows span two tiles
# (150) or three (300), one of exactly one warpgroup's 64 or one tile's
# 128 and one row past them (65, 129), empty experts, R not a multiple
# of 64; K not a multiple of the 64-wide step; N a multiple of 16 but
# not of the 256-column strip (400, 144, 1408), and of 8 only (72)
X1_TC_TILES = {
    'ragged': ((1, 0, 150, 64, 0, 37), 200, 400),
    'n_of_8': ((3, 70, 0, 129), 64, 72),
    'one_warpgroup_and_one_row': ((64, 1, 0, 65), 1024, 144),
    'one_expert': ((300,), 136, 256),
    'tile_edges': ((129, 0, 128, 1), 520, 1408),
}


@pytest.mark.parametrize('case', list(X1_TC_TILES))
def test_moe_grouped_matmul_tensor_core_tiles(card, case):
    """The tensor-core route at tile edges, held to X1_TOL against the
    plain version, bitwise repeatable, equal to the CUDA-core tiles
    within the same tolerance, and one CUDA kernel a call."""
    counts, K, N = X1_TC_TILES[case]
    E = len(counts)
    rng = np.random.default_rng(sum(counts) + K + N)
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                       dtype=torch.int32, device=card)
    R = int(off[-1])
    x = _randn(rng, (R, K), card, torch.bfloat16)
    w = _randn(rng, (E, K, N), card, torch.bfloat16, 0.02)
    got = k_moe.launch_path('tensor_core', x, w, off)
    want = k_moe.moe_grouped_matmul_plain(x, w, off)
    rtol, atol = X1_TOL[torch.bfloat16]
    scale = atol * want.abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=scale)
    torch.testing.assert_close(
        got.float(), k_moe.launch_path('tiled', x, w, off).float(),
        rtol=rtol, atol=scale)
    assert torch.equal(got, k_moe.launch_path('tensor_core', x, w, off))
    assert _build.kernels_per_call(
        lambda: k_moe.launch_path('tensor_core', x, w, off), card) == 1


def test_moe_grouped_matmul_tensor_core_in_a_cuda_graph(card):
    """A bf16 prefill product (512 tokens, top 6 of 64 experts, 2048 ->
    1408) on the tensor-core route captured in a CUDA graph and replayed
    after new rows and a new routing are copied into its inputs equals
    the eager call: the launch reads its offsets on the device."""
    T, E, k, K, N = 512, 64, 6, 2048, 1408
    rng = np.random.default_rng(31)
    x, w, off = _x1_inputs(card, rng, T, E, k, K, N, torch.bfloat16)
    assert k_moe.path(x.shape[0], E, K, N, torch.bfloat16, True) == \
        'tensor_core'
    k_moe.moe_grouped_matmul(x, w, off)                  # warm
    torch.cuda.synchronize()
    before = k_moe.PATH_LAUNCHES['tensor_core']
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k_moe.moe_grouped_matmul(x, w, off)
    assert k_moe.PATH_LAUNCHES['tensor_core'] == before + 1
    seen = []
    for seed in (4, 5):
        r = np.random.default_rng(seed)
        off.copy_(torch.from_numpy(_routing(r, T, E, k)))
        x.copy_(_randn(r, x.shape, card, torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k_moe.moe_grouped_matmul(x, w, off))
        want = k_moe.moe_grouped_matmul_plain(x, w, off)
        rtol, atol = X1_TOL[torch.bfloat16]
        torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                                   atol=atol * want.abs().max().item())
        seen.append(off.clone())
    assert not torch.equal(seen[0], seen[1])         # the routing moved


def test_moe_grouped_matmul_no_rows_and_refusals(card):
    w = torch.zeros(4, 8, 16, device=card)
    before = _build.LAUNCHES['moe_grouped_matmul']
    y = ops.moe_grouped_matmul(torch.zeros(0, 8, device=card), w,
                               torch.zeros(5, dtype=torch.int32,
                                           device=card))
    assert y.shape == (0, 16) and y.device.type == 'cuda'
    assert _build.LAUNCHES['moe_grouped_matmul'] == before
    off = torch.tensor([0, 1, 1, 2, 2], dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match='share a dtype'):
        ops.moe_grouped_matmul(torch.zeros(2, 8, device=card), w.bfloat16(),
                               off)
    with pytest.raises(ValueError, match='contiguous'):
        k_moe.moe_grouped_matmul(torch.zeros(8, 2, device=card).T, w, off)
    with pytest.raises(NotImplementedError, match='experts'):
        k_moe.moe_grouped_matmul(torch.zeros(2, 8, device=card),
                                 torch.zeros(1025, 8, 4, device=card),
                                 torch.zeros(1026, dtype=torch.int32,
                                             device=card))


# X1's backward: (T, E, k, K, N, empty experts) of the forward product
# x (R, K) @ w[e] (K, N): odd widths (no 16-byte rows, a column tail), K
# past a staged chunk, most experts empty, the 64-expert model's b1
# prefill (gate / up) and decode, and no rows at all
X1_BWD_SHAPES = [(5, 6, 2, 37, 100, (1, 4)), (40, 6, 3, 600, 72, (0,)),
                 (3, 11, 1, 64, 64, (2, 3, 5, 6, 7, 8, 9)),
                 (512, 64, 6, 2048, 1408, ()), (8, 64, 6, 1408, 2048, ()),
                 (0, 4, 2, 64, 48, ())]


def _x1_bwd_inputs(card, T, E, k, K, N, dtype, empty):
    rng = np.random.default_rng(T + K + N)
    x, w, off = _x1_inputs(card, rng, T, E, k, K, N, dtype, empty)
    dy = _randn(rng, (x.shape[0], N), card, dtype, 0.02)
    return x, w, dy, off


def _x1_close(got, want, dtype):
    rtol, atol = X1_TOL[dtype]
    scale = want.abs().max().item() if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * max(scale, 1e-30))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('p', ['skinny', 'tiled', 'tensor_core'])
@pytest.mark.parametrize('T,E,k,K,N,empty', X1_BWD_SHAPES)
def test_moe_grouped_matmul_dx_paths(card, p, T, E, k, K, N, empty, dtype):
    """dx = dy w[e]^T on every route against the plain version, bitwise
    repeatable, one CUDA kernel a call (none at R = 0); the tensor-core
    route refuses what it does not take."""
    x, w, dy, off = _x1_bwd_inputs(card, T, E, k, K, N, dtype, empty)
    if p == 'tensor_core' and (dtype != torch.bfloat16 or K % 8 or N % 8):
        with pytest.raises(ValueError, match='tensor-core path takes'):
            k_moe.launch_dx_path(p, dy, w, off)
        return
    before = _build.LAUNCHES['moe_grouped_matmul_dx']
    got = k_moe.launch_dx_path(p, dy, w, off)
    assert got.shape == x.shape and got.dtype == dtype
    assert _build.LAUNCHES['moe_grouped_matmul_dx'] == before + (T > 0)
    _x1_close(got, k_moe.moe_grouped_matmul_dx_plain(dy, w, off), dtype)
    assert torch.equal(got, k_moe.launch_dx_path(p, dy, w, off))
    if T:
        assert _build.kernels_per_call(
            lambda: k_moe.launch_dx_path(p, dy, w, off), card) == 1


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('p', ['tiled', 'tensor_core'])
@pytest.mark.parametrize('T,E,k,K,N,empty', X1_BWD_SHAPES)
def test_moe_grouped_matmul_dw_paths(card, p, T, E, k, K, N, empty, dtype):
    """dw[e] = x_e^T dy_e on both routes against the plain version: zero
    for every expert with no rows (all of them at R = 0, which launches
    too), bitwise repeatable, one CUDA kernel a call."""
    x, w, dy, off = _x1_bwd_inputs(card, T, E, k, K, N, dtype, empty)
    if p == 'tensor_core' and (dtype != torch.bfloat16 or K % 8 or N % 8):
        with pytest.raises(ValueError, match='tensor-core path takes'):
            k_moe.launch_dw_path(p, x, dy, off)
        return
    got = k_moe.launch_dw_path(p, x, dy, off)
    want = k_moe.moe_grouped_matmul_dw_plain(x, dy, off)
    assert got.shape == w.shape and got.dtype == dtype
    _x1_close(got, want, dtype)
    sizes = (off[1:] - off[:-1]).cpu()
    assert not got[sizes == 0].any()
    assert torch.equal(got, k_moe.launch_dw_path(p, x, dy, off))
    assert _build.kernels_per_call(
        lambda: k_moe.launch_dw_path(p, x, dy, off), card) == 1


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_moe_grouped_matmul_backward_launches_kernels(card, dtype):
    """ops.moe_grouped_matmul under a gradient on CUDA tensors: one
    forward, one dx and one dW launch on the route rules' paths, and
    never the plain versions (patched to raise); the gradients equal the
    plain versions'."""
    from unittest import mock

    x, w, dy, off = _x1_bwd_inputs(card, 512, 64, 6, 2048, 1408, dtype, ())
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    keys = ('moe_grouped_matmul', 'moe_grouped_matmul_dx',
            'moe_grouped_matmul_dw')
    before = [_build.LAUNCHES[k] for k in keys]
    routes = (dict(k_moe.DX_PATH_LAUNCHES), dict(k_moe.DW_PATH_LAUNCHES))

    def refuse(*a, **kw):
        raise AssertionError('a CUDA tensor reached a plain version')

    with mock.patch.multiple(k_moe, moe_grouped_matmul_plain=refuse,
                             moe_grouped_matmul_dx_plain=refuse,
                             moe_grouped_matmul_dw_plain=refuse):
        ops.moe_grouped_matmul(xg, wg, off).backward(dy)
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[k] for k in keys] == [b + 1 for b in before]
    want = 'tensor_core' if dtype == torch.bfloat16 else 'tiled'
    assert k_moe.DX_PATH_LAUNCHES[want] == routes[0][want] + 1
    assert k_moe.DW_PATH_LAUNCHES[want] == routes[1][want] + 1
    _x1_close(xg.grad, k_moe.moe_grouped_matmul_dx_plain(dy, w, off), dtype)
    _x1_close(wg.grad, k_moe.moe_grouped_matmul_dw_plain(x, dy, off), dtype)


def test_moe_model_trains_on_the_card(card):
    """A bf16 MoEForCausalLM (dropless, 8 experts top 2, a shared expert)
    through TrainEngine + AdamW on one repeated batch: the loss falls,
    every step launches 3L X1, 3L dx and 3L dW kernels, and the router and
    experts move."""
    from paddle_tpu_torch.models.moe_lm import MoEForCausalLM, moe_tiny
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.training import TrainEngine

    cfg = moe_tiny(vocab_size=128, num_experts=8, dispatch_mode='ragged')
    model = MoEForCausalLM(cfg, device=card, dtype='bfloat16', seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    eng = TrainEngine(model, AdamW(learning_rate=1e-2), log_window=5)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 129))).to(card)
    keys = ('moe_grouped_matmul', 'moe_grouped_matmul_dx',
            'moe_grouped_matmul_dw')
    before = [_build.LAUNCHES[k] for k in keys]
    for _ in range(5):
        logs = eng.step((ids,))
    L = cfg.num_hidden_layers
    assert [_build.LAUNCHES[k] - b for k, b in zip(keys, before)] == \
        [3 * L * 5] * 3
    assert all(np.isfinite(logs['losses']))
    assert logs['losses'][-1] < logs['losses'][0]
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), start[n])]
    assert not still, still


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_moe_layer_dropless_in_a_cuda_graph(card, dtype):
    """The dropless layer's forward (gating, sort, offsets, three X1
    launches, the combine, shared experts) captured in a CUDA graph and
    replayed over new inputs, which route to other experts, equals the
    eager forward: nothing on the path reads the device on the host."""
    from paddle_tpu_torch.distributed.moe import MoELayer

    layer = MoELayer(256, 192, num_experts=64, top_k=6, num_shared_experts=2,
                     dispatch_mode='ragged', dtype=dtype, device=card,
                     generator=torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(3)
    x = _randn(rng, (8, 1, 256), card, dtype)
    with torch.no_grad():
        layer(x, dropless=True)                  # warm
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = layer(x, dropless=True)
        seen = []
        for seed in (4, 5):
            x.copy_(_randn(np.random.default_rng(seed), x.shape, card,
                           dtype))
            graph.replay()
            torch.cuda.synchronize()
            want = layer(x, dropless=True)
            assert torch.equal(out, want)
            gates = x.reshape(8, 256).to(torch.float32) @ layer.gate
            seen.append(torch.sort(gates, dim=-1, descending=True,
                                   stable=True)[1][:, :6])
        assert not torch.equal(seen[0], seen[1])     # the routing moved


def _moe_models(card):
    """A float32 2-layer MoE model (16 experts, top 4, a shared expert)
    and a draft of its first layer (its embedding, final norm and
    head), on the card."""
    from paddle_tpu_torch.models.moe_lm import MoEForCausalLM, moe_tiny

    cfg = moe_tiny(vocab_size=128, num_experts=16, top_k=4,
                   dispatch_mode='ragged')
    target = MoEForCausalLM(cfg, device=card, seed=0)
    draft = MoEForCausalLM(moe_tiny(vocab_size=128, num_experts=16, top_k=4,
                                    num_hidden_layers=1,
                                    dispatch_mode='ragged'),
                           device=card, seed=1)
    own = target.state_dict()
    draft.load_state_dict({k: own[k] for k in draft.state_dict()})
    return target, draft


def test_moe_generate_runs_the_kernels(card):
    """generate (plain, left-padded, int8 KV), DecodeEngine and
    generate_speculative of an MoE model on the card (float32): every
    forward launches K1 2L + 1 times and X1 3L times, every one-token
    forward K7 L times; tokens equal to the run through the plain
    versions; the self-draft accepts every proposal."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.generation import generate_speculative

    target, draft = _moe_models(card)
    L, n = 2, 10
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        3, 128, (3, 9))).to(card)
    am = torch.ones_like(ids)
    am[0, :4] = 0
    runs = {'plain': lambda: target.generate(ids, max_new_tokens=n),
            'padded': lambda: target.generate(ids * am, max_new_tokens=n,
                                              attention_mask=am),
            'kv8': lambda: target.generate(ids, max_new_tokens=n,
                                           kv_cache_int8=True),
            'engine': lambda: DecodeEngine(target, max_new_tokens=n,
                                           buckets=(16,)).generate(ids)}
    for name, run in runs.items():
        before = dict(_build.LAUNCHES)
        out = run()
        got = {k: _build.LAUNCHES[k] - before[k] for k in before}
        assert got == dict(dict.fromkeys(before, 0), rms_norm=5 * n,
                           moe_grouped_matmul=3 * L * n,
                           decode_attention=L * (n - 1)), name
        # X1's plain version reads its offsets on the host, so it runs
        # the decode steps directly, not captured
        with _plain_kernels(), _direct_steps():
            assert torch.equal(out, run()), name
    want = target.generate(ids, max_new_tokens=n)
    for d in (draft, target):
        out = generate_speculative(target, d, ids, max_new_tokens=n,
                                   num_draft_tokens=3)
        assert torch.equal(out, want)
        eng = DecodeEngine(target, max_new_tokens=n)
        assert torch.equal(out, eng.generate_speculative(
            d, ids, num_draft_tokens=3))
        if d is target:
            assert eng.stats()['spec']['accept_rate'] == 1.0


# ---------------------------------------------------------------------------
# The compiled decode window and decode step (CUDA graphs)
# ---------------------------------------------------------------------------

def _direct_steps():
    """generate's decode step run directly, its eager reference, in place
    of the captured graph (a runner off the card calls the body)."""
    from unittest import mock

    from paddle_tpu_torch.inference.graphs import GraphRunner
    from paddle_tpu_torch.models import generation

    return mock.patch.object(generation, '_decode_graphs',
                             lambda owner, model: generation.DecodeGraphs(
                                 GraphRunner('cpu')))


def _serving_engine(card, kv, **kw):
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cfg = llama_tiny(vocab_size=128, hidden_size=64, layers=2)
    cfg.dtype = 'bfloat16'
    model = LlamaForCausalLM(cfg, device=card, seed=0)
    return ServingEngine(model, max_slots=3, block_size=4, max_new_tokens=12,
                         decode_window=3, max_context_len=64,
                         kv_cache_dtype=kv, **kw)


@pytest.mark.parametrize('variant', ['greedy', 'sampled', 'carried'])
@pytest.mark.parametrize('kv', [None, 'int8'], ids=['bf16', 'int8'])
def test_serving_window_graph_equals_the_direct_window(card, kv, variant):
    """A captured serving window replayed over live slots equals a direct
    `_window` call on cloned state bit for bit: tokens, the carried
    logits and every pool byte, greedy and sampled, over bf16 and int8
    pools, and with the carried token a speculative engine's chunk step
    commits first."""
    from paddle_tpu_torch.inference.serving import _window

    eng = _serving_engine(card, kv)
    rng = np.random.default_rng(9)
    for i, n in enumerate((5, 14, 9)):
        eng.submit(rng.integers(3, 128, n),
                   **(dict(temperature=0.9, top_k=30) if i != 1 else {}))
    eng.step()
    # the pages the next window writes, as a step tops them up first
    eng._ensure_window_pages()
    sampled, forced = variant == 'sampled', variant == 'carried'
    if forced:
        eng._slot_req[0].spec_next = 77
        eng._slot_req[2].spec_next = 5
    live = np.ones(3, bool)
    graph = eng._window_graph(sampled, forced)
    inputs = eng._window_inputs(live, sampled, forced)
    t = {k: (v.clone() if isinstance(v, torch.Tensor)
             else torch.as_tensor(v, device=card)) for k, v in inputs.items()}
    pages = [type(pc)(*(f.clone() for f in pc)) for pc in eng._pages]
    with torch.no_grad():
        want, want_last, _ = _window(
            eng.model, pages, t['last_logits'], t['btab'], t['ctx'],
            t['live'], t['budget'], window=3, eos_token_id=None,
            sampling=(tuple(t[k] for k in ('temp', 'topk', 'topp', 'seed',
                                           'plen')) if sampled else None),
            **(dict(forced_tok=t['forced_tok'], forced=t['forced'])
               if forced else {}))
    graph.load(**inputs)
    got, got_last = graph.run()
    assert torch.equal(got, want) and torch.equal(got_last, want_last)
    for pa, pb in zip(eng._pages, pages):
        for a, b in zip(pa, pb):
            assert torch.equal(a, b)
    if forced:
        assert int(got[0, 0]) == 77 and int(got[2, 0]) == 5


def test_serving_with_graphs_counts_and_refuses_a_replaced_pool(card):
    """Through the captured windows a burst launches exactly what the
    direct windows launch (K8q L per decode forward, K1 2L + 1 per
    forward), the engine's streams equal an engine whose windows run
    directly, and a pool replaced after the capture raises."""
    from paddle_tpu_torch.inference.graphs import GraphRunner

    prompts = [np.arange(3, 12), np.arange(5, 25), np.arange(40, 47)]
    runs = []
    for direct in (False, True):
        eng = _serving_engine(card, 'int8')
        if direct:
            eng._graphs = GraphRunner('cpu')
        eng.warmup()
        before = dict(_build.LAUNCHES)
        outs = eng.serve(prompts)
        got = {k: _build.LAUNCHES[k] - before[k] for k in before}
        s = eng.stats()
        assert got['paged_decode_attention_int8'] == 2 * s['decode_forwards']
        assert got['rms_norm'] == 5 * (s['decode_forwards']
                                       + s['prefill_forwards'])
        runs.append((outs, got))
    assert runs[0][1] == runs[1][1]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    eng = _serving_engine(card, None)
    eng.warmup()
    eng._pages = eng.model.init_paged_cache(eng.allocator.num_blocks, 4)
    eng.submit(prompts[0])
    with pytest.raises(RuntimeError, match='not the ones'):
        eng.step()


@pytest.mark.parametrize('mode', ['greedy', 'sampled', 'int8-kv-padded'])
@pytest.mark.parametrize('arch', ['llama', 'moe'])
def test_generate_graph_equals_the_direct_steps(card, arch, mode):
    """generate's replayed decode step gives the tokens of its direct
    steps (the sampled ones from the caller's generator, registered with
    the graph: the same seed, the same draws), with the same launch
    counts, over N replays; the caller's generator ends where the direct
    loop leaves it."""
    if arch == 'llama':
        from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                                   llama_tiny)
        cfg = llama_tiny(vocab_size=128, hidden_size=64, layers=2)
        model = LlamaForCausalLM(cfg, device=card, seed=0)
    else:
        model, _ = _moe_models(card)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        3, 128, (3, 9))).to(card)
    kw = dict(max_new_tokens=10)
    if mode == 'sampled':
        kw.update(temperature=0.9, top_k=40)
    if mode == 'int8-kv-padded':
        am = torch.ones_like(ids)
        am[0, :3] = 0
        ids = ids * am
        kw.update(kv_cache_int8=True, attention_mask=am)
    outs, counts, states = [], [], []
    for direct in (False, True, False):
        gen = torch.Generator(device=card).manual_seed(11)
        before = dict(_build.LAUNCHES)
        if direct:
            with _direct_steps():
                out = model.generate(ids, rng_key=gen, **kw)
        else:
            out = model.generate(ids, rng_key=gen, **kw)
        counts.append({k: _build.LAUNCHES[k] - before[k] for k in before})
        outs.append(out)
        states.append(gen.get_state())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[1])
    assert counts[0] == counts[1] == counts[2]
    assert counts[0]['decode_attention'] == 2 * 9
    assert torch.equal(states[0], states[1])


def test_graphs_follow_a_replaced_weight(card):
    """A weight replaced between two calls (a new tensor, as
    `module.to(dtype)` or `load_state_dict(assign=True)` leave one)
    drops the graphs captured over the old one: generate captures its
    step anew over the buffers its last call left and gives the direct
    steps' tokens over the new weight, greedy and then sampled over the
    same buffers, and a warmed ServingEngine captures its window anew
    and streams as an engine built over the new weight."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.generation import _decode_graphs
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    cfg = llama_tiny(vocab_size=128, hidden_size=64, layers=2)
    model = LlamaForCausalLM(cfg, device=card, seed=0)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        3, 128, (2, 9))).to(card)
    first = model.generate(ids, max_new_tokens=8)
    runner = _decode_graphs(model, model).runner
    n = runner.captures
    kw = dict(max_slots=2, block_size=4, max_new_tokens=6, decode_window=3,
              max_context_len=32)
    eng = ServingEngine(model, **kw)
    eng.warmup()
    m = eng._graphs.captures
    model.lm_head = torch.nn.Parameter(model.lm_head.detach().flip(1)
                                       .clone())
    got = model.generate(ids, max_new_tokens=8)
    with _direct_steps():
        want = model.generate(ids, max_new_tokens=8)
    assert runner.captures == n + 1
    assert torch.equal(got, want) and not torch.equal(got, first)
    # a sampling variant captured over the same geometry's buffers
    skw = dict(max_new_tokens=8, temperature=0.9, top_k=40, rng_key=3)
    got = model.generate(ids, **skw)
    with _direct_steps():
        want = model.generate(ids, **skw)
    assert runner.captures == n + 2 and torch.equal(got, want)
    assert len(_decode_graphs(model, model).buffers) == 1
    prompts = [np.arange(3, 12), np.arange(20, 27)]
    outs = eng.serve(prompts)
    # the greedy window and the prefill of the prompts' bucket
    assert eng._graphs.captures == m + 2
    fresh = ServingEngine(model, **kw).serve(prompts)
    assert all(np.array_equal(a, b) for a, b in zip(outs, fresh))


# ---------------------------------------------------------------------------
# The compiled speculative windows (CUDA graphs)
# ---------------------------------------------------------------------------

def _spec_serving_engine(card, kv, **kw):
    """`_serving_engine`'s settings with a draft (the target's first
    layer under its embedding, norm and head) proposing 3 tokens."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    models = []
    for layers in (2, 1):
        cfg = llama_tiny(vocab_size=128, hidden_size=64, layers=layers)
        cfg.dtype = 'bfloat16'
        models.append(LlamaForCausalLM(cfg, device=card, seed=0))
    target, draft = models
    draft.load_state_dict({k: v for k, v in target.state_dict().items()
                           if '.layers.1.' not in k})
    return ServingEngine(target, draft=draft, num_draft_tokens=3,
                         max_slots=3, block_size=4, max_new_tokens=12,
                         decode_window=3, max_context_len=64,
                         kv_cache_dtype=kv, **kw)


@pytest.mark.parametrize('sampled', [False, True], ids=['greedy', 'sampled'])
@pytest.mark.parametrize('kv', [None, 'int8'], ids=['bf16', 'int8'])
def test_serving_spec_window_graph_equals_the_direct_window(card, kv,
                                                            sampled):
    """A captured speculative window replayed over live slots equals a
    direct `_spec_window` call on cloned state bit for bit: candidates,
    commit counts, next tokens, carried logits, and every byte of the
    target's and the draft's pools past the scratch page, greedy and
    sampled, over bf16 and int8 pools. (Page 0 takes every slot's
    uncommitted verify rows; rows that land on one of its slots are
    written in no fixed order, and it is never read.)"""
    from paddle_tpu_torch.inference.serving import _spec_window

    eng = _spec_serving_engine(card, kv)
    rng = np.random.default_rng(9)
    for i, n in enumerate((5, 14, 9)):
        eng.submit(rng.integers(3, 128, n),
                   **(dict(temperature=0.9, top_k=30) if i != 1 else {}))
    eng.step()
    eng._ensure_window_pages()
    live = np.ones(3, bool)
    graph = eng._spec_graph(32, sampled)
    inputs = eng._window_inputs(live, sampled, True)
    t = {k: (v.clone() if isinstance(v, torch.Tensor)
             else torch.as_tensor(v, device=card)) for k, v in inputs.items()}
    clone = [type(pc)(*(f.clone() for f in pc))
             for pc in eng._pages + eng._dpages]
    L = len(eng._pages)
    with torch.no_grad():
        want = _spec_window(
            eng.model, eng.draft, clone[:L], clone[L:], t['last_logits'],
            t['forced_tok'], t['forced'], t['btab'], t['ctx'], t['live'],
            t['budget'], k=3, ctx_bucket=32, eos_token_id=None,
            sampling=(tuple(t[k] for k in ('temp', 'topk', 'topp', 'seed',
                                           'plen')) if sampled else None))
    graph.load(**inputs)
    got = graph.run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1].sum()) > 0
    for pa, pb in zip(eng._pages + eng._dpages, clone):
        for a, b in zip(pa, pb):
            assert torch.equal(a[1:], b[1:])


def test_generate_speculative_graph_equals_the_direct_windows(card):
    """generate_speculative (b1, b3, int8 caches) and the sampled b1
    through their replayed windows give the direct windows' tokens, with
    the same launch counts; the sampled stream draws from the caller's
    generator state, which it leaves where the direct loop does; a
    warmed DecodeEngine captures nothing more."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.inference.graphs import for_decode_engine
    from paddle_tpu_torch.models.generation import (
        _decode_graphs, generate_speculative, generate_speculative_sampled)

    eng = _spec_serving_engine(card, None)
    target, draft = eng.model, eng.draft
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        3, 128, (3, 9))).to(card)
    runs = {'b1': lambda: generate_speculative(
                target, draft, ids[:1], max_new_tokens=10,
                num_draft_tokens=3),
            'b3 int8': lambda: generate_speculative(
                target, draft, ids, max_new_tokens=10, num_draft_tokens=3,
                kv_cache_int8=True),
            'sampled': lambda: generate_speculative_sampled(
                target, draft, ids[:1], max_new_tokens=10,
                num_draft_tokens=3, temperature=0.9, top_k=40,
                rng_key=gen)}
    for name, run in runs.items():
        outs, counts, states = [], [], []
        for direct in (False, True, False):
            gen = torch.Generator(device=card).manual_seed(3)
            before = dict(_build.LAUNCHES)
            if direct:
                with _direct_steps():
                    out = run()
            else:
                out = run()
            counts.append({k: _build.LAUNCHES[k] - before[k]
                           for k in before})
            outs.append(out)
            states.append(gen.get_state())
        assert torch.equal(outs[0], outs[1]), name
        assert torch.equal(outs[2], outs[1]), name
        assert counts[0] == counts[1] == counts[2], name
        assert torch.equal(states[0], states[1]), name
    dec = DecodeEngine(target, max_new_tokens=10)
    dec.warmup(geometries=[g for g in for_decode_engine(
        dec, [9], spec_draft_tokens=[3], spec_batch_sizes=(3,))
        if g.kind == 'decode_spec'], draft=draft)
    n = _decode_graphs(dec, target).captures()
    assert torch.equal(dec.generate_speculative(draft, ids,
                                                num_draft_tokens=3),
                       generate_speculative(target, draft, ids,
                                            max_new_tokens=10,
                                            num_draft_tokens=3))
    assert _decode_graphs(dec, target).captures() == n


def test_spec_capture_failure_raises_and_foreign_pools_are_refused(card):
    """A speculative window whose body cannot be captured (a host read
    inside it) raises at its step: nothing falls back to the eager
    body. A draft pool replaced after the capture is refused by
    `check_state`, as a target pool is."""
    from unittest import mock

    from paddle_tpu_torch.inference import serving

    prompts = [np.arange(3, 12), np.arange(5, 25)]
    eng = _spec_serving_engine(card, None)
    accept = serving._spec_accept

    def host_read(*a, **k):
        m, nxt = accept(*a, **k)
        int(m.sum())                   # a device-to-host copy
        return m, nxt

    with mock.patch.object(serving, '_spec_accept', host_read):
        for p in prompts:
            eng.submit(p)
        with pytest.raises(RuntimeError):
            eng.step()
    assert not any(k[0] == 'serve_spec_window' for k in eng._graphs.entries)

    eng = _spec_serving_engine(card, 'int8')
    eng.warmup()
    geos = eng.geometries()
    ctxs = {g.params['ctx'] for g in geos if g.kind == 'serve_spec_window'}
    bks = {g.params['bucket'] for g in geos if g.kind == 'serve_prefill'}
    # each window greedy and sampled, each bucket's prefill of both
    # models at each row width (1, 2, 3)
    assert eng.stats()['graphs']['captures'] == 2 * len(ctxs) + 6 * len(bks)
    eng._dpages = eng.draft.init_paged_cache(eng.allocator.num_blocks, 4,
                                             dtype=torch.int8)
    for p in prompts:
        eng.submit(p)
    with pytest.raises(RuntimeError, match='not the ones'):
        eng.step()


# ---------------------------------------------------------------------------
# The compiled admission prefills, chunks, catch-ups and fused decode step
# ---------------------------------------------------------------------------

def _randomize(pools, seed):
    gen = torch.Generator(device=pools[0][0].device).manual_seed(seed)
    for pc in pools:
        for f in pc:
            if f.dtype == torch.int8:
                f.copy_(torch.randint(-100, 100, f.shape, generator=gen,
                                      device=f.device, dtype=torch.int8))
            else:
                f.copy_(torch.randn(f.shape, generator=gen, device=f.device,
                                    dtype=f.dtype))


@pytest.mark.parametrize('kv', [None, 'int8'], ids=['bf16', 'int8'])
def test_serving_prefill_and_chunk_graphs_equal_the_direct_bodies(card, kv):
    """The captured admission prefill and chunk of the target and the
    draft at max_slots rows (a dummy row; a chunk with one copy-on-write
    pair beside a (0, 0) one, a row that ends its context and one that
    does not, pad columns past the ctx bucket) replayed over random
    pools equal the direct bodies on cloned state bit for bit: both models' pools past the scratch page
    and the carried logits, with the direct bodies' launch counts."""
    from paddle_tpu_torch.inference import serving

    eng = _spec_serving_engine(card, kv, prefix_cache=True, prefill_chunk=8)
    _randomize(eng._pages + eng._dpages, 1)
    eng._last_logits.normal_()
    rng = np.random.default_rng(3)
    S, MAXB = 3, eng.max_blocks_per_seq
    pre = dict(ids=np.zeros((S, 16), np.int64),
               real_len=np.array([9, 14, 0]),
               btabs=np.zeros((S, MAXB), np.int32),
               slots=np.array([2, 0, S]))
    pre['ids'][0, :9] = rng.integers(3, 128, 9)
    pre['ids'][1, :14] = rng.integers(3, 128, 14)
    pre['btabs'][0, :3] = [1, 2, 3]
    pre['btabs'][1, :4] = [4, 5, 6, 7]
    ch = dict(ids=np.zeros((S, 8), np.int64), chunk_len=np.array([8, 5, 0]),
              start=np.array([9, 26, 0]), btabs=np.zeros((S, MAXB), np.int32),
              slots=np.array([S, 0, S]), cow_src=np.array([0, 6, 0]),
              cow_dst=np.array([0, 8, 0]))
    ch['ids'][0] = rng.integers(3, 128, 8)
    ch['ids'][1, :5] = rng.integers(3, 128, 5)
    ch['btabs'][0, :5] = [1, 2, 3, 9, 10]
    ch['btabs'][1, :8] = [4, 5, 6, 8, 11, 12, 13, 14]
    dev = {k: {n: torch.as_tensor(a, device=card) for n, a in d.items()}
           for k, d in (('pre', pre), ('ch', ch))}
    clone = [[type(pc)(*(f.clone() for f in pc)) for pc in p]
             for p in (eng._pages, eng._dpages)]
    logits = eng._last_logits.clone()
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        for i, model in enumerate((eng.model, eng.draft)):
            lg = logits if i == 0 else None
            serving._prefill_body(model, clone[i], lg, dev['pre'])
            serving._chunk_body(model, clone[i], lg, dev['ch'],
                                ctx_bucket=32)
    direct = {k: _build.LAUNCHES[k] - before[k] for k in before}
    graphs = [eng._prefill_graph(16, S), eng._prefill_graph(16, S, True),
              eng._chunk_graph(8, 32, S), eng._chunk_graph(8, 32, S, True)]
    before = dict(_build.LAUNCHES)
    for draft in (False, True):
        eng._replay(graphs[draft], draft, pre)
        eng._replay(graphs[2 + draft], draft, ch)
    replayed = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert replayed == direct and direct['rms_norm'] == 2 * (5 + 3)
    for got, want in zip((eng._pages, eng._dpages), clone):
        for pa, pb in zip(got, want):
            for a, b in zip(pa, pb):
                assert torch.equal(a[1:], b[1:])
    assert torch.equal(eng._last_logits, logits)


@pytest.mark.parametrize('kv', [None, 'int8'], ids=['bf16', 'int8'])
def test_speculative_chunked_serving_replays_equal_direct_bodies(card, kv):
    """A speculative engine with chunked prefill and the prefix cache,
    warmed over every geometry: its admission steps (both models'
    prefills then the speculative window), chunk steps (both models'
    chunks, the draft's catch-up, the window) and speculative windows
    replayed give the streams and launch counts of an engine whose
    bodies run directly, and capture nothing while serving."""
    from paddle_tpu_torch.inference.graphs import GraphRunner

    rng = np.random.default_rng(12)
    system = rng.integers(3, 128, 12)
    prompts = [np.concatenate([system, rng.integers(3, 128, n)])
               for n in (3, 9, 20)] + [rng.integers(3, 128, 30)]
    runs = []
    for direct in (False, True):
        eng = _spec_serving_engine(card, kv, prefix_cache=True,
                                   prefill_chunk=8)
        if direct:
            eng._graphs = GraphRunner('cpu')
        eng.warmup(geometries=eng.geometries(prompt_lens=[len(p)
                                                          for p in prompts]))
        n = eng._graphs.captures
        eng.serve(prompts[:1], max_new_tokens=4)
        before = dict(_build.LAUNCHES)
        outs = eng.serve(prompts[1:])
        got = {k: _build.LAUNCHES[k] - before[k] for k in before}
        s = eng.stats()
        runs.append((outs, got, s['spec'], s['prefix']))
        if not direct:
            assert eng._graphs.captures == n
    assert runs[0][1] == runs[1][1] and runs[0][2] == runs[1][2]
    assert runs[0][3]['hits'] > 0 and runs[0][3]['chunk_steps'] > 0
    assert runs[0][2]['draft_forwards']['chunk'] > 0
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))


def test_serving_prefill_capture_failure_raises(card):
    """An admission prefill whose body cannot be captured (a host read
    inside it) raises at its step: nothing falls back to the eager
    body, and no graph is kept for it."""
    from unittest import mock

    from paddle_tpu_torch.inference import serving

    eng = _serving_engine(card, None)
    prefill = serving._prefill_kv

    def host_read(*a, **k):
        last, pages = prefill(*a, **k)
        float(last.sum())              # a device-to-host copy
        return last, pages

    with mock.patch.object(serving, '_prefill_kv', host_read):
        eng.submit(np.arange(3, 12))
        with pytest.raises(RuntimeError):
            eng.step()
    assert not any(k[0] == 'serve_prefill' for k in eng._graphs.entries)


def test_fused_decode_step_graph_equals_the_direct_step(card):
    """fused_multi_transformer_decode_step replayed over 3 steps (one
    capture; per-row positions by seq_lens, then a uniform time_step)
    equals fused_multi_transformer's direct time_step path on cloned
    caches bit for bit, with its launch counts; a full cache raises
    before the replay; release_graphs frees the graph."""
    from paddle_tpu_torch.incubate.nn import functional as FF

    L, E, H, F_, B, S, T = 2, 256, 2, 512, 3, 20, 32
    gen = torch.Generator(device=card).manual_seed(0)

    def r(*shape, std=0.05):
        return (std * torch.randn(*shape, generator=gen, device=card)).to(
            torch.bfloat16)

    w = dict(ln_scales=[1 + r(E) for _ in range(L)], ln_biases=[None] * L,
             qkv_weights=[r(3, H, E // H, E) for _ in range(L)],
             qkv_biases=[None] * L,
             linear_weights=[r(E, E) for _ in range(L)],
             linear_biases=[None] * L,
             ffn_ln_scales=[1 + r(E) for _ in range(L)],
             ffn_ln_biases=[None] * L,
             ffn1_weights=[r(E, F_) for _ in range(L)],
             ffn1_biases=[None] * L,
             ffn2_weights=[r(F_, E) for _ in range(L)],
             ffn2_biases=[None] * L)
    kw = dict(norm_type='rmsnorm', activation='silu')
    caches = [r(2, B, H, T, E // H, std=1.0) for _ in range(L)]
    ref = [c.clone() for c in caches]
    FF.release_graphs()
    lens = [torch.tensor([S, S + 3, S + 1], device=card), None, None]
    for i in range(3):
        x = r(B, 1, E, std=1.0)
        ts = S + 5 + i
        before = dict(_build.LAUNCHES)
        got, _ = FF.fused_multi_transformer_decode_step(
            x, **w, cache_kvs=caches, time_step=ts, seq_lens=lens[i], **kw)
        counts = {k: _build.LAUNCHES[k] - before[k] for k in before}
        before = dict(_build.LAUNCHES)
        with torch.no_grad():
            want, _ = FF.fused_multi_transformer(
                x, **w, cache_kvs=ref, time_step=ts, seq_lens=lens[i],
                **kw)
        assert counts == {k: _build.LAUNCHES[k] - before[k] for k in before}
        assert counts['decode_attention_headmajor'] == L
        assert torch.equal(got, want), i
        for a, b in zip(caches, ref):
            assert torch.equal(a, b), i
    runner = FF._FMT_RUNNERS[caches[0].device]
    assert runner.captures == 1 and len(runner.entries) == 1
    with pytest.raises(ValueError, match='cache is full'):
        FF.fused_multi_transformer_decode_step(
            r(B, 1, E), **w, cache_kvs=caches, time_step=T, **kw)
    FF.release_graphs()
    assert not runner.entries
