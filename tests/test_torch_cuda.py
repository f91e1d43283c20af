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

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.hopper import paged_attention as k_paged
from paddle_tpu_torch.ops.hopper import rms_norm as k_rms

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
    want, want_r = k_rms.rms_norm_plain(x, w, 1e-5, return_r=True)
    assert _build.LAUNCHES['rms_norm'] == before + 1
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
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
    assert _build.LAUNCHES == before
