"""Kernels K1, K2 and K3 against their plain PyTorch versions on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(CUDA kernels have no CPU mode). On a machine with a card:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
(`tests/conftest.py` sets up jax, which this file does not use.)
The binding comparison at the main path's shapes is chip_smoke.py's
phases 5 and 7; these run the same checks at small shapes, plus K3's
determinism and the wrappers' refusals."""
import numpy as np
import pytest
import torch

from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                            fused_block1_alpha_bwd,
                                            fused_block1_alpha_bwd_plain,
                                            fused_block1_alpha_plain)
from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select,
                                            fused_knn_select_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _knn_inputs(dev, M=1000, C=64):
    rng = np.random.default_rng(0)
    off = rng.normal(scale=0.02, size=(M, C, 3)).astype(np.float32)
    off[:, 1::7] = off[:, 0:1]
    pid = rng.integers(0, 1 << 30, size=(M, C)).astype(np.int32)
    pid[:, 2::5] = -1
    xi = torch.from_numpy(off).to(torch.bfloat16).view(torch.int16)
    pi = torch.from_numpy(pid).view(torch.int16).reshape(M, C, 2)
    rows = torch.cat([xi.movedim(-1, -2).reshape(M, -1),
                      pi.movedim(-1, -2).reshape(M, -1)], dim=-1)
    delta = torch.from_numpy(rng.normal(scale=0.02, size=(M, 3)).astype(
        np.float32))
    ok = torch.from_numpy(rng.random(M) < 0.9)
    return rows.to(dev), delta.to(dev), ok.to(dev)


@pytest.mark.parametrize("r2,K,C", [(9e-4, 8, 64), (0.0, 8, 64),
                                    (4e-4, 4, 24)])
def test_k1_kernel_equals_plain(dev, r2, K, C):
    rows, delta, ok = _knn_inputs(dev, C=C)
    n0 = fused_knn_select.launches
    got = fused_knn_select(rows, delta, ok, r2, C=C, K=K)
    assert fused_knn_select.launches == n0 + 1
    ref = fused_knn_select_plain(rows, delta, ok, r2, C=C, K=K)
    assert torch.equal(got, ref)


def _agg_inputs(dev, M=500, K=8, F=32, Dd=6, C=256, n_layers=2):
    g = torch.Generator().manual_seed(0)
    feat = torch.randn(M, K, F, generator=g) * 0.2
    d = torch.randn(M, K, Dd, generator=g) * 0.05
    w = torch.rand(M, K, generator=g)
    cin = F + 2 * F * 3 + 2 * Dd * 5
    block1 = [{"w": torch.randn(i, C, generator=g) * (2.0 / (i + C)) ** 0.5,
               "b": torch.randn(C, generator=g) * 0.05}
              for i in [cin] + [C] * (n_layers - 1)]
    alpha = [{"w": torch.randn(C, 1, generator=g) * 0.1,
              "b": torch.randn(1, generator=g) * 0.1}]
    to = (lambda t: t.to(dev))
    return (to(feat), to(d), to(w),
            [{k: to(v) for k, v in l_.items()} for l_ in block1],
            [{k: to(v) for k, v in l_.items()} for l_ in alpha])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("K,n_layers", [(8, 2), (3, 1)])
def test_k2_kernel_matches_plain(dev, bf16, K, n_layers):
    args = _agg_inputs(dev, K=K, n_layers=n_layers)
    n0 = fused_block1_alpha.launches
    fa, al = fused_block1_alpha(*args, K=K, nf=3, df=5, bf16=bf16)
    assert fused_block1_alpha.launches == n0 + 1
    rfa, ral = fused_block1_alpha_plain(*args, K=K, nf=3, df=5, bf16=bf16)
    tol = dict(atol=2e-2, rtol=1e-2) if bf16 else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(fa, rfa, **tol)
    torch.testing.assert_close(al, ral, **tol)


# K3 tolerance vs its plain version, per output tensor, relative to the
# largest magnitude of the plain gradient: summation order (f32), flipped
# bf16 roundings of product inputs (bf16)
K3_TOL = {False: 2e-3, True: 3e-2}


def _flat(grads):
    dfeat, dd, dw, dblock1, dalpha = grads
    return [dfeat, dd, dw] + [t for l_ in dblock1 + dalpha
                              for t in (l_["w"], l_["b"])]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,K,n_layers", [(501, 8, 2), (77, 3, 1),
                                          (300, 8, 3)])
def test_k3_kernel_matches_plain(dev, bf16, M, K, n_layers):
    """Odd M (a ragged last tile), masked rows (w = 0), K not dividing the
    32-row tile, 1-3 block1 layers."""
    feat, d, w, block1, alpha = _agg_inputs(dev, M=M, K=K, n_layers=n_layers)
    w = w * (torch.rand(w.shape, device=dev) < 0.7)
    C = block1[0]["w"].shape[1]
    g = torch.randn(M, C + 1, device=dev)
    n0 = fused_block1_alpha_bwd.launches
    got = _flat(fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, K=K,
                                       nf=3, df=5, bf16=bf16))
    assert fused_block1_alpha_bwd.launches == n0 + 1
    ref = _flat(fused_block1_alpha_bwd_plain(feat, d, w, block1, alpha, g,
                                             K=K, nf=3, df=5, bf16=bf16))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        err = float((a - b).abs().max())
        assert err <= K3_TOL[bf16] * float(b.abs().max()) + 1e-7, (i, err)


def test_k3_is_deterministic(dev):
    feat, d, w, block1, alpha = _agg_inputs(dev, M=2000)
    g = torch.randn(2000, 257, device=dev)
    a = _flat(fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, K=8,
                                     nf=3, df=5, bf16=False))
    b = _flat(fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, K=8,
                                     nf=3, df=5, bf16=False))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_k2_autograd_backward_is_k3(dev):
    feat, d, w, block1, alpha = _agg_inputs(dev, M=64)
    feat.requires_grad_(True)
    for layer in block1:
        layer["w"].requires_grad_(True)
    n2, n3 = fused_block1_alpha.launches, fused_block1_alpha_bwd.launches
    fa, al = fused_block1_alpha(feat, d, w, block1, alpha, K=8, nf=3, df=5,
                                bf16=False)
    ((fa ** 2).sum() + al.sum()).backward()
    assert fused_block1_alpha.launches == n2 + 1
    assert fused_block1_alpha_bwd.launches == n3 + 1
    gf, gw = feat.grad, block1[0]["w"].grad
    feat.grad = block1[0]["w"].grad = None
    fa, al = fused_block1_alpha_plain(feat, d, w, block1, alpha, K=8, nf=3,
                                      df=5, bf16=False)
    ((fa ** 2).sum() + al.sum()).backward()
    for a, b in ((gf, feat.grad), (gw, block1[0]["w"].grad)):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())


def test_wrappers_refuse_mixed_devices(dev):
    rows, delta, ok = _knn_inputs(dev)
    with pytest.raises(ValueError):
        fused_knn_select(rows, delta.cpu(), ok, 0.0, C=64, K=8)
