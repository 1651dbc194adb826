"""Kernels K1-K7 against their plain PyTorch versions on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(CUDA kernels have no CPU mode). On a machine with a card:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
(`tests/conftest.py` sets up jax, which this file does not use.)
The binding comparison at the main path's shapes is chip_smoke.py's
phases 5, 7, 12 and 14; these run the same checks at small shapes (odd M,
masked rows, K and SR that do not divide the kernels' tiles), plus
determinism and the wrappers' refusals."""
import numpy as np
import pytest
import torch

from sgnerf_tpu_torch.ops.fused_agg import (
    fused_block1_alpha, fused_block1_alpha_bwd, fused_block1_alpha_bwd_plain,
    fused_block1_alpha_color, fused_block1_alpha_color_march,
    fused_block1_alpha_color_march_plain, fused_block1_alpha_color_plain,
    fused_block1_alpha_plain, color_tail_plain, march_tail_plain)
from sgnerf_tpu_torch.ops.pallas_gather import (gather_rows_pallas,
                                                gather_rows_staged,
                                                sorted_segment_sum)
from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select,
                                            fused_knn_select_plain,
                                            fused_knn_select_tiled,
                                            fused_knn_select_tiled_plain,
                                            tile_unique)

pytestmark = pytest.mark.cuda

# K2's tolerances (chip_smoke.py K2_TOL): summation order in f32; a flipped
# bf16 rounding of a product input in bf16
K2_TOL = {False: dict(atol=1e-4, rtol=1e-4), True: dict(atol=2e-2, rtol=1e-2)}


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


def _masks(shape, dev, seed, keep=0.7):
    """A seeded mask: True on about `keep` of the entries."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) < keep).to(dev)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,K,C,n_layers,F,Dd", [
    (501, 8, 256, 2, 32, 6),     # canonical widths, 284-deep first layer
    (77, 3, 256, 1, 32, 6),      # K not dividing the 128-row tile
    (1000, 1, 32, 3, 8, 3),      # 86-deep first layer, narrowest C
    (130, 16, 160, 2, 16, 6),    # 172-deep first layer, C = 160
    (37, 64, 256, 3, 32, 6),     # two points a tile
    (300, 8, 160, 1, 20, 3),     # 170-deep first layer
])
def test_k2_kernel_matches_plain(dev, bf16, M, K, C, n_layers, F, Dd):
    """Ragged M, K in {1, 3, 8, 16, 64}, C in {32, 160, 256}, 1-3 layers,
    first-layer depths that are not multiples of 16, masked rows (w = 0)
    and a whole masked point; a rerun gives the same bits."""
    feat, d, w, block1, alpha = _agg_inputs(dev, M=M, K=K, F=F, Dd=Dd, C=C,
                                            n_layers=n_layers)
    w = w * _masks(w.shape, dev, seed=M)
    w[M // 2] = 0.0
    args = (feat, d, w, block1, alpha)
    n0 = fused_block1_alpha.launches
    fa, al = fused_block1_alpha(*args, K=K, nf=3, df=5, bf16=bf16)
    assert fused_block1_alpha.launches == n0 + 1
    rfa, ral = fused_block1_alpha_plain(*args, K=K, nf=3, df=5, bf16=bf16)
    torch.testing.assert_close(fa, rfa, **K2_TOL[bf16])
    torch.testing.assert_close(al, ral, **K2_TOL[bf16])
    assert not fa[M // 2].any() and not al[M // 2].any()
    again = fused_block1_alpha(*args, K=K, nf=3, df=5, bf16=bf16)
    assert torch.equal(fa, again[0]) and torch.equal(al, again[1])


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
    w = w * _masks(w.shape, dev, seed=M)
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


# bf16 mode, K4 vs the plain colour head on the K2 kernel's reduced rows
# (K4 computes them with K2's tile body) and K5 vs the plain march on K4's
# outputs (chip_smoke.py COLOR_SOUND_TOL): only the colour layers'
# summation order (K4) and the march's exp (K5) are left. Each limit lies
# below the kernel's bf16-vs-f32 gap, which K2_TOL[True] does not.
COLOR_SOUND_TOL = {"K4": 2e-3, "K5": 1e-6}


def _on_k2_rows(feat, d, w, vd, block1, alpha, color, K):
    """bf16 (alpha, colour logits): K2 kernel, then the plain colour head."""
    fa, al = fused_block1_alpha(feat, d, w, block1, alpha, K=K, nf=3, df=5,
                                bf16=True)
    return al, color_tail_plain(fa, vd, color, vf=4, bf16=True)


def _assert_sound_bf16(key, got, ref, got_f32):
    """got within COLOR_SOUND_TOL[key] of ref, and that limit below the gap
    between the kernel's bf16 and f32 modes: a kernel that never rounded
    to bf16 would fail."""
    atol = COLOR_SOUND_TOL[key]
    torch.testing.assert_close(got, ref, atol=atol, rtol=0.0)
    assert float((got - got_f32).abs().max()) > atol


def _color_inputs(dev, M, K, C=256, vf=4, Nh=128, n_layers=4):
    """K4/K5 inputs: K2's, with masked rows (w = 0) and a whole masked
    point, unit view directions and a colour head of n_layers."""
    feat, d, w, block1, alpha = _agg_inputs(dev, M=M, K=K, C=C)
    w = w * _masks(w.shape, dev, seed=M)
    w[0] = 0.0
    g = torch.Generator().manual_seed(1)
    vd = torch.randn(M, 3, generator=g)
    vd = (vd / vd.norm(dim=-1, keepdim=True)).to(dev)
    sizes = [C + 6 * vf] + [Nh] * (n_layers - 1) + [3]
    color = [{"w": (torch.randn(i, o, generator=g) * (2.0 / (i + o)) ** 0.5
                    ).to(dev),
              "b": (torch.randn(o, generator=g) * 0.05).to(dev)}
             for i, o in zip(sizes[:-1], sizes[1:])]
    return feat, d, w, vd, block1, alpha, color


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,K,n_layers", [(501, 8, 4), (77, 3, 1)])
def test_k4_kernel_matches_plain(dev, bf16, M, K, n_layers):
    args = _color_inputs(dev, M, K, n_layers=n_layers)
    n0 = fused_block1_alpha_color.launches
    al, rc = fused_block1_alpha_color(*args, K=K, nf=3, df=5, vf=4, bf16=bf16)
    assert fused_block1_alpha_color.launches == n0 + 1
    ral, rrc = fused_block1_alpha_color_plain(*args, K=K, nf=3, df=5, vf=4,
                                              bf16=bf16)
    torch.testing.assert_close(al, ral, **K2_TOL[bf16])
    torch.testing.assert_close(rc, rrc, **K2_TOL[bf16])
    again = fused_block1_alpha_color(*args, K=K, nf=3, df=5, vf=4, bf16=bf16)
    assert torch.equal(al, again[0]) and torch.equal(rc, again[1])
    if bf16:
        sal, src = _on_k2_rows(*args, K=K)
        assert torch.equal(al, sal)       # K2's tile body, bit for bit
        f32 = fused_block1_alpha_color(*args, K=K, nf=3, df=5, vf=4,
                                       bf16=False)
        _assert_sound_bf16("K4", torch.cat([al, rc], -1),
                           torch.cat([sal, src], -1), torch.cat(f32, -1))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("SR,K", [(24, 8), (5, 8), (3, 8), (8, 4)])
def test_k5_kernel_matches_plain(dev, bf16, SR, K):
    """SR 24: three whole sub-tiles a ray; SR 5: one partial sub-tile; SR 3
    and SR 8 with K 4: several rays a block."""
    n_rays = 37
    feat, d, w, vd, block1, alpha, color = _color_inputs(dev, n_rays * SR, K)
    g = torch.Generator().manual_seed(2)
    ray_dist = (torch.rand(n_rays * SR, generator=g) * 0.5 + 0.02).to(dev)
    ray_valid = (torch.rand(n_rays * SR, generator=g) < 0.8).float().to(dev)
    args = (feat, d, w, vd, ray_dist, ray_valid, block1, alpha, color)
    n0 = fused_block1_alpha_color_march.launches
    got = fused_block1_alpha_color_march(*args, K=K, nf=3, df=5, vf=4, SR=SR,
                                         bf16=bf16)
    assert fused_block1_alpha_color_march.launches == n0 + 1
    ref = fused_block1_alpha_color_march_plain(*args, K=K, nf=3, df=5, vf=4,
                                               SR=SR, bf16=bf16)
    assert got.shape == (n_rays, 4)
    torch.testing.assert_close(got, ref, **K2_TOL[bf16])
    again = fused_block1_alpha_color_march(*args, K=K, nf=3, df=5, vf=4,
                                           SR=SR, bf16=bf16)
    assert torch.equal(got, again)
    if bf16:
        al, rc = fused_block1_alpha_color(feat, d, w, vd, block1, alpha,
                                          color, K=K, nf=3, df=5, vf=4,
                                          bf16=True)
        f32 = fused_block1_alpha_color_march(*args, K=K, nf=3, df=5, vf=4,
                                             SR=SR, bf16=False)
        _assert_sound_bf16("K5", got, march_tail_plain(al, rc, ray_dist,
                                                       ray_valid, SR=SR), f32)


def _tiled_inputs(dev, nt, T, U, n_slots, C=64):
    rows, delta, ok = _knn_inputs(dev, M=nt * U, C=C)
    g = torch.Generator().manual_seed(3)
    slot = torch.randint(0, n_slots, (nt * T,), generator=g,
                         dtype=torch.int32).to(dev)
    okp = (torch.rand(nt * T, generator=g) < 0.85).to(dev)
    _, inv = tile_unique(slot, okp, T, U)
    deltap = (torch.randn(nt * T, 3, generator=g) * 0.02).to(dev)
    return rows, inv, deltap, okp


@pytest.mark.parametrize("U,n_slots,overflow", [(160, 120, False),
                                                (40, 120, True)])
def test_k6_kernel_equals_plain_and_k1(dev, U, n_slots, overflow):
    nt, T = 5, 1536
    rows, inv, delta, ok = _tiled_inputs(dev, nt, T, U, n_slots)
    assert bool(((inv == U) & ok).any()) == overflow
    n0 = fused_knn_select_tiled.launches
    got = fused_knn_select_tiled(rows, inv, delta, ok, 9e-4, C=64, K=8, T=T,
                                 U=U)
    assert fused_knn_select_tiled.launches == n0 + 1
    ref = fused_knn_select_tiled_plain(rows, inv, delta, ok, 9e-4, C=64, K=8,
                                       T=T, U=U)
    assert torch.equal(got, ref)
    tile = torch.arange(nt * T, device=dev) // T
    own = rows[tile * U + inv.clamp(max=U - 1).long()]
    k1 = fused_knn_select(own, delta, ok, 9e-4, C=64, K=8)
    kept = inv < U
    assert torch.equal(got[kept], k1[kept])
    assert (got[~kept] == -1).all()
    assert torch.equal(got, fused_knn_select_tiled(rows, inv, delta, ok, 9e-4,
                                                   C=64, K=8, T=T, U=U))


def test_k4_autograd_backward_matches_plain(dev):
    """K4's backward on CUDA: K2 recompute, the colour tail by autograd,
    K3 — one launch each — against autograd of the plain K4."""
    feat, d, w, vd, block1, alpha, color = _color_inputs(dev, 200, 8)
    leaves = [feat, vd] + [t for l_ in block1 + color for t in l_.values()]
    for t in leaves:
        t.requires_grad_(True)
    n = (fused_block1_alpha_color.launches, fused_block1_alpha.launches,
         fused_block1_alpha_bwd.launches)
    al, rc = fused_block1_alpha_color(feat, d, w, vd, block1, alpha, color,
                                      K=8, nf=3, df=5, vf=4, bf16=False)
    got = torch.autograd.grad((rc ** 2).sum() + 3 * (al ** 2).sum(), leaves)
    assert (fused_block1_alpha_color.launches, fused_block1_alpha.launches,
            fused_block1_alpha_bwd.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    al, rc = fused_block1_alpha_color_plain(feat, d, w, vd, block1, alpha,
                                            color, K=8, nf=3, df=5, vf=4,
                                            bf16=False)
    ref = torch.autograd.grad((rc ** 2).sum() + 3 * (al ** 2).sum(), leaves)
    for i, (a, b) in enumerate(zip(got, ref)):
        err = float((a - b).abs().max())
        assert err <= K3_TOL[False] * float(b.abs().max()) + 1e-7, (i, err)


def test_color_wrappers_refuse_mixed_devices(dev):
    feat, d, w, vd, block1, alpha, color = _color_inputs(dev, 16, 8)
    with pytest.raises(ValueError):
        fused_block1_alpha_color(feat, d, w, vd.cpu(), block1, alpha, color,
                                 K=8, nf=3, df=5, vf=4, bf16=False)
    rows, inv, delta, ok = _tiled_inputs(dev, 1, 64, 16, 40)
    with pytest.raises(ValueError):
        fused_knn_select_tiled(rows, inv.cpu(), delta, ok, 0.0, C=64, K=8,
                               T=64, U=16)


# ROW x itemsize: 16, 80, 128 and 640 B take 16-byte vectors; 6, 20 and 36 B
# the 2- and 4-byte paths
GATHER_ROWS = [(torch.int16, 8), (torch.float32, 20), (torch.int16, 64),
               (torch.int16, 320), (torch.int16, 3), (torch.float32, 5),
               (torch.int16, 18)]


def _gather_inputs(dev, dtype, row, T=3001, shape=(997,)):
    g = torch.Generator(device=dev).manual_seed(row)
    if dtype.is_floating_point:
        table = torch.randn(T, row, generator=g, device=dev).to(dtype)
    else:
        table = torch.randint(-30000, 30000, (T, row), generator=g,
                              device=dev).to(dtype)
    idx = torch.randint(0, T, shape, generator=g, device=dev,
                        dtype=torch.int32)
    return table, idx


@pytest.mark.parametrize("wave", [1, 16, 32])
@pytest.mark.parametrize("dtype,row", GATHER_ROWS)
def test_k7_and_staged_equal_index_select(dev, dtype, row, wave):
    table, idx = _gather_inputs(dev, dtype, row, shape=(31, 33))
    ref = table.index_select(0, idx.reshape(-1).long()).reshape(31, 33, row)
    n = gather_rows_pallas.launches
    got = gather_rows_pallas(table, idx, wave=wave)
    assert gather_rows_pallas.launches == n + 1
    assert torch.equal(got, ref)
    if row * table.element_size() % 16:
        with pytest.raises(ValueError, match="16 bytes"):
            gather_rows_staged(table, idx, wave=wave)
        return
    n = gather_rows_staged.launches
    got = gather_rows_staged(table, idx, wave=wave)
    torch.cuda.synchronize()
    assert gather_rows_staged.launches == n + 1
    assert torch.equal(got, ref)


def test_k7_unaligned_table_takes_the_narrow_path(dev):
    """A table view one element into its storage: no 16-byte vectors."""
    base, idx = _gather_inputs(dev, torch.int16, 64)
    table = base.reshape(-1)[1:1 + 3000 * 64].reshape(3000, 64)
    idx = idx.clamp_max(2999)
    assert torch.equal(gather_rows_pallas(table, idx),
                       table.index_select(0, idx.long()))


def test_k7_backward_is_deterministic_and_matches_index_add(dev):
    table, idx = _gather_inputs(dev, torch.float32, 40, T=500,
                                shape=(20000,))
    g = torch.randn(20000, 40, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    grads = []
    for _ in range(2):
        t = table.clone().requires_grad_(True)
        gather_rows_pallas(t, idx).backward(g)
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])
    ref = torch.zeros_like(table).index_add_(0, idx.long(), g)
    assert float((grads[0] - ref).abs().max()) <= 1e-6 * max(
        1.0, float(ref.abs().max()))
    assert torch.equal(sorted_segment_sum(idx, g, 500), grads[0])
