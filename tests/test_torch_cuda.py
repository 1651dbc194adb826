"""Kernels K1-K7 against their plain PyTorch versions on the card, and
the MVS nets (MVSNet's depth inference, one feed-forward step) on the card
against the port's CPU forward.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(CUDA kernels have no CPU mode). On a machine with a card:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
(`tests/conftest.py` sets up jax, which this file does not use.)
The binding comparison at the main path's shapes is chip_smoke.py's
phases 5, 7, 12 and 14; these run the same checks at small shapes (odd M,
masked rows, K and SR that do not divide the kernels' tiles), plus
determinism and the wrappers' refusals."""
import dataclasses

import numpy as np
import pytest
import torch

from sgnerf_tpu_torch.ops.fused_agg import (
    fused_block1_alpha, fused_block1_alpha_bwd, fused_block1_alpha_bwd_plain,
    fused_block1_alpha_color, fused_block1_alpha_color_march,
    fused_block1_alpha_color_march_plain, fused_block1_alpha_color_plain,
    fused_block1_alpha_plain, color_head_hidden, color_head_plain,
    color_tail_on_roundings, fused_color_head, fused_color_head_resources,
    k3a_recompute, sum_error_units, _bf16,
    k3a_recompute_plain, k3b_data_grads, k3b_data_grads_plain,
    k3c_weight_grads, k3c_weight_grads_plain, k2_supports, k3_supports,
    k4_supports, march_tail_plain)
from sgnerf_tpu_torch.ops.pallas_gather import (gather_rows_pallas,
                                                gather_rows_staged,
                                                sorted_segment_sum)
from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_resources,
                                            fused_knn_select,
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


def _knn_inputs(dev, M=1000, C=64, lattice=False):
    """Planar bf16 rows with duplicated offsets, padding ids, a row with no
    valid id and slots that are not ok. lattice: offsets and deltas on a
    grid of 2^-6, so many candidates share a d2 (within a row and across
    the kernel's lanes)."""
    rng = np.random.default_rng(M + C)
    if lattice:
        off = rng.integers(-3, 4, size=(M, C, 3)).astype(np.float32) / 64
        dlt = rng.integers(-2, 3, size=(M, 3)).astype(np.float32) / 64
    else:
        off = rng.normal(scale=0.02, size=(M, C, 3)).astype(np.float32)
        dlt = rng.normal(scale=0.02, size=(M, 3)).astype(np.float32)
    off[:, 1::7] = off[:, 0:1]
    pid = rng.integers(0, 1 << 30, size=(M, C)).astype(np.int32)
    pid[:, 2::5] = -1
    if M > 2:
        pid[M // 2] = -1
    xi = torch.from_numpy(off).to(torch.bfloat16).view(torch.int16)
    pi = torch.from_numpy(pid).view(torch.int16).reshape(M, C, 2)
    rows = torch.cat([xi.movedim(-1, -2).reshape(M, -1),
                      pi.movedim(-1, -2).reshape(M, -1)], dim=-1)
    ok = torch.from_numpy(rng.random(M) < 0.9)
    return rows.to(dev), torch.from_numpy(dlt).to(dev), ok.to(dev)


# every K bucket edge of the select (its lists hold N = ceil(C/8) keys a
# lane whatever K is) at C of 1, 24, 63 and 64 (64: the 16-byte path)
KNN_KC = [(K, C) for C in (1, 24, 63, 64) for K in (1, 7, 8, 9, 16, 33, 64)
          if K <= C]


@pytest.mark.parametrize("K,C", KNN_KC)
@pytest.mark.parametrize("lattice", [False, True])
def test_k1_kernel_equals_plain(dev, lattice, K, C):
    """Ids bit-equal to the plain K1 at M of 1, 7 and 1001 (one point, part
    of a warp, an odd M past a block of 32 points), with r2 on and off, on
    rows with ties; an unaligned row table (the scalar path at C = 64);
    a rerun gives the same bits."""
    for M in (1, 7, 1001):
        rows, delta, ok = _knn_inputs(dev, M=M, C=C, lattice=lattice)
        for r2 in (9e-4, 0.0):
            n0 = fused_knn_select.launches
            got = fused_knn_select(rows, delta, ok, r2, C=C, K=K)
            assert fused_knn_select.launches == n0 + 1
            ref = fused_knn_select_plain(rows, delta, ok, r2, C=C, K=K)
            assert torch.equal(got, ref), (M, r2, int((got != ref).sum()))
            assert M <= 2 or (got[M // 2] == -1).all()
            assert torch.equal(got, fused_knn_select(rows, delta, ok, r2,
                                                     C=C, K=K))
    # a row table 2 bytes past a 16-byte boundary
    buf = torch.empty(rows.numel() + 1, dtype=torch.int16, device=dev)
    shifted = buf[1:].view(rows.shape)
    shifted.copy_(rows)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(fused_knn_select(shifted, delta, ok, 0.0, C=C, K=K),
                       fused_knn_select_plain(rows, delta, ok, 0.0, C=C,
                                              K=K))


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
# bf16 roundings of product inputs (bf16). K3 is the gradient of the
# forward that ran: the plain K3 takes K3a's LeakyReLU branch where its
# own recompute lies on the other one (chip_smoke.py K3_TOL)
K3_TOL = {False: 2e-3, True: 3e-2}


def _flat(grads):
    dfeat, dd, dw, dblock1, dalpha = grads
    return [dfeat, dd, dw] + [t for l_ in dblock1 + dalpha
                              for t in (l_["w"], l_["b"])]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,K,n_layers,C,F,Dd,masked", [
    (501, 8, 2, 256, 32, 6, False),   # canonical widths, a ragged last tile
    (77, 3, 1, 256, 32, 6, False),    # K not dividing the tiles
    (300, 8, 3, 256, 32, 6, False),   # 3 layers; 2 slabs, the last partial
    (1, 8, 2, 256, 32, 6, False),     # M = 1: one ragged tile and slab
    (130, 8, 2, 256, 32, 6, True),    # every w = 0
    (600, 8, 2, 256, 32, 6, False),   # 3 slabs of K3c, the last partial
    (200, 8, 2, 32, 8, 3, False),     # 86-deep first layer, C = 32, one dx pass
    (130, 16, 2, 160, 16, 6, False),  # 172-deep first layer, C = 160
])
def test_k3_kernel_matches_plain(dev, bf16, M, K, n_layers, C, F, Dd, masked):
    """Odd M (a ragged last tile), masked rows (w = 0), K = 3 not dividing
    the tiles, 1-3 block1 layers, M = 1, all of w masked, and K3c's last
    split-K slab partial; narrower widths take one dx product."""
    feat, d, w, block1, alpha = _agg_inputs(dev, M=M, K=K, n_layers=n_layers,
                                            C=C, F=F, Dd=Dd)
    w = w * _masks(w.shape, dev, seed=M) * (0.0 if masked else 1.0)
    g = torch.randn(M, C + 1, device=dev)
    n0 = fused_block1_alpha_bwd.launches
    got = _flat(fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, K=K,
                                       nf=3, df=5, bf16=bf16))
    assert fused_block1_alpha_bwd.launches == n0 + 1
    hs_k = k3a_recompute(feat, d, block1, alpha, nf=3, df=5, bf16=bf16)[1]
    ref = _flat(fused_block1_alpha_bwd_plain(feat, d, w, block1, alpha, g,
                                             K=K, nf=3, df=5, bf16=bf16,
                                             branches=hs_k))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        err = float((a - b).abs().max())
        assert err <= K3_TOL[bf16] * float(b.abs().max()) + 1e-7, (i, err)


# K3's launches vs their plain statements, on the same inputs: K3a's saved
# activations (f32: K2's 3xTF32 error; bf16: a flipped bf16 rounding), K3b's
# data gradients (K3_TOL, as K3), K3c's weight gradients (IEEE f32 products
# of the same operands on both sides: the summation order only)
K3A_TOL = {False: dict(atol=1e-4, rtol=1e-4), True: dict(atol=2e-2, rtol=1e-2)}
K3C_TOL = 1e-5


def _k3_inputs(dev, M, K=8, n_layers=2, seed=0):
    feat, d, w, block1, alpha = _agg_inputs(dev, M=M, K=K, n_layers=n_layers)
    w = w * _masks(w.shape, dev, seed=seed)
    C = block1[0]["w"].shape[1]
    g = torch.randn(M, C + 1, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    return feat, d, w, block1, alpha, g


def _rel_errs(got, ref):
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(got, ref)]


@pytest.mark.parametrize("bf16", [False, True])
def test_k3a_kernel_matches_plain_and_k2(dev, bf16):
    """K3a's x, h and raw against the plain recompute; and its last h,
    weighted and summed over K in order as K2 sums it, equals K2's
    features bit for bit (K3a runs K2's tile body: the backward reads the
    forward's activations)."""
    M, K = 301, 8
    feat, d, w, block1, alpha, _ = _k3_inputs(dev, M)
    kw = dict(nf=3, df=5, bf16=bf16)
    got = k3a_recompute(feat, d, block1, alpha, **kw)
    ref = k3a_recompute_plain(feat, d, block1, alpha, **kw)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0.0)
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, **K3A_TOL[bf16])
    fa, _ = fused_block1_alpha(feat, d, w, block1, alpha, K=K, **kw)
    hw = got[1][-1].view(M, K, -1) * w[..., None]
    s = torch.zeros_like(fa)
    for k in range(K):
        s = s + hw[:, k]
    assert torch.equal(s, fa)


@pytest.mark.parametrize("bf16", [False, True])
def test_k3b_kernel_matches_plain(dev, bf16):
    """K3b on the plain K3a's activations: d_feat, d_d, d_w, every dh and
    the sum of its tile partials of [dwa | dba] against the plain chain."""
    M, K = 301, 8
    feat, d, w, block1, alpha, g = _k3_inputs(dev, M, n_layers=3, seed=1)
    x, hs, raw = k3a_recompute_plain(feat, d, block1, alpha, nf=3, df=5,
                                     bf16=bf16)
    kw = dict(K=K, nf=3, df=5, F=feat.shape[-1], bf16=bf16)
    got = list(k3b_data_grads(x, hs, raw, w, g, block1, alpha, **kw))
    ref = list(k3b_data_grads_plain(x, hs, raw, w, g, block1, alpha, **kw))
    assert got[4].shape[0] == -(-M * K // (128 if bf16 else 64))
    got[4], ref[4] = got[4].sum(0), ref[4].sum(0)
    rel = _rel_errs(got, ref)
    assert max(rel) <= K3_TOL[bf16], rel


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("N,in0,C,L", [(4100, 284, 256, 2), (1000, 86, 32, 3),
                                       (37, 172, 160, 1)])
def test_k3c_kernel_matches_plain(dev, bf16, N, in0, C, L):
    """K3c on seeded operands: 3 slabs (the last partial), first-layer
    depths not a multiple of the 128-row output tile or of 4, one slab of
    37 rows."""
    gen = torch.Generator(device=dev).manual_seed(N)
    x = torch.randn(N, in0, device=dev, generator=gen)
    hs = torch.randn(L, N, C, device=dev, generator=gen)
    dhs = torch.randn(L, N, C, device=dev, generator=gen)
    part = torch.randn(5, C + 1, device=dev, generator=gen)
    got = k3c_weight_grads(x, hs, dhs, part, bf16=bf16)
    ref = k3c_weight_grads_plain(x, hs, dhs, part, bf16=bf16)
    err = float((got - ref).abs().max())
    assert err <= K3C_TOL * float(ref.abs().max()), err


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
# (K4's first launch is K2's kernel) and K5 vs the plain march on K4's
# outputs (chip_smoke.py COLOR_SOUND_TOL): the plain head takes the
# kernel's hidden bf16 roundings where the tensor cores' and cuBLAS's f32
# sums put a midpoint (or LeakyReLU's kink) between them
# (color_tail_on_roundings refuses unrounded hidden values, more flips than
# FLIP_SHARE, and a flip past FLIP_BOUND units of the sums' error); then
# only the last layer's summation order (K4) and the march's exp (K5) are
# left. Each limit lies below the kernel's bf16-vs-f32 gap, which
# K2_TOL[True] does not.
COLOR_SOUND_TOL = {"K4": 2e-3, "K5": 1e-6}


def _on_roundings(red, vd, color, vf=4):
    """bf16: the colour launch on red (M, C+1) with its hidden values, and
    the plain colour head taking its flipped roundings (every flip checked)
    -> (the launch's (M, 4), the plain (M, 4) [alpha | logits])."""
    C = red.shape[1] - 1
    head, hid = color_head_hidden(red, vd, color, vf=vf, bf16=True)
    logits, _, _ = color_tail_on_roundings(red[:, :C], vd, color, hid,
                                           vf=vf)
    return head, torch.cat([red[:, C:], logits], -1)


def _on_k2_rows(feat, d, w, vd, block1, alpha, color, K):
    """bf16: K2 kernel, then _on_roundings on its reduced rows -> (the
    colour launch's (M, 4), the plain head's (M, 4))."""
    fa, al = fused_block1_alpha(feat, d, w, block1, alpha, K=K, nf=3, df=5,
                                bf16=True)
    return _on_roundings(torch.cat([fa, al], -1), vd, color)


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


# (M, K, colour layers, hidden width): the canonical head, a 1-layer head,
# heads of 8, 32 and 256 columns (256: f32 splits a 64-point tile by
# columns), M ragged across a 128-point tile, K past 32 (K2's range)
K4_SHAPES = [(501, 8, 4, 128), (77, 3, 1, 128), (129, 8, 2, 8),
             (300, 4, 3, 32), (257, 8, 4, 256), (200, 2, 4, 128),
             (150, 33, 2, 128)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,K,n_layers,Nh", K4_SHAPES)
def test_k4_kernel_matches_plain(dev, bf16, M, K, n_layers, Nh):
    args = _color_inputs(dev, M, K, Nh=Nh, n_layers=n_layers)
    n0 = (fused_block1_alpha_color.launches, fused_block1_alpha.launches)
    al, rc = fused_block1_alpha_color(*args, K=K, nf=3, df=5, vf=4, bf16=bf16)
    # K2's launch inside K4 counts under K4 only
    assert (fused_block1_alpha_color.launches,
            fused_block1_alpha.launches) == (n0[0] + 1, n0[1])
    ral, rrc = fused_block1_alpha_color_plain(*args, K=K, nf=3, df=5, vf=4,
                                              bf16=bf16)
    torch.testing.assert_close(al, ral, **K2_TOL[bf16])
    torch.testing.assert_close(rc, rrc, **K2_TOL[bf16])
    again = fused_block1_alpha_color(*args, K=K, nf=3, df=5, vf=4, bf16=bf16)
    assert torch.equal(al, again[0]) and torch.equal(rc, again[1])
    if bf16:
        head, ref = _on_k2_rows(*args, K=K)
        # K2's rows and the colour launch, bit for bit
        assert torch.equal(torch.cat([al, rc], -1), head)
        f32 = fused_block1_alpha_color(*args, K=K, nf=3, df=5, vf=4,
                                       bf16=False)
        _assert_sound_bf16("K4", head, ref, torch.cat(f32, -1))


# (SR, K, hidden width): several rays a tile (SR 1, 3, 5, 8, 24), a ray
# longer than a tile (SR 200), and the f32 64-point tiles of a 256-wide
# head (SR 100: two sub-tiles a ray there, one in bf16)
K5_SHAPES = [(24, 8, 128), (5, 8, 128), (3, 8, 128), (8, 4, 128),
             (1, 8, 128), (200, 4, 128), (100, 4, 256)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("SR,K,Nh", K5_SHAPES)
def test_k5_kernel_matches_plain(dev, bf16, SR, K, Nh):
    """Whole rays a tile, the last tile partial (37 rays), and rays walked
    across tiles carrying their transmission."""
    n_rays = 37
    feat, d, w, vd, block1, alpha, color = _color_inputs(dev, n_rays * SR, K,
                                                         Nh=Nh)
    g = torch.Generator().manual_seed(2)
    ray_dist = (torch.rand(n_rays * SR, generator=g) * 0.5 + 0.02).to(dev)
    ray_valid = (torch.rand(n_rays * SR, generator=g) < 0.8).float().to(dev)
    args = (feat, d, w, vd, ray_dist, ray_valid, block1, alpha, color)
    n0 = (fused_block1_alpha_color_march.launches,
          fused_block1_alpha.launches)
    got = fused_block1_alpha_color_march(*args, K=K, nf=3, df=5, vf=4, SR=SR,
                                         bf16=bf16)
    assert (fused_block1_alpha_color_march.launches,
            fused_block1_alpha.launches) == (n0[0] + 1, n0[1])
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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,n_layers,Nh,SR", [
    (1000, 4, 128, 0), (131, 1, 3, 0), (200, 3, 256, 0), (64, 2, 8, 0),
    (37 * 24, 4, 128, 24), (3 * 300, 2, 256, 300)])
def test_color_head_kernel_matches_plain(dev, bf16, M, n_layers, Nh, SR):
    """The colour launch alone against color_tail_plain (and, with SR,
    march_tail_plain) on the same reduced rows: the alpha column copied
    bit for bit; f32 within K2_TOL[False] (3xTF32 against IEEE f32
    products), bf16 within COLOR_SOUND_TOL["K4"] of the plain head taking
    its flipped hidden roundings (_on_roundings); the march within
    COLOR_SOUND_TOL["K5"] of the plain march on the head's own logits;
    reruns bit-identical."""
    g = torch.Generator().manual_seed(M + Nh)
    C, vf = 256, 4
    red = torch.cat([torch.randn(M, C, generator=g) * 0.5,
                     torch.rand(M, 1, generator=g) * 3], -1).to(dev)
    vd = torch.randn(M, 3, generator=g)
    vd = (vd / vd.norm(dim=-1, keepdim=True)).to(dev)
    sizes = [C + 6 * vf] + [Nh] * (n_layers - 1) + [3]
    color = [{"w": (torch.randn(i, o, generator=g) * (2.0 / (i + o)) ** 0.5
                    ).to(dev),
              "b": (torch.randn(o, generator=g) * 0.05).to(dev)}
             for i, o in zip(sizes[:-1], sizes[1:])]
    n0 = fused_color_head.launches
    head = fused_color_head(red, vd, color, vf=vf, bf16=bf16)
    assert fused_color_head.launches == n0 + 1
    assert head.shape == (M, 4)
    assert torch.equal(head[:, 0], red[:, C])
    if bf16:
        saved, ref = _on_roundings(red, vd, color, vf=vf)
        assert torch.equal(saved, head)
        torch.testing.assert_close(head, ref, atol=COLOR_SOUND_TOL["K4"],
                                   rtol=0.0)
    else:
        torch.testing.assert_close(
            head, color_head_plain(red, vd, color, vf=vf, bf16=False),
            **K2_TOL[False])
    assert torch.equal(head, fused_color_head(red, vd, color, vf=vf,
                                              bf16=bf16))
    if SR:
        rd = (torch.rand(M, generator=g) * 0.5 + 0.02).to(dev)
        rv = (torch.rand(M, generator=g) < 0.8).float().to(dev)
        got = fused_color_head(red, vd, color, vf=vf, bf16=bf16,
                               march=(rd, rv, SR))
        assert got.shape == (M // SR, 4)
        torch.testing.assert_close(
            got, march_tail_plain(head[:, :1], head[:, 1:], rd, rv, SR=SR),
            atol=COLOR_SOUND_TOL["K5"], rtol=0.0)


@pytest.mark.parametrize("M,Nh", [(1000, 128), (300, 256), (517, 32)])
def test_color_head_sums_within_their_error_bound(dev, M, Nh):
    """FLIP_BOUND's basis, measured: the bf16 head's last layer, its saved
    hidden values (bf16) times the bf16 logit weights summed on the tensor
    cores, lies within 2 units of n 2^-24 sum |x w| of the float64 sums
    (rounded toward zero), and cuBLAS's f32 sums of the same products
    within 1 (to nearest)."""
    g = torch.Generator().manual_seed(M)
    C, vf = 256, 4
    red = torch.cat([torch.randn(M, C, generator=g) * 0.5,
                     torch.rand(M, 1, generator=g) * 3], -1).to(dev)
    vd = torch.randn(M, 3, generator=g)
    vd = (vd / vd.norm(dim=-1, keepdim=True)).to(dev)
    sizes = [C + 6 * vf, Nh, Nh, 3]
    color = [{"w": (torch.randn(i, o, generator=g) * (2.0 / (i + o)) ** 0.5
                    ).to(dev),
              "b": (torch.randn(o, generator=g) * 0.05).to(dev)}
             for i, o in zip(sizes[:-1], sizes[1:])]
    head, hid = color_head_hidden(red, vd, color, vf=vf, bf16=True)
    x, w, b = hid[-1], _bf16(color[-1]["w"]), color[-1]["b"]
    assert sum_error_units(head[:, 1:], x, w, b) <= 2.0
    assert sum_error_units(x @ w + b, x, w, b) <= 1.0


def test_color_head_resources(dev):
    """The colour head's block at the canonical head: blocks of 256
    threads within 227 KB, two an SM in bf16 (128 registers a thread,
    half the SM's shared memory each), one in f32; one in bf16 at a head
    256 wide."""
    for bf16 in (False, True):
        res = fused_color_head_resources(256, 4, 128, 4, bf16, dev)
        assert res["blocks_per_sm"] == (2 if bf16 else 1), res
        assert 0 < res["smem_bytes"] <= 232448, res
        assert 0 < res["registers"] <= (128 if bf16 else 255), res
    res = fused_color_head_resources(256, 4, 256, 4, True, dev)
    assert res["blocks_per_sm"] == 1, res


def _tiled_inputs(dev, nt, T, U, n_slots, C=64):
    rows, delta, ok = _knn_inputs(dev, M=nt * U, C=C)
    g = torch.Generator().manual_seed(3)
    slot = torch.randint(0, n_slots, (nt * T,), generator=g,
                         dtype=torch.int32).to(dev)
    okp = (torch.rand(nt * T, generator=g) < 0.85).to(dev)
    _, inv = tile_unique(slot, okp, T, U)
    deltap = (torch.randn(nt * T, 3, generator=g) * 0.02).to(dev)
    return rows, inv, deltap, okp


@pytest.mark.parametrize("U,n_slots,T,overflow", [
    (160, 120, 1536, False),     # the eval chunk's T and cap
    (40, 120, 1536, True),       # tiles past the cap
    (1, 30, 100, True),          # one row a tile; T not a block's multiple
    (160, 120, 100, False),
    (363, 300, 700, False),      # the largest U the select takes at C = 64
])
def test_k6_kernel_equals_plain_and_k1(dev, U, n_slots, T, overflow):
    """Ids bit-equal to the plain K6 and to K1 on each point's own row
    inside its tile's cap (-1 past it), a rerun the same bits; then with
    tile 0 wholly overflowed (inv == U on every point): -1 there."""
    nt = 5
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
    inv[:T] = U
    got = fused_knn_select_tiled(rows, inv, delta, ok, 9e-4, C=64, K=8, T=T,
                                 U=U)
    assert (got[:T] == -1).all()
    assert torch.equal(got, fused_knn_select_tiled_plain(
        rows, inv, delta, ok, 9e-4, C=64, K=8, T=T, U=U))


@pytest.mark.parametrize("K,C", [(1, 1), (9, 24), (33, 63), (64, 64)])
def test_k6_kernel_takes_every_k_and_c(dev, K, C):
    """K6's scalar paths (C below 64) and the K edges, at the largest U the
    select takes at that C (U rows of 10 C bytes within 232,448 bytes of
    shared memory, as before the redesign); one row more is refused with
    a ValueError before any launch."""
    U, T, nt = 232448 // (10 * C), 300, 3
    rows, inv, delta, ok = _tiled_inputs(dev, nt, T, U, 2 * U, C=C)
    got = fused_knn_select_tiled(rows, inv, delta, ok, 0.0, C=C, K=K, T=T,
                                 U=U)
    assert torch.equal(got, fused_knn_select_tiled_plain(
        rows, inv, delta, ok, 0.0, C=C, K=K, T=T, U=U))
    n0 = fused_knn_select_tiled.launches
    with pytest.raises(ValueError):
        fused_knn_select_tiled(torch.zeros(nt * (U + 1), 5 * C,
                                           dtype=torch.int16, device=dev),
                               inv, delta, ok, 0.0, C=C, K=K, T=T, U=U + 1)
    assert fused_knn_select_tiled.launches == n0


def test_knn_resources(dev):
    """K1's and K6's registers, shared memory and blocks an SM at the eval
    chunk's C = 64 and U = 160: K6 holds its tile, K1 has no shared
    memory, neither spills past what fits a block."""
    res = fused_knn_resources(64, 160, dev)
    assert res["K1"]["smem_bytes"] == 0
    assert res["K6"]["smem_bytes"] >= 160 * 640
    assert res["K1"]["blocks_per_sm"] >= 1 and res["K6"]["blocks_per_sm"] >= 1
    assert 0 < res["K1"]["registers"] <= 255


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


# ---- K2's f32 mode and K3 against the JAX tests' own tolerances
# (tests/test_fused_agg.py), at those tests' input laws and shapes. The
# weights come from the port's seeded init (the same law as the JAX init;
# the card's machine has no jax). The plain side runs IEEE f32 products:
# the `dev` fixture turns TF32 off for cuBLAS.


def _jax_test_agg_inputs(dev, seed, B=1, R=7, SR=5, K=8, F=32):
    """tests/test_fused_agg.py `_agg_inputs`: the same draws in the same
    order, as the port's aggregate() keywords (it takes no colour,
    direction or label inputs; their draws are made and dropped)."""
    rng = np.random.default_rng(seed)

    def mk(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    mask = torch.from_numpy(rng.random((B, R, SR, K)) < 0.5)
    emb = mk((B, R, SR, K, F)) * 0.2
    mk((B, R, SR, K, 3)), mk((B, R, SR, K, 3))       # colour, direction
    kw = dict(sampled_embedding=emb,
              sampled_conf=mk((B, R, SR, K, 1)).abs(),
              sampled_xyz=mk((B, R, SR, K, 3)),
              sampled_xyz_pers=mk((B, R, SR, K, 3)),
              sample_pnt_mask=mask,
              sample_loc=mk((B, R, SR, 3)),
              sample_loc_w=mk((B, R, SR, 3)),
              sample_ray_dirs=mk((B, R, SR, 3)))
    kw = {k: v.to(dev) for k, v in kw.items()}
    kw.update(Rw2c=None, vsize=(0.008,) * 3)
    return kw


def _agg_cfgs():
    from sgnerf_tpu_torch.models.aggregator import AggregatorConfig
    cfg = AggregatorConfig()
    return cfg, dataclasses.replace(cfg, fused_mlp="cuda")


def test_k2_f32_meets_the_jax_block_tolerances(dev):
    """F9, test_fused_agg.py::test_fused_pads_nonmultiple_rows's inputs
    (M = 35, d * 0.01): features within 3e-5 and alpha within 3e-6 of the
    IEEE f32 statement."""
    from sgnerf_tpu_torch.models.aggregator import init_aggregator_params
    cfg, _ = _agg_cfgs()
    rng = np.random.default_rng(2)
    M, K, F = 35, 8, 32
    feat = torch.from_numpy(rng.normal(size=(M, K, F)).astype(np.float32)) * 0.2
    d = torch.from_numpy(rng.normal(size=(M, K, 6)).astype(np.float32)) * 0.01
    w = torch.from_numpy(rng.random((M, K)).astype(np.float32))
    p = init_aggregator_params(3, cfg, device=dev)
    args = (feat.to(dev), d.to(dev), w.to(dev), p["block1"], p["alpha_branch"])
    kw = dict(K=K, nf=cfg.num_feat_freqs, df=abs(cfg.dist_xyz_freq),
              bf16=False)
    fa, al = fused_block1_alpha(*args, **kw)
    rfa, ral = fused_block1_alpha_plain(*args, **kw)
    e_fa, e_al = (float((a - b).abs().max()) for a, b in ((fa, rfa),
                                                          (al, ral)))
    print(f"F9 K2 f32: features {e_fa:.3e} (limit 3e-5), alpha {e_al:.3e} "
          "(limit 3e-6)")
    assert e_fa <= 3e-5 and e_al <= 3e-6, (e_fa, e_al)


def test_aggregate_f32_kernel_meets_the_jax_forward_tolerance(dev):
    """F9, test_fused_agg.py::test_fused_matches_xla_forward's inputs:
    aggregate()'s decoded output through K2 within 3e-6 of the un-fused
    path, ray_valid equal."""
    from sgnerf_tpu_torch.models.aggregator import (aggregate,
                                                    init_aggregator_params)
    cfg, fused = _agg_cfgs()
    kw = _jax_test_agg_inputs(dev, 0)
    p = init_aggregator_params(0, cfg, device=dev)
    n0 = fused_block1_alpha.launches
    got = aggregate(p, fused, **kw)
    assert fused_block1_alpha.launches == n0 + 1
    ref = aggregate(p, cfg, **kw)
    err = float((got[0] - ref[0]).abs().max())
    print(f"F9 aggregate f32: decoded {err:.3e} (limit 3e-6)")
    assert torch.equal(got[1], ref[1])
    assert err <= 3e-6, err


def _agg_grads(p, cfg, kw):
    """aggregate()'s decoded output, and the gradients of sum(decoded^2)
    for every parameter and the embedding."""
    from sgnerf_tpu_torch.models.aggregator import aggregate
    emb = kw["sampled_embedding"].clone().requires_grad_(True)
    ts = [t.detach().clone().requires_grad_(True)
          for v in p.values() for l_ in v for t in l_.values()]
    it = iter(ts)
    params = {k: [{n: next(it) for n in l_} for l_ in v]
              for k, v in p.items()}
    dec = aggregate(params, cfg, **dict(kw, sampled_embedding=emb))[0]
    return dec.detach(), torch.autograd.grad((dec ** 2).sum(), ts + [emb])


def test_k3_f32_meets_the_jax_gradient_tolerance(dev):
    """test_fused_agg.py::test_fused_gradients_match_xla's inputs (rng 1,
    R = 3, SR = 4), loss sum(decoded^2): the gradients of every parameter
    and of the embedding through K2 + K3 within atol 1e-5 of the un-fused
    path's."""
    from sgnerf_tpu_torch.models.aggregator import (aggregate,
                                                    init_aggregator_params)
    cfg, fused = _agg_cfgs()
    kw = _jax_test_agg_inputs(dev, 1, R=3, SR=4)
    p = init_aggregator_params(0, cfg, device=dev)
    n0 = fused_block1_alpha_bwd.launches
    got = _agg_grads(p, fused, kw)[1]
    assert fused_block1_alpha_bwd.launches == n0 + 1
    ref = _agg_grads(p, cfg, kw)[1]
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    print(f"K3 f32 at test_fused_gradients_match_xla's inputs: max |diff| "
          f"{err:.3e} (limit 1e-5)")
    assert err <= 1e-5, err


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("K", [1, 2, 33])
def test_gate_runs_every_k_and_matches_the_unfused_path(dev, bf16, K):
    """F8: --fused_mlp with --fused_color on at K 1, 2 and 33. The gate
    picks K4 at each (K4 runs K2's kernel, then the colour head on its
    rows: K2's range, K <= 64); forward and backward run and match the
    un-fused path (K2's and K3's tolerances)."""
    from sgnerf_tpu_torch.models.aggregator import (AggregatorConfig,
                                                    init_aggregator_params)
    cfg = AggregatorConfig(compute_dtype="bfloat16" if bf16 else "float32")
    fused = dataclasses.replace(cfg, fused_mlp="cuda", fused_color=True)
    kw = _jax_test_agg_inputs(dev, 3, R=6, SR=4, K=K)
    p = init_aggregator_params(0, cfg, device=dev)
    k4 = k4_supports(K=K, F=32, Dd=6, nf=3, df=5, C=256, bf16=bf16, vf=4,
                     Nh=128, n_clayers=4, device=dev)
    assert k4
    n = (fused_block1_alpha_color.launches, fused_block1_alpha.launches,
         fused_block1_alpha_bwd.launches)
    dec, got = _agg_grads(p, fused, kw)
    # K4's backward re-runs K2 for the reduced features
    assert (fused_block1_alpha_color.launches - n[0],
            fused_block1_alpha.launches - n[1],
            fused_block1_alpha_bwd.launches - n[2]) == (int(k4), 1, 1)
    rdec, ref = _agg_grads(p, cfg, kw)
    torch.testing.assert_close(dec, rdec, **K2_TOL[bf16])
    rel = _rel_errs(got, ref)
    assert max(rel) <= K3_TOL[bf16], rel


@pytest.mark.parametrize("bf16", [False, True])
def test_k4_block_fits_at_the_canonical_widths(dev, bf16):
    """The library's shared-memory query, as the gate asks it: K4 and K5
    are K2's launch and then the colour head's, so they take every K that
    K2 takes (1-64) at the canonical widths, K5 at SR 24; the head's block
    fits at every hidden width to 256; K2's and K3's at every K the gate
    sends them."""
    canon = dict(F=32, Dd=6, nf=3, df=5, C=256, bf16=bf16, device=dev)
    head = dict(vf=4, Nh=128, n_clayers=4)
    fits = [K for K in range(1, 70) if k4_supports(K=K, **canon, **head)]
    assert fits == list(range(1, 65))
    assert k4_supports(K=8, SR=24, **canon, **head)
    for Nh in (3, 8, 32, 129, 256):
        assert k4_supports(K=8, **canon, **dict(head, Nh=Nh))
    assert not k4_supports(K=8, **canon, **dict(head, Nh=257))
    for K in (1, 2, 8, 33, 64):
        assert k2_supports(K=K, **canon) and k3_supports(K=K, **canon)


# ------------------------------------------------ the semantic branch's BPNet
# No hand-written kernel: the sparse convolutions are gathers and
# torch.matmul, the 2D branch cuDNN. The card's f32 (TF32 off) against the
# CPU's: the same products summed in other orders.

def _sparse_grid_inputs(n=3000, box=40, c=24, seed=3):
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, box, size=(n, 3)), axis=0).astype(
        np.int32)
    return coords, rng.normal(size=(len(coords), c)).astype(np.float32), \
        (box,) * 3


@pytest.mark.parametrize("k", [2, 3, 5])
def test_sparse_conv_on_the_card_matches_the_cpu(dev, k):
    from sgnerf_tpu_torch.ops.sparse import (make_sparse_grid, sparse_conv,
                                             sparse_conv_down, sparse_conv_up)
    torch.backends.cudnn.allow_tf32 = False
    coords, feats, dims = _sparse_grid_inputs()
    w = torch.from_numpy(np.random.default_rng(k).normal(
        size=(k ** 3, 24, 16)).astype(np.float32) * 0.1)
    outs = []
    for d in (dev, torch.device("cpu")):
        g = make_sparse_grid(torch.as_tensor(coords, device=d),
                             torch.as_tensor(feats, device=d), dims)
        if k == 2:
            c, f = sparse_conv_down(g, w.to(d), g.M)
            up = sparse_conv_up(c, g.coords, g.mask,
                                w.to(d).transpose(1, 2).contiguous())
            outs.append((c.coords.cpu(), c.mask.cpu(), f.cpu(), up.cpu()))
        else:
            outs.append((sparse_conv(g, w.to(d), kernel_size=k).cpu(),))
    for a, b in zip(*outs):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bpnet_forward_on_the_card_matches_the_cpu(dev, dtype):
    """A small BPNet forward (64x48, 2 views, ~700 voxels): f32 on the card
    against the CPU, features within 1e-4 of their largest magnitude and
    probabilities within 1e-3 (the seeded weights drive the logits to
    ~1e3: a reordered f32 sum moves a near-tied probability by ~1e-4;
    1.1e-4 measured, 1e-4 was set before the first reading); bf16 on the
    card agrees with the CPU's f32 labels on > 95% of voxels."""
    from sgnerf_tpu_torch.models.bpnet.bpnet import (BPNetConfig,
                                                     bpnet_forward,
                                                     init_bpnet_params,
                                                     map_tensors)
    from sgnerf_tpu_torch.ops.sparse import make_sparse_grid
    torch.backends.cudnn.allow_tf32 = False
    cfg = BPNetConfig(view_num=2, img_wh=(64, 48))
    params = init_bpnet_params(torch.Generator().manual_seed(0), cfg)
    coords, feats, dims = _sparse_grid_inputs(n=800, box=24, c=3, seed=4)
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, 48, 64, 3)).astype(np.float32)
    links = np.zeros((len(coords), 4, 2), np.int32)
    links[:, 1] = rng.integers(0, 48, size=(len(coords), 2))
    links[:, 2] = rng.integers(0, 64, size=(len(coords), 2))
    links[:, 3] = 1
    m = len(coords)
    outs = []
    for d, dt in ((dev, dtype), (torch.device("cpu"), "float32")):
        g = make_sparse_grid(torch.as_tensor(coords, device=d),
                             torch.as_tensor(feats, device=d), dims)
        with torch.no_grad():
            o = bpnet_forward(
                map_tensors(lambda t: t.to(d), params),
                dataclasses.replace(cfg, compute_dtype=dt), g,
                torch.as_tensor(imgs, device=d),
                torch.as_tensor(links, device=d), (m, m, m, m))
        outs.append([t.cpu() for t in o])
    (gs, gl, gf), (cs, cl, cf) = outs
    assert gs.dtype == torch.float32 and torch.isfinite(gf).all()
    if dtype == "float32":
        torch.testing.assert_close(gs, cs, atol=1e-3, rtol=0)
        assert (gf - cf).abs().max() <= 1e-4 * cf.abs().max().clamp(min=1)
    else:
        agree = (gs.argmax(-1) == cs.argmax(-1)).float().mean().item()
        assert agree > 0.95, agree


# ------------------------------------ the aggregator variants, the perspective
# path: no kernel of their own (the reference's gate keeps the variants
# un-fused); one chunk on the card against the same on the CPU, f32 with
# TF32 off: the same products summed in other orders.
AGG_VARIANTS = {
    "block2": dict(shading_feature_mlp_layer2=2),
    "block3": dict(shading_feature_mlp_layer3=2),
    "bpnet_block3": dict(shading_feature_mlp_layer2_bpnet=1,
                         predict_semantic=1, shading_feature_mlp_layer3=2),
    "yuze": dict(agg_variant="yuze", shading_feature_mlp_layer3=1,
                 shading_feature_mlp_layer4=1),
    "yuze_linear": dict(agg_variant="yuze", shading_feature_mlp_layer4=2,
                        shading_feature_mlp_linear=1),
    "order1": dict(agg_intrp_order=1),
    "trilinear": dict(agg_distance_kernel="trilinear"),
    "sh_intrp": dict(agg_distance_kernel="sh_intrp"),
    "gau_intrp": dict(agg_distance_kernel="gau_intrp"),
    # the non-unit axis-weight branches; on the default variant they run
    # through K2 (the reference's gate), so here behind block2 / block3
    "quadric_axis": dict(agg_distance_kernel="quadric", agg_dist_pers=0,
                         axis_weight=(1.0, 0.5, 2.0),
                         shading_feature_mlp_layer2=1),
    "linear_axis": dict(axis_weight=(2.0, 0.5, 1.0),
                        shading_feature_mlp_layer3=2),
}
# the gradients' floor: where 4x the CPU's own float32 error was smaller,
# the card's float32 gradients lay at most 1.19e-4 (block2) and 4.4e-5
# (order1) from the CPU's float64 ones (H100, f32, TF32 off, two runs);
# 3e-4 leaves a 2.5x margin and stays below TF32's 2^-11 = 4.9e-4
# rounding of each product's inputs
VARIANT_GRAD_TOL = 3e-4


def _kernel_launches():
    return (fused_block1_alpha.launches, fused_block1_alpha_bwd.launches,
            fused_block1_alpha_color.launches,
            fused_block1_alpha_color_march.launches)


@pytest.mark.parametrize("name", sorted(AGG_VARIANTS))
def test_aggregator_variant_on_the_card_matches_the_cpu(dev, name):
    """A 9216-shading-point chunk (K 8) of each variant with every kernel
    flag on: no fused kernel launches (forward and backward); the decoded
    output within 1e-4 of the CPU's; each gradient of sum(decoded^2), max
    |diff| / max |ref| against the CPU's float64 one, within
    VARIANT_GRAD_TOL or 4x the CPU's own float32 error where that is
    larger: the embedding's float32 gradient lies ~3e-2 from float64 on
    the CPU too (PE's high frequencies and LeakyReLU branches amplify the
    rounding).
    Trilinear divides by the reference's grid_vox_sz of 0 (floored at
    1e-8): its weights' gradients overflow to NaN in float32, at the same
    places on the card as on the CPU."""
    from sgnerf_tpu_torch.models.aggregator import (AggregatorConfig,
                                                    aggregate,
                                                    init_aggregator_params)
    cfg = AggregatorConfig(fused_mlp="cuda", fused_color=True,
                           **AGG_VARIANTS[name])
    rng = np.random.default_rng(7)
    B, R, SR, K = 1, 384, 24, 8

    def mk(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32))
    d = mk(B, R, SR, K, 3)
    xyz = mk(B, R, SR, K, 3, scale=0.02)
    loc = mk(B, R, SR, 3, scale=0.02)
    kw = dict(sampled_embedding=mk(B, R, SR, K, 32, scale=0.3),
              sampled_conf=mk(B, R, SR, K, 1).abs(),
              sampled_label_embedding=mk(B, R, SR, K, 96),
              sampled_color=mk(B, R, SR, K, 3).sigmoid(),
              sampled_dir=d / d.norm(dim=-1, keepdim=True),
              sampled_xyz=xyz, sampled_xyz_pers=xyz + 1.5,
              sample_pnt_mask=torch.from_numpy(rng.random((B, R, SR, K))
                                               < 0.7),
              sample_loc=loc + 1.5, sample_loc_w=loc,
              sample_ray_dirs=mk(B, R, SR, 3))
    p = init_aggregator_params(0, cfg)
    cpu = torch.device("cpu")
    outs = []
    for d_, dt in ((dev, torch.float32), (cpu, torch.float32),
                   (cpu, torch.float64)):
        n0 = _kernel_launches()
        dkw = {k: v.to(d_, dt) if v.is_floating_point() else v.to(d_)
               for k, v in kw.items()}
        emb = dkw["sampled_embedding"].requires_grad_(True)
        ts = [t.detach().to(d_, dt).requires_grad_(True)
              for v in p.values() for l_ in v for t in l_.values()]
        it = iter(ts)
        params = {k: [{n: next(it) for n in l_} for l_ in v]
                  for k, v in p.items()}
        dec = aggregate(params, cfg, vsize=(0.008,) * 3,
                        **dict(dkw, sampled_embedding=emb))[0]
        grads = torch.autograd.grad((dec ** 2).sum(), ts + [emb])
        assert _kernel_launches() == n0
        outs.append((dec.detach().cpu().double(),
                     [g.cpu().double() for g in grads]))
    (dec, got), (rdec, ref32), (_, ref) = outs
    assert torch.isfinite(dec).all()
    torch.testing.assert_close(dec, rdec, atol=1e-4, rtol=1e-4)
    nan = [torch.isnan(g) for g in ref32]      # float32 overflows only
    assert all(torch.equal(torch.isnan(g), m) for g, m in zip(got, nan))
    assert any(m.any() for m in nan) == (name == "trilinear")

    def finite(gs):
        return [torch.where(m, 0, g) for g, m in zip(gs, nan)]
    e_card = _rel_errs(finite(got), finite(ref))
    e_cpu = _rel_errs(finite(ref32), finite(ref))
    print(name, "card", max(e_card), "cpu f32", max(e_cpu), "floor-bound",
          max((a for a, b in zip(e_card, e_cpu) if a > 4 * b), default=0.0))
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(e_card, e_cpu))
           if a > max(4 * b, VARIANT_GRAD_TOL)]
    assert not bad, bad


@pytest.mark.parametrize("train", [False, True])
def test_perspective_chunk_on_the_card_matches_the_cpu(dev, train):
    """One 1024-ray chunk of render_rays_perspective (a sphere of 20k
    points seen from 3 m): the card's frame grid and neighbour ids equal
    the CPU's; colours within 1e-4 (K2 on the card, its plain version on
    the CPU); training (the uniform shading-point jitter, the same noise on
    both) launches K2 and K3 once each."""
    from sgnerf_tpu_torch.models.aggregator import (AggregatorConfig,
                                                    init_aggregator_params)
    from sgnerf_tpu_torch.models.point_cloud import make_point_cloud
    from sgnerf_tpu_torch.models.renderer import (RenderConfig,
                                                  draw_render_noise,
                                                  render_rays_perspective)
    from sgnerf_tpu_torch.ops.query_pers import (perspective_grid,
                                                 perspective_spec_from_camera)
    rng = np.random.default_rng(0)
    n = 20000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    emb = (rng.normal(size=(n, 32)) * 0.2).astype(np.float32)
    intr = np.array([[80.0, 0, 32.0], [0, 80.0, 16.0], [0, 0, 1]])
    spec = perspective_spec_from_camera(intr, 64, 32, 1.0, 5.0, [0.01] * 3,
                                        [2, 2, 2], [3, 3, 3], 40000, 8)
    R = 1024
    d = (rng.normal(size=(1, R, 3)) * 0.2).astype(np.float32)
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = dict(campos=torch.tensor([[0.0, 0.0, -3.0]]),
               raydir=torch.from_numpy(d),
               camrotc2w=torch.eye(3)[None], bg_color=torch.ones(3))
    base = AggregatorConfig()
    p = init_aggregator_params(0, base)
    rcfg = RenderConfig(agg=base, z_depth_dim=128, SR=8, K=8,
                        vsize=(0.01,) * 3, shpnt_jitter="uniform")
    noise = draw_render_noise(torch.Generator().manual_seed(1), rcfg, 1, R,
                              is_train=True, perspective=True) \
        if train else None
    outs, grids = [], []
    for d_ in (dev, torch.device("cpu")):
        cfg = dataclasses.replace(rcfg, agg=dataclasses.replace(
            base, fused_mlp="cuda" if d_.type == "cuda" else "none"))
        cloud = make_point_cloud(xyz, emb, capacity=n, device=d_)
        params = {k: [{m: t.to(d_) for m, t in l_.items()} for l_ in v]
                  for k, v in p.items()}
        grids.append(perspective_grid(cloud.xyz, cloud.active,
                                      cam["camrotc2w"][0].to(d_),
                                      cam["campos"][0].to(d_), spec)[0])
        n0 = _kernel_launches()
        with torch.set_grad_enabled(train):
            if train:
                for l_ in params["block1"]:
                    for t in l_.values():
                        t.requires_grad_(True)
            out = render_rays_perspective(
                params, cloud, spec, cfg, near=1.0, far=5.0,
                is_train=train,
                noise=None if noise is None else {
                    k: v.to(d_) for k, v in noise.items()},
                **{k: v.to(d_) for k, v in cam.items()})
            if train:
                (out["coarse_raycolor"] ** 2).sum().backward()
        k2, k3 = (a - b for a, b in zip(_kernel_launches()[:2], n0[:2]))
        assert (k2, k3) == ((1, int(train)) if d_.type == "cuda"
                            else (0, 0)), (k2, k3)
        outs.append({k: v.detach().cpu() for k, v in out.items()
                     if torch.is_tensor(v)})
    assert torch.equal(grids[0].vox_slot.cpu(), grids[1].vox_slot)
    assert torch.equal(grids[0].bucket_pnts.cpu(), grids[1].bucket_pnts)
    a, b = outs
    assert torch.equal(a["ray_mask"], b["ray_mask"])
    assert b["ray_mask"].float().mean() > 0.3
    torch.testing.assert_close(a["coarse_raycolor"], b["coarse_raycolor"],
                               atol=1e-4, rtol=0)


def _mvs_views(V=3, H=64, W=80, seed=4):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    projs = np.stack([np.eye(4, dtype=np.float32)[:3] for _ in range(V)])
    for v in range(1, V):
        th = 0.02 * v
        projs[v, :3, :3] = [[np.cos(th), -np.sin(th), 0],
                            [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        projs[v, :3, 3] = [0.3 * v, -0.15 * v, 0.01]
    return imgs, projs


def test_predict_depth_on_the_card_matches_the_cpu(dev):
    """MVSNet's depth inference (IEEE f32 convolutions, TF32 off inside the
    nets whatever the process set) on the card against the port's CPU
    forward: depth within 1e-4 (far - near), probability within 1e-4,
    confidence within 1e-4 where the truncated index agrees."""
    from sgnerf_tpu_torch.models.mvs import MVSConfig, MvsPointsModel
    imgs, projs = _mvs_views()
    D, near, far = 32, 1.0, 3.0
    dv = torch.linspace(near, far, D)
    cpu = MvsPointsModel(MVSConfig(), seed=3)
    card = MvsPointsModel(MVSConfig(), params=_to(cpu.params, dev))
    a = cpu.predict_depth(torch.from_numpy(imgs), torch.from_numpy(projs), dv)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True      # what the nets must undo
    try:
        b = card.predict_depth(torch.from_numpy(imgs).to(dev),
                               torch.from_numpy(projs).to(dev), dv.to(dev))
    finally:
        torch.backends.cudnn.allow_tf32 = old
    b = [t.cpu() for t in b]
    assert torch.allclose(b[0], a[0], rtol=0, atol=1e-4 * (far - near))
    assert torch.allclose(b[2], a[2], rtol=0, atol=1e-4)
    ar = torch.arange(D, dtype=torch.float32)[:, None, None]
    same = ((a[2] * ar).sum(0).int() == (b[2] * ar).sum(0).int())
    assert same.float().mean() >= 0.99
    assert torch.allclose(b[1][same], a[1][same], rtol=0, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_feedforward_step_on_the_card_matches_the_cpu(dev):
    """One feed-forward step (jitter 0) on the card against the same step
    on the CPU: the loss within 1e-5 relative, every leaf of both groups
    within 1e-5 of its largest magnitude but where the CPU's first Adam
    step is shorter than 0.999 lr (a gradient within ~1e-5 of zero)."""
    from sgnerf_tpu_torch.models import feedforward as ff
    from sgnerf_tpu_torch.models.aggregator import (AggregatorConfig,
                                                    init_aggregator_params)
    from sgnerf_tpu_torch.models.mvs import MVSConfig, init_mvs_params
    from sgnerf_tpu_torch.models.renderer import RenderConfig
    from sgnerf_tpu_torch.ops.camera import get_dtu_raydir
    from sgnerf_tpu_torch.ops.grid import compute_grid_spec
    rng = np.random.default_rng(0)
    H, W, V, lr = 24, 32, 2, 5e-4
    intr = np.array([[24.0, 0, W / 2], [0, 24.0, H / 2], [0, 0, 1]],
                    np.float32)
    c2ws = np.stack([np.eye(4, dtype=np.float32)] * V)
    c2ws[1, 0, 3] = 0.1
    gy, gx = np.mgrid[0:H, 0:W]
    px, py = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([px, py], -1).reshape(-1, 2)[rng.integers(0, H * W, 128)]
    batch = {
        "images": rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32),
        "c2ws": c2ws,
        "w2cs": np.stack([np.linalg.inv(c) for c in c2ws]).astype(
            np.float32),
        "intrinsics": np.stack([intr] * V), "depth_intr": intr,
        "near_far": np.asarray([0.5, 4.0], np.float32),
        "gt_depth": (2.0 + 0.2 * np.sin(gx / 5.0) * np.cos(gy / 4.0)
                     ).astype(np.float32),
        "campos": np.zeros((1, 3), np.float32),
        "raydir": get_dtu_raydir(torch.from_numpy(pix),
                                 torch.from_numpy(intr), torch.eye(3),
                                 True).numpy()[None],
        "camrotc2w": np.eye(3, dtype=np.float32)[None],
        "bg_color": np.ones(3, np.float32),
        "gt_image": rng.uniform(0, 1, (1, 128, 3)).astype(np.float32)}
    cfg = RenderConfig(agg=AggregatorConfig(), z_depth_dim=48, SR=8, K=4,
                       vsize=(0.1,) * 3, jitter=0.0)
    spec = compute_grid_spec(np.array([[-3, -3, -0.5], [3, 3, 4.0]]),
                             vsize=[0.1] * 3, vscale=[1, 1, 1],
                             kernel_size=[3, 3, 3], max_o=8192, P=8)
    params = {"agg": init_aggregator_params(0, cfg.agg),
              "mvs": init_mvs_params(1, MVSConfig())}
    init = _to(params, "cpu")
    init = {g: [t.clone() for t in ff.tree_leaves(init[g])] for g in init}
    out = {}
    for d in ("cpu", dev):
        p = _to(params, d)           # a copy on each device
        if str(d) == "cpu":
            p = {g: _to(_to(p[g], dev), "cpu") for g in p}
        st = ff.init_opt_states(p)
        fn = ff.make_feedforward_step(MVSConfig(), cfg, spec, lr, lr)
        b = {k: torch.from_numpy(np.asarray(v)).to(d)
             for k, v in batch.items()}
        b.update(near=0.5, far=4.0)
        p, st, losses = fn(p, st, b, 0)
        out[str(d)] = ({g: [t.cpu() for t in ff.tree_leaves(p[g])]
                        for g in p}, {k: v.cpu() for k, v in losses.items()})
    (pc, lc), (pg, lg) = out["cpu"], out[str(dev)]
    for k in lc:
        assert torch.allclose(lg[k], lc[k], rtol=1e-5, atol=0), k
    for g in ("agg", "mvs"):
        for a, c, i in zip(pg[g], pc[g], init[g]):
            off = (a - c).abs() > 1e-5 * c.abs().max()
            step = (c - i).abs()
            soft = (step > 0) & (step < 0.999 * lr)
            assert not (off & ~soft).any(), g
            assert off.sum() <= max(1, int(1e-4 * off.numel())), g


@pytest.mark.parametrize("kind", ["ray", "scene"])
def test_two_shards_on_one_card_match_the_unsharded_render(dev, kind):
    """--ray_shards 2 and --scene_shards 2 on [cuda, cuda]: the eval path's
    kernels (K1 on the bf16 cache, K2) run in each shard, twice a chunk,
    and the render equals the unsharded one (RENDER_ATOL of chip_smoke.py,
    ray_mask equal); the ray-split train step's losses within 1e-5 relative
    and gradients within K3's tolerance of the unsharded step's, through a
    float32 table (a bf16 table's scatter-add sums in bf16 in no fixed
    order: chip_smoke phase 21 holds those)."""
    from sgnerf_tpu_torch.models import aggregator as tagg
    from sgnerf_tpu_torch.models import point_cloud as tpc
    from sgnerf_tpu_torch.models import renderer as tren
    from sgnerf_tpu_torch.models import train as ttrain
    from sgnerf_tpu_torch.parallel import (ShardGroup, build_sharded_scene,
                                           render_rays_sharded,
                                           render_rays_spatial)
    rng = np.random.default_rng(3)
    n = 20000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    cloud = tpc.make_point_cloud(
        xyz, (rng.normal(size=(n, 32)) * 0.1).astype(np.float32),
        conf=rng.uniform(0.3, 1, (n, 1)), color=xyz * 0.4 + 0.5, dir=xyz,
        device=dev)
    spec = tpc.grid_spec_for_cloud(cloud, vsize=[0.04] * 3, vscale=[2] * 3,
                                   kernel_size=[3] * 3, max_o=65536, P=16,
                                   cache_dtype="bfloat16")
    grid = tpc.build_grid(cloud, spec)
    cfg = tren.RenderConfig(
        agg=tagg.AggregatorConfig(fused_mlp="cuda", fused_bwd="cuda"),
        z_depth_dim=64, SR=8, K=8, vsize=(0.08,) * 3, knn_mode="fused",
        gather_dtype="bfloat16")
    params = tagg.init_aggregator_params(0, cfg.agg, dev)
    d = rng.normal(size=(1, 1024, 3)).astype(np.float32) * 0.3
    d[..., 2] = 1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = dict(campos=torch.tensor([[0, 0, -3.0]], device=dev),
               raydir=torch.from_numpy(d).to(dev),
               camrotc2w=torch.eye(3, device=dev)[None], near=1.0, far=5.0,
               bg_color=torch.ones(3, device=dev))
    group = ShardGroup([dev, dev])
    with torch.no_grad():
        ref = tren.render_rays(params, cloud, grid, cfg, **cam)
        fused_knn_select.launches = fused_block1_alpha.launches = 0
        if kind == "ray":
            got = render_rays_sharded(params, cloud, grid, cfg, group, **cam)
        else:
            scene, sspec = build_sharded_scene(cloud, spec, 2,
                                               devices=group.devices)
            got = render_rays_spatial(params, scene, sspec, cfg, **cam)
    assert fused_knn_select.launches == fused_block1_alpha.launches == 2
    assert bool(ref["ray_mask"].any())
    assert torch.equal(got["ray_mask"], ref["ray_mask"])
    torch.testing.assert_close(got["coarse_raycolor"],
                               ref["coarse_raycolor"], atol=1e-4, rtol=0)
    if kind == "scene":
        return
    cfg = dataclasses.replace(cfg, gather_dtype="float32")
    tc = ttrain.TrainConfig()
    st = ttrain.create_train_state(params, cloud, tc)
    batch = dict(cam, gt_image=torch.rand((1, 1024, 3), device=dev,
                                          generator=torch.Generator(
                                              device=dev).manual_seed(1)))
    noise = tren.draw_render_noise(torch.Generator(device=dev).manual_seed(
        2), cfg, 1, 1024, table_shape=(cloud.capacity, 42))
    runs = [ttrain.loss_and_grads(st, grid, cfg, tc, batch, noise=noise,
                                  ray_mesh=m) for m in (None, group)]
    (rl, rn, rp), (gl, gn, gp) = runs
    for k in rl:
        torch.testing.assert_close(gl[k], rl[k], rtol=1e-5, atol=0)
    for a, b in zip(gn + gp, rn + rp):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())
