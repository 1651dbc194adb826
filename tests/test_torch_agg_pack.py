"""The fused aggregator's weight packing (ops/fused_agg.py `pack_block1`,
and K3b's `pack_block1_bwd`) and the numerics of its f32 mode, on the CPU.

K2's tile body (csrc/fused_agg_body.cuh) reads block1's weights in the
layout `pack_block1` writes, wgmma's no-swizzle K-major planes: k-slices
of 32 bf16 input rows (four 8-row planes of 256 columns) in bf16 mode, of
8 rows as tf32 hi and lo planes in f32 mode. These tests undo the packing
and get the weights back, and model the f32 mode's 3xTF32 product
(hi.hi' + hi.lo' + lo.hi') against float64."""
import numpy as np
import pytest
import torch

from sgnerf_tpu_torch.ops.fused_agg import (SLICE_DEPTH, WGMMA_N,
                                            pack_block1, pack_block1_bwd,
                                            tf32_rna)


def _block1(in0, C, n_layers, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [{"w": torch.randn(i, C, generator=g) * (2.0 / (i + C)) ** 0.5,
             "b": torch.randn(C, generator=g) * 0.05}
            for i in [in0] + [C] * (n_layers - 1)]


def _unpack(packed, in0, C, n_layers, bf16):
    """Inverse of pack_block1's weights: -> per layer (k padded, C) as
    stored, and the columns past C: bf16 (w, pad) or float32
    ((hi, lo), (hi pad, lo pad))."""
    ks = SLICE_DEPTH[bf16]
    out, i = [], 0
    for k in [in0] + [C] * (n_layers - 1):
        kp = -(-k // ks) * ks
        n = kp * WGMMA_N * (1 if bf16 else 2)
        x = packed[i:i + n].reshape(kp // ks, 4, WGMMA_N, -1).transpose(2, 3)
        i += n
        if bf16:
            w = x.reshape(kp, WGMMA_N)
            out.append((w[:, :C], w[:, C:]))
        else:
            hl = x.reshape(kp // ks, 2, ks, WGMMA_N)
            ws = [hl[:, h].reshape(kp, WGMMA_N) for h in (0, 1)]
            out.append(((ws[0][:, :C], ws[1][:, :C]),
                        (ws[0][:, C:], ws[1][:, C:])))
    assert i == packed.numel()
    return out


@pytest.mark.parametrize("in0,C,n_layers", [(284, 256, 2), (86, 32, 3),
                                            (172, 160, 1), (256, 256, 2)])
def test_pack_bf16_unpacks_to_the_rounded_weights(in0, C, n_layers):
    block1 = _block1(in0, C, n_layers)
    packed, bias = pack_block1(block1, in0, bf16=True)
    assert packed.dtype == torch.bfloat16
    for layer, (w, pad) in zip(block1,
                               _unpack(packed, in0, C, n_layers, True)):
        k = layer["w"].shape[0]
        assert torch.equal(w[:k], layer["w"].to(torch.bfloat16))
        assert not w[k:].any() and not pad.any()  # zeros only in the pad
    assert torch.equal(bias, torch.cat([l_["b"] for l_ in block1]))


@pytest.mark.parametrize("in0,C,n_layers", [(284, 256, 2), (86, 32, 3),
                                            (172, 160, 1)])
def test_pack_f32_unpacks_to_tf32_pairs(in0, C, n_layers):
    block1 = _block1(in0, C, n_layers)
    packed, _ = pack_block1(block1, in0, bf16=False)
    assert packed.dtype == torch.float32
    for layer, ((hi, lo), pads) in zip(
            block1, _unpack(packed, in0, C, n_layers, False)):
        w = layer["w"]
        k = w.shape[0]
        assert torch.equal(hi[:k], tf32_rna(w))
        assert torch.equal(lo[:k], tf32_rna(w - hi[:k]))
        assert not hi[k:].any() and not lo[k:].any()
        assert not pads[0].any() and not pads[1].any()
        # hi + lo holds w to within the split's error, 2^-22 |w|
        err = (hi[:k].double() + lo[:k].double() - w.double()).abs()
        assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
        for t in (hi, lo):                       # both are tf32 values
            assert not (t.view(torch.int32) & 0x1FFF).any()


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                             # tf32's ulp at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4, 3.0e-3, -7.5, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp],
                        dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got[:5], want)
    assert float((got - x).abs().max()) <= 2.0 ** -11 * float(x.abs().max())
    assert not (got.view(torch.int32) & 0x1FFF).any()


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _rel_err(approx, a, b):
    """Per output, |approx - exact| / sum |a_k b_k| (float64 reference)."""
    a64, b64 = a.double(), b.double()
    exact = a64 @ b64
    scale = a64.abs() @ b64.abs()
    return float(((approx.double() - exact).abs() / scale).max())


def _first_layer_inputs(seed=0, rows=512, in0=284, C=256):
    """PE-like rows (raw features, then sin/cos values) and a first-layer
    weight at block1's canonical shape (284 -> 256)."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.normal(scale=0.3, size=(rows, 32)),
                        np.sin(rng.uniform(-8, 8, size=(rows, in0 - 32)))],
                       axis=1)
    w = rng.normal(scale=(2.0 / (in0 + C)) ** 0.5, size=(in0, C))
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(w.astype(np.float32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_product_is_as_close_as_f32(seed):
    """f32 mode's product model: three tf32 products summed in f32 stay
    within 1e-6 of float64 relative to sum |a.b|, where a plain f32 product
    lies; a single tf32 product exceeds 1e-5, which is why f32 mode
    multiplies three times."""
    a, w = _first_layer_inputs(seed)
    (ah, al), (wh, wl) = _split(a), _split(w)
    three = al @ wh + ah @ wl + ah @ wh
    one = ah @ wh
    err3, err1 = _rel_err(three, a, w), _rel_err(one, a, w)
    err_f32 = _rel_err(a @ w, a, w)
    assert err3 <= 1e-6, err3
    assert err_f32 <= 1e-6, err_f32
    assert err1 > 1e-5, err1


@pytest.mark.parametrize("bf16", [False, True])
def test_pack_refuses_the_shapes_the_kernels_refuse(bf16):
    """pack_block1 checks shapes with the helper _check_cuda uses, so it
    raises the same ValueErrors."""
    good = _block1(284, 256, 2)
    bad_layer = [good[0], {"w": torch.zeros(128, 256), "b": torch.zeros(256)}]
    with pytest.raises(ValueError, match=r"block1 must be \(284,256\)"):
        pack_block1(bad_layer, 284, bf16)
    with pytest.raises(ValueError, match=r"block1 must be \(100,256\)"):
        pack_block1(good, 100, bf16)
    for C in (48, 288):
        with pytest.raises(ValueError, match="needs C % 32 == 0, C <= 256"):
            pack_block1(_block1(64, C, 1), 64, bf16)


def test_packed_weights_are_kept_until_a_weight_changes():
    """The wrappers pack once for a run of calls with unchanged weights and
    pack again after an in-place update (an optimizer step) or for other
    tensors."""
    from sgnerf_tpu_torch.ops.fused_agg import _packed_block1
    block1 = _block1(86, 32, 2)
    p1, b1 = _packed_block1(block1, 86, True)
    p2, _ = _packed_block1(block1, 86, True)
    assert p2 is p1
    with torch.no_grad():
        block1[1]["w"].add_(1.0)
    p3, _ = _packed_block1(block1, 86, True)
    assert p3 is not p1
    assert torch.equal(p3, pack_block1(block1, 86, True)[0])
    other = [{k: v.clone() for k, v in l_.items()} for l_ in block1]
    assert _packed_block1(other, 86, True)[0] is not p3
    assert torch.equal(_packed_block1(other, 86, False)[0],
                       pack_block1(other, 86, False)[0])


def _desc_model(packed, ks, n_mats, k, bf16):
    """The tile body's reading of packed k-slices, as its wgmma
    descriptors address them (no swizzle, K-major): element (row r, column
    n) of a slice lies in the 16-byte row n of the 8-column core matrix
    n // 8 (SBO 128 bytes apart) of plane (r mod ks) // e (LBO one plane of
    WGMMA_N columns apart), at (r mod e) within the row, e values to 16
    bytes. f32 keeps tf32 hi in planes 0-1, lo in planes 2-3. -> (n_mats,
    k, WGMMA_N) as read (f32: hi + lo)."""
    e = 8 if bf16 else 4
    flat = packed.view(torch.int16 if bf16 else torch.int32).numpy()
    esize = 2 if bf16 else 4
    per_slice = 64 * WGMMA_N // esize            # 16 KB a slice
    r = np.arange(k)[:, None]
    n = np.arange(WGMMA_N)[None, :]
    out = []
    for m in range(n_mats):
        base = (m * (k // ks) + r // ks) * per_slice
        byte = (((r % ks) // e) * WGMMA_N * 16 + (n // 8) * 128
                + (n % 8) * 16 + (r % e) * esize)
        idx = base + byte // esize
        if bf16:
            vals = torch.from_numpy(flat[idx]).view(torch.bfloat16).float()
        else:
            hi = torch.from_numpy(flat[idx]).view(torch.float32)
            lo = torch.from_numpy(flat[idx + 2 * WGMMA_N * 4]).view(
                torch.float32)
            vals = (hi.double() + lo.double()).float()
        out.append(vals)
    return torch.stack(out)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("in0,C,n_layers", [(284, 256, 2), (86, 32, 3),
                                            (172, 160, 1), (288, 256, 1)])
def test_pack_bwd_reads_back_the_transposed_weights(bf16, in0, C, n_layers):
    """K3b's B operands (pack_block1_bwd), read the way its descriptors
    address them: W_{L-1}^T .. W_1^T, then W_0^T's columns past 256 (in0 >
    256) and its first 256, each C deep, zero past its columns; bf16 the
    rounded weights, f32 hi + lo within 2^-22 of them."""
    block1 = _block1(in0, C, n_layers, seed=in0)
    packed = pack_block1_bwd(block1, in0, bf16)
    w0t = block1[0]["w"].t()
    mats = [l_["w"].t() for l_ in reversed(block1[1:])]
    if in0 > WGMMA_N:
        mats.append(w0t[:, WGMMA_N:])
    mats.append(w0t[:, :WGMMA_N])
    ks = SLICE_DEPTH[bf16]
    assert packed.numel() == len(mats) * (C // ks) * 64 * WGMMA_N // (
        2 if bf16 else 4)
    got = _desc_model(packed, ks, len(mats), C, bf16)
    for m, want in enumerate(mats):
        n = want.shape[1]
        if bf16:
            assert torch.equal(got[m, :, :n], want.to(torch.bfloat16).float())
        else:
            err = (got[m, :, :n].double() - want.double()).abs()
            assert bool((err <= 2.0 ** -22 * want.double().abs()).all())
        assert not got[m, :, n:].any()


def test_pack_bwd_refuses_inputs_past_288():
    with pytest.raises(ValueError, match="block1 input <= 288"):
        pack_block1_bwd(_block1(300, 256, 2), 300, True)
