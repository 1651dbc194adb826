"""The colour head kernel's weight packing (ops/fused_agg.py `pack_color`,
`head_plan`), the numerics of its f32 mode and the checks that hold its
bf16 mode to the plain head (`color_tail_on_roundings`,
`sum_error_units`), on the CPU.

K4's and K5's second launch (csrc/fused_agg_color.cu) reads the colour
weights as the ring streams them: layer by layer, k-slices of 32 bf16
input rows (four 8-row planes) or of 8 rows as tf32 hi and lo planes,
each plane as wide as the layer's padded output (the hidden width padded
to 64 columns, the 3 logits to 8). These tests read the packing back the
way the kernel's descriptors address it and get the weights, with zeros
in every padded row and column; model its 3xTF32 product against
float64; and plant faults in a head's hidden values that the bf16 check
must refuse. K5's tile plan lives in the kernel alone: the card tests
(tests/test_torch_cuda.py) run it at SR 1-300."""
import numpy as np
import pytest
import torch

from sgnerf_tpu_torch.ops.fused_agg import (
    FLIP_BOUND, FLIP_FLOOR, HEAD_LAST_N, SLICE_DEPTH, _bf16,
    color_head_plain, color_tail_on_roundings, color_tail_plain,
    fused_color_head, head_plan, leaky_relu, march_tail_plain, pack_color,
    sum_error_units, tf32_rna)
from sgnerf_tpu_torch.ops.pe import positional_encoding


def _color(C, vf, Nh, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    sizes = [C + 6 * vf] + [Nh] * (n - 1) + [3]
    return [{"w": torch.randn(i, o, generator=g) * (2.0 / (i + o)) ** 0.5,
             "b": torch.randn(o, generator=g) * 0.05}
            for i, o in zip(sizes[:-1], sizes[1:])]


def _read_layers(packed, dims, bf16):
    """The kernel's reading of the packed layers (csrc/fused_agg_color.cu
    `Ring` and `layer`): a layer of (depth, width) is depth / ks slices of
    64 x width bytes, one after another; element (row r, column n) of a
    slice lies in the 16-byte row n of the 8-column core matrix n // 8
    (SBO 128 bytes apart) of plane (r mod ks) // e (LBO one plane of width
    columns apart), at (r mod e) within the row, e values to 16 bytes; f32
    keeps tf32 hi in planes 0-1, lo in planes 2-3 (2 x width x 16 bytes
    on). -> [(depth, width) as read (f32: (hi, lo))], bytes read."""
    ks = SLICE_DEPTH[bf16]
    e = 8 if bf16 else 4
    esize = 2 if bf16 else 4
    flat = packed.view(torch.int16 if bf16 else torch.int32).numpy()
    out, off = [], 0
    for dp, wd in dims:
        r = np.arange(dp)[:, None]
        n = np.arange(wd)[None, :]
        byte = (off + (r // ks) * 64 * wd + ((r % ks) // e) * wd * 16
                + (n // 8) * 128 + (n % 8) * 16 + (r % e) * esize)
        idx = byte // esize
        if bf16:
            out.append(torch.from_numpy(flat[idx]).view(torch.bfloat16)
                       .float())
        else:
            lo_idx = idx + 2 * wd * 16 // esize
            out.append((torch.from_numpy(flat[idx]).view(torch.float32),
                        torch.from_numpy(flat[lo_idx]).view(torch.float32)))
        off += dp // ks * 64 * wd
    return out, off


HEADS = [(256, 4, 128, 4), (256, 4, 256, 4), (256, 4, 200, 3),
         (32, 1, 8, 2), (64, 2, 3, 1), (96, 30, 32, 2)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("C,vf,Nh,n", HEADS)
def test_pack_color_reads_back_the_weights(bf16, C, vf, Nh, n):
    """Every layer read as the kernel reads it: bf16 the rounded weights,
    f32 tf32 hi and lo summing to within 2^-22 of them; zero rows past
    each layer's input (C + 6 vf to the slice depth, Nh to the padded
    hidden width) and zero columns past its output (the 3 logits' 5 of
    8); the biases padded with zeros the same way."""
    color = _color(C, vf, Nh, n, seed=C + Nh)
    packed, bias = pack_color(color, vf, bf16)
    assert packed.dtype == (torch.bfloat16 if bf16 else torch.float32)
    plan = head_plan(C, vf, Nh, n, bf16)
    layers, nbytes = _read_layers(packed, plan["dims"], bf16)
    assert nbytes == packed.numel() * packed.element_size()
    assert plan["dims"][-1][1] == HEAD_LAST_N
    boff = 0
    for layer, got, (dp, wd) in zip(color, layers, plan["dims"]):
        w = layer["w"]
        k, m = w.shape
        assert dp % SLICE_DEPTH[bf16] == 0 and dp >= k and wd >= m
        if bf16:
            assert torch.equal(got[:k, :m], w.to(torch.bfloat16).float())
            pads = [got[k:], got[:, m:]]
        else:
            hi, lo = got
            assert torch.equal(hi[:k, :m], tf32_rna(w))
            assert torch.equal(lo[:k, :m], tf32_rna(w - tf32_rna(w)))
            err = (hi[:k, :m].double() + lo[:k, :m].double()
                   - w.double()).abs()
            assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
            pads = [hi[k:], hi[:, m:], lo[k:], lo[:, m:]]
        assert not any(p.any() for p in pads)
        assert torch.equal(bias[boff:boff + m], layer["b"])
        assert not bias[boff + m:boff + wd].any()
        boff += wd
    assert boff == bias.numel()


def test_head_plan_at_the_canonical_head():
    """The canonical head (C 256, vf 4, 128 hidden, 4 layers): 128-point
    tiles in both modes, layer 0 288 deep in bf16 (32-row slices) and 280
    in f32; an f32 head wider than 128 columns takes 64-point tiles at 256
    columns, bf16 keeps 128-point tiles at its width padded to 64."""
    bf = head_plan(256, 4, 128, 4, True)
    f32 = head_plan(256, 4, 128, 4, False)
    assert (bf["kp0"], bf["Np"], bf["rows"], bf["split"]) == (288, 128, 128,
                                                               False)
    assert (f32["kp0"], f32["Np"], f32["rows"]) == (280, 128, 128)
    assert bf["dims"] == [(288, 128), (128, 128), (128, 128), (128, 8)]
    wide = head_plan(256, 4, 192, 3, False)
    assert (wide["Np"], wide["rows"], wide["split"]) == (256, 64, True)
    assert head_plan(256, 4, 192, 3, True)["Np"] == 192
    assert head_plan(256, 4, 128, 1, True)["dims"] == [(288, 8)]


def test_pack_color_refuses_other_shapes():
    color = _color(256, 4, 128, 3)
    bad = color[:1] + [{"w": torch.zeros(64, 128), "b": torch.zeros(128)}]
    with pytest.raises(ValueError, match="color_branch must be"):
        pack_color(bad + color[2:], 4, False)
    with pytest.raises(ValueError, match="color_branch must be"):
        pack_color(_color(256, 4, 320, 2), 4, True)   # wider than 256


def _rel_err(approx, a, b):
    """Per output, |approx - exact| / sum |a_k b_k| (float64 reference)."""
    a64, b64 = a.double(), b.double()
    return float(((approx.double() - a64 @ b64).abs()
                  / (a64.abs() @ b64.abs())).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_color_product_is_as_close_as_f32(seed):
    """The f32 head's first product (280 -> 128: reduced features, then
    the view directions' sin/cos) as three tf32 products summed in f32
    (the kernel's lo.hi' + hi.lo' sums apart from hi.hi', added at the
    end) stays within 1e-6 of float64 relative to sum |a.b|, as a plain
    f32 product does; one tf32 product lies past 1e-5."""
    rng = np.random.default_rng(seed)
    rows, C, vf, Nh = 512, 256, 4, 128
    fa = rng.normal(scale=2.0, size=(rows, C))
    pe = rng.uniform(-8, 8, size=(rows, 3 * vf))
    a = torch.from_numpy(np.concatenate([fa, np.sin(pe), np.cos(pe)],
                                        axis=1).astype(np.float32))
    w = torch.from_numpy(rng.normal(scale=(2.0 / (C + 6 * vf + Nh)) ** 0.5,
                                    size=(C + 6 * vf, Nh)).astype(np.float32))
    ah, wh = tf32_rna(a), tf32_rna(w)
    al, wl = tf32_rna(a - ah), tf32_rna(w - wh)
    three = ah @ wh + (al @ wh + ah @ wl)
    assert _rel_err(three, a, w) <= 1e-6
    assert _rel_err(a @ w, a, w) <= 1e-6
    assert _rel_err(ah @ wh, a, w) > 1e-5


def test_color_head_on_the_cpu_is_the_plain_head():
    """fused_color_head on CPU tensors runs color_head_plain: [alpha |
    color_tail_plain] on the reduced rows, and march_tail_plain on that
    with a march."""
    g = torch.Generator().manual_seed(3)
    M, C, vf, SR = 48, 64, 2, 6
    red = torch.randn(M, C + 1, generator=g)
    vd = torch.randn(M, 3, generator=g)
    color = _color(C, vf, 32, 3)
    for bf16 in (False, True):
        head = fused_color_head(red, vd, color, vf=vf, bf16=bf16)
        hc = color_tail_plain(red[:, :C], vd, color, vf=vf, bf16=bf16)
        assert torch.equal(head, torch.cat([red[:, C:], hc], -1))
        rd, rv = torch.rand(M, generator=g), torch.ones(M)
        got = fused_color_head(red, vd, color, vf=vf, bf16=bf16,
                               march=(rd, rv, SR))
        assert torch.equal(got, march_tail_plain(red[:, C:], hc, rd, rv,
                                                 SR=SR))
        assert torch.equal(got, color_head_plain(red, vd, color, vf=vf,
                                                 bf16=bf16,
                                                 march=(rd, rv, SR)))


def _plain_hidden(seed=5, M=40, C=64, vf=2, Nh=32, n=3):
    """A small bf16 head: (fa, vd, colour layers, the hidden values the
    plain head rounds to (n-1, M, Nh), their f32 values before rounding)."""
    g = torch.Generator().manual_seed(seed)
    fa = torch.randn(M, C, generator=g)
    vd = torch.randn(M, 3, generator=g)
    color = _color(C, vf, Nh, n)
    x = torch.cat([fa, positional_encoding(vd, vf, ori=True)[..., 3:]], -1)
    pre = []
    for layer in color[:-1]:
        x = leaky_relu(_bf16(x) @ _bf16(layer["w"]) + layer["b"])
        pre.append(x)
    pre = torch.stack(pre)
    return fa, vd, color, _bf16(pre), pre


def test_the_plain_head_on_the_kernels_roundings():
    """color_tail_on_roundings, the plain bf16 head that takes a kernel's
    hidden roundings: on the plain head's own roundings it is the plain
    head, bit for bit, with no flip. A hidden value moved to its other
    bf16 neighbour, two steps, or across LeakyReLU's kink (the plain value
    taken next to a bf16 value, half a step from any midpoint) lies far
    past FLIP_BOUND units of the sums' error: refused."""
    fa, vd, color, hidden, pre = _plain_hidden()
    vf = 2
    logits, flips, worst = color_tail_on_roundings(fa, vd, color, hidden,
                                                   vf=vf)
    assert torch.equal(logits, color_tail_plain(fa, vd, color, vf=vf,
                                                bf16=True))
    assert flips == [0, 0] and worst == 0.0
    # the value nearest a bf16 value (farthest from a midpoint), not on one
    near_bf16 = (pre[1] - hidden[1]).abs() / pre[1].abs()
    near_bf16[(near_bf16 == 0) | ~torch.isfinite(near_bf16)] = 1.0
    i, j = divmod(int(near_bf16.argmin()), pre[1].shape[1])
    h = pre[1][i, j].abs()          # a positive |value| and its neighbours
    down = (h.view(torch.int32) & -0x10000).view(torch.float32)
    up = ((h.view(torch.int32) & -0x10000) + 0x10000).view(torch.float32)
    other = up if bool(_bf16(h) == down) else down
    step = 0x10000 if bool(other == up) else -0x10000
    sign = torch.sign(pre[1][i, j])
    for far in (other * sign,
                (other.view(torch.int32) + step).view(torch.float32) * sign,
                _bf16(-0.01 * hidden[1, i, j].abs() * sign)):
        moved = hidden.clone()
        moved[1, i, j] = far
        with pytest.raises(ValueError, match="units from the plain sum"):
            color_tail_on_roundings(fa, vd, color, moved, vf=vf)


@pytest.mark.parametrize("fault", ["unrounded", "nan"])
def test_the_roundings_check_refuses_unrounded_hidden_values(fault):
    """A kernel that leaves its hidden activations in f32 (or writes a NaN)
    is refused before any flip is counted: an unrounded value lies inside
    its own bf16 interval, and the plain head would otherwise follow it."""
    fa, vd, color, hidden, pre = _plain_hidden()
    bad = pre.clone() if fault == "unrounded" else hidden.clone()
    if fault == "nan":
        bad[0, 3, 5] = float("nan")
    assert not torch.equal(_bf16(bad), bad)
    with pytest.raises(ValueError, match="not bf16 values"):
        color_tail_on_roundings(fa, vd, color, bad, vf=2)


def test_the_roundings_check_caps_the_flips():
    """More flips in a layer than FLIP_SHARE of its values (FLIP_FLOOR on a
    small one) are refused, however near their sums: FLIP_FLOOR values
    moved to a bf16 neighbour pass a distance limit that takes them all,
    one more does not."""
    fa, vd, color, hidden, _ = _plain_hidden()
    flat = hidden[0].reshape(-1)
    idx = torch.nonzero(flat != 0).reshape(-1)[:FLIP_FLOOR + 1]
    for n, ok in ((FLIP_FLOOR, True), (FLIP_FLOOR + 1, False)):
        moved = hidden.clone()
        m = moved[0].reshape(-1)
        m[idx[:n]] = (m[idx[:n]].view(torch.int32) + 0x10000).view(
            torch.float32)
        if ok:
            _, flips, _ = color_tail_on_roundings(fa, vd, color, moved, vf=2,
                                                  flip_bound=1e30)
            assert flips == [n, 0]
        else:
            with pytest.raises(ValueError, match="values flip"):
                color_tail_on_roundings(fa, vd, color, moved, vf=2,
                                        flip_bound=1e30)


@pytest.mark.parametrize("seed", [0, 1])
def test_sum_error_units(seed):
    """sum_error_units on the CPU's f32 products of bf16 values (each
    product exact, the sums rounded to nearest): within 1 unit of
    n 2^-24 sum |x w|, the measure FLIP_BOUND's 3 units add up from; a sum
    moved by 2.5 units reads 2.5; an all-zero row with no error reads 0."""
    g = torch.Generator().manual_seed(seed)
    x = _bf16(torch.randn(300, 280, generator=g))
    x[0] = 0.0
    w = _bf16(torch.randn(280, 8, generator=g) * 0.1)
    b = torch.randn(8, generator=g) * 0.05
    got = x @ w + b
    assert sum_error_units(got, x, w, b) <= 1.0 < FLIP_BOUND
    unit = (x[5].double().abs() @ w[:, 2].double().abs()) * 280 * 2.0 ** -24
    exact = x[5].double() @ w[:, 2].double() + b[2].double()
    moved = got.clone()
    moved[5, 2] = float(exact + 2.5 * unit)
    assert abs(sum_error_units(moved, x, w, b) - 2.5) < 0.01
