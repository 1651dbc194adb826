"""The port's BPNet (sgnerf_tpu_torch/models/bpnet) against the JAX
package's on the same seeded inputs and weights.

Integers bit-equal: the host ops (links, voxel maps, the elastic
distortion on the same generator state), representative children, scaled
links. Floats in f32, against JAX on the CPU: each stage within 1e-5 of
the largest magnitude of its output (the random weights keep no
activation scale: up to ~1e2 after the residual stages; the same products
summed in another order through up to ~20 layers), the whole forward's
probabilities within 1e-4 absolute and its logits and features within
1e-5 of their largest magnitude (~50 layers; measured 1.5e-5 and
1.2e-6), argmax labels equal. The JAX
weights are drawn by numpy into the shapes `jax.eval_shape` gives of
`init_bpnet_params` (its eager init takes ~36 s here), BN statistics
non-trivial, then carried into the port by `bpnet_params_from_jax`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models.bpnet import bpnet as jb
from sgnerf_tpu.models.bpnet import linking as jlk
from sgnerf_tpu.models.bpnet import unet2d as ju2
from sgnerf_tpu.models.bpnet import unet3d as ju3
from sgnerf_tpu.ops import sparse as jsp
from sgnerf_tpu_torch.models.bpnet import bpnet as tb
from sgnerf_tpu_torch.models.bpnet import linking as tlk
from sgnerf_tpu_torch.models.bpnet import unet2d as tu2
from sgnerf_tpu_torch.models.bpnet import unet3d as tu3
from sgnerf_tpu_torch.models.params import (bpnet_params_from_jax,
                                            bpnet_params_to_jax)
from sgnerf_tpu_torch.ops import sparse as tsp
from torch_threads import one_cpu_thread  # noqa: F401

STAGE_RTOL = 1e-5
V, W, H = 2, 32, 24


def jax_tree_np(seed=0, view_num=V):
    """The JAX BPNet tree's shapes filled from numpy: He-scaled conv
    weights, BN weight ~1, bias/mean ~0.1, variance in [0.5, 1.5]."""
    cfg = jb.BPNetConfig(view_num=view_num, img_wh=(W, H))
    shapes = jax.eval_shape(lambda k: jb.init_bpnet_params(k, cfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if s.shape == ():
            return 0                       # fea2d_dim: unused by forward
        if "running_var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "running_mean" in name or "bias" in name:
            return (rng.normal(size=s.shape) * 0.1).astype(np.float32)
        if name.endswith("['weight']"):
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jnp(tree):
    return jax.tree.map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray)
                        else a, tree)


@pytest.fixture(scope="module")
def params():
    np_tree = jax_tree_np()
    return _jnp(np_tree), bpnet_params_from_jax(np_tree), np_tree


def _grid_inputs(seed, n=150, box=12, c=3):
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, box, size=(n, 3)), axis=0).astype(
        np.int32)
    feats = rng.normal(size=(len(coords), c)).astype(np.float32)
    return coords, feats, (box, box, box)


def _grids(coords, feats, dims):
    return (jsp.make_sparse_grid(jnp.asarray(coords), jnp.asarray(feats),
                                 dims),
            tsp.make_sparse_grid(torch.as_tensor(coords),
                                 torch.as_tensor(feats), dims))


def _links(rng, m, h=H, w=W, v=V):
    links = np.zeros((m, 4, v), np.int32)
    links[:, 1, :] = rng.integers(0, h, size=(m, v))
    links[:, 2, :] = rng.integers(0, w, size=(m, v))
    links[:, 3, :] = rng.uniform(size=(m, v)) > 0.2
    return links


def _close(t, j, rtol=STAGE_RTOL):
    """max |t - j| within rtol of j's largest magnitude (at least 1)."""
    a, b = t.detach().numpy(), np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= rtol * scale, (err, scale)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- host ops

def test_compute_linking_and_voxelize_bit_equal():
    rng = np.random.default_rng(1)
    locs = (rng.normal(size=(400, 3)) * 0.6 + [0, 0, 2]).astype(np.float32)
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 20.0
    intr[0, 2], intr[1, 2] = 16, 12
    c2w = np.eye(4)
    c2w[:3, 3] = [0.05, -0.02, 0.1]
    depth = rng.uniform(1.5, 2.5, (H, W)).astype(np.float32)
    for vs in (0.05, 0.5):
        np.testing.assert_array_equal(
            tb.compute_linking(intr, c2w, locs, depth, vs),
            jb.compute_linking(intr, c2w, locs, depth, vs))
    feats = rng.uniform(0, 255, (400, 3)).astype(np.float32)
    links = rng.integers(0, 9, size=(400, 4, 2)).astype(np.int32)
    a = tb.voxelize(locs, feats, 0.1, links, return_first=True)
    b = jb.voxelize(locs, feats, 0.1, links, return_first=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_elastic_distortion_bit_equal_on_the_same_generator_state():
    locs = (np.random.default_rng(2).normal(size=(300, 3))).astype(
        np.float32)
    for g, m in ((0.2, 0.4), (0.8, 1.6)):
        np.testing.assert_array_equal(
            tb.elastic_distortion(locs, g, m, np.random.default_rng(5)),
            jb.elastic_distortion(locs, g, m, np.random.default_rng(5)))
    np.testing.assert_array_equal(
        tb.prevoxel_distort(locs, np.random.default_rng(6)),
        jb.prevoxel_distort(locs, np.random.default_rng(6)))


def test_representative_child_and_scaled_links_bit_equal():
    coords, feats, dims = _grid_inputs(3, n=300)
    jg, tg = _grids(coords, feats, dims)
    w = np.ones((8, 3, 3), np.float32)
    jc, _ = jsp.sparse_conv_down(jg, jnp.asarray(w), 90)
    tc, _ = tsp.sparse_conv_down(tg, torch.as_tensor(w), 90)
    np.testing.assert_array_equal(
        tb.representative_child(tg, tc).numpy(),
        np.asarray(jb.representative_child(jg, jc)))
    links = _links(np.random.default_rng(4), 50, h=480, w=640)
    for hw in ((15, 20), (60, 80), (120, 160)):
        np.testing.assert_array_equal(
            tb._scale_links(torch.as_tensor(links), *hw, 480, 640).numpy(),
            np.asarray(jb._scale_links(jnp.asarray(links), *hw, 480, 640)))


def test_select_views_equals_jax():
    paths = [f"/s/color/{i}.jpg" for i in range(0, 40, 5)]
    cfg = tb.BPNetConfig(view_num=3, img_wh=(W, H))
    jnet = jb.BPNet.__new__(jb.BPNet)
    jnet.cfg = jb.BPNetConfig(view_num=3, img_wh=(W, H))
    tnet = tb.BPNet.__new__(tb.BPNet)
    tnet.cfg = cfg
    for cur in (paths[0], paths[5], "/s/color/3.jpg"):
        assert tnet._select_views(paths, cur) == jnet._select_views(paths,
                                                                    cur)


# ------------------------------------------------------------------ stages

@pytest.mark.parametrize("k,stride", [(7, 2), (3, 1), (3, 2), (1, 2)])
def test_mvs_2d_helpers_match_jax(k, stride):
    """conv2d (symmetric k//2 padding), batch_norm, the align-corners
    resize and the 2x upsample, NCHW/OIHW against NHWC/HWIO."""
    from sgnerf_tpu.models import mvs as jm
    from sgnerf_tpu_torch.models import mvs as tm
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, 13, 17, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 6)).astype(np.float32)
    p = {"weight": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(size=6),
         "running_mean": rng.normal(size=6),
         "running_var": rng.uniform(0.5, 1.5, 6)}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    jy = jm.batch_norm(jm.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride),
                       {n: jnp.asarray(v) for n, v in p.items()})
    ty = tm.batch_norm(tm.conv2d(tx, torch.from_numpy(w).permute(3, 2, 0, 1),
                                 stride=stride),
                       {n: torch.from_numpy(v) for n, v in p.items()})
    _close(_nhwc(ty), jy)
    _close(_nhwc(tm.resize_bilinear_align_corners(tx, (7, 29))),
           jm.resize_bilinear_align_corners(jnp.asarray(x), (7, 29)))
    _close(_nhwc(tm.upsample2x_bilinear(tx)),
           jm.upsample2x_bilinear(jnp.asarray(x)))


def test_unet2d_encoder_up_block_and_cls_match_jax(params):
    jp, tp, _ = params
    imgs = np.random.default_rng(5).normal(size=(V, H, W, 3)).astype(
        np.float32)
    jx = ju2.encoder_apply(jp["unet2d"], jnp.asarray(imgs))
    tx = tu2.encoder_apply(tp["unet2d"],
                           torch.as_tensor(imgs).permute(0, 3, 1, 2))
    for a, b in zip(tx, jx):
        _close(_nhwc(a), b)
    jy = ju2.up_block(jp["unet2d"], "up4", "delayer4", jx[4], jx[3])
    ty = tu2.up_block(tp["unet2d"], "up4", "delayer4", tx[4], tx[3])
    _close(_nhwc(ty), jy)
    jy = ju2.up_block(jp["unet2d"], "up2", "delayer2",
                      jnp.asarray(np.asarray(jx[2])[..., :128]), jx[1])
    ty = tu2.up_block(tp["unet2d"], "up2", "delayer2", tx[2][:, :128], tx[1])
    _close(_nhwc(ty), jy)
    _close(_nhwc(tu2.cls_apply(tp["unet2d"], ty, (H, W))),
           ju2.cls_apply(jp["unet2d"], jy, (H, W)))


def test_unet3d_stages_match_jax(params):
    jp, tp, _ = params
    j3, t3 = jp["unet3d"], tp["unet3d"]
    coords, feats, dims = _grid_inputs(6)
    jg, tg = _grids(coords, feats, dims)
    m = len(coords)
    j1, t1 = ju3.layer0(j3, jg), tu3.layer0(t3, tg)
    _close(t1.feats, j1.feats)
    j2, t2 = ju3.down_stage(j3, 1, j1, m), tu3.down_stage(t3, 1, t1, m)
    np.testing.assert_array_equal(t2.coords.numpy(), np.asarray(j2.coords))
    _close(t2.feats, j2.feats)
    j4, t4 = ju3.down_stage(j3, 2, j2, m), tu3.down_stage(t3, 2, t2, m)
    _close(t4.feats, j4.feats)
    # decoder on widths of its own: convtr6 takes planes[5] channels
    rng = np.random.default_rng(7)
    c4 = rng.normal(size=(m, 128)).astype(np.float32)
    jc = dataclasses.replace(j4, feats=jnp.asarray(c4))
    tc = dataclasses.replace(t4, feats=torch.as_tensor(c4))
    ju, tu = (ju3.up_stage(j3, "convtr6", jc, j2),
              tu3.up_stage(t3, "convtr6", tc, t2))
    _close(tu.feats, ju.feats)
    jb7, tb7 = (ju3.blocks_on_cat(j3, "block7", ju, j2.feats),
                tu3.blocks_on_cat(t3, "block7", tu, t2.feats))
    _close(tb7.feats, jb7.feats)
    f8 = rng.normal(size=(m, 96)).astype(np.float32)
    jc = dataclasses.replace(j1, feats=jnp.asarray(f8))
    tc = dataclasses.replace(t1, feats=torch.as_tensor(f8))
    _close(tu3.cls_head(t3, tc), ju3.cls_head(j3, jc))


@pytest.mark.parametrize("level,c3", [("p4", 128), ("p2", 96)])
def test_apply_linking_matches_jax(params, level, c3):
    """Many voxels link to the same pixels (a 6x8 map, ~100 rows): the
    3D -> 2D scatter's last writer decides, as in the JAX scatter."""
    jp, tp, _ = params
    coords, feats, dims = _grid_inputs(8, c=c3)
    jg, tg = _grids(coords, feats, dims)
    c2 = {"p4": 256, "p2": 96}[level]
    rng = np.random.default_rng(9)
    f2 = rng.normal(size=(V, 6, 8, c2)).astype(np.float32)
    links = _links(rng, len(coords), h=6, w=8)
    j3, j2 = jlk.apply_linking(jp[f"linker_{level}"], jnp.asarray(f2), jg,
                               jnp.asarray(links), V)
    t3, t2 = tlk.apply_linking(tp[f"linker_{level}"],
                               torch.as_tensor(f2).permute(0, 3, 1, 2), tg,
                               torch.as_tensor(links), V)
    _close(t3.feats, j3.feats)
    _close(_nhwc(t2), j2)


# ------------------------------------------------------------ whole forward

def _forward_inputs(seed=10):
    coords, feats, dims = _grid_inputs(seed, n=130)
    rng = np.random.default_rng(seed + 1)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    return coords, feats, dims, imgs, _links(rng, len(coords))


@pytest.fixture(scope="module")
def jax_forward(params):
    """The jitted JAX forward on _forward_inputs (~8 s to compile)."""
    jp, _, _ = params
    coords, feats, dims, imgs, links = _forward_inputs()
    m = len(coords)
    jg = jsp.make_sparse_grid(jnp.asarray(coords), jnp.asarray(feats), dims)
    cfg = jb.BPNetConfig(view_num=V, img_wh=(W, H))
    fwd = jax.jit(lambda p, g, im, lk: jb.bpnet_forward(
        p, cfg, g, im, lk, (m, m, max(m // 2, 64), max(m // 4, 64))))
    return [np.asarray(x) for x in fwd(jp, jg, jnp.asarray(imgs),
                                       jnp.asarray(links))]


def _port_forward(tree, dtype="float32"):
    coords, feats, dims, imgs, links = _forward_inputs()
    m = len(coords)
    tg = tsp.make_sparse_grid(torch.as_tensor(coords), torch.as_tensor(feats),
                              dims)
    cfg = tb.BPNetConfig(view_num=V, img_wh=(W, H), compute_dtype=dtype)
    with torch.no_grad():
        return tb.bpnet_forward(tree, cfg, tg, torch.as_tensor(imgs),
                                torch.as_tensor(links),
                                (m, m, max(m // 2, 64), max(m // 4, 64)))


def _check_forward(got, want):
    sm, l2, f3 = got
    assert sm.dtype == l2.dtype == f3.dtype == torch.float32
    np.testing.assert_allclose(sm.numpy(), want[0], atol=1e-4)
    _close(l2, want[1], 1e-5)
    _close(f3, want[2], 1e-5)
    np.testing.assert_array_equal(sm.numpy().argmax(-1), want[0].argmax(-1))


def test_bpnet_forward_matches_jitted_jax(params, jax_forward):
    _, tp, _ = params
    got = _port_forward(tp)
    assert got[0].shape == jax_forward[0].shape
    assert got[1].shape == (V, H, W, 20) and got[2].shape[1] == 96
    np.testing.assert_allclose(got[0].sum(-1).numpy(), 1.0, atol=1e-5)
    _check_forward(got, jax_forward)


def test_bpnet_bf16_agrees_with_f32(params):
    """bf16 weights, images and grid features: 3D labels agree with f32 on
    > 95% of voxels (the JAX package's criterion, tests/test_bpnet.py),
    outputs f32 and finite."""
    _, tp, _ = params
    sm32, _, _ = _port_forward(tp)
    sm16, l16, f16 = _port_forward(tp, "bfloat16")
    assert sm16.dtype == l16.dtype == f16.dtype == torch.float32
    assert torch.isfinite(f16).all() and torch.isfinite(l16).all()
    agree = (sm16.argmax(-1) == sm32.argmax(-1)).float().mean().item()
    assert agree > 0.95, agree


def test_params_round_trip_to_jax(params):
    _, tp, np_tree = params
    back = bpnet_params_to_jax(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    by_path = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(np_tree)
               if isinstance(v, np.ndarray)}
    assert len(flat_a) == len(by_path) > 400
    for k, v in flat_a:
        np.testing.assert_array_equal(v, by_path[jax.tree_util.keystr(k)])


def test_convert_bpnet_checkpoint_agrees_with_jax(params, jax_forward,
                                                  tmp_path):
    """A reference-format checkpoint fabricated from the JAX tree (the JAX
    test's fabricator, module. prefixes and a state_dict wrapper) through
    both packages' converters: the JAX converter's tree carried into the
    port equals the port converter's bit for bit, and the port's forward
    on it matches the JAX forward on the original tree."""
    from sgnerf_tpu.models.checkpoint_io import (
        convert_bpnet_checkpoint as j_convert)
    from sgnerf_tpu_torch.models.checkpoint_io import (
        convert_bpnet_checkpoint as t_convert)
    from test_bpnet import _fabricate_reference_bpnet_sd
    _, tp, np_tree = params
    sd = _fabricate_reference_bpnet_sd(np_tree)
    path = str(tmp_path / "bpnet_5cm.pth.tar")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
    got = t_convert(path)
    via_jax = bpnet_params_from_jax(j_convert(path))
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(via_jax)):
        assert ka == kb
        assert torch.equal(a, b), jax.tree_util.keystr(ka)
    assert len(jax.tree_util.tree_leaves(got)) == len(
        jax.tree_util.tree_leaves(tp))
    _check_forward(_port_forward(got), jax_forward)
