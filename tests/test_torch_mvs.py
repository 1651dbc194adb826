"""The port's MVS nets, depth filter and point bootstrap against the JAX
package on the CPU, on the same seeded inputs and the JAX weights carried
over (`mvs_params_from_jax`).

Tolerances: FeatureNet, the official FeatureNet, both CostRegNets and the
stride-2 transposed conv within 1e-4 of the largest magnitude (the two
packages sum the convolutions in different orders); predict_depth's depth
within 1e-4 (far - near), its probability within 1e-4, its confidence
within 1e-4 where the truncated depth index agrees (the test counts the
pixels where it does not); the weights' layouts and the MVSNet converter
bit-equal; filter_depths' masks and point counts equal but for pixels
whose reprojection error lies within 1e-5 of its threshold (counted);
alpha_masking and the nerf-synth hull views bit-equal (numpy copies); the
whole bootstrap's point count equal, its points within 1e-4 and its
embeddings within 1e-4 on every point but those on their camera's frame
border (a point unprojected from a view's first row or column projects
back onto the border, where an ulp decides the in-frame test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_cpu_thread  # noqa: F401

from sgnerf_tpu.models import mvs as jm
from sgnerf_tpu_torch.models import mvs as tm
from sgnerf_tpu_torch.models.params import (mvs_params_from_jax,
                                            mvs_params_to_jax)


def _close(a, b, rel=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * max(float(np.abs(b).max()), 1e-30))


@pytest.fixture(scope="module")
def params():
    """JAX's init with non-trivial BN statistics (so a swapped mean/var or
    a missed leaf shows), as numpy, and the port's copy."""
    tree = jax.tree.map(np.asarray, jm.init_mvs_params(
        jax.random.key(1), jm.MVSConfig()))
    rng = np.random.default_rng(0)

    def stats(t):
        if isinstance(t, dict):
            if "running_mean" in t:
                n = t["running_mean"].shape
                t["running_mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                t["running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                t["weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                t["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            for v in t.values():
                stats(v)
        elif isinstance(t, list):
            for v in t:
                stats(v)
    stats(tree)
    return tree, mvs_params_from_jax(tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_mvs_params_round_trip(params):
    tree, port = params
    back = mvs_params_to_jax(port)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back)) > 150
    for path, a in leaves:
        b = back
        for k in path:
            b = b[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    w = port["CostRegNet"]["conv7"]["0"]["weight"]       # transposed conv
    assert tuple(w.shape) == (64, 32, 3, 3, 3)


def test_conv_transpose3d_s2_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 3, 5, 6)).astype(np.float32)   # NDHWC
    w = rng.normal(size=(3, 3, 3, 2, 6)).astype(np.float32)   # (k,k,k,co,ci)
    want = np.asarray(jm.conv_transpose3d_s2(jnp.asarray(x), jnp.asarray(w)))
    got = tm.conv_transpose3d_s2(
        torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()),
        mvs_params_from_jax({"w": w})["w"]).numpy()
    _close(got.transpose(0, 2, 3, 4, 1), want)


@pytest.mark.parametrize("net", ["FeatureNet", "official"])
def test_feature_nets_match_jax(params, net):
    tree, port = params
    imgs = np.random.default_rng(2).uniform(0, 1, (2, 40, 48, 3)).astype(
        np.float32)
    if net == "FeatureNet":
        want = jm.feature_net_apply(tree["FeatureNet"], jnp.asarray(imgs))
        got = tm.feature_net_apply(port["FeatureNet"], _nchw(imgs))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _close(g.numpy().transpose(0, 2, 3, 1), w)
    else:
        want = jm.official_feature_apply(tree["official"]["feature"],
                                         jnp.asarray(imgs))
        got = tm.official_feature_apply(port["official"]["feature"],
                                        _nchw(imgs))
        _close(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("net", ["CostRegNet", "official"])
def test_cost_reg_nets_match_jax(params, net):
    tree, port = params
    ci = 41 if net == "CostRegNet" else 32
    vol = np.random.default_rng(3).normal(size=(1, 8, 8, 16, ci)).astype(
        np.float32)
    tvol = torch.from_numpy(vol.transpose(0, 4, 1, 2, 3).copy())
    if net == "CostRegNet":
        want = jm.cost_reg_apply(tree["CostRegNet"], jnp.asarray(vol))
        got = tm.cost_reg_apply(port["CostRegNet"], tvol)
    else:
        want = jm.official_cost_reg_apply(
            tree["official"]["cost_regularization"], jnp.asarray(vol))
        got = tm.official_cost_reg_apply(
            port["official"]["cost_regularization"], tvol)
    _close(got.numpy().transpose(0, 2, 3, 4, 1), want)


def _views(V=3, H=64, W=80, seed=4):
    """V views of a textured scene: images and feature-scale projections
    with small rotations and baselines."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    projs = np.stack([np.eye(4, dtype=np.float32)[:3] for _ in range(V)])
    for v in range(1, V):
        th = 0.02 * v
        projs[v, :3, :3] = [[np.cos(th), -np.sin(th), 0],
                            [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        projs[v, :3, 3] = [0.3 * v, -0.15 * v, 0.01]
    return imgs, projs


def test_homo_warp_matches_jax():
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(12, 16, 4)).astype(np.float32)
    _, projs = _views()
    d = np.broadcast_to(np.linspace(1.0, 3.0, 5)[:, None, None],
                        (5, 12, 16)).astype(np.float32)
    wj, gj = jm.homo_warp(jnp.asarray(feat), jnp.asarray(projs[1]),
                          jnp.asarray(d))
    wt, gt = tm.homo_warp(torch.from_numpy(feat.transpose(2, 0, 1).copy()),
                          torch.from_numpy(projs[1]), torch.from_numpy(d))
    _close(gt.numpy(), gj, 1e-5)
    _close(wt.numpy().transpose(1, 2, 3, 0), wj)


@pytest.mark.parametrize("D,H", [(16, 64), (12, 44)])
def test_predict_depth_matches_jax(params, D, H):
    """D 12 and h 11 exercise the zero-padding to multiples of 8."""
    tree, port = params
    imgs, projs = _views(H=H)
    near, far = 1.0, 3.0
    dvals = np.linspace(near, far, D).astype(np.float32)
    jd, jc, jp = jm.MvsPointsModel(jm.MVSConfig(), params=tree).predict_depth(
        jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dvals))
    td, tc, tp = tm.MvsPointsModel(tm.MVSConfig(), params=port).predict_depth(
        torch.from_numpy(imgs), torch.from_numpy(projs),
        torch.from_numpy(dvals))
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-4 * (far - near))
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-4)
    jp_, tp_ = np.asarray(jp), tp.numpy()
    ar = np.arange(D)[:, None, None]
    same = (jp_ * ar).sum(0).astype(np.int32) == (tp_ * ar).sum(0).astype(
        np.int32)
    print(f"truncated depth index differs on {(~same).sum()} of {same.size}")
    assert (~same).mean() <= 0.01
    np.testing.assert_allclose(tc.numpy()[same], np.asarray(jc)[same],
                               rtol=0, atol=1e-4)


def test_gen_points_and_query_embedding_match_jax(params):
    tree, port = params
    rng = np.random.default_rng(6)
    H, W, V = 24, 32, 2
    intr = np.array([[24.0, 0, W / 2], [0, 24.0, H / 2], [0, 0, 1]],
                    np.float32)
    c2ws = np.stack([np.eye(4, dtype=np.float32)] * V)
    c2ws[1, 0, 3] = 0.1
    w2cs = np.stack([np.linalg.inv(c) for c in c2ws]).astype(np.float32)
    imgs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    depth = (2.0 + 0.2 * np.sin(gx / 5.0) * np.cos(gy / 4.0)).astype(
        np.float32)
    depth[:3] = 9.0                                     # off the far plane
    nf = (0.5, 4.0)
    a = jm.MvsPointsModel(jm.MVSConfig(), params=tree).gen_points(
        jnp.asarray(imgs), None, jnp.asarray(intr), nf,
        gt_depth=jnp.asarray(depth))
    b = tm.MvsPointsModel(tm.MVSConfig(), params=port).gen_points(
        torch.from_numpy(imgs), None, torch.from_numpy(intr), nf,
        gt_depth=torch.from_numpy(depth))
    np.testing.assert_allclose(b[0].numpy(), a[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(b[1].numpy(), a[1])
    cam = np.asarray(a[0]).reshape(-1, 3)
    conf = rng.uniform(0.5, 1, len(cam)).astype(np.float32)
    for cam_vid in (0, 1):
        ja = jm.MvsPointsModel(jm.MVSConfig(), params=tree).query_embedding(
            (H, W), jnp.asarray(cam), jnp.asarray(conf), jnp.asarray(imgs),
            jnp.asarray(c2ws), jnp.asarray(w2cs),
            jnp.asarray(np.stack([intr] * V)), cam_vid=cam_vid)
        tb = tm.MvsPointsModel(tm.MVSConfig(), params=port).query_embedding(
            (H, W), torch.from_numpy(cam), torch.from_numpy(conf),
            torch.from_numpy(imgs), torch.from_numpy(c2ws),
            torch.from_numpy(w2cs), torch.from_numpy(np.stack([intr] * V)),
            cam_vid=cam_vid)
        for x, y in zip(tb, ja):
            _close(x.numpy(), y)


def _ref_sd(tree, seed=7):
    """A state dict with the reference MVSNet's key names (module. prefix,
    ConvBnReLU .conv/.bn, BN counters) from the JAX `official` tree."""
    from sgnerf_tpu_torch.models.params import mvs_params_from_jax as conv
    port = conv(tree["official"])
    sd = {}

    def put(prefix, t):
        for k, v in t.items():
            name = f"{prefix}.{k}"
            if isinstance(v, dict):
                if "running_var" in v:
                    sd[f"module.{name}.num_batches_tracked"] = \
                        torch.tensor(5)
                put(name, v)
            else:
                sd[f"module.{name}"] = v.clone()
    put("feature", port["feature"])
    put("cost_regularization", port["cost_regularization"])
    return sd


def test_official_mvsnet_converters_agree(params, tmp_path):
    """A checkpoint written with the reference's key names: both packages
    convert it to the same tree, and the port's predict_depth on it agrees
    with JAX's."""
    from sgnerf_tpu.models.checkpoint_io import (
        convert_official_mvsnet_checkpoint as jconv)
    from sgnerf_tpu_torch.models.checkpoint_io import (
        convert_official_mvsnet_checkpoint as tconv)
    tree, port = params
    path = str(tmp_path / "model_000015.ckpt")
    torch.save({"model": _ref_sd(tree)}, path)
    j, t = jconv(path), tconv(path)
    back = mvs_params_to_jax(t)
    jl = jax.tree_util.tree_leaves_with_path(j)
    assert len(jl) == len(jax.tree_util.tree_leaves(back)) >= 60
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for pa, a in jl:
        np.testing.assert_array_equal(np.asarray(a), flat_b[pa],
                                      err_msg=str(pa))
    imgs, projs = _views()
    dvals = np.linspace(1.0, 3.0, 8).astype(np.float32)
    jt = dict(jax.tree.map(np.asarray, tree), official=j)
    jd, _, _ = jm.MvsPointsModel(jm.MVSConfig(), params=jt).predict_depth(
        jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dvals))
    td, _, _ = tm.MvsPointsModel(tm.MVSConfig(),
                                 params=dict(port, official=t)).predict_depth(
        torch.from_numpy(imgs), torch.from_numpy(projs),
        torch.from_numpy(dvals))
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=2e-4)


# ------------------------------------------------------------------ filter

def _plane_views(V=3, H=24, W=32, seed=8):
    """V cameras facing a tilted plane; each view's depth analytic, one
    view with a noisy patch so the masks vary."""
    rng = np.random.default_rng(seed)
    intr = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]],
                    np.float32)
    n, c = np.array([0.1, 0.05, 1.0]), 2.0          # plane n.x = c
    depths, extrs = [], []
    for v in range(V):
        w2c = np.eye(4)
        w2c[:3, 3] = [-0.15 * v, 0.05 * v, 0.0]
        extrs.append(w2c.astype(np.float32))
        campos = -w2c[:3, 3]
        gy, gx = np.mgrid[0:H, 0:W].astype(np.float64)
        d = np.stack([(gx - W / 2) / 30.0, (gy - H / 2) / 30.0,
                      np.ones_like(gx)], -1)
        t = (c - campos @ n) / (d @ n)                # z-depth along the ray
        depth = t.astype(np.float32)
        if v == 1:
            depth[5:12, 4:14] += rng.uniform(-0.1, 0.1, (7, 10))
        depths.append(depth)
    confs = [rng.uniform(0.5, 1.0, (H, W)).astype(np.float32)
             for _ in range(V)]
    return depths, [intr] * V, extrs, confs


def test_filter_depths_matches_jax():
    from sgnerf_tpu.models import mvs_filter as jf
    from sgnerf_tpu_torch.models import mvs_filter as tf
    depths, intrs, extrs, confs = _plane_views()
    V = len(depths)
    near_px = np.zeros(depths[0].shape, bool)
    jt = [[jnp.asarray(x) for x in xs] for xs in (depths, intrs, extrs,
                                                  confs)]
    tt = [[torch.from_numpy(x) for x in xs] for xs in (depths, intrs, extrs,
                                                       confs)]
    n_near = 0
    for ref in range(V):
        near = np.zeros(depths[0].shape, bool)
        for src in range(V):
            if src == ref:
                continue
            args_j = (jt[0][ref], jt[1][ref], jt[2][ref], jt[0][src],
                      jt[1][src], jt[2][src])
            mj, vj, dj = jf.check_geometric_consistency(*args_j)
            dist, rel, _, _ = tf.consistency_terms(
                tt[0][ref], tt[1][ref], tt[2][ref], tt[0][src], tt[1][src],
                tt[2][src])
            mt, vt, dt = tf.check_geometric_consistency(
                tt[0][ref], tt[1][ref], tt[2][ref], tt[0][src], tt[1][src],
                tt[2][src])
            nr = ((np.abs(dist.numpy() - 1) < 1e-5)
                  | (np.abs(rel.numpy() - 0.01) < 1e-5))
            near |= nr
            np.testing.assert_array_equal(mt.numpy()[~nr],
                                          np.asarray(mj)[~nr])
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
            np.testing.assert_allclose(dt.numpy()[~nr], np.asarray(dj)[~nr],
                                       rtol=1e-5, atol=1e-5)
        n_near += int(near.sum())
        near_px |= near
    print(f"pixels within 1e-5 of a threshold: {n_near}")
    for g in (0, 1, 2):
        a = jf.filter_depths(*jt, depth_conf_thresh=0.7, geo_cnsst_num=g)
        b = tf.filter_depths(*tt, depth_conf_thresh=0.7, geo_cnsst_num=g)
        for (xa, ca), (xb, cb) in zip(a, b):
            assert abs(len(xa) - len(xb)) <= n_near, (g, len(xa), len(xb))
            if len(xa) == len(xb) and n_near == 0:
                np.testing.assert_allclose(xb, xa, rtol=0, atol=1e-4)
                np.testing.assert_array_equal(cb, ca)
        assert sum(len(x) for x, _ in b) > 0


def test_alpha_masking_and_hull_views_match_jax(tmp_path):
    from sgnerf_tpu.models.mvs_filter import alpha_masking as ja
    from sgnerf_tpu_torch.models.mvs_filter import alpha_masking as ta
    rng = np.random.default_rng(9)
    H, W = 24, 32
    intr = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]],
                    np.float32)
    w2cs = [np.eye(4, dtype=np.float32) for _ in range(3)]
    w2cs[1][0, 3], w2cs[2][1, 3] = 0.1, -0.1
    alphas = [(rng.uniform(0, 1, (1, H, W)) > 0.3).astype(np.float32)
              for _ in range(3)]
    xyz = (rng.uniform(-1.5, 1.5, (2000, 3)) + [0, 0, 3]).astype(np.float32)
    for nf in (None, (2.0, 3.5)):
        for ar, inall in ((0, 1), (1, 1), (0, 0)):
            np.testing.assert_array_equal(
                ta(xyz, alphas, [intr] * 3, w2cs, nf, ar, inall),
                ja(xyz, alphas, [intr] * 3, w2cs, nf, ar, inall))


# --------------------------------------------------------------- bootstrap

def test_mvs_bootstrap_matches_jax(tmp_path, monkeypatch):
    """gen_points_filter_embeddings on a DTU tree, the dataset's depths
    (manual_depth_view 0) and JAX's weights: the same number of points,
    positions within 1e-4, embeddings, colours and directions within 1e-4
    on all but the border points."""
    from test_torch_dtu import _jax_full_image, write_dtu_tree
    from sgnerf_tpu.data import create_dataset as jcreate
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu.runtime.mvs_bootstrap import gen_points_filter_embeddings
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.runtime import mvs_bootstrap
    root = write_dtu_tree(tmp_path / "dtu")
    flags = ["--data_root", root, "--scan", "scan1", "--dataset_name", "dtu",
             "--img_wh", "64", "48", "--train_step", "5",
             "--load_points", "0", "--manual_depth_view", "0",
             "--depth_conf_thresh", "0.5", "--geo_cnsst_num", "1",
             "--vox_res", "40", "--point_features_dim", "32",
             "--ranges", "-10", "-10", "-10", "10", "10", "10"]
    opt = JOpts().parse(flags)
    opt.split = "train"
    _jax_full_image(monkeypatch)
    jcfg = jm.MVSConfig(depth_grid=opt.depth_grid,
                        dprob_thresh=opt.dprob_thresh,
                        point_features_dim=opt.point_features_dim,
                        init_view_num=opt.init_view_num)
    a = gen_points_filter_embeddings(jcreate(opt), opt,
                                     key=jax.random.key(11))
    tree = jax.tree.map(np.asarray, jm.init_mvs_params(jax.random.key(11),
                                                       jcfg))
    mvs = mvs_bootstrap.mvs_model(opt, "cpu")
    mvs.params = mvs_params_from_jax(tree)
    b = mvs_bootstrap.gen_points_filter_embeddings(create_dataset(opt), opt,
                                                   "cpu", mvs=mvs)
    assert len(a[0]) == len(b[0]) > 200, (len(a[0]), len(b[0]))
    np.testing.assert_allclose(b[0], np.asarray(a[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(b[4], np.asarray(a[4]))
    off = np.zeros(len(a[0]), bool)
    for x, y in zip(b[1:4], a[1:4]):
        y = np.asarray(y)
        off |= np.abs(x - y).max(-1) > 1e-4 * max(np.abs(y).max(), 1e-30)
    # the off points must sit on their camera's frame border
    from sgnerf_tpu_torch.runtime.native import nearest_view
    ds = create_dataset(opt)
    cam = nearest_view(*ds.get_campos_ray(), b[0])
    edge = np.full(len(b[0]), np.inf)
    for ci in np.unique(cam):
        sel = cam == ci
        item = ds.get_item(int(ci), full_img=True)
        w2c = np.linalg.inv(item["c2w"])
        pc = b[0][sel] @ w2c[:3, :3].T + w2c[:3, 3]
        px = (pc / pc[:, 2:3]) @ item["intrinsic"].T
        edge[sel] = np.min(np.abs(np.concatenate(
            [px[:, :2], px[:, :2] - [ds.width - 1, ds.height - 1]], -1)), -1)
    print(f"bootstrap: {len(a[0])} points, {off.sum()} off by > 1e-4, "
          f"{(edge < 1e-3).sum()} on a frame border")
    assert (edge[off] < 1e-3).all(), edge[off]
