"""The port's perspective-space path (`--wcoord_query 0`) and NeRF-synthetic
data against the JAX package on the CPU: the five ray generators, the
per-frame perspective grid and query, render_rays_perspective (eval, and
the train step with its shading-point jitter), the blender dataset,
growing in perspective mode, and train_ft then test_ft on a tiny
NeRF-synthetic scene.

Tolerances: voxel slots, bucket contents and neighbour ids bit for bit;
sample depths, positions and perspective coords rtol 1e-6 (f32, the same
formulas); rendered colours 1e-4 (tests/test_torch_render.py's limit); the train step's losses rtol 1e-5, parameters and point fields
rtol 2e-3, atol 2e-6 (tests/test_torch_semantic.py's limits).
"""
import contextlib
import io
import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.models import train as jtrain
from sgnerf_tpu.ops import query_pers as jqp
from sgnerf_tpu.ops import raygen as jraygen
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models import point_cloud as tpc
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models import train as ttrain
from sgnerf_tpu_torch.models.params import params_from_jax
from sgnerf_tpu_torch.ops import camera as tcam
from sgnerf_tpu_torch.ops import query_pers as tqp
from sgnerf_tpu_torch.ops import raygen as traygen
from torch_threads import one_cpu_thread  # noqa: F401

GENERATORS = ["near_far_linear", "near_far_disparity_linear",
              "nerf_near_far_linear", "nerf_near_far_disparity_linear",
              "cube"]


def _rays(R=64, seed=1):
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(1, R, 3)) * 0.25).astype(np.float32)
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.asarray([[0.1, -0.2, -3.0]], np.float32), d


@pytest.mark.parametrize("jitter", [0.0, 0.3], ids=["eval", "train"])
@pytest.mark.parametrize("name", GENERATORS)
def test_ray_generator_matches_jax(name, jitter):
    campos, d = _rays()
    D = 40
    cfg = jren.RenderConfig(z_depth_dim=D, which_ray_generation=name)
    u = jren.draw_render_noise(jax.random.key(3), cfg, 1, d.shape[1],
                               is_train=True)["raygen_u"]
    kw = dict(near=1.0, far=5.0, jitter=jitter, domain_size=0.6)
    jout = jraygen.find_ray_generation_method(name)(
        jnp.asarray(campos), jnp.asarray(d), D, u=u, **kw)
    tout = traygen.find_ray_generation_method(name)(
        torch.from_numpy(campos), torch.from_numpy(d), D,
        u=torch.from_numpy(np.asarray(u)), **kw)
    for a, b, what in zip(tout, jout, ("raypos", "seg", "valid", "ts")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=what)
    if name == "cube":
        assert 0 < tout[2].numpy().mean() < 1
    with pytest.raises(RuntimeError, match="No such ray generation"):
        traygen.find_ray_generation_method("refine")


def test_render_noise_draws_jax_shapes():
    for name, perspective, jit in (("cube", False, "uniform"),
                                   ("near_far_linear", True, "uniform"),
                                   ("near_far_linear", True, "gaussian")):
        jcfg = jren.RenderConfig(z_depth_dim=16, SR=4,
                                 which_ray_generation=name, shpnt_jitter=jit)
        tcfg = tren.RenderConfig(z_depth_dim=16, SR=4,
                                 which_ray_generation=name, shpnt_jitter=jit)
        j = jren.draw_render_noise(jax.random.key(0), jcfg, 1, 256,
                                   perspective=perspective)
        t = tren.draw_render_noise(torch.Generator().manual_seed(0), tcfg,
                                   1, 256, perspective=perspective)
        assert sorted(t) == sorted(k for k in j if k != "kg")
        for k in t:
            assert tuple(t[k].shape) == j[k].shape, k
        lo = float(t["raygen_u"].min())
        assert (lo < 0) == (name == "cube") and lo >= -1
        if jit == "gaussian":
            assert float(t["shade_u"].min()) < 0


def test_pers2w_inverts_w2pers():
    rng = np.random.default_rng(0)
    rot = torch.from_numpy(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(
        np.float32))
    cp = torch.tensor([0.2, -0.1, -3.0])
    x = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    back = tcam.pers2w(tcam.w2pers(x, rot, cp), rot, cp)
    torch.testing.assert_close(back, x, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tcam.pers2w(x, rot, cp).numpy(),
        np.asarray(__import__("sgnerf_tpu.ops.camera", fromlist=["x"]).pers2w(
            jnp.asarray(x.numpy()), jnp.asarray(rot.numpy()),
            jnp.asarray(cp.numpy()))), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- the perspective grid

def _cloud(n=3000, cap=3200, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    return jpc.make_point_cloud(
        xyz, rng.normal(size=(n, 32)).astype(np.float32) * 0.2,
        conf=rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32), dir=xyz,
        capacity=cap)


def _port(jcloud):
    return tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")


INTR = np.array([[40.0, 0, 24.0], [0, 40.0, 18.0], [0, 0, 1]], np.float32)
PSPEC_KW = dict(intrinsic=INTR, W=48, H=36, near=1.0, far=5.0,
                vsize=[0.02] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
                max_o=8000, P=8)


def test_perspective_specs_match_jax():
    assert tqp.perspective_spec_from_camera(**PSPEC_KW).__dict__ == \
        jqp.perspective_spec_from_camera(**PSPEC_KW).__dict__
    pers = np.random.default_rng(2).normal(size=(100, 3)) + [0, 0, 3]
    kw = dict(vsize=[0.02] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
              max_o=100, P=4)
    assert tqp.perspective_grid_spec(pers, **kw).__dict__ == \
        jqp.perspective_grid_spec(pers, **kw).__dict__


def test_query_neighbors_perspective_matches_jax():
    """Slots of the frame's grid and neighbour ids bit for bit."""
    jcloud = _cloud()
    tcloud = _port(jcloud)
    spec = tqp.perspective_spec_from_camera(**PSPEC_KW)
    jspec = jqp.perspective_spec_from_camera(**PSPEC_KW)
    campos, d = _rays(R=96)
    rot = np.eye(3, dtype=np.float32)[None]
    raypos, _, _, _ = jraygen.near_far_linear_ray_generation(
        jnp.asarray(campos), jnp.asarray(d), 48, near=1.0, far=5.0)
    jres, jpers = jqp.query_neighbors_perspective(
        jcloud.xyz, jcloud.active, raypos, jnp.asarray(rot),
        jnp.asarray(campos), jspec, K=4, SR=6, radius_limit=0.16)
    tres, tpers = tqp.query_neighbors_perspective(
        tcloud.xyz, tcloud.active, torch.from_numpy(np.asarray(raypos)),
        torch.from_numpy(rot), torch.from_numpy(campos), spec, K=4, SR=6,
        radius_limit=0.16)
    np.testing.assert_allclose(tpers.numpy(), np.asarray(jpers), rtol=1e-6,
                               atol=1e-6)
    jgrid = jpc.build_grid(jpc.make_point_cloud(np.asarray(jpers),
                                                np.zeros((3200, 1),
                                                         np.float32)),
                           jspec)
    tgrid, _ = tqp.perspective_grid(tcloud.xyz, tcloud.active,
                                    torch.from_numpy(rot[0]),
                                    torch.from_numpy(campos[0]), spec)
    np.testing.assert_array_equal(tgrid.vox_slot.numpy(),
                                  np.asarray(jgrid.vox_slot))
    np.testing.assert_array_equal(tgrid.bucket_pnts.numpy(),
                                  np.asarray(jgrid.bucket_pnts))
    np.testing.assert_array_equal(tres.sample_pidx.numpy(),
                                  np.asarray(jres.sample_pidx))
    np.testing.assert_array_equal(tres.ray_mask.numpy(),
                                  np.asarray(jres.ray_mask))
    np.testing.assert_allclose(tres.sample_loc_w.numpy(),
                               np.asarray(jres.sample_loc_w), rtol=1e-6,
                               atol=1e-6)
    assert int((tres.sample_pidx >= 0).sum()) > 500


# ------------------------------------------------------------ the renders

RKW = dict(z_depth_dim=48, SR=6, K=4, vsize=(0.02,) * 3,
           shpnt_jitter="uniform")


def _setup(akw=None):
    akw = akw or {}
    jcloud = _cloud()
    jcfg = jren.RenderConfig(agg=jagg.AggregatorConfig(
        fused_mlp="none", fused_bwd="xla", **akw), **RKW)
    tcfg = tren.RenderConfig(agg=tagg.AggregatorConfig(**akw), **RKW)
    jparams = jagg.init_aggregator_params(jax.random.key(0), jcfg.agg)
    spec = tqp.perspective_spec_from_camera(**PSPEC_KW)
    return (jcloud, jcfg, jparams, jqp.perspective_spec_from_camera(
        **PSPEC_KW)), (_port(jcloud), tcfg, spec)


def _batch(R=64, seed=1):
    campos, d = _rays(R, seed)
    rng = np.random.default_rng(seed)
    return {"campos": campos, "raydir": d,
            "camrotc2w": np.eye(3, dtype=np.float32)[None],
            "near": np.float32(1.0), "far": np.float32(5.0),
            "bg_color": np.ones(3, np.float32),
            "gt_image": rng.uniform(0.2, 0.8, (1, R, 3)).astype(np.float32)}


@pytest.mark.parametrize("block3", [False, True], ids=["default", "block3"])
def test_render_rays_perspective_eval_matches_jax(block3):
    akw = dict(shading_feature_mlp_layer3=2) if block3 else {}
    (jcloud, jcfg, jparams, jspec), (tcloud, tcfg, spec) = _setup(akw)
    b = _batch(R=128)
    cam = ("campos", "raydir", "camrotc2w", "bg_color")
    jout = jren.render_rays_perspective(
        jparams, jcloud, jspec, jcfg, near=1.0, far=5.0,
        **{k: jnp.asarray(b[k]) for k in cam})
    with torch.inference_mode():
        tout = tren.render_rays_perspective(
            params_from_jax(jax.tree.map(np.asarray, jparams)), tcloud, spec,
            tcfg, near=1.0, far=5.0, **{k: torch.from_numpy(b[k])
                                        for k in cam})
    np.testing.assert_array_equal(tout["ray_mask"].numpy(),
                                  np.asarray(jout["ray_mask"]))
    assert tout["ray_mask"].numpy().mean() > 0.3
    for k in ("coarse_raycolor", "coarse_is_background",
              "coarse_point_opacity"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("jitter", ["uniform", "gaussian"])
def test_perspective_train_step_matches_jax(jitter):
    """One step through render_rays_perspective with the shading-point
    jitter and block3 (colour trained): losses, parameters, points."""
    akw = dict(shading_feature_mlp_layer3=2)
    (jcloud, jcfg, jparams, jspec), (tcloud, tcfg, spec) = _setup(akw)
    jcfg = jcfg.__class__(**dict(vars(jcfg), shpnt_jitter=jitter))
    tcfg = tcfg.__class__(**dict(vars(tcfg), shpnt_jitter=jitter))
    jtc, ttc = jtrain.TrainConfig(), ttrain.TrainConfig()
    jstate = jtrain.create_train_state(jparams, jcloud, jtc)
    tstate = ttrain.create_train_state(
        params_from_jax(jax.tree.map(np.asarray, jparams)), tcloud, ttc)
    jgrid = jpc.build_grid(jcloud, jpc.grid_spec_for_cloud(
        jcloud, vsize=[0.08] * 3, vscale=[1, 1, 1], kernel_size=[3, 3, 3],
        max_o=8192, P=16))
    b = _batch()
    key = jax.random.key(7)
    noise = jren.draw_render_noise(key, jcfg, 1, 64, perspective=True,
                                   is_train=True)
    assert "shade_u" in noise
    jstate, jl = jtrain.train_step(jstate, jgrid, jcfg, jtc,
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   key, pspec=jspec)
    tstate, tl = ttrain.train_step(
        tstate, None, tcfg, ttc,
        {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
        noise={k: torch.from_numpy(np.array(noise[k]))
               for k in ("raygen_u", "shade_u")}, pspec=spec)
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, err_msg=k)
    jp = jax.tree.map(np.asarray, jstate.params)
    for block, layers in jp.items():
        for li, layer in enumerate(layers):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    tstate.params[block][li][k].numpy(), layer[k],
                    rtol=2e-3, atol=2e-6, err_msg=f"{block}.{li}.{k}")
    for f in ("embedding", "conf", "color"):
        np.testing.assert_allclose(getattr(tstate.cloud, f).numpy(),
                                   np.asarray(getattr(jstate.cloud, f)),
                                   rtol=2e-3, atol=2e-6, err_msg=f)


# ------------------------------------------------------ NeRF-synthetic data

def _write_blender(root, size=32, n_pts=600, seed=3):
    """tests/test_cli_blender.py's scene: RGBA views from +z towards the
    origin and a pickled unit-sphere cloud."""
    from PIL import Image
    root.mkdir()
    rng = np.random.default_rng(seed)
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        (root / split).mkdir()
        for i in range(n):
            pose = np.eye(4)
            pose[:3, 3] = [0.08 * i, 0.05 * i, 4.0]
            img = rng.uniform(0, 255, size=(size, size, 4)).astype(np.uint8)
            Image.fromarray(img, "RGBA").save(root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    xyz = rng.normal(size=(n_pts, 3)).astype(np.float32)
    xyz = 0.6 * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    with open(root / "cloud.pkl", "wb") as f:
        pickle.dump({"point_xyz": xyz}, f)


@pytest.fixture(scope="module")
def lego(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerf")
    _write_blender(root / "lego")
    return str(root)


def _blender_flags(lego, ckpt, extra=()):
    """tests/test_cli_blender.py's flags, on the CPU."""
    return [
        "--scan", "lego", "--dataset_name", "nerf_synth_ft",
        "--data_root", lego, "--checkpoints_dir", str(ckpt),
        "--cloud_path", os.path.join(lego, "lego", "cloud.pkl"),
        "--num_point", "600", "--name", "lego_pers",
        "--img_wh", "32", "32", "--random_sample", "random",
        "--random_sample_size", "8",
        "--which_ray_generation", "near_far_linear",
        "--which_render_func", "radiance", "--which_blend_func", "alpha",
        "--which_tonemap_func", "off",
        "--near_plane", "2.0", "--far_plane", "6.0",
        "--z_depth_dim", "40", "--SR", "4", "--K", "2", "--P", "10",
        "--max_o", "40000", "--vsize", "0.02", "0.02", "0.02",
        "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
        "--radius_limit_scale", "4", "--agg_dist_pers", "20",
        "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
        "--point_features_dim", "32", "--num_feat_freqs", "3",
        "--dist_xyz_freq", "5", "--num_viewdir_freqs", "4",
        "--act_type", "LeakyReLU", "--shading_color_mlp_layer", "4",
        "--shading_feature_mlp_layer1", "2", "--act_super", "1",
        "--color_loss_items", "ray_masked_coarse_raycolor",
        "ray_miss_coarse_raycolor", "coarse_raycolor",
        "--color_loss_weights", "1.0", "0.0", "0.0",
        "--zero_one_loss_items", "conf_coefficient",
        "--zero_one_loss_weights", "0.0001",
        "--lr", "0.001", "--plr", "0.002",
        "--lr_policy", "iter_exponential_decay",
        "--lr_decay_iters", "1000000", "--raydist_mode_unit", "1",
        "--bg_color", "white", "--vox_res", "0",
        "--ranges", "-10", "-10", "-10", "10", "10", "10",
        "--wcoord_query", "0", "--shpnt_jitter", "uniform",
        "--gpu_ids", "-1", "--n_threads", "0"] + list(extra)


def test_blender_dataset_matches_jax(lego, tmp_path):
    from sgnerf_tpu.data import create_dataset as jcreate
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TrainOptions
    flags = _blender_flags(lego, tmp_path, ["--num_point", "200"])
    for split in ("train", "test"):
        jopt, opt = JOpts().parse(flags), TrainOptions().parse(flags)
        jopt.split = opt.split = split
        jd, td = jcreate(jopt), create_dataset(opt)
        assert len(td) == len(jd) and td.focal == jd.focal
        for i in range(len(td)):
            a = td.get_item(i, rng=np.random.default_rng(i))
            b = jd.get_item(i, rng=np.random.default_rng(i))
            assert sorted(a) == sorted(b)
            for k in ("pixel_idx", "gt_image", "campos", "camrotc2w",
                      "intrinsic", "bg_color"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_allclose(a["raydir"], b["raydir"], rtol=1e-6,
                                       atol=1e-7)
        for x, y in zip(td.get_campos_ray(), jd.get_campos_ray()):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    random.seed(5)
    xa = td.load_init_points()[0]
    random.seed(5)
    xb = jd.load_init_points()[0]
    np.testing.assert_array_equal(xa, xb)
    assert xa.shape == (200, 3)



def test_blender_hull_views_match_jax(lego, tmp_path):
    """The views the MVS bootstrap's visual hull reads: alpha masks,
    intrinsics and world-to-camera poses, bit-equal."""
    from sgnerf_tpu.data import create_dataset as jcreate
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TrainOptions
    flags = _blender_flags(lego, tmp_path)
    jopt, opt = JOpts().parse(flags), TrainOptions().parse(flags)
    jopt.split = opt.split = "train"
    jd, td = jcreate(jopt), create_dataset(opt)
    for k in ("alphas", "view_intrinsics", "world2cams"):
        a, b = getattr(td, k), getattr(jd, k)
        assert len(a) == len(b) == len(td)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=k)

def test_train_ft_then_test_ft_at_wcoord_query_0(lego, tmp_path):
    """train_ft then test_ft on the NeRF-synthetic scene through the
    perspective path, with block3 on colour and dir (the point colours
    train)."""
    from sgnerf_tpu_torch.run import test_ft, train_ft
    flags = _blender_flags(lego, tmp_path, [
        "--shading_feature_mlp_layer3", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_ft.main(flags + ["--maximum_step", "4", "--save_iter_freq",
                               "4", "--test_freq", "0", "--print_freq", "1",
                               "--test_num", "1"])
    out = buf.getvalue()
    assert "perspective frustum grid" in out and "training done" in out
    masked = [float(l_.split("ray_masked_coarse_raycolor:")[1].split()[0]
                    .rstrip(","))
              for l_ in out.splitlines()
              if "ray_masked_coarse_raycolor:" in l_]
    assert masked and any(v > 0 for v in masked), out[-2000:]
    expr = tmp_path / "lego_pers"
    for f in ("4_net_ray_marching.npz", "4_net_ray_marching.pth"):
        assert (expr / f).exists(), f
    tree = np.load(expr / "4_net_ray_marching.npz")
    assert any("block3" in k for k in tree.files)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        test_ft.main(flags + ["--resume_iter", "latest",
                              "--test_num_step", "1"])
    out = buf.getvalue()
    psnrs = [float(l_.split("psnr:")[1].split()[0])
             for l_ in out.splitlines() if l_.startswith("num.")]
    # the test split keeps every --testskip (8)-th view: one of two
    assert len(psnrs) == 1 and np.isfinite(psnrs).all(), out[-2000:]
    assert "mean psnr" in out


def test_growing_at_wcoord_query_0_matches_jax(tmp_path):
    """Growing in perspective mode probes the world grid, as the JAX
    package does (its probe render is render_rays on model.grid); then
    the grown model trains through the perspective path."""
    from sgnerf_tpu.runtime.growing import probe_and_grow as jgrow
    from sgnerf_tpu_torch.runtime.growing import probe_and_grow
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    from test_torch_growing import _models, _scene_dir
    scans = _scene_dir(tmp_path / "scans")
    (jm, jds, jopt), (tm, ds, opt) = _models(
        scans, tmp_path / "ckpt", ["--wcoord_query", "0", "--max_o", "0",
                                   "--P", "0"])
    assert tm.perspective and jm.perspective
    n0 = int(tm.cloud.n_active)
    key = jax.random.key(1)
    seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        jn = jgrow(jm, jds, jopt, key, opacity_thresh=0.0)
        tn = probe_and_grow(tm, ds, opt, seed, opacity_thresh=0.0)
    assert tn == jn > 0
    sl = slice(n0, n0 + tn)
    np.testing.assert_allclose(tm.cloud.xyz.numpy()[sl],
                               np.asarray(jm.state.cloud.xyz)[sl], rtol=0,
                               atol=1e-5)
    item = ds.get_item(0, rng=np.random.default_rng(0))
    jm.ensure_pspec(item)
    tm.ensure_pspec(item)
    assert tm.pspec.__dict__ == jm.pspec.__dict__
    losses = tm.optimize(batch_to_device(item, tm.device))
    assert torch.isfinite(losses["total"])
