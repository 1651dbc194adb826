"""The port's eval render vs the JAX reference on one synthetic ScanNet-layout
scene and one native checkpoint (checkpoint_io.save_native of numpy
params and cloud):

  * render_rays: coarse_raycolor within 1e-4 (f32 compute) on every ray.
    Sample depths, the grid and the K-nearest ids are bit-equal by
    construction (tests/test_torch_{grid,query}.py); what is left is float
    summation order in the MLPs and the FMA contraction XLA applies to
    campos + t*dir, which moves shading points by an ulp. The test allows
    at most 0.1% of rays whose neighbour ids differ and checks every such
    ray's shading points against the reference to 1e-6.
  * SceneModel.render_image on a full test view, same bound.
  * `python -m sgnerf_tpu_torch.run.test_ft` writes the per-image PSNR
    lines, the images and scores.txt.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 36


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """ScanNet export layout (pcd-free: the checkpoint carries the cloud)
    plus a native checkpoint of reference-initialised weights."""
    from PIL import Image
    from sgnerf_tpu.models.aggregator import (AggregatorConfig,
                                              init_aggregator_params)
    from sgnerf_tpu.models.checkpoint_io import save_native
    from sgnerf_tpu.models.point_cloud import make_point_cloud

    root = tmp_path_factory.mktemp("scans")
    scan = root / "scene_test" / "exported"
    for sub in ("color", "pose", "intrinsic"):
        (scan / sub).mkdir(parents=True)
    intr = np.eye(4)
    intr[:3, :3] = [[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]
    np.savetxt(scan / "intrinsic/intrinsic_color.txt", intr)
    rng = np.random.default_rng(0)
    for i in range(4):
        ang = 2 * np.pi * i / 4
        campos = np.array([3 * np.sin(ang), 0.3, -3 * np.cos(ang)],
                          np.float32)
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross([0, 1, 0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = campos
        np.savetxt(scan / f"pose/{i}.txt", c2w)
        Image.fromarray((rng.uniform(0, 1, (H, W, 3)) * 255).astype(
            np.uint8)).save(scan / f"color/{i}.jpg")

    n = 4000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    cloud = make_point_cloud(
        xyz, (rng.normal(size=(n, 32)) * 0.3).astype(np.float32),
        conf=rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32),
        color=np.clip(xyz * 0.5 + 0.5, 0, 1), dir=xyz, capacity=n + 512)
    params = init_aggregator_params(jax.random.key(1), AggregatorConfig())
    ckpt = tmp_path_factory.mktemp("ckpt")
    tree = {"params": jax.tree.map(np.asarray, params),
            "cloud": {k: np.asarray(v) for k, v in vars(cloud).items()}}
    save_native(str(ckpt / "t" / "10_net_ray_marching.npz"), tree,
                {"iter": 10, "best_psnr": 0.0, "best_iter": 0})
    return str(root) + "/", str(ckpt)


def _flags(scene, extra=()):
    data_root, ckpt = scene
    return [
        "--name", "t", "--data_root", data_root, "--scan", "scene_test",
        "--dataset_name", "scannet_ft", "--checkpoints_dir", ckpt,
        "--resume_iter", "latest", "--split", "test", "--test_num_step", "2",
        "--train_step", "2", "--img_wh", str(W), str(H), "--edge_filter", "2",
        "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
        "--query_size", "3", "3", "3", "--vsize", "0.03", "0.03", "0.03",
        "--wcoord_query", "1", "--z_depth_dim", "64",
        "--ranges", "-10", "-10", "-10", "10", "10", "10",
        "--SR", "8", "--K", "4", "--P", "16",
        "--act_type", "LeakyReLU", "--agg_intrp_order", "2",
        "--agg_distance_kernel", "linear", "--agg_dist_pers", "20",
        "--radius_limit_scale", "4", "--point_features_dim", "32",
        "--shading_feature_mlp_layer1", "2", "--shading_alpha_mlp_layer", "1",
        "--shading_color_mlp_layer", "4", "--shading_feature_num", "256",
        "--dist_xyz_freq", "5", "--num_feat_freqs", "3",
        "--num_viewdir_freqs", "4", "--raydist_mode_unit", "1",
        "--near_plane", "1.0", "--far_plane", "5.0",
        "--which_ray_generation", "near_far_linear",
        "--which_tonemap_func", "off", "--which_render_func", "radiance",
        "--which_blend_func", "alpha", "--bg_color", "white",
    ] + list(extra)


VARIANTS = {
    "f32": ["--compute_depth", "1"],
    # the main path's flags; on the CPU the port runs K1/K2's plain versions
    # and the reference its Pallas kernels in interpret mode
    "bf16-fused": ["--gather_dtype", "bfloat16", "--cache_dtype", "bfloat16",
                   "--knn_mode", "fused", "--fused_mlp", "pallas"],
}


def _models(scene, variant):
    from sgnerf_tpu.options.options import TestOptions
    from sgnerf_tpu.runtime import SceneModel as JaxSceneModel
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

    opt = TestOptions().parse(_flags(scene, VARIANTS[variant]))
    jm, tm = JaxSceneModel(opt), SceneModel(opt, device="cpu")
    for m in (jm, tm):
        m.load_checkpoint(m.resolve_resume())
    return opt, jm, tm


def _item(opt, idx=0):
    from sgnerf_tpu_torch.data import create_dataset
    return create_dataset(opt).get_item(idx)


def _close_rays(a, b, atol):
    return np.all(np.abs(a - b) <= atol, axis=-1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_render_rays_matches_reference(scene, variant):
    from sgnerf_tpu.models.renderer import render_rays as jrender
    from sgnerf_tpu.ops.query import query_neighbors as jquery
    from sgnerf_tpu.ops.raygen import near_far_linear_ray_generation as jgen
    from sgnerf_tpu_torch.models.renderer import render_rays as trender
    from sgnerf_tpu_torch.ops.query import query_neighbors as tquery
    from sgnerf_tpu_torch.ops.raygen import near_far_linear_ray_generation

    opt, jm, tm = _models(scene, variant)
    item = _item(opt)
    rd = item["raydir"][None, :768]
    kw = dict(near=float(item["near"]), far=float(item["far"]))
    jin = dict(campos=jnp.asarray(item["campos"][None]),
               raydir=jnp.asarray(rd))
    tin = dict(campos=torch.from_numpy(item["campos"][None]),
               raydir=torch.from_numpy(rd))
    jout = jrender(jm.state.params, jm.state.cloud, jm.grid, jm.cfg,
                   camrotc2w=jnp.asarray(item["camrotc2w"][None]),
                   bg_color=jnp.asarray(item["bg_color"]), **jin, **kw)
    with torch.inference_mode():
        tout = trender(tm.params, tm.cloud, tm.grid, tm.cfg,
                       camrotc2w=torch.from_numpy(item["camrotc2w"][None]),
                       bg_color=torch.from_numpy(item["bg_color"]),
                       **tin, **kw)
    # the same query as inside both renders, to find rays whose ids differ
    raypos, _, _, ts = jgen(*jin.values(), jm.cfg.z_depth_dim, **kw)
    jq = jquery(jm.grid, jm.state.cloud.xyz, raypos, K=jm.cfg.K,
                SR=jm.cfg.SR, radius_limit=jm.cfg.radius_limit,
                knn_mode=jm.cfg.knn_mode, tvals=ts, **jin)
    tpos, _, _, tts = near_far_linear_ray_generation(
        *tin.values(), tm.cfg.z_depth_dim, **kw)
    tq = tquery(tm.grid, tpos, K=tm.cfg.K, SR=tm.cfg.SR,
                radius_limit=tm.cfg.radius_limit, knn_mode=tm.cfg.knn_mode,
                tvals=tts, **tin)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(ts))
    ids_differ = np.any(tq.sample_pidx.numpy()[0] != np.asarray(
        jq.sample_pidx)[0], axis=(-1, -2))
    assert ids_differ.mean() <= 0.001, ids_differ.sum()
    # each such ray: its shading points moved by float32 rounding only
    np.testing.assert_allclose(tq.sample_loc_w.numpy()[0][ids_differ],
                               np.asarray(jq.sample_loc_w)[0][ids_differ],
                               rtol=0, atol=1e-6)

    a = tout["coarse_raycolor"].numpy()[0]
    b = np.asarray(jout["coarse_raycolor"])[0]
    assert np.isfinite(a).all()
    assert tout["ray_mask"].numpy().mean() > 0.2   # the sphere fills the view
    np.testing.assert_allclose(a[~ids_differ], b[~ids_differ], rtol=0,
                               atol=1e-4)
    assert ("coarse_depth" in tout) == ("coarse_depth" in jout)
    if "coarse_depth" in tout:
        np.testing.assert_allclose(
            tout["coarse_depth"].numpy()[0][~ids_differ],
            np.asarray(jout["coarse_depth"])[0][~ids_differ], rtol=1e-5,
            atol=1e-4)


def test_render_image_matches_reference(scene):
    opt, jm, tm = _models(scene, "bf16-fused")
    item = _item(opt, 1)
    a = tm.render_image(item, chunk_rays=512)
    b = np.asarray(jm.render_image(item, chunk_rays=512))
    assert a.shape == b.shape == (len(item["raydir"]), 3)
    bad = ~_close_rays(a, b, 1e-4)
    assert bad.mean() <= 0.001, (bad.sum(), np.abs(a - b).max())


def test_pth_checkpoint_renders_like_npz(scene, tmp_path):
    """The reference-format .pth route (load_torch_state_dict +
    convert_reference_checkpoint) loads the same scene as the .npz."""
    from sgnerf_tpu.models.checkpoint_io import (export_reference_checkpoint,
                                                 load_native)
    from sgnerf_tpu.options.options import TestOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

    tree, _ = load_native(os.path.join(scene[1], "t",
                                       "10_net_ray_marching.npz"))
    act = tree["cloud"]["active"]
    pts = {k: tree["cloud"][k][act]
           for k in ("xyz", "embedding", "conf", "dir", "color")}
    pts["Rw2c"] = tree["cloud"]["Rw2c"]
    export_reference_checkpoint(
        tree["params"], pts, str(tmp_path / "t" / "10_net_ray_marching.pth"))
    models = []
    for ckpt in (scene[1], str(tmp_path)):
        opt = TestOptions().parse(_flags((scene[0], ckpt)))
        m = SceneModel(opt, device="cpu")
        m.load_checkpoint(m.resolve_resume())
        models.append(m)
    assert models[1].resolve_resume().endswith(".pth")
    assert models[1].step == models[0].step == 10
    item = _item(opt)
    np.testing.assert_array_equal(models[0].render_image(item),
                                  models[1].render_image(item))


def test_test_ft_cli_writes_scores(scene, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "sgnerf_tpu_torch.run.test_ft"]
        + _flags(scene, VARIANTS["bf16-fused"]) + ["--gpu_ids", "-1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "num.0 psnr:" in proc.stdout and "mean psnr:" in proc.stdout
    out = os.path.join(scene[1], "t", "images", "test_10")
    with open(os.path.join(out, "scores.txt")) as f:
        scores = dict(line.split(": ") for line in f.read().splitlines())
    assert np.isfinite(float(scores["psnr"]))
    assert os.path.exists(os.path.join(out, "step-0000-coarse_raycolor.png"))
