"""Edited scenes in the port against the JAX package on the CPU: a cloud of
two parts (a (2,3,3) rotation table and each point's row, rot_idx), the
per-neighbour rotation of view directions, neighbour offsets and stored
dirs, the composition of edited parts (run/editing.py `load_parts`) and a
reference .pth with a dense per-point Rw2c.

Renders: `render_rays` of the port (plain K1/K2 on the CPU) against JAX
(its Pallas kernels in interpret mode) on the same checkpoint and rays,
within tests/test_torch_render.py's limit: 1e-4 on every ray whose
neighbour ids agree. Ids differ where XLA's FMA in campos + t * dir moves
a ray sample by an ulp across a voxel's occupancy or a neighbour's
radius, which shifts that ray's list of shading points (no rotation
enters the query): the ray samples of both packages are held within 1e-6
everywhere, and such rays to 0.5% of the frame (up to 3 of its 1,728;
test_torch_render.py's 768 rays have none).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, FOCAL = 48, 36, 40.0


def rot_z(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]], np.float32)


def rot_x(deg):
    a = np.deg2rad(deg)
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]], np.float32)


def two_part_cloud(n=4000, seed=0):
    """A unit sphere whose +x half is part 1 (rotated 30 deg about z, then
    20 about x, as an edit would store it); point 0 lies in part 1, so the
    empty-slot rule (a sample with no neighbour takes point 0's row)
    reaches the rotated row."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz[0] = np.abs(xyz[0])
    rot_idx = (xyz[:, 0] > 0).astype(np.int32)
    table = np.stack([np.eye(3, dtype=np.float32), rot_x(20) @ rot_z(30)])
    return dict(
        xyz=xyz, embedding=(rng.normal(size=(n, 32)) * 0.3).astype(
            np.float32),
        conf=rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32),
        color=np.clip(xyz * 0.5 + 0.5, 0, 1).astype(np.float32),
        dir=rng.normal(size=(n, 3)).astype(np.float32), Rw2c=table,
        rot_idx=rot_idx)


def flags(ckpt, extra=()):
    return [
        "--name", "t", "--checkpoints_dir", ckpt, "--resume_iter", "latest",
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


FUSED = ["--gather_dtype", "bfloat16", "--cache_dtype", "bfloat16",
         "--knn_mode", "fused", "--fused_mlp", "pallas"]
VARIANTS = {
    # the main path's flags: the offsets K2 takes are rotated per neighbour
    "fused": FUSED,
    # K4: the view directions rotate by the first neighbour's row too
    "fused_color": FUSED + ["--fused_color", "on"],
    # block3 with stored dirs (un-fused in both): dirs rotate per neighbour
    "block3_dir": ["--shading_feature_mlp_layer3", "2",
                   "--point_dir_mode", "1", "--point_color_mode", "1"],
}


def write_checkpoint(ckpt_dir, opt, arrays):
    from sgnerf_tpu.models.aggregator import init_aggregator_params
    from sgnerf_tpu.models.checkpoint_io import save_native
    from sgnerf_tpu.models.point_cloud import make_point_cloud
    from sgnerf_tpu.options.options import configs_from_opt
    cfg, _, _ = configs_from_opt(opt)
    cloud = make_point_cloud(capacity=len(arrays["xyz"]) + 512, **arrays)
    params = init_aggregator_params(jax.random.key(1), cfg.agg)
    tree = {"params": jax.tree.map(np.asarray, params),
            "cloud": {k: np.asarray(v) for k, v in vars(cloud).items()}}
    save_native(os.path.join(ckpt_dir, "t", "10_net_ray_marching.npz"),
                tree, {"iter": 10, "best_psnr": 0.0, "best_iter": 0})


def camera(az):
    """Looking at the origin from distance 3, azimuth az (radians)."""
    campos = np.array([3 * np.sin(az), 0.4, -3 * np.cos(az)], np.float32)
    fwd = -campos / np.linalg.norm(campos)
    right = np.cross([0, 1, 0], fwd)
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd], 1).astype(np.float32)
    intr = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    px, py = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([px, py], -1).reshape(-1, 2)
    from sgnerf_tpu_torch.ops.camera import get_dtu_raydir
    rd = get_dtu_raydir(torch.from_numpy(pix), torch.from_numpy(intr),
                        torch.from_numpy(rot), False).numpy()
    return campos, rot, rd


def models(ckpt):
    from sgnerf_tpu.options.options import TestOptions
    from sgnerf_tpu.runtime import SceneModel as JaxSceneModel
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    opt = TestOptions().parse(ckpt)
    jm, tm = JaxSceneModel(opt), SceneModel(opt, device="cpu")
    for m in (jm, tm):
        m.load_checkpoint(m.resolve_resume())
    return jm, tm


def render_both(jm, tm, campos, rot, rd):
    """coarse_raycolor of both packages on the rays rd (R,3), and which rays'
    neighbour ids differ (the ray samples within 1e-6 everywhere)."""
    from sgnerf_tpu.models.renderer import render_rays as jrender
    from sgnerf_tpu.ops.query import query_neighbors as jquery
    from sgnerf_tpu.ops.raygen import near_far_linear_ray_generation as jgen
    from sgnerf_tpu_torch.models.renderer import render_rays as trender
    from sgnerf_tpu_torch.ops.query import query_neighbors as tquery
    from sgnerf_tpu_torch.ops.raygen import near_far_linear_ray_generation
    kw = dict(near=1.0, far=5.0)
    jin = dict(campos=jnp.asarray(campos[None]), raydir=jnp.asarray(rd[None]))
    tin = dict(campos=torch.from_numpy(campos[None]),
               raydir=torch.from_numpy(rd[None]))
    bg = np.ones(3, np.float32)
    jout = jrender(jm.state.params, jm.state.cloud, jm.grid, jm.cfg,
                   camrotc2w=jnp.asarray(rot[None]), bg_color=jnp.asarray(bg),
                   **jin, **kw)
    with torch.inference_mode():
        tout = trender(tm.params, tm.cloud, tm.grid, tm.cfg,
                       camrotc2w=torch.from_numpy(rot[None]),
                       bg_color=torch.from_numpy(bg), **tin, **kw)
    raypos, _, _, ts = jgen(*jin.values(), jm.cfg.z_depth_dim, **kw)
    jq = jquery(jm.grid, jm.state.cloud.xyz, raypos, K=jm.cfg.K,
                SR=jm.cfg.SR, radius_limit=jm.cfg.radius_limit,
                knn_mode=jm.cfg.knn_mode, tvals=ts, **jin)
    tpos, _, _, tts = near_far_linear_ray_generation(
        *tin.values(), tm.cfg.z_depth_dim, **kw)
    tq = tquery(tm.grid, tpos, K=tm.cfg.K, SR=tm.cfg.SR,
                radius_limit=tm.cfg.radius_limit, knn_mode=tm.cfg.knn_mode,
                tvals=tts, **tin)
    tpid, jpid = tq.sample_pidx.numpy()[0], np.asarray(jq.sample_pidx)[0]
    differ = np.any(tpid != jpid, axis=(-1, -2))
    assert differ.mean() <= 0.005, differ.sum()
    np.testing.assert_array_equal(tts.numpy(), np.asarray(ts))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(raypos), rtol=0,
                               atol=1e-6)
    return (tout["coarse_raycolor"].numpy()[0],
            np.asarray(jout["coarse_raycolor"])[0], differ, tpid)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_part_render_matches_reference(tmp_path, variant):
    opt_flags = flags(str(tmp_path), VARIANTS[variant])
    from sgnerf_tpu.options.options import TestOptions
    arrays = two_part_cloud()
    write_checkpoint(str(tmp_path), TestOptions().parse(opt_flags), arrays)
    jm, tm = models(opt_flags)
    assert tuple(tm.cloud.Rw2c.shape) == (2, 3, 3)
    np.testing.assert_array_equal(tm.cloud.rot_idx.numpy(),
                                  np.asarray(jm.state.cloud.rot_idx))
    campos, rot, rd = camera(0.7)
    a, b, differ, pid = render_both(jm, tm, campos, rot, rd)
    assert np.isfinite(a).all()
    # the frame shades both parts, and samples that mix them
    rows = arrays["rot_idx"][np.clip(pid, 0, None)][pid >= 0]
    assert 0.1 < rows.mean() < 0.9, rows.mean()
    np.testing.assert_allclose(a[~differ], b[~differ], rtol=0, atol=1e-4)
    # the table is used: the same cloud under one rotation renders otherwise
    import dataclasses
    flat = dataclasses.replace(tm.cloud, Rw2c=torch.eye(3))
    from sgnerf_tpu_torch.models.renderer import render_rays as trender
    with torch.inference_mode():
        c = trender(tm.params, flat, tm.grid, tm.cfg,
                    campos=torch.from_numpy(campos[None]),
                    raydir=torch.from_numpy(rd[None]),
                    camrotc2w=torch.from_numpy(rot[None]),
                    bg_color=torch.ones(3), near=1.0, far=5.0)
    assert np.abs(c["coarse_raycolor"].numpy()[0] - a).max() > 1e-3


def test_dense_rw2c_pth_loads_like_jax_and_saves_back(tmp_path):
    """A reference .pth with a per-point (N,3,3) Rw2c: both packages factor
    it into the same table and rot_idx; the port's export writes the same
    dense rotations back."""
    from sgnerf_tpu.models.checkpoint_io import export_reference_checkpoint
    from sgnerf_tpu.options.options import TestOptions
    from sgnerf_tpu_torch.models.checkpoint_io import load_torch_state_dict
    arrays = two_part_cloud(n=1500, seed=3)
    # a third part, whose rotation equals the second's within rounding
    third = np.arange(len(arrays["xyz"])) % 7 == 0
    table = np.concatenate([arrays["Rw2c"],
                            (rot_z(-45) @ rot_x(10))[None]])
    rot_idx = np.where(third, 2, arrays["rot_idx"])
    dense = table[rot_idx] + np.float32(1e-8) * (rot_idx == 1)[:, None, None]
    from sgnerf_tpu.models.aggregator import (AggregatorConfig,
                                              init_aggregator_params)
    params = jax.tree.map(np.asarray, init_aggregator_params(
        jax.random.key(2), AggregatorConfig()))
    pts = {k: arrays[k] for k in ("xyz", "embedding", "conf", "dir",
                                  "color")}
    pts["Rw2c"] = dense
    pth = tmp_path / "t" / "10_net_ray_marching.pth"
    export_reference_checkpoint(params, pts, str(pth))
    jm, tm = models(flags(str(tmp_path)))
    np.testing.assert_array_equal(tm.cloud.Rw2c.numpy(),
                                  np.asarray(jm.state.cloud.Rw2c))
    np.testing.assert_array_equal(tm.cloud.rot_idx.numpy(),
                                  np.asarray(jm.state.cloud.rot_idx))
    assert tm.cloud.Rw2c.shape[0] == 3
    # each point's row gives its own rotation back (to the 1e-8 offsets)
    n = len(dense)
    got = tm.cloud.Rw2c.numpy()[tm.cloud.rot_idx.numpy()[:n]]
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-7)
    tm.export_reference(20)
    sd = load_torch_state_dict(os.path.join(tm.expr_dir,
                                            "20_net_ray_marching.pth"))
    np.testing.assert_array_equal(sd["neural_points.Rw2c"], got)
    np.testing.assert_array_equal(sd["neural_points.xyz"], arrays["xyz"])


def test_load_parts_composes_like_jax(tmp_path):
    """run/editing.py load_parts: a rotated, index-selected part put in
    front of an identity part, in both packages: equal clouds, tables and
    rot_idx."""
    import importlib
    from sgnerf_tpu.models.checkpoint_io import export_reference_checkpoint
    from sgnerf_tpu.options.options import EditOptions as JaxEditOptions
    from sgnerf_tpu_torch.options import EditOptions
    from sgnerf_tpu_torch.run.editing import load_parts
    jediting = importlib.import_module("run.editing")
    base = tmp_path / "parts"
    base.mkdir()
    for i, seed in enumerate((4, 5)):
        a = two_part_cloud(n=900, seed=seed)
        pts = {k: a[k] for k in ("xyz", "embedding", "conf", "dir", "color")}
        pts["Rw2c"] = np.eye(3, dtype=np.float32)
        export_reference_checkpoint({}, pts, str(base / f"p{i}.pth"))
    np.savetxt(base / "idx.txt", np.arange(0, 900, 3))
    T = np.eye(4)
    T[:3, :3] = rot_z(30)
    T[:3, 3] = [0.2, -0.1, 0.05]
    np.savetxt(base / "T.txt", T)
    np.savetxt(base / "I.txt", np.eye(4))
    args = ["--resume_dir", str(base), "--neural_points_names", "p0.pth",
            "p1.pth", "--parts_index_names", "all", "idx.txt",
            "--Transformation_names", "I.txt", "T.txt"]
    got = load_parts(EditOptions().parse(args))
    want = jediting.load_parts(JaxEditOptions().parse(args))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (2, 3, 3) and got[2][:300].tolist() == [1] * 300
    for f in ("xyz", "embedding", "conf", "dir", "color", "label"):
        np.testing.assert_array_equal(getattr(got[0], f),
                                      getattr(want[0], f), err_msg=f)
