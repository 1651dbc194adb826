"""Point growing in the port against the JAX package on the CPU.

  * render_rays(prob=True) on the scene of tests/test_renderer.py: ray_mask
    bit-equal, the eight probe outputs within 1e-4 (eval render, no noise).
  * point_cloud.grow and SceneModel.grow_points (into the free slots, and
    re-allocated past the capacity): n_active, active and the grown rows
    equal. After a prune the port grows into the holes, where the JAX grow
    writes over live rows (ROADMAP.md section 3, F7).
  * probe_grid_for_step's tiers, and probe_and_grow on the synthetic
    ScanNet scene of tests/test_e2e_scannet.py, seeded with the integer the
    JAX package draws from its key: the same frames, the same number of
    points grown, their xyz within 1e-5.
  * train_ft with --prob_freq 2 for 4 steps.
"""
import contextlib
import dataclasses
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu_torch.models import point_cloud as tpc
from torch_threads import one_cpu_thread  # noqa: F401

GROWN = ("xyz", "embedding", "conf", "color", "dir")
UNGROWN = ("feats", "label", "label_prob", "sem_embedding", "rot_idx")


def _port_cloud(jcloud):
    return tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")


# ------------------------------------------------------------ probe outputs

def test_render_rays_prob_outputs_match_reference():
    from sgnerf_tpu.models.aggregator import (AggregatorConfig as JAgg,
                                              init_aggregator_params)
    from sgnerf_tpu.models.renderer import RenderConfig as JCfg
    from sgnerf_tpu.models.renderer import render_rays as jrender
    from sgnerf_tpu_torch.models import aggregator as tagg
    from sgnerf_tpu_torch.models import renderer as tren
    from sgnerf_tpu_torch.models.params import params_from_jax
    from sgnerf_tpu_torch.runtime.growing import PROBE_KEYS

    rng = np.random.default_rng(0)
    n = 2000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    emb = rng.normal(size=(n, 32)).astype(np.float32) * 0.1
    jcloud = jpc.make_point_cloud(xyz, emb, color=(xyz * 0.5 + 0.5),
                                  dir=xyz, capacity=2048)
    gkw = dict(vsize=[0.05] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
               max_o=8192, P=16)
    jgrid = jpc.build_grid(jcloud, jpc.grid_spec_for_cloud(jcloud, **gkw))
    cloud = _port_cloud(jcloud)
    grid = tpc.build_grid(cloud, tpc.grid_spec_for_cloud(cloud, **gkw))
    kw = dict(z_depth_dim=80, SR=8, K=4, vsize=(0.05,) * 3)
    jcfg = JCfg(agg=JAgg(act_type="LeakyReLU"), **kw)
    cfg = tren.RenderConfig(agg=tagg.AggregatorConfig(act_type="LeakyReLU"),
                            **kw)
    jparams = init_aggregator_params(jax.random.key(0), jcfg.agg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    r = np.random.default_rng(1)
    d = r.normal(size=(1, 64, 3)).astype(np.float32) * 0.2
    d[..., 2] = 1.0
    d[:, :4, 1] += 10.0                       # these rays miss
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jout = jrender(jparams, jcloud, jgrid, jcfg,
                   campos=jnp.asarray([[0.0, 0.0, -3.0]]),
                   raydir=jnp.asarray(d), camrotc2w=jnp.eye(3)[None],
                   near=1.0, far=5.0, bg_color=jnp.ones(3), prob=True)
    with torch.inference_mode():
        out = tren.render_rays(params, cloud, grid, cfg,
                               campos=torch.tensor([[0.0, 0.0, -3.0]]),
                               raydir=torch.from_numpy(d),
                               camrotc2w=torch.eye(3)[None], near=1.0,
                               far=5.0, bg_color=torch.ones(3), prob=True)
    rm = out["ray_mask"].numpy()
    np.testing.assert_array_equal(rm, np.asarray(jout["ray_mask"]))
    assert rm.any() and not rm.all()
    for k in PROBE_KEYS:
        if k != "ray_mask":
            assert out[k].shape == jout[k].shape, k
            np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                       rtol=0, atol=1e-4, err_msg=k)


def test_probe_takes_the_first_sample_of_largest_opacity():
    """Ties go to the first sample, as jnp.argmax (torch.argmax does not
    promise it on CUDA)."""
    from sgnerf_tpu_torch.models.renderer import _probe_outputs
    op = torch.tensor([[[0.1, 0.5, 0.5, 0.2], [0.3, 0.3, 0.3, 0.3]]])
    loc = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(1, 2, 4, 3)
    w = torch.ones(1, 2, 4, 2)
    sampled = {k: torch.zeros(1, 2, 4, 2, c) for k, c in
               (("xyz", 3), ("color", 3), ("dir", 3), ("conf", 1),
                ("embedding", 5))}
    out = _probe_outputs(op, loc, w, w, sampled)
    assert torch.equal(out["ray_max_sample_loc_w"][0, 0], loc[0, 0, 1])
    assert torch.equal(out["ray_max_sample_loc_w"][0, 1], loc[0, 1, 0])
    assert torch.equal(out["ray_max_shading_opacity"][0, :, 0],
                       torch.tensor([0.5, 0.3]))


# ------------------------------------------------------------------- grow

def _cloud(n=600, cap=640, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    return jpc.make_point_cloud(
        xyz, rng.normal(size=(n, 8)).astype(np.float32),
        conf=rng.uniform(0, 1, (n, 1)), color=rng.uniform(0, 1, (n, 3)),
        dir=xyz, capacity=cap)


def _new(g, seed=1, F=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(g, w)).astype(np.float32)
            for w in (3, F, 1, 3, 3)]


@pytest.mark.parametrize("g", [25, 100])        # 100: 60 past the capacity
def test_grow_matches_reference(g):
    jcloud = _cloud()
    cloud = _port_cloud(jcloud)
    new = _new(g)
    jg = jpc.grow(jcloud, *new)
    active, n_active = cloud.active, cloud.n_active
    tg = tpc.grow(cloud, *new)
    assert tg.active is active and tg.n_active is n_active   # in place
    assert int(tg.n_active) == int(jg.n_active) == min(600 + g, 640)
    for f in ("active",) + GROWN:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def test_grow_after_prune_fills_the_holes():
    """After a prune the live rows do not fill the front of the cloud; the
    port writes the new rows into the pruned slots and keeps every live
    row, where the JAX grow writes at n_active over live rows and its
    n_active no longer counts the active rows (F7). The fields grow does
    not write (features, labels, rotation index) of the filled holes go
    back to the padding's zeros: nothing of the pruned point survives."""
    jcloud = _cloud(n=600, cap=700)
    conf = np.asarray(jcloud.conf).copy()
    conf[100:150] = 0.0
    jcloud = dataclasses.replace(jcloud, conf=jnp.asarray(conf))
    jpruned = jpc.prune(jcloud, 0.1)
    cloud = _port_cloud(jcloud)
    for f in UNGROWN:
        getattr(cloud, f).fill_(3)
    cloud = tpc.prune(cloud, 0.1)
    n0 = int(cloud.n_active)
    live = cloud.active.clone()
    before = {f: getattr(cloud, f).clone() for f in ("xyz",) + UNGROWN}
    new = _new(80)
    tg = tpc.grow(cloud, *new)
    assert int(tg.n_active) == n0 + 80 == int(tg.active.sum())
    for f, t in before.items():                            # no live row lost
        assert torch.equal(getattr(tg, f)[live], t[live]), f
    grown = tg.active & ~live
    np.testing.assert_array_equal(np.sort(tg.xyz[grown].numpy(), axis=0),
                                  np.sort(new[0], axis=0))
    for f in UNGROWN:
        assert not getattr(tg, f)[grown].any(), f
    jg = jpc.grow(jpruned, *new)
    assert int(jg.n_active) == n0 + 80
    assert int(np.sum(np.asarray(jg.active))) < n0 + 80


def _scene_dir(root):
    """tests/test_e2e_scannet.py's scene: a coloured sphere cloud (pcd.ply)
    and 6 cameras around it, 48 x 36."""
    from PIL import Image
    from sgnerf_tpu_torch.utils.ply import write_ply
    scan = root / "scene_test" / "exported"
    for sub in ("color", "pose", "intrinsic"):
        (scan / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    W, H = 48, 36
    intr = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    np.savetxt(scan / "intrinsic/intrinsic_color.txt", np.eye(4) * 1.0
               + np.pad(intr - np.eye(3), ((0, 1), (0, 1))))
    n = 800
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    rgb = np.clip(xyz * 0.5 + 0.5, 0, 1)
    write_ply(str(scan / "pcd.ply"),
              {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
               "red": (rgb[:, 0] * 255).astype(np.uint8),
               "green": (rgb[:, 1] * 255).astype(np.uint8),
               "blue": (rgb[:, 2] * 255).astype(np.uint8)})
    for i in range(6):
        ang = 2 * np.pi * i / 6
        campos = np.array([3 * np.sin(ang), 0.0, -3 * np.cos(ang)],
                          np.float32)
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross(np.array([0, 1, 0], np.float32), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
            right, np.cross(fwd, right), fwd, campos)
        np.savetxt(scan / f"pose/{i}.txt", c2w)
        img = (rng.uniform(0, 1, size=(H, W, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(scan / f"color/{i}.jpg")
    return str(root) + "/"


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return _scene_dir(tmp_path_factory.mktemp("scans"))


def _flags(scene_dir, ckpt, extra=()):
    """tests/test_e2e_scannet.py's flags, on the CPU; full probe frames
    (no_crop), so both packages probe the same pixels."""
    return [
        "--name", "g", "--data_root", scene_dir, "--scan", "scene_test",
        "--dataset_name", "scannet_ft", "--checkpoints_dir", str(ckpt),
        "--img_wh", "48", "36", "--train_step", "2",
        "--random_sample", "no_crop", "--random_sample_size", "8",
        "--which_ray_generation", "near_far_linear",
        "--which_render_func", "radiance", "--which_blend_func", "alpha",
        "--which_tonemap_func", "off",
        "--near_plane", "1.0", "--far_plane", "5.0",
        "--z_depth_dim", "32", "--SR", "4", "--K", "2", "--P", "8",
        "--max_o", "40000", "--vsize", "0.08", "0.08", "0.08",
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
        "--lr", "0.001", "--plr", "0.002", "--raydist_mode_unit", "1",
        "--bg_color", "white", "--edge_filter", "2", "--vox_res", "0",
        "--ranges", "-10", "-10", "-10", "10", "10", "10",
        "--wcoord_query", "1", "--gpu_ids", "-1",
        "--prob_num_step", "1", "--prob_mul", "0.5",
    ] + list(extra)


def _models(scene_dir, ckpt, extra=()):
    """The JAX SceneModel bootstrapped from the scene's points, saved, and
    the port's SceneModel loaded from that checkpoint; their datasets."""
    from sgnerf_tpu.data import create_dataset as jcreate
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu.runtime import SceneModel as JaxSceneModel
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    flags = _flags(scene_dir, ckpt, extra)
    jopt, opt = JOpts().parse(flags), TrainOptions().parse(flags)
    jopt.split = opt.split = "train"
    jds, ds = jcreate(jopt), create_dataset(opt)
    jm = JaxSceneModel(jopt)
    jm.setup_from_points(*jds.load_init_points(), dataset=jds)
    jm.save_checkpoint(0)
    tm = SceneModel(opt)
    tm.load_checkpoint(tm.resolve_resume())
    return (jm, jds, jopt), (tm, ds, opt)


@pytest.mark.parametrize("g", [100, 3000])    # 3000: past the capacity
def test_grow_points_matches_reference(scene_dir, tmp_path, g):
    (jm, _, _), (tm, _, _) = _models(scene_dir, tmp_path)
    n0, cap = int(tm.cloud.n_active), tm.cloud.capacity
    assert n0 == int(jm.state.cloud.n_active) and cap == 3072
    new = _new(g, F=32)
    jm.grow_points(*new)
    tm.grow_points(*new)
    jc = jm.state.cloud
    assert tm.cloud.capacity == jc.capacity == (
        cap if g == 100 else tm._capacity_for(n0 + g))
    assert int(tm.cloud.n_active) == int(jc.n_active) == n0 + g
    np.testing.assert_array_equal(tm.cloud.active.numpy(),
                                  np.asarray(jc.active))
    for f in GROWN:
        np.testing.assert_array_equal(
            getattr(tm.cloud, f).numpy()[:n0 + g],
            np.asarray(getattr(jc, f))[:n0 + g], err_msg=f)
    for f in UNGROWN:                      # as the padding, in both branches
        assert not getattr(tm.cloud, f)[n0:].any(), f
    # the grid was rebuilt around the grown cloud
    assert torch.equal(tm.grid.occ_mask, tpc.build_grid(
        tm.cloud, tm.spec).occ_mask)
    assert tm.state.opt_pts["count"] == 0


@pytest.mark.parametrize("pks,tiers,step,want", [
    (None, (100,), 50, "model"),
    ((3, 3, 3, 5, 5, 5), (1000,), 10, "model"),
    ((3, 3, 3, 5, 5, 5), (1000,), 2000, "wide"),
    ((3, 3, 3), (1000,), 2000, "exhausted")])
def test_probe_grid_for_step_matches_reference(pks, tiers, step, want):
    from sgnerf_tpu.runtime.growing import probe_grid_for_step as jprobe
    from sgnerf_tpu_torch.runtime.growing import probe_grid_for_step
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    jcloud = jpc.make_point_cloud(
        xyz, rng.normal(size=(500, 32)).astype(np.float32))
    kw = dict(vsize=[0.1] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
              max_o=4096, P=8, ranges=None)
    models = []
    for mod, cloud in ((jpc, jcloud), (tpc, _port_cloud(jcloud))):
        spec = mod.grid_spec_for_cloud(cloud, **kw)
        models.append(types.SimpleNamespace(
            grid=mod.build_grid(cloud, spec), spec=spec, grid_kwargs=kw,
            state=types.SimpleNamespace(cloud=cloud)))
    opt = types.SimpleNamespace(prob_kernel_size=pks, prob_tiers=tiers)
    (jg, jdone), (tg, tdone) = (jprobe(models[0], opt, step),
                                probe_grid_for_step(models[1], opt, step))
    assert jdone == tdone == (want == "exhausted")
    if want == "model":
        assert tg is models[1].grid and jg is models[0].grid
    if want == "wide":
        assert tg is not models[1].grid
        np.testing.assert_array_equal(tg.occ_mask.numpy(),
                                      np.asarray(jg.occ_mask))


def test_probe_and_grow_matches_reference(scene_dir, tmp_path):
    """Forced growth (opacity_thresh 0), as tests/test_e2e_scannet.py's
    growing cycle, in both packages from one checkpoint."""
    from sgnerf_tpu.runtime.growing import probe_and_grow as jgrow
    from sgnerf_tpu_torch.runtime.growing import probe_and_grow
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    (jm, jds, jopt), (tm, ds, opt) = _models(scene_dir, tmp_path)
    n0 = int(tm.cloud.n_active)
    key = jax.random.key(1)
    seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        jn = jgrow(jm, jds, jopt, key, opacity_thresh=0.0)
        tn = probe_and_grow(tm, ds, opt, seed, opacity_thresh=0.0)
    assert tn == jn > 0
    assert int(tm.cloud.n_active) == int(jm.state.cloud.n_active) == n0 + tn
    jc = jm.state.cloud
    sl = slice(n0, n0 + tn)
    np.testing.assert_allclose(tm.cloud.xyz.numpy()[sl],
                               np.asarray(jc.xyz)[sl], rtol=0, atol=1e-5)
    for f in ("embedding", "conf", "color", "dir"):
        np.testing.assert_allclose(getattr(tm.cloud, f).numpy()[sl],
                                   np.asarray(getattr(jc, f))[sl], rtol=0,
                                   atol=1e-4, err_msg=f)
    # the grown model trains
    item = ds.get_item(0, rng=np.random.default_rng(0))
    losses = tm.optimize(batch_to_device(item, tm.device))
    assert torch.isfinite(losses["total"])


def test_train_ft_grows_on_cpu(scene_dir, tmp_path):
    """--prob_freq 2 within 4 steps: two probes, after the prune, and the
    run saves and tests as before."""
    from sgnerf_tpu_torch.run import train_ft
    flags = _flags(scene_dir, tmp_path, [
        "--random_sample", "random", "--maximum_step", "4",
        "--prob_freq", "2", "--prune_iter", "2", "--prune_thresh", "0.0",
        "--save_iter_freq", "4", "--print_freq", "2", "--test_freq", "0",
        "--test_num", "1", "--n_threads", "0", "--load_points", "1"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_ft.main(flags)
    out = buf.getvalue()
    probes = [l_ for l_ in out.splitlines()
              if l_.startswith(("grow: +", "probe_and_grow: "))]
    assert len(probes) == 2, out[-3000:]
    lines = out.splitlines()
    assert lines.index(probes[0]) > min(
        i for i, l_ in enumerate(lines) if l_.startswith("prune:"))
    assert "training from step 0 to 4" in out
    assert (tmp_path / "g" / "4_net_ray_marching.npz").exists()
