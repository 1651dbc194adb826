"""The port's training slice against the JAX package on the CPU: losses,
schedules and Adam against optax, two train steps against JAX train_step
(fed the noise JAX drew), prune, the voxel downsampling, the train-item
pixels, checkpoints across the two packages, and the train_ft CLI.

Tolerances: losses rtol 1e-5 and parameters rtol 2e-3, atol 2e-6, those of
tests/test_train.py:223-226 (the fused backward and the XLA recompute sum
in different orders; so do the two packages). Losses and Adam alone are
elementwise: rtol 1e-6.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.models import losses as jlosses
from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.models import train as jtrain
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models import losses as tlosses
from sgnerf_tpu_torch.models import point_cloud as tpc
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models import train as ttrain
from sgnerf_tpu_torch.models.params import params_from_jax
from torch_threads import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ losses

def _loss_inputs(seed, R=12):
    rng = np.random.default_rng(seed)
    out = {
        "coarse_raycolor": rng.uniform(0, 1, (1, R, 3)).astype(np.float32),
        "ray_mask": rng.random((1, R)) < 0.6,
        "ray_depth_mask": (rng.random((1, R)) < 0.5).astype(np.float32),
        "coarse_depth": rng.uniform(1, 3, (1, R)).astype(np.float32),
        "coarse_is_background": rng.uniform(0, 1, (1, R, 1)).astype(
            np.float32),
        "conf_coefficient": rng.uniform(0, 1, (1, R, 4, 2)).astype(
            np.float32),
        "weight": rng.uniform(0, 1, (1, R, 4, 2)).astype(np.float32),
    }
    gt = rng.uniform(0, 1, (1, R, 3)).astype(np.float32)
    gt_depth = rng.uniform(1, 3, (1, R)).astype(np.float32)
    gt_mask = (rng.random((1, R)) < 0.7).astype(np.float32)
    return out, gt, gt_depth, gt_mask


LOSS_CONFIGS = {
    "color": dict(color_loss_items=(
        "ray_masked_coarse_raycolor", "ray_miss_coarse_raycolor",
        "coarse_raycolor", "ray_depth_masked_coarse_raycolor"),
        color_loss_weights=(1.0, 0.5, 0.25, 2.0)),
    "zero_one_sparse": dict(
        color_loss_items=("coarse_raycolor",), color_loss_weights=(1.0,),
        zero_one_loss_items=("conf_coefficient",),
        zero_one_loss_weights=(0.1,), sparse_loss_weight=0.3),
    "depth_bg_l2": dict(
        color_loss_items=("coarse_raycolor",), color_loss_weights=(1.0,),
        depth_loss_items=("coarse_depth",), depth_loss_weights=(0.5,),
        bg_loss_items=("coarse_is_background",), bg_loss_weights=(0.2,),
        l2_size_loss_items=("coarse_depth",), l2_size_loss_weights=(0.01,)),
}


@pytest.mark.parametrize("family", sorted(LOSS_CONFIGS))
def test_compute_losses_match_reference(family):
    out, gt, gt_depth, gt_mask = _loss_inputs(len(family))
    kw = LOSS_CONFIGS[family]
    jt, jl = jlosses.compute_losses(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(gt),
        gt_depth=jnp.asarray(gt_depth), gt_mask=jnp.asarray(gt_mask), **kw)
    tt, tl = tlosses.compute_losses(
        {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()},
        torch.from_numpy(gt), gt_depth=torch.from_numpy(gt_depth),
        gt_mask=torch.from_numpy(gt_mask), **kw)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)


# ---------------------------------------------------------- schedules, Adam

@pytest.mark.parametrize("policy", ["iter_exponential_decay", "lambda",
                                    "step", "plateau"])
def test_schedules_match_reference(policy):
    tcfg = dict(lr_policy=policy, lr_decay_iters=7, niter=5, niter_decay=9)
    jfn = jtrain._schedule(jtrain.TrainConfig(**tcfg), 3e-3)
    for count in (0, 1, 6, 7, 13, 40):
        np.testing.assert_allclose(
            ttrain.schedule(ttrain.TrainConfig(**tcfg), 3e-3, count),
            float(jfn(jnp.asarray(count, jnp.int32))), rtol=1e-6)


@pytest.mark.parametrize("scales", [(1.0, 1.0, 1.0), (1.0, 0.0, 1.0)])
def test_adam_matches_optax(scales):
    """Three steps, the middle one gated off when scales[1] == 0: optax
    still advances the moments and its count."""
    tcfg = ttrain.TrainConfig(lr_decay_iters=3)
    jfn = jtrain._schedule(jtrain.TrainConfig(lr_decay_iters=3), 1e-2)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in scales]
    tx = optax.adam(jfn, b1=0.9, b2=0.999)
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    tst = ttrain.adam_init([tp])
    for g, s in zip(grads, scales):
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up * s)
        ttrain.adam_step([tp], [torch.from_numpy(g)], tst,
                         ttrain.schedule(tcfg, 1e-2, tst["count"]), s)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    assert tst["count"] == len(scales)


# -------------------------------------------------------------- train step

def _scene(n=600, cap=640):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    emb = rng.normal(size=(n, 32)).astype(np.float32) * 0.1
    conf = rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32)
    return jpc.make_point_cloud(xyz, emb, conf=conf, color=(xyz * .5 + .5),
                                dir=xyz, capacity=cap)


def _batch(R=48, seed=1):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(1, R, 3)).astype(np.float32) * 0.25
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"campos": np.asarray([[0.0, 0.0, -3.0]], np.float32),
            "raydir": d, "camrotc2w": np.eye(3, dtype=np.float32)[None],
            "near": np.float32(1.0), "far": np.float32(5.0),
            "bg_color": np.ones(3, np.float32),
            "gt_image": rng.uniform(0.2, 0.8, (1, R, 3)).astype(np.float32)}


def _cfgs(fused, tkw):
    kw = dict(z_depth_dim=48, SR=6, K=4, vsize=(0.08,) * 3)
    jcfg = jren.RenderConfig(agg=jagg.AggregatorConfig(
        fused_mlp="pallas" if fused else "none",
        fused_bwd="pallas" if fused else "xla"), **kw)
    tcfg = tren.RenderConfig(agg=tagg.AggregatorConfig(
        fused_mlp="cuda" if fused else "none"), **kw)
    return jcfg, tcfg, jtrain.TrainConfig(**tkw), ttrain.TrainConfig(**tkw)


def _port_state(jcloud, jparams, tcfg_train):
    cloud = tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return ttrain.create_train_state(params, cloud, tcfg_train)


@pytest.mark.parametrize("variant", ["f32", "fused", "alter_step"])
def test_two_train_steps_match_reference(variant):
    fused = variant == "fused"
    tkw = dict(alter_step=1) if variant == "alter_step" else {}
    jcfg, tcfg, jtc, ttc = _cfgs(fused, tkw)
    jcloud = _scene()
    spec = jpc.grid_spec_for_cloud(jcloud, vsize=[0.08] * 3,
                                   vscale=[1, 1, 1], kernel_size=[3, 3, 3],
                                   max_o=8192, P=16)
    jgrid = jpc.build_grid(jcloud, spec)
    jparams = jagg.init_aggregator_params(jax.random.key(0), jcfg.agg)
    tstate = _port_state(jcloud, jparams, ttc)
    tspec = tpc.grid_spec_for_cloud(tstate.cloud, vsize=[0.08] * 3,
                                    vscale=[1, 1, 1], kernel_size=[3, 3, 3],
                                    max_o=8192, P=16)
    tgrid = tpc.build_grid(tstate.cloud, tspec)
    jstate = jtrain.create_train_state(jparams, jcloud, jtc)
    for i in range(2):
        b = _batch(seed=2 + i)
        key = jax.random.key(5 + i)
        noise = jren.draw_render_noise(key, jcfg, 1, b["raydir"].shape[1],
                                       grid=jgrid, is_train=True)
        jstate, jl = jtrain.train_step(
            jstate, jgrid, jcfg, jtc,
            {k: jnp.asarray(v) for k, v in b.items()}, key)
        tstate, tl = ttrain.train_step(
            tstate, tgrid, tcfg, ttc,
            {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
            noise={"raygen_u": torch.from_numpy(
                np.array(noise["raygen_u"]))})
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    assert tstate.step == int(jstate.step) == 2
    jp = jax.tree.map(np.asarray, jstate.params)
    for block, layers in jp.items():
        for li, layer in enumerate(layers):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    tstate.params[block][li][k].numpy(), layer[k],
                    rtol=2e-3, atol=2e-6, err_msg=f"{block}.{li}.{k}")
    for f in ("embedding", "conf", "color", "dir", "xyz"):
        np.testing.assert_allclose(getattr(tstate.cloud, f).numpy(),
                                   np.asarray(getattr(jstate.cloud, f)),
                                   rtol=2e-3, atol=2e-6, err_msg=f)


def test_train_step_moves_only_trained_fields():
    jcfg, tcfg, _, ttc = _cfgs(False, {})
    jcloud = _scene()
    tstate = _port_state(jcloud, jagg.init_aggregator_params(
        jax.random.key(0), jcfg.agg), ttc)
    grid = tpc.build_grid(tstate.cloud, tpc.grid_spec_for_cloud(
        tstate.cloud, vsize=[0.08] * 3, vscale=[1, 1, 1],
        kernel_size=[3, 3, 3], max_o=8192, P=16))
    before = {f: getattr(tstate.cloud, f).clone() for f in ttrain.POINT_FIELDS}
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()}
    tstate, losses = ttrain.train_step(tstate, grid, tcfg, ttc, b,
                                       generator=torch.Generator())
    assert torch.isfinite(losses["total"])
    for f in ("xyz", "dir"):
        assert torch.equal(getattr(tstate.cloud, f), before[f])
    assert not torch.equal(tstate.cloud.embedding, before["embedding"])
    assert not any(getattr(tstate.cloud, f).requires_grad
                   for f in ttrain.POINT_FIELDS)


def test_prune_matches_reference():
    jcloud = _scene()
    jp = jpc.prune(jcloud, 0.6)
    tp = tpc.prune(tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu"), 0.6)
    assert 0 < int(tp.n_active) < 600
    for f in ("xyz", "active", "n_active"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


# ------------------------------------------------------- host-side helpers

@pytest.mark.parametrize("n,res", [(5000, 20), (30000, 64)])
def test_vox_downsample_closest_matches_reference(n, res):
    from sgnerf_tpu.runtime.native import vox_downsample_closest as jv
    from sgnerf_tpu_torch.runtime.native import vox_downsample_closest as tv
    x = (np.random.default_rng(n).normal(size=(n, 3)) * 2).astype(np.float32)
    np.testing.assert_array_equal(tv(x, res), jv(x, res))


def test_nearest_view_matches_reference():
    from sgnerf_tpu.runtime.scene_model import nearest_view as jnv
    from sgnerf_tpu_torch.runtime.native import nearest_view as tnv
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    campos = rng.normal(size=(6, 3)).astype(np.float32) * 3
    camdir = -campos / np.linalg.norm(campos, axis=-1, keepdims=True)
    np.testing.assert_array_equal(tnv(campos, camdir, xyz),
                                  jnv(campos, camdir, xyz))


# ------------------------------------------- dataset, checkpoints and CLI

W, H = 48, 36


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """ScanNet export layout with a pcd.ply of a unit sphere."""
    from PIL import Image
    from sgnerf_tpu_torch.utils.ply import write_ply
    root = tmp_path_factory.mktemp("scans")
    scan = root / "scene_t" / "exported"
    for sub in ("color", "pose", "intrinsic"):
        (scan / sub).mkdir(parents=True)
    intr = np.eye(4)
    intr[:3, :3] = [[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]
    np.savetxt(scan / "intrinsic/intrinsic_color.txt", intr)
    rng = np.random.default_rng(0)
    for i in range(4):
        ang = 2 * np.pi * i / 4
        campos = np.array([3 * np.sin(ang), 0.3, -3 * np.cos(ang)])
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross([0, 1, 0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = campos
        np.savetxt(scan / f"pose/{i}.txt", c2w)
        Image.fromarray((rng.uniform(0, 1, (H, W, 3)) * 255).astype(
            np.uint8)).save(scan / f"color/{i}.jpg")
    xyz = rng.normal(size=(3000, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    rgb = (rng.uniform(0, 255, (3000, 3))).astype(np.uint8)
    write_ply(str(scan / "pcd.ply"), {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2], "red": rgb[:, 0],
        "green": rgb[:, 1], "blue": rgb[:, 2]})
    return str(root) + "/"


def _train_flags(data_root, ckpt, extra=()):
    return [
        "--name", "t", "--data_root", data_root, "--scan", "scene_t",
        "--checkpoints_dir", ckpt, "--dataset_name", "scannet_ft",
        "--img_wh", str(W), str(H), "--train_step", "2",
        "--random_sample", "random", "--random_sample_size", "6",
        "--z_depth_dim", "40", "--SR", "6", "--K", "4", "--P", "8",
        "--max_o", "40000", "--vsize", ".06", ".06", ".06",
        "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
        "--near_plane", "1", "--far_plane", "5", "--agg_dist_pers", "20",
        "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
        "--act_type", "LeakyReLU", "--which_ray_generation",
        "near_far_linear", "--which_render_func", "radiance",
        "--which_blend_func", "alpha", "--which_tonemap_func", "off",
        "--color_loss_items", "ray_masked_coarse_raycolor",
        "--color_loss_weights", "1", "--vox_res", "40",
        "--ranges", "-10", "-10", "-10", "10", "10", "10",
        "--bg_color", "random", "--edge_filter", "2", "--gpu_ids", "-1",
        "--wcoord_query", "1"] + list(extra)


@pytest.mark.parametrize("mode", ["random", "random2", "patch"])
def test_train_item_pixels_match_reference(scans, tmp_path, mode):
    from sgnerf_tpu.data.scannet_ft_dataset import ScannetFtDataset as JDs
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu_torch.data.scannet_ft_dataset import ScannetFtDataset
    from sgnerf_tpu_torch.options import TrainOptions
    flags = _train_flags(scans, str(tmp_path), ["--random_sample", mode])
    topt, jopt = TrainOptions().parse(flags), JOpts().parse(flags)
    topt.split = jopt.split = "train"
    a = ScannetFtDataset(topt).get_item(1, rng=np.random.default_rng(7))
    b = JDs(jopt).get_item(1, rng=np.random.default_rng(7))
    for k in ("pixel_idx", "gt_image", "bg_color", "campos"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["raydir"], b["raydir"], rtol=1e-6,
                               atol=1e-7)


def test_load_init_points_and_campos_match_reference(scans, tmp_path):
    from sgnerf_tpu.data.scannet_ft_dataset import ScannetFtDataset as JDs
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu_torch.data.scannet_ft_dataset import ScannetFtDataset
    from sgnerf_tpu_torch.options import TrainOptions
    flags = _train_flags(scans, str(tmp_path),
                         ["--ranges", "-0.9", "-2", "-2", "2", "2", "2"])
    topt, jopt = TrainOptions().parse(flags), JOpts().parse(flags)
    topt.split = jopt.split = "train"
    td, jd = ScannetFtDataset(topt), JDs(jopt)
    for a, b in zip(td.load_init_points(), jd.load_init_points()):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(td.get_campos_ray(), jd.get_campos_ray()):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_checkpoints_load_across_packages(scans, tmp_path):
    """A native checkpoint the port saves loads in the JAX package, and
    the reverse, with every cloud field and parameter intact."""
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu.runtime import SceneModel as JaxSceneModel
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(700, 3)).astype(np.float32)
    flags = _train_flags(scans, "unused", ["--name", "x"])
    for src_pkg in ("port", "jax"):
        src_dir, dst_dir = tmp_path / f"{src_pkg}_a", tmp_path / f"{src_pkg}_b"
        src_opt = (TrainOptions if src_pkg == "port" else JOpts)().parse(
            flags + ["--checkpoints_dir", str(src_dir)])
        if src_pkg == "port":
            src = SceneModel(src_opt)
            src.setup_from_points(xyz, rng.uniform(0, 255, (700, 3)), None)
            src.best_psnr = 12.5
            src.save_checkpoint(3)
        else:
            src = JaxSceneModel(src_opt)
            src.setup_from_points(xyz, rng.uniform(0, 255, (700, 3)), None)
            src.best_psnr = 12.5
            src.save_checkpoint(3)
        path = str(src_dir / "x" / "3_net_ray_marching.npz")
        dst_opt = (JOpts if src_pkg == "port" else TrainOptions)().parse(
            flags + ["--checkpoints_dir", str(dst_dir)])
        dst = (JaxSceneModel(dst_opt) if src_pkg == "port"
               else SceneModel(dst_opt))
        dst.load_checkpoint(path)
        assert int(dst.state.step) == 3 and dst.best_psnr == 12.5
        jc = (dst if src_pkg == "port" else src).state.cloud
        tc = (src if src_pkg == "port" else dst).cloud
        for f in dataclasses.fields(jc):
            np.testing.assert_array_equal(getattr(tc, f.name).numpy(),
                                          np.asarray(getattr(jc, f.name)),
                                          err_msg=f.name)


def test_train_ft_cli_runs_and_writes_checkpoints(scans, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "sgnerf_tpu_torch.run.train_ft"]
        + _train_flags(scans, str(tmp_path), [
            "--maximum_step", "4", "--save_iter_freq", "2",
            "--print_freq", "2", "--test_freq", "0", "--test_num", "1",
            "--prob_freq", "0", "--n_threads", "1",
            "--steps_per_dispatch", "2",
            "--profile_dir", str(tmp_path / "prof"), "--profile_start", "1",
            "--profile_steps", "1"]),
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "after voxelize" in out and "training from step 0 to 4" in out
    assert "step: 4," in out and "test mean psnr over 1 imgs" in out
    d = tmp_path / "t"
    for f in ("2_net_ray_marching.npz", "4_net_ray_marching.npz",
              "4_net_ray_marching.pth", "4_states.pth"):
        assert (d / f).exists(), f
    trace = tmp_path / "prof" / "train_ft_2.json"
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"sgnerf.step", "sgnerf.step.forward", "sgnerf.step.loss",
            "sgnerf.step.backward", "sgnerf.step.update", "sgnerf.query",
            "sgnerf.shade"} <= names
    # the spans' summary of the profiled step
    assert "spans: 0 frames, 1 steps" in out and "shade.found" in out


@pytest.mark.parametrize("flags", [["--scene_shards", "2"],
                                   ["--ray_shards", "2"],
                                   ["--gather_dtype", "int8"],
                                   ["--gather_dtype", "bfloat16"]])
def test_train_ft_refuses_unported_flags_at_startup(scans, tmp_path, flags):
    """Each flag, refused until the port took it, trains and test_ft
    renders the checkpoint: the shard flags on two CPU shards (--gpu_ids
    -1,-1), after the one-id run is refused before any work; the opt-in
    gathers (int8: the forward's int8 gather; bf16 with stochastic
    rounding and batchdedup's transpose)."""
    import contextlib
    import io
    from sgnerf_tpu_torch.run import test_ft, train_ft
    if any(f.endswith("_shards") for f in flags):
        with pytest.raises(ValueError, match="--gpu_ids"):
            train_ft.main(_train_flags(scans, str(tmp_path), flags))
        assert not (tmp_path / "t").exists()
        flags = flags + ["--gpu_ids", "-1,-1"]
    if flags[-1] == "bfloat16":
        flags = flags + ["--gather_round", "stochastic",
                         "--gather_vjp", "batchdedup"]
    args = _train_flags(scans, str(tmp_path), flags)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_ft.main(args + ["--maximum_step", "2", "--save_iter_freq", "2",
                              "--print_freq", "1", "--test_freq", "0",
                              "--test_num", "1", "--n_threads", "1"])
        test_ft.main(args + ["--resume_iter", "latest",
                             "--test_num_step", "4"])
    out = buf.getvalue()
    assert "step: 2," in out and "training done" in out, out[-2000:]
    assert ("gvjp_overflow: 0.000" in out) == (flags[-1] == "batchdedup"), \
        out[-2000:]
    assert (tmp_path / "t" / "2_net_ray_marching.npz").exists()
    psnrs = [float(l_.split("psnr:")[1].split()[0])
             for l_ in out.splitlines() if l_.startswith("num.")]
    assert psnrs and np.isfinite(psnrs).all(), out[-2000:]


def test_room_scan_is_bench_room_scan():
    import bench
    from sgnerf_tpu_torch.data.synthetic import room_scan
    a = room_scan(np.random.default_rng(4), 5000)
    b = bench._room_scan(np.random.default_rng(4), 5000)
    np.testing.assert_array_equal(a, b)


def test_train_step_multi_equals_sequential_steps():
    jcfg, tcfg, _, ttc = _cfgs(False, {})
    jparams = jagg.init_aggregator_params(jax.random.key(0), jcfg.agg)
    states = [_port_state(_scene(), jparams, ttc) for _ in range(2)]
    grid = tpc.build_grid(states[0].cloud, tpc.grid_spec_for_cloud(
        states[0].cloud, vsize=[0.08] * 3, vscale=[1, 1, 1],
        kernel_size=[3, 3, 3], max_o=8192, P=16))
    batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in
                _batch(seed=s).items()} for s in (3, 4, 5)]
    noises = [tren.draw_render_noise(torch.Generator().manual_seed(s), tcfg,
                                     1, 48) for s in (3, 4, 5)]
    seq = []
    for b, n in zip(batches, noises):
        _, l_ = ttrain.train_step(states[0], grid, tcfg, ttc, b, noise=n)
        seq.append(l_)
    _, multi = ttrain.train_step_multi(states[1], grid, tcfg, ttc, batches,
                                       noises=noises)
    for a, b in zip(seq, multi):
        assert torch.equal(a["total"], b["total"])
    for a, b in zip(ttrain.param_leaves(states[0].params),
                    ttrain.param_leaves(states[1].params)):
        assert torch.equal(a, b)
    assert states[0].step == states[1].step == 3


def test_scene_model_prune_keeps_step_and_net_state(scans, tmp_path):
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import (SceneModel,
                                                      batch_to_device)
    opt = TrainOptions().parse(_train_flags(scans, str(tmp_path)))
    opt.split = "train"
    ds = create_dataset(opt)
    model = SceneModel(opt)
    model.setup_from_points(*ds.load_init_points(), dataset=ds)
    batch = batch_to_device(ds.get_item(0, rng=np.random.default_rng(0)),
                            model.device)
    model.optimize(batch)
    n0, count = int(model.cloud.n_active), model.state.opt_net["count"]
    with torch.no_grad():
        model.cloud.conf[: n0 // 2] = 0.05
    model.prune_points(0.1)
    assert int(model.cloud.n_active) == n0 - n0 // 2
    assert model.step == 1 and model.state.opt_net["count"] == count
    assert model.state.opt_pts["count"] == 0
    losses = model.optimize(batch)
    assert torch.isfinite(losses["total"]) and model.step == 2
