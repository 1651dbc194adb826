"""The port's feed-forward training against the JAX package on the CPU:
one joint step (MVS nets in the autograd graph, two Adams) from the same
weights, the behaviour tests of tests/test_feedforward.py on the port,
and `python -m sgnerf_tpu_torch.run.train`, which resumes from a
`_feedforward.pkl` the JAX run/train.py wrote and writes one JAX reads.

Tolerances: the step runs at zero jitter and manual_std_depth 0 (the ete
scripts' value), so neither package draws random numbers; the loss within
1e-5 relative, and after the step every leaf of both parameter groups
within 1e-5 of its largest magnitude, with alter_step 0 and 1 (the
ordering of float sums in the convolutions and the render differs between
the packages, and one Adam step moves a leaf by about lr times the sign of
its gradient); elements whose gradient is within ~1e-5 of zero, where
that step reads the gradient's last bits, are counted (at most 1e-4 of
the elements) instead.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_cpu_thread  # noqa: F401

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.models import mvs as jmvs
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.models.feedforward import make_feedforward_step as jstep
from sgnerf_tpu.ops.camera import get_dtu_raydir
from sgnerf_tpu.ops.grid import compute_grid_spec as jspec
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models import feedforward as tff
from sgnerf_tpu_torch.models import mvs as tmvs
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models.params import (mvs_params_from_jax,
                                            mvs_params_to_jax,
                                            params_from_jax, params_to_jax)
from sgnerf_tpu_torch.ops.grid import compute_grid_spec as tspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEMS = ("ray_masked_coarse_raycolor", "coarse_raycolor")
WEIGHTS = (1.0, 0.5)


def _batch(rng, H=24, W=32, V=2):
    """tests/test_feedforward.py's batch: a bumpy depth plane at ~2 m, two
    views with a small baseline, 128 random rays."""
    f = 24.0
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    c2ws = np.stack([np.eye(4, dtype=np.float32)] * V)
    c2ws[1, 0, 3] = 0.1
    w2cs = np.stack([np.linalg.inv(c) for c in c2ws]).astype(np.float32)
    imgs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gt_depth = (2.0 + 0.2 * np.sin(gx / 5.0) * np.cos(gy / 4.0)).astype(
        np.float32)
    px, py = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([px, py], -1).reshape(-1, 2)
    sel = rng.integers(0, len(pix), 128)
    rd = np.asarray(get_dtu_raydir(jnp.asarray(pix[sel]), jnp.asarray(intr),
                                   jnp.eye(3), True), np.float32)
    return {
        "images": imgs, "c2ws": c2ws, "w2cs": w2cs,
        "intrinsics": np.stack([intr] * V), "depth_intr": intr,
        "near_far": np.asarray([0.5, 4.0], np.float32), "gt_depth": gt_depth,
        "campos": np.zeros((1, 3), np.float32), "raydir": rd[None],
        "camrotc2w": np.eye(3, dtype=np.float32)[None],
        "near": np.float32(0.5), "far": np.float32(4.0),
        "bg_color": np.ones(3, np.float32),
        "gt_image": rng.uniform(0, 1, (1, 128, 3)).astype(np.float32)}


def _setup(seed=0):
    corners = np.array([[-3, -3, -0.5], [3, 3, 4.0]], np.float32)
    kw = dict(vsize=[0.1] * 3, vscale=[1, 1, 1], kernel_size=[3, 3, 3],
              max_o=8192, P=8)
    rkw = dict(z_depth_dim=48, SR=8, K=4, vsize=(0.1,) * 3, jitter=0.0)
    jcfg = jren.RenderConfig(agg=jagg.AggregatorConfig(), **rkw)
    tcfg = tren.RenderConfig(agg=tagg.AggregatorConfig(), **rkw)
    jparams = jax.tree.map(np.asarray, {
        "agg": jagg.init_aggregator_params(jax.random.key(seed), jcfg.agg),
        "mvs": jmvs.init_mvs_params(jax.random.key(seed + 1),
                                    jmvs.MVSConfig())})
    return (jcfg, tcfg, jspec(corners, **kw), tspec(corners, **kw), jparams)


def _bucket(spec):
    """The spec without the neighbourhood cache: the query takes the
    bucket path, exact as the cache path is. On the CPU the cache build
    over the bucketed 190k dilated voxels is most of a step; the
    behaviour tests below take 25 steps."""
    return dataclasses.replace(spec, nbr_cache=0)


def _port(jparams):
    return {"agg": params_from_jax(jparams["agg"]),
            "mvs": mvs_params_from_jax(jparams["mvs"])}


def _tbatch(b):
    return {k: (float(v) if k in ("near", "far") else torch.from_numpy(
        np.asarray(v))) for k, v in b.items()}


def _assert_params_close(tparams, jparams, before, lr, what):
    """Every leaf within 1e-5 of its largest magnitude; elements whose
    first Adam step JAX made shorter than 0.999 lr are counted, not held:
    their gradient lies within ~1000 eps (1e-5) of zero, where the step
    g / (|g| + eps) reads the gradient's last bits."""
    back = {"agg": params_to_jax(tparams["agg"]),
            "mvs": mvs_params_to_jax(tparams["mvs"])}
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    old = dict(jax.tree_util.tree_leaves_with_path(before))
    n = n_el = n_soft = 0
    for path, a in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jparams)):
        tol = 1e-5 * float(np.abs(a).max())
        off = np.abs(flat[path] - a) > tol
        step = np.abs(a - old[path])
        soft = (step > 0) & (step < 0.999 * lr)
        assert not (off & ~soft).any(), (what, path, np.abs(
            flat[path] - a)[off & ~soft].max(), tol)
        n_soft += int((off & soft).sum())
        n_el += a.size
        n += 1
    assert n == len(flat) > 150
    print(f"{what}: {n_soft} of {n_el} elements off by more than 1e-5 of "
          f"their leaf's magnitude, each with a JAX step < 0.999 lr")
    assert n_soft <= 1e-4 * n_el, n_soft


@pytest.mark.parametrize("alter_step", [0, 1])
def test_feedforward_step_matches_jax(alter_step):
    jcfg, tcfg, js, ts, jparams = _setup()
    lr = 5e-4
    tx = optax.adam(lr)
    jp = jax.tree.map(jnp.asarray, jparams)
    jst = {"agg": tx.init(jp["agg"]), "mvs": tx.init(jp["mvs"])}
    jfn = jstep(jmvs.MVSConfig(), jcfg, js, tx, tx, alter_step=alter_step,
                color_loss_items=ITEMS, color_loss_weights=WEIGHTS)
    tp = _port(jparams)
    tst = tff.init_opt_states(tp)
    tfn = tff.make_feedforward_step(tmvs.MVSConfig(), tcfg, ts, lr, lr,
                                    alter_step=alter_step,
                                    color_loss_items=ITEMS,
                                    color_loss_weights=WEIGHTS)
    rng = np.random.default_rng(0)
    for step in range(1 + alter_step):
        b = _batch(rng)
        before = jax.tree.map(np.asarray, jp)
        jp, jst, jl = jfn(jp, jst, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.key(3 + step), jnp.asarray(step))
        tp, tst, tl = tfn(tp, tst, _tbatch(b), step)
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-5, err_msg=f"step {step} {k}")
        assert float(tl["n_points"]) > 100
        # each group takes at most one Adam step here: its move from the
        # initial weights is that step
        _assert_params_close(tp, jp, jparams, lr, f"step {step}")
        if alter_step:                       # the gated group did not move
            still = "mvs" if step == 0 else "agg"
            for a, c in zip(jax.tree.leaves(before[still]),
                            jax.tree.leaves(jax.tree.map(np.asarray,
                                                         jp[still]))):
                np.testing.assert_array_equal(a, c)
            assert tst[still]["count"] == (0 if step == 0 else 1)


def test_feedforward_trains_mvs_through_render():
    """tests/test_feedforward.py's test on the port: the loss falls on a
    fixed batch and the render loss reaches FeatureNet."""
    _, tcfg, _, ts, jparams = _setup()
    tp = _port(jparams)
    tst = tff.init_opt_states(tp)
    fn = tff.make_feedforward_step(tmvs.MVSConfig(), tcfg, _bucket(ts),
                                   5e-4, 5e-4)
    b = _tbatch(_batch(np.random.default_rng(0)))
    w0 = tff.tree_leaves(tp["mvs"]["FeatureNet"])[0].clone()
    hist = []
    for s in range(25):
        tp, tst, losses = fn(tp, tst, b, s)
        hist.append(float(losses["total"]))
    assert float(losses["n_points"]) > 100
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) * 0.9, hist
    w1 = tff.tree_leaves(tp["mvs"]["FeatureNet"])[0]
    assert float((w1 - w0).abs().max()) > 1e-6


def test_feedforward_alternating_updates():
    """alter_step 1: even steps move only the aggregator, odd steps only
    the MVS nets."""
    _, tcfg, _, ts, jparams = _setup()
    tp = _port(jparams)
    tst = tff.init_opt_states(tp)
    fn = tff.make_feedforward_step(tmvs.MVSConfig(), tcfg, _bucket(ts),
                                   1e-3, 1e-3, alter_step=1)
    b = _tbatch(_batch(np.random.default_rng(1)))

    def snap():
        return {g: [t.clone() for t in tff.tree_leaves(tp[g])]
                for g in ("agg", "mvs")}

    def delta(p, q, g):
        return max(float((x - y).abs().max()) for x, y in zip(p[g], q[g]))
    p0 = snap()
    tp, tst, _ = fn(tp, tst, b, 0)
    p1 = snap()
    assert delta(p1, p0, "agg") > 0 and delta(p1, p0, "mvs") == 0
    tp, tst, _ = fn(tp, tst, b, 1)
    p2 = snap()
    assert delta(p2, p1, "agg") == 0 and delta(p2, p1, "mvs") > 0


def test_feedforward_step_with_missing_depth_stays_finite():
    """Pixels without depth (0, as DTU's maps have around the object) are
    inactive points; their projection divides by zero, and the port embeds
    them at a finite stand-in, so no NaN reaches the weights."""
    _, tcfg, _, ts, jparams = _setup()
    tp = _port(jparams)
    tst = tff.init_opt_states(tp)
    fn = tff.make_feedforward_step(tmvs.MVSConfig(), tcfg, _bucket(ts),
                                   5e-4, 5e-4)
    b = _batch(np.random.default_rng(2))
    b["gt_depth"][:, :10] = 0.0
    tp, tst, losses = fn(tp, tst, _tbatch(b), 0)
    assert np.isfinite(float(losses["total"]))
    assert 100 < float(losses["n_points"]) < b["gt_depth"].size
    for g in ("agg", "mvs"):
        assert all(bool(torch.isfinite(t).all())
                   for t in tff.tree_leaves(tp[g])), g

def test_mvs_precision_is_set_per_forward():
    """The MVS nets' IEEE-f32 mode is set and undone around each forward,
    whatever the process set before (BPNet turns TF32 off process-wide)."""
    old = torch.backends.cudnn.allow_tf32
    try:
        for before in (True, False):
            torch.backends.cudnn.allow_tf32 = before
            with tmvs.ieee_f32():
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32 = old


# -------------------------------------------------------------------- CLI

def _ff_flags(root, ckpt, items=("ray_masked_coarse_raycolor",),
              weights=("1.0",)):
    return [
        "--name", "ff", "--data_root", root, "--scan", "scan1",
        "--dataset_name", "dtu", "--checkpoints_dir", ckpt,
        "--feedforward", "1", "--img_wh", "64", "48", "--train_step", "5",
        "--random_sample", "random", "--random_sample_size", "8",
        "--which_ray_generation", "near_far_linear",
        "--which_render_func", "radiance", "--which_blend_func", "alpha",
        "--which_tonemap_func", "off", "--near_plane", "2.0",
        "--far_plane", "6.0", "--z_depth_dim", "32", "--SR", "4", "--K", "2",
        "--P", "8", "--max_o", "4000", "--vsize", "0.1", "0.1", "0.1",
        "--vscale", "2", "2", "1", "--kernel_size", "3", "3", "3",
        "--agg_intrp_order", "2", "--agg_distance_kernel", "linear",
        "--agg_dist_pers", "20", "--act_type", "LeakyReLU",
        "--shading_color_mlp_layer", "4", "--shading_feature_mlp_layer1",
        "2", "--point_features_dim", "32", "--num_feat_freqs", "3",
        "--dist_xyz_freq", "5", "--num_viewdir_freqs", "4",
        "--raydist_mode_unit", "1", "--radius_limit_scale", "4",
        "--ranges", "-3", "-3", "-3", "3", "3", "3", "--print_freq", "1",
        "--save_iter_freq", "2", "--resume_iter", "latest",
        "--color_loss_items", *items, "--color_loss_weights", *weights]


def test_train_cli_resumes_across_packages(tmp_path):
    """The JAX run/train.py writes 2_feedforward.pkl; the port's CLI
    resumes it, trains to step 4 (with the ete scripts' depth-masked
    loss, which needs the batch's ray_depth_mask) and writes
    4_feedforward.{pkl,npz} in the JAX package's trees; the port's reader
    and writer carry every leaf bit for bit."""
    from test_torch_dtu import write_dtu_tree
    from sgnerf_tpu_torch.run import train
    root = write_dtu_tree(tmp_path / "dtu")
    ck = str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", SGNERF_JAX_CACHE=str(tmp_path / "jc"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "run", "train.py")]
        + _ff_flags(root, ck) + ["--maximum_step", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    d = tmp_path / "ck" / "ff"
    with open(d / "2_feedforward.pkl", "rb") as f:
        jtree = pickle.load(f)
    # reader and writer: bit for bit
    port = train.load_feedforward(str(d / "2_feedforward.pkl"), "cpu")
    train.save_feedforward(port, str(tmp_path / "rt"), 2)
    with open(tmp_path / "rt" / "2_feedforward.pkl", "rb") as f:
        rt = pickle.load(f)
    ja = dict(jax.tree_util.tree_leaves_with_path(jtree))
    ra = dict(jax.tree_util.tree_leaves_with_path(rt))
    assert ja.keys() == ra.keys() and len(ja) > 150
    for k in ja:
        np.testing.assert_array_equal(ra[k], ja[k], err_msg=str(k))
    jn, rn = np.load(d / "2_feedforward.npz"), \
        np.load(tmp_path / "rt" / "2_feedforward.npz")
    assert sorted(jn.files) == sorted(rn.files)
    for k in jn.files:
        np.testing.assert_array_equal(rn[k], jn[k], err_msg=k)

    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(_ff_flags(
            root, ck, ("ray_masked_coarse_raycolor",
                       "ray_depth_masked_coarse_raycolor"), ("0.0", "1.0"))
            + ["--maximum_step", "4", "--gpu_ids", "-1"])
    out = buf.getvalue()
    assert "2_feedforward.pkl (step 2)" in out, out[-2000:]
    lines = [l_ for l_ in out.splitlines() if l_.startswith("step: ")]
    assert [l_.split(",")[0] for l_ in lines] == ["step: 3", "step: 4"]
    assert all("ray_depth_masked_coarse_raycolor" in l_ and "n_points: 3072"
               in l_ for l_ in lines), lines
    with open(d / "4_feedforward.pkl", "rb") as f:
        new = pickle.load(f)
    na = jax.tree_util.tree_leaves_with_path(new)
    assert [p for p, _ in na] == list(ja.keys())
    for p, x in na:
        assert x.shape == ja[p].shape and x.dtype == ja[p].dtype
    jax.tree.map(jnp.asarray, new)           # the JAX trainer's resume
    moved = tff.tree_leaves(mvs_params_from_jax(new["mvs"]["FeatureNet"]))[0]
    was = tff.tree_leaves(mvs_params_from_jax(jtree["mvs"]["FeatureNet"]))[0]
    assert float((moved - was).abs().max()) > 0
