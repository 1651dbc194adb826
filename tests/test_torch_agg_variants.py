"""The port's aggregator variants against the JAX package on the CPU:
block2, block3, block2_bpnet + block3, the yuze variant with and without
block_linear, order 1, every distance kernel with unit and non-unit axis
weights, one block3 train step (its colour gradients included), the
reference checkpoint round trip of each new block, and the port's
check_flags on the repo's ScanNet and DTU scripts.

Tolerances: aggregate() rtol 1e-5, atol 1e-6 (f32, the same products in
the same order); the train step's losses rtol 1e-5, parameters and point
fields rtol 2e-3, atol 2e-6 (tests/test_torch_semantic.py's limits). The
parameters come from the JAX init through models/params.py.
"""
import glob
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.models import train as jtrain
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models import point_cloud as tpc
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models import train as ttrain
from sgnerf_tpu_torch.models.params import params_from_jax
from torch_threads import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, B=1, R=5, SR=4, K=4, F=32):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(B, R, SR, K, 3)) * 0.02).astype(np.float32)
    loc = (rng.normal(size=(B, R, SR, 3)) * 0.02).astype(np.float32)
    d = rng.normal(size=(B, R, SR, K, 3)).astype(np.float32)
    return {
        "sampled_embedding": rng.normal(size=(B, R, SR, K, F)).astype(
            np.float32),
        "sampled_conf": rng.uniform(0.1, 1, (B, R, SR, K, 1)).astype(
            np.float32),
        "sampled_label_embedding": rng.normal(size=(B, R, SR, K, 96)).astype(
            np.float32),
        "sampled_color": rng.uniform(0, 1, (B, R, SR, K, 3)).astype(
            np.float32),
        "sampled_dir": d / np.linalg.norm(d, axis=-1, keepdims=True),
        "sampled_xyz": xyz, "sampled_xyz_pers": xyz + 1.5,
        "sample_pnt_mask": rng.uniform(size=(B, R, SR, K)) > 0.3,
        "sample_loc": loc + 1.5, "sample_loc_w": loc,
        "sample_ray_dirs": rng.normal(size=(B, R, SR, 3)).astype(np.float32),
    }


def _rot(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q.astype(np.float32)


def _compare(kw, seed=2, rot=None, x=None):
    """aggregate() of both packages on the same inputs and params."""
    jcfg = jagg.AggregatorConfig(**kw)
    tcfg = tagg.AggregatorConfig(**kw)
    jparams = jagg.init_aggregator_params(jax.random.key(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    x = _inputs(seed) if x is None else x
    rw = {} if rot is None else {"Rw2c": rot}
    jout = jagg.aggregate(jparams, jcfg, vsize=(0.008,) * 3,
                          **{k: jnp.asarray(v) for k, v in
                             dict(x, **rw).items()})
    with torch.no_grad():
        tout = tagg.aggregate(tparams, tcfg, vsize=(0.008,) * 3,
                              **{k: torch.from_numpy(v) for k, v in
                                 dict(x, **rw).items()})
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # the port's own init builds the same blocks at the same shapes
    own = tagg.init_aggregator_params(0, tcfg)
    assert sorted(own) == sorted(tparams)
    for blk in own:
        assert [tuple(layer["w"].shape) for layer in own[blk]] == [
            tuple(layer["w"].shape) for layer in tparams[blk]], blk
    return tparams, tout


VARIANTS = {
    "block2": dict(shading_feature_mlp_layer2=2),
    "block3": dict(shading_feature_mlp_layer3=2),
    "block3_no_color_dir": dict(shading_feature_mlp_layer3=1,
                                point_color_mode="0", point_dir_mode="0"),
    "bpnet_block3": dict(shading_feature_mlp_layer2_bpnet=1,
                         predict_semantic=1, shading_feature_mlp_layer3=2),
    "yuze": dict(agg_variant="yuze", shading_feature_mlp_layer3=1,
                 shading_feature_mlp_layer4=1),
    "yuze_linear": dict(agg_variant="yuze", shading_feature_mlp_layer4=2,
                        shading_feature_mlp_linear=1),
    "order1": dict(agg_intrp_order=1),
    "order1_block3": dict(agg_intrp_order=1, shading_feature_mlp_layer3=2),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax(name):
    kw = VARIANTS[name]
    params, out = _compare(kw, rot=_rot(4) if "block3" in name else None)
    for blk in ("block2", "block3", "block4", "block_linear"):
        want = {"block2": "shading_feature_mlp_layer2",
                "block3": "shading_feature_mlp_layer3",
                "block4": "shading_feature_mlp_layer4",
                "block_linear": "shading_feature_mlp_linear"}[blk]
        assert (blk in params) == bool(kw.get(want, 0)), blk
    assert np.isfinite(out[0].numpy()).all()


def test_block3_input_widths():
    """block3 takes 256 + 3 + 4 with colour and dir modes on, block4 the
    PE'd angles and the colour, block2 the distance features again."""
    cfg = tagg.AggregatorConfig(shading_feature_mlp_layer2=1,
                                shading_feature_mlp_layer3=2,
                                agg_variant="yuze",
                                shading_feature_mlp_layer4=1,
                                shading_feature_mlp_linear=1)
    p = tagg.init_aggregator_params(0, cfg)
    assert p["block3"][0]["w"].shape == (256 + 3 + 4, 256)
    assert p["block4"][0]["w"].shape == (256 + 6 * 3 + 3, 256)
    assert p["block2"][0]["w"].shape == (256 + cfg.dist_xyz_dim, 256)
    assert [layer["w"].shape for layer in p["block_linear"]] == [(256, 256)]


def test_order_zero_raises_as_in_jax():
    cfg = tagg.AggregatorConfig(agg_intrp_order=0)
    x = {k: torch.from_numpy(v) for k, v in _inputs(1).items()}
    with pytest.raises(ValueError, match="agg_intrp_order"):
        tagg.aggregate(tagg.init_aggregator_params(0, cfg), cfg, **x)


KERNELS = ["linear", "quadric", "avg", "numlinear", "numquadric",
           "trilinear", "sh_intrp", "gau_intrp"]


@pytest.mark.parametrize("aw", [(1.0, 1.0, 1.0), (1.0, 0.5, 2.0)],
                         ids=["unit", "nonunit"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_distance_kernel_matches_jax(kernel, aw):
    kw = dict(agg_distance_kernel=kernel, axis_weight=aw)
    if aw != (1.0, 1.0, 1.0) and kernel.endswith("quadric"):
        # the reference weighs the whole dists row by the 3-wide weight,
        # which broadcasts for 3-wide dists only
        kw["agg_dist_pers"] = 0
    if kernel in ("trilinear", "avg"):
        kw["shading_feature_mlp_layer3"] = 1     # a variant beside it
    _compare(kw, seed=7)


def test_non_unit_quadric_fails_at_pers_20_in_both():
    kw = dict(agg_distance_kernel="quadric", axis_weight=(1.0, 0.5, 2.0))
    x = _inputs(3)
    with pytest.raises(ValueError):
        jagg._dist_weights(jagg.AggregatorConfig(**kw),
                           jnp.ones(x["sampled_xyz"].shape[:-1] + (6,)),
                           jnp.asarray(x["sample_pnt_mask"]))
    with pytest.raises(RuntimeError):
        tagg._dist_weights(tagg.AggregatorConfig(**kw),
                           torch.ones(x["sampled_xyz"].shape[:-1] + (6,)),
                           torch.from_numpy(x["sample_pnt_mask"]))


def test_sh_and_gau_consume_leading_channels():
    for kern, used in (("sh_intrp", 16), ("gau_intrp", 7)):
        cfg = tagg.AggregatorConfig(agg_distance_kernel=kern)
        c = 32 - used
        assert cfg.block1_in == c + 6 * c + cfg.dist_xyz_dim
        assert cfg.block1_in == jagg.AggregatorConfig(
            agg_distance_kernel=kern).block1_in


# ------------------------------------------------------ block3 train step

@pytest.mark.parametrize("gather_vjp", ["scatter", "sorted", "f32", "spread",
                                        "raydedup", "batchdedup"])
def test_block3_train_step_matches_jax(gather_vjp):
    """One step of scene0000_00.sh's aggregator (block3 on colour and dir)
    with colour training on: losses, parameters and the point fields,
    colour's gradient (through each of the gather's six transposes) and
    Adam update included; raydedup's and batchdedup's overflow counts in
    the losses."""
    n, cap = 600, 640
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    jcloud = jpc.make_point_cloud(
        xyz, rng.normal(size=(n, 32)).astype(np.float32) * 0.1,
        conf=rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32), dir=xyz,
        capacity=cap)
    akw = dict(shading_feature_mlp_layer3=2)
    rkw = dict(z_depth_dim=48, SR=6, K=4, vsize=(0.08,) * 3,
               gather_vjp=gather_vjp)
    jcfg = jren.RenderConfig(agg=jagg.AggregatorConfig(
        fused_mlp="none", fused_bwd="xla", **akw), **rkw)
    tcfg = tren.RenderConfig(agg=tagg.AggregatorConfig(**akw), **rkw)
    tkw = dict(color_grad=1, dir_grad=0)
    jtc, ttc = jtrain.TrainConfig(**tkw), ttrain.TrainConfig(**tkw)
    gkw = dict(vsize=[0.08] * 3, vscale=[1, 1, 1], kernel_size=[3, 3, 3],
               max_o=8192, P=16)
    jgrid = jpc.build_grid(jcloud, jpc.grid_spec_for_cloud(jcloud, **gkw))
    jparams = jagg.init_aggregator_params(jax.random.key(0), jcfg.agg)
    tcloud = tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")
    color0 = tcloud.color.clone()
    tstate = ttrain.create_train_state(
        params_from_jax(jax.tree.map(np.asarray, jparams)), tcloud, ttc)
    tgrid = tpc.build_grid(tcloud, tpc.grid_spec_for_cloud(tcloud, **gkw))
    jstate = jtrain.create_train_state(jparams, jcloud, jtc)
    R = 48
    d = rng.normal(size=(1, R, 3)).astype(np.float32) * 0.25
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = {"campos": np.asarray([[0.0, 0.0, -3.0]], np.float32),
         "raydir": d, "camrotc2w": np.eye(3, dtype=np.float32)[None],
         "near": np.float32(1.0), "far": np.float32(5.0),
         "bg_color": np.ones(3, np.float32),
         "gt_image": rng.uniform(0.2, 0.8, (1, R, 3)).astype(np.float32)}
    key = jax.random.key(5)
    noise = jren.draw_render_noise(key, jcfg, 1, R, grid=jgrid,
                                   is_train=True)
    jstate, jl = jtrain.train_step(jstate, jgrid, jcfg, jtc,
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   key)
    tstate, tl = ttrain.train_step(
        tstate, tgrid, tcfg, ttc,
        {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
        noise={"raygen_u": torch.from_numpy(np.array(noise["raygen_u"]))})
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, err_msg=k)
    jp = jax.tree.map(np.asarray, jstate.params)
    assert "block3" in tstate.params
    for block, layers in jp.items():
        for li, layer in enumerate(layers):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    tstate.params[block][li][k].numpy(), layer[k],
                    rtol=2e-3, atol=2e-6, err_msg=f"{block}.{li}.{k}")
    for f in ("embedding", "conf", "color", "dir"):
        np.testing.assert_allclose(getattr(tstate.cloud, f).numpy(),
                                   np.asarray(getattr(jstate.cloud, f)),
                                   rtol=2e-3, atol=2e-6, err_msg=f)
    # colour got a gradient and Adam moved it
    assert not torch.equal(tstate.cloud.color, color0)


@pytest.mark.parametrize("block,kw", [
    ("block2", dict(shading_feature_mlp_layer2=2)),
    ("block3", dict(shading_feature_mlp_layer3=2)),
    ("block4", dict(agg_variant="yuze", shading_feature_mlp_layer4=1)),
    ("block_linear", dict(agg_variant="yuze", shading_feature_mlp_layer4=1,
                          shading_feature_mlp_linear=1)),
])
def test_reference_checkpoint_round_trip(tmp_path, block, kw):
    """export_reference_checkpoint -> convert_reference_checkpoint keeps
    each new block, and the port renders the converted params as JAX
    does."""
    from sgnerf_tpu_torch.models.checkpoint_io import (
        convert_reference_checkpoint, export_reference_checkpoint,
        load_torch_state_dict)
    from sgnerf_tpu_torch.models.params import params_to_jax
    cfg = tagg.AggregatorConfig(**kw)
    params = tagg.init_aggregator_params(3, cfg)
    pts = {"xyz": np.zeros((4, 3), np.float32)}
    path = str(tmp_path / "1_net_ray_marching.pth")
    export_reference_checkpoint(params_to_jax(params), pts, path)
    back, _ = convert_reference_checkpoint(load_torch_state_dict(path))
    assert block in back and sorted(back) == sorted(params)
    for name, layers in params.items():
        for a, b in zip(layers, back[name]):
            np.testing.assert_array_equal(a["w"].numpy(), b["w"])
            np.testing.assert_array_equal(a["b"].numpy(), b["b"])
    x = _inputs(5)
    jout = jagg.aggregate(back, jagg.AggregatorConfig(**kw),
                          **{k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        tout = tagg.aggregate(params_from_jax(back), cfg,
                              **{k: torch.from_numpy(v) for k, v in x.items()})
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------- the scripts' flags

def _script_text(path):
    """A dev_scripts/*.sh with its `source`d file put in place and its
    continuation lines joined."""
    out = []
    for line in open(path).read().replace("\\\n", " ").splitlines():
        if line.strip().startswith("source "):
            inc = os.path.basename(shlex.split(line)[1])
            out.append(_script_text(os.path.join(os.path.dirname(path), inc)))
        else:
            out.append(line)
    return "\n".join(out)


def _script_args(path):
    """The python command's arguments of a dev_scripts/*.sh, its shell
    variables put in (unset ones are empty)."""
    lines = _script_text(path).splitlines()
    env = {}
    for line in lines:
        k, eq, v = line.partition("=")
        if eq and k.isidentifier():
            env[k] = (shlex.split(v) or [""])[0]
    cmd = next(line for line in lines if line.strip().startswith("python"))
    for k in sorted(env, key=len, reverse=True):
        cmd = cmd.replace("${" + k + "}", env[k]).replace("$" + k, env[k])
    return shlex.split(cmd)[2:]


SCANNET_SCRIPTS = sorted(
    glob.glob(os.path.join(REPO, "dev_scripts", "myexp_scannet_colmap",
                           "*.sh"))
    + glob.glob(os.path.join(REPO, "dev_scripts", "w_scannet_etf", "*.sh")))
# inftest_common.sh is the body the inftest_scan*.sh scripts source
DTU_SCRIPTS = sorted(
    p for p in glob.glob(os.path.join(REPO, "dev_scripts", "dtu_test_inf",
                                      "*.sh"))
    + glob.glob(os.path.join(REPO, "dev_scripts", "ete", "*.sh"))
    if not p.endswith("_common.sh"))


def _port_startup(path):
    """What the port's entry point for the script (run/train.py's trainer,
    train_ft or test_ft) checks before any work on its flags, and its
    configs."""
    from sgnerf_tpu_torch.options import TestOptions, TrainOptions
    from sgnerf_tpu_torch.options.options import (_check_slice,
                                                  configs_from_opt)
    from sgnerf_tpu_torch.run import train as ff_train
    from sgnerf_tpu_torch.run.train_ft import check_flags
    args = _script_args(path)
    text = _script_text(path)
    train = "run/test_ft.py" not in text
    opt = (TrainOptions() if train else TestOptions()).parse(args)
    if "run/train.py" in text:
        ff_train.check_flags(opt)
    else:
        (check_flags if train else _check_slice)(opt)
    return configs_from_opt(opt, device="cpu"), opt


def test_the_scannet_scripts_are_found():
    assert len(SCANNET_SCRIPTS) == 13, SCANNET_SCRIPTS
    assert len(DTU_SCRIPTS) == 7, DTU_SCRIPTS


@pytest.mark.parametrize("path", SCANNET_SCRIPTS,
                         ids=[os.path.basename(p) for p in SCANNET_SCRIPTS])
def test_port_accepts_every_scannet_script(path):
    cfg = _port_startup(path)[0][0]
    assert cfg.agg.agg_intrp_order == 2


def test_block3_scripts_turn_the_fused_kernels_off():
    path = os.path.join(REPO, "dev_scripts", "myexp_scannet_colmap",
                        "scene0000_00.sh")
    agg = _port_startup(path)[0][0].agg
    assert agg.shading_feature_mlp_layer3 == 2 and not tagg.use_fused(
        __import__("dataclasses").replace(agg, fused_mlp="cuda"))


@pytest.mark.parametrize("path", DTU_SCRIPTS,
                         ids=[os.path.basename(p) for p in DTU_SCRIPTS])
def test_port_accepts_every_dtu_script(path):
    """The DTU scripts pass the port's startup checks: the dtu_test_inf
    family through train_ft (dtu_ft, the plane background, order 1, the
    MVS bootstrap), the ete family through run/train.py (the feed-forward
    trainer on the dtu dataset)."""
    (cfg, _, grid_kwargs), opt = _port_startup(path)
    if "dtu_test_inf" in path:
        assert opt.dataset_name == "dtu_ft" and opt.bgmodel == "plane"
        assert cfg.agg.agg_intrp_order == 1 and opt.load_points == 0
        assert opt.maximum_step == 0
    else:
        assert opt.dataset_name == "dtu" and opt.feedforward == 1
        assert cfg.agg.agg_intrp_order == 2 and grid_kwargs["ranges"]
    # both shade un-fused (block3) and query with the exact top-k
    assert cfg.agg.shading_feature_mlp_layer3 == 2
    assert cfg.knn_mode == "exact" and cfg.gather_dtype == "float32"
