"""The port imports torch and never jax, triton, the JAX package or
bench.py; its flag table is the JAX package's; its device comes from
--gpu_ids and every `auto` resolves from that device; it rejects what the
ported slices do not cover."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import sgnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sgnerf_tpu_torch.__path__,
                                               "sgnerf_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 20, names
for want in ("ops.pallas_gather", "runtime.growing", "dev.probe_gather",
             "ops.sparse", "models.mvs", "models.bpnet.bpnet",
             "models.bpnet.unet2d", "models.bpnet.unet3d",
             "models.bpnet.linking", "runtime.semantic", "ops.query_pers",
             "utils.spherical", "data.load_blender", "data.data_utils",
             "data.nerf_synth_ft_dataset", "data.dtu_dataset",
             "data.dtu_ft_dataset", "ops.scatter", "models.background",
             "models.mvs_filter", "models.feedforward",
             "runtime.mvs_bootstrap", "run.train", "editor.editor",
             "editor.pointcloud", "utils.lpips", "utils.camera_path",
             "utils.blur", "utils.util", "data.prepare_scannet",
             "data.resample", "run.editing", "run.test_edit",
             "run.render_vid", "run.gui", "run.visualize",
             "run.vis_grow_train", "run.evaluate", "run.result",
             "parallel", "parallel.mesh", "parallel.sharded",
             "parallel.spatial"):
    assert "sgnerf_tpu_torch." + want in names, want
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "sgnerf_tpu",
                                    "bench"))
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_without_jax_or_triton():
    """Every port module imported in a fresh interpreter pulls in no jax,
    triton, sgnerf_tpu or bench module."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


FORBIDDEN = ("jax", "jaxlib", "triton", "sgnerf_tpu", "bench")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(REPO, "sgnerf_tpu_torch", "parallel"))
    if f.endswith(".py")))
def test_parallel_package_imports_neither_jax_nor_the_jax_package(name):
    """Each module of sgnerf_tpu_torch/parallel/ (the multi-device paths)
    imports torch and the port, never jax, triton, the JAX package or
    bench.py."""
    roots = _imported_roots(os.path.join(REPO, "sgnerf_tpu_torch",
                                         "parallel", name))
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
    assert name == "__init__.py" or "torch" in roots


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "sgnerf_tpu_torch" in roots
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


def test_chip_smoke_main_runs_after_every_definition():
    """`python3 chip_smoke.py` calls main() from the module's last
    statement, so every phase function main() names is defined by then."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    last = tree.body[-1]
    assert isinstance(last, ast.If) and "__main__" in ast.unparse(last.test)
    guards = [n for n in tree.body if isinstance(n, ast.If)
              and "__main__" in ast.unparse(n.test)]
    assert guards == [last]


def test_flag_table_matches_the_jax_package():
    """dev_scripts parse unchanged: the same names, types, defaults and
    nargs, in the same order."""
    from sgnerf_tpu.options import options as jopts
    from sgnerf_tpu_torch.options import options as topts
    assert topts._F == jopts._F
    a = vars(topts.TrainOptions().parse([]))
    b = vars(jopts.TrainOptions().parse([]))
    assert a == b


def _opt(extra=()):
    from sgnerf_tpu_torch.options import TestOptions
    return TestOptions().parse([
        "--SR", "24", "--K", "8", "--z_depth_dim", "400",
        "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
        "--agg_dist_pers", "20", "--act_type", "LeakyReLU",
        "--which_ray_generation", "near_far_linear",
        "--near_plane", "0.1", "--far_plane", "8.0",
        "--vsize", "0.008", "0.008", "0.008", "--kernel_size", "3", "3", "3",
        "--cache_dtype", "bfloat16", "--gather_dtype", "bfloat16",
        "--num_feat_freqs", "3", "--dist_xyz_freq", "5",
        "--wcoord_query", "1", "--gpu_ids", "-1"] + list(extra))


def test_configs_match_reference_on_cpu():
    import dataclasses

    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu_torch.options import configs_from_opt

    opt = _opt()
    cfg, tcfg, grid_kwargs = configs_from_opt(opt)
    jcfg, jtcfg, jgrid_kwargs = jconfigs(opt)
    assert grid_kwargs == jgrid_kwargs
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)
    assert grid_kwargs["coarse_factor"] == 4          # the auto two-level
    # auto on the CPU (--gpu_ids -1): the plain paths, as the reference's
    # CPU backend
    assert cfg.knn_mode == jcfg.knn_mode == "exact"
    assert cfg.agg.fused_mlp == "none" and cfg.agg.fused_bwd == "plain"
    for f in dataclasses.fields(cfg):
        if f.name != "agg":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(cfg.agg):
        if f.name not in ("fused_mlp", "fused_bwd"):
            assert getattr(cfg.agg, f.name) == getattr(jcfg.agg, f.name)
    assert cfg.radius_limit == jcfg.radius_limit
    forced, _, _ = configs_from_opt(_opt(["--fused_mlp", "pallas",
                                          "--knn_mode", "fused"]))
    assert forced.agg.fused_mlp == "cuda" and forced.knn_mode == "fused"
    assert forced.agg.fused_bwd == "cuda"
    # the card's defaults, resolved from --gpu_ids alone (no probe)
    card, _, _ = configs_from_opt(_opt(["--gpu_ids", "0"]))
    assert card.knn_mode == "fused" and card.agg.fused_mlp == "cuda"
    assert card.agg.fused_bwd == "cuda"
    xla, _, _ = configs_from_opt(_opt(["--gpu_ids", "0",
                                       "--fused_bwd", "xla"]))
    assert xla.agg.fused_mlp == "cuda" and xla.agg.fused_bwd == "plain"


def test_scene_model_device_comes_from_gpu_ids():
    """--gpu_ids -1 (or device="cpu") is the CPU; the default asks for
    cuda:0 and, without a card, fails at the first CUDA allocation instead
    of falling back to the CPU."""
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ck = ["--checkpoints_dir", d]
        assert SceneModel(_opt(ck)).device == torch.device("cpu")
        cuda = SceneModel(_opt(ck + ["--gpu_ids", "0"]))
        assert cuda.device == torch.device("cuda", 0)
        assert cuda.cfg.agg.fused_mlp == "cuda"
        forced = SceneModel(_opt(ck + ["--gpu_ids", "0"]), device="cpu")
        assert forced.device.type == "cpu"
        assert forced.cfg.agg.fused_mlp == "none"
        if not torch.cuda.is_available():
            xyz = np.random.default_rng(0).normal(size=(50, 3))
            with pytest.raises((RuntimeError, AssertionError)):
                cuda.setup_from_points(xyz.astype(np.float32), None, None)


@pytest.mark.parametrize("flags", [
    ["--gather_dtype", "int8"],
    ["--gather_dtype", "int8", "--bgmodel", "plane"],
    ["--scene_shards", "2", "--dataset_name", "dtu_ft"],
    ["--ray_shards", "2", "--dataset_name", "dtu"],
    ["--knn_mode", "approx", "--cache_dtype", "float32"],
    ["--scene_shards", "2"],
    ["--ray_shards", "4"],
    ["--knn_mode", "approx"],
    ["--gather_vjp", "f32"],
    ["--gather_round", "stochastic"],
    ["--gather_vjp", "spread"],
    ["--gather_vjp", "raydedup"],
    ["--gather_vjp", "batchdedup"],
])
def test_flags_outside_the_slice_raise(flags):
    """Every flag among these cases, each refused until the port took it,
    resolves to the RenderConfig fields the JAX package's configs_from_opt
    sets for the same flags. --scene_shards/--ray_shards above 1 take one
    --gpu_ids entry a shard: with one id they raise ValueError (nothing
    runs on fewer shards than asked), with one an id they resolve."""
    from sgnerf_tpu_torch.options import configs_from_opt
    if any(f.endswith("_shards") for f in flags):
        with pytest.raises(ValueError, match="--gpu_ids"):
            configs_from_opt(_opt(flags))
        flags = flags + ["--gpu_ids", "-1,-1,-1,-1"]
    _same_render_config(flags)


_ITEM17_FIELDS = ("gather_dtype", "gather_round", "gather_vjp", "spread_J",
                  "gvjp_rows", "gvjp_U", "gvjp_batch_U", "knn_mode")


def _same_render_config(flags):
    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu_torch.options import configs_from_opt
    opt = _opt(flags)
    cfg, _, _ = configs_from_opt(opt, device="cpu")
    jcfg, _, _ = jconfigs(opt)
    for f in _ITEM17_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), (f, flags)
    return cfg


@pytest.mark.parametrize("flags", [
    ["--gather_dtype", "int8", "--gather_round", "stochastic"],
    ["--gather_dtype", "float32", "--gather_vjp", "spread"],
    ["--gather_vjp", "raydedup", "--gvjp_U", "64"],
    ["--gather_vjp", "batchdedup", "--gvjp_batch_U", "5000"],
    ["--gather_round", "stochastic", "--gather_vjp", "batchdedup",
     "--knn_mode", "approx"],
    ["--gather_vjp", "sorted", "--knn_mode", "exact"],
])
def test_item17_flags_resolve_as_in_the_jax_package(flags):
    from sgnerf_tpu_torch.options import configs_from_opt
    cfg = _same_render_config(flags)
    card, _, _ = configs_from_opt(_opt(flags + ["--gpu_ids", "0"]))
    # on the card the fused kernels run behind the same gathers
    assert card.agg.fused_mlp == "cuda" and card.agg.fused_bwd == "cuda"
    for f in _ITEM17_FIELDS[:-1]:
        assert getattr(card, f) == getattr(cfg, f), f


@pytest.mark.parametrize("flags,match", [
    (["--gather_dtype", "int8", "--gather_vjp", "f32"], "int8"),
    (["--gather_dtype", "int8", "--gather_vjp", "sorted"], "int8"),
    (["--gather_round", "up"], "gather_round"),
    (["--gather_vjp", "dedup"], "gather_vjp"),
    (["--gather_dtype", "float16"], "gather_dtype"),
])
def test_item17_flags_refused_as_in_the_jax_package(flags, match):
    """What the JAX package's configs_from_opt refuses with ValueError the
    port refuses the same way, on its configs and its trainers' startup."""
    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu_torch.options import TrainOptions, configs_from_opt
    from sgnerf_tpu_torch.run import train as ff_train
    from sgnerf_tpu_torch.run.train_ft import check_flags
    opt = _opt(flags)
    for fn in (configs_from_opt, jconfigs):
        with pytest.raises(ValueError, match=match):
            fn(opt)
    topt = TrainOptions().parse(flags + ["--feedforward", "1",
                                         "--ranges", "-1", "-1", "-1",
                                         "1", "1", "1"])
    for fn in (check_flags, ff_train.check_flags):
        with pytest.raises(ValueError, match=match):
            fn(topt)


@pytest.mark.parametrize("flag,value", [("fused_color", "on"),
                                        ("fused_march", "on"),
                                        ("knn_mode", "dedup")])
def test_opt_in_kernel_flags_resolve_as_in_the_jax_package(flag, value):
    """--fused_color on / --fused_march on (kernels K4, K5) set the same
    AggregatorConfig fields as the JAX package's configs_from_opt, on the
    CPU and the card; --knn_mode dedup is no CLI mode in either package
    (K6 is reached through RenderConfig)."""
    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu_torch.options import configs_from_opt

    opt = _opt([f"--{flag}", value])
    if flag == "knn_mode":
        for fn in (configs_from_opt, jconfigs):
            with pytest.raises(ValueError, match="auto/exact/approx/fused"):
                fn(opt)
        return
    cfg, _, _ = configs_from_opt(opt)
    jcfg, _, _ = jconfigs(opt)
    assert getattr(cfg.agg, flag) is getattr(jcfg.agg, flag) is True
    assert (cfg.agg.fused_color, cfg.agg.fused_march) == (
        jcfg.agg.fused_color, jcfg.agg.fused_march)
    card, _, _ = configs_from_opt(_opt([f"--{flag}", value, "--gpu_ids",
                                        "0"]))
    assert getattr(card.agg, flag) is True and card.agg.fused_mlp == "cuda"


def test_semantic_flags_resolve_as_in_the_jax_package():
    """The scene0241_02_semanticGuidance.sh flags: the guided query, the
    96-d embedding into block2_bpnet, and block2_bpnet's un-fused path on
    the card too (the JAX package's use_fused gate)."""
    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu_torch.options import configs_from_opt
    flags = ["--semantic_guidance", "1", "--predict_semantic", "1",
             "--shading_feature_mlp_layer2_bpnet", "1",
             "--bpnet_dtype", "bfloat16"]
    cfg, _, _ = configs_from_opt(_opt(flags))
    jcfg, _, _ = jconfigs(_opt(flags))
    assert cfg.semantic_guidance == jcfg.semantic_guidance == 1
    for f in ("shading_feature_mlp_layer2_bpnet", "predict_semantic",
              "semantic_dim"):
        assert getattr(cfg.agg, f) == getattr(jcfg.agg, f), f
    from sgnerf_tpu_torch.models.aggregator import use_fused
    card, _, _ = configs_from_opt(_opt(flags + ["--gpu_ids", "0"]))
    assert card.agg.fused_mlp == "cuda" and not use_fused(card.agg)
