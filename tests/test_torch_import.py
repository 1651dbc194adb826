"""The port imports torch and never jax or triton, and its flag handling
resolves `auto` from torch.cuda.is_available() and rejects what the slice
does not cover."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import sgnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sgnerf_tpu_torch.__path__,
                                               "sgnerf_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 20, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_without_jax_or_triton():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def _opt(extra=()):
    from sgnerf_tpu.options.options import TestOptions
    return TestOptions().parse([
        "--SR", "24", "--K", "8", "--z_depth_dim", "400",
        "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
        "--agg_dist_pers", "20", "--act_type", "LeakyReLU",
        "--which_ray_generation", "near_far_linear",
        "--near_plane", "0.1", "--far_plane", "8.0",
        "--vsize", "0.008", "0.008", "0.008", "--kernel_size", "3", "3", "3",
        "--cache_dtype", "bfloat16", "--gather_dtype", "bfloat16",
        "--num_feat_freqs", "3", "--dist_xyz_freq", "5",
        "--wcoord_query", "1"] + list(extra))


def test_configs_match_reference_on_cpu():
    import dataclasses

    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu_torch.options import configs_from_opt

    opt = _opt()
    cfg, grid_kwargs = configs_from_opt(opt)
    jcfg, _, jgrid_kwargs = jconfigs(opt)
    assert grid_kwargs == jgrid_kwargs
    assert grid_kwargs["coarse_factor"] == 4          # the auto two-level
    # auto on the CPU: the plain paths, as the reference's CPU backend
    assert cfg.knn_mode == jcfg.knn_mode == "exact"
    assert cfg.agg.fused_mlp == "none"
    for f in dataclasses.fields(cfg):
        if f.name != "agg":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(cfg.agg):
        if f.name != "fused_mlp":
            assert getattr(cfg.agg, f.name) == getattr(jcfg.agg, f.name)
    assert cfg.radius_limit == jcfg.radius_limit
    forced, _ = configs_from_opt(_opt(["--fused_mlp", "pallas",
                                       "--knn_mode", "fused"]))
    assert forced.agg.fused_mlp == "cuda" and forced.knn_mode == "fused"


@pytest.mark.parametrize("flags", [
    ["--semantic_guidance", "1"],
    ["--shading_feature_mlp_layer3", "1"],
    ["--shading_feature_mlp_layer2_bpnet", "1"],
    ["--which_agg_model", "viewmlp_yuze"],
    ["--wcoord_query", "0"],
    ["--scene_shards", "2"],
    ["--ray_shards", "4"],
    ["--fused_color", "on"],
    ["--fused_march", "on"],
    ["--knn_mode", "dedup"],
    ["--knn_mode", "approx"],
])
def test_flags_outside_the_slice_raise(flags):
    from sgnerf_tpu_torch.options import configs_from_opt
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        configs_from_opt(_opt(flags))
