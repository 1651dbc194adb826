"""One small scene in both packages for the multi-device parity tests
(tests/test_torch_parallel.py, tests/test_torch_spatial.py): a shell of
points around the origin with seeded attributes, its grid, seeded
aggregator weights, rays from a camera looking at it, and the JAX package's
render noise as the port's noise dict. The JAX side runs on the virtual
CPU devices of tests/conftest.py, in a mesh as large as the port's shard
count; the port's shards are CPU devices. Then the SceneModel flags of a
2000-point shell, and the wiring check: a sharded model and an unsharded
one trained, saved, pruned, grown and rendered alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.ops import query_pers as jqp
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models import point_cloud as tpc
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models.params import params_from_jax
from sgnerf_tpu_torch.ops import query_pers as tqp

RENDER = dict(z_depth_dim=48, SR=6, K=4, vsize=(0.08,) * 3)
W, H = 64, 48
INTR = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])


@dataclasses.dataclass
class Pair:
    jcloud: object
    jgrid: object
    jparams: dict
    tcloud: object
    tgrid: object
    tparams: dict
    spec_kw: dict


def make_pair(n=12000, seed=3, semantic=False, **grid_kw) -> Pair:
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz *= rng.uniform(0.8, 1.2, size=(n, 1)).astype(np.float32)
    kw = {}
    if semantic:
        kw = dict(label=rng.integers(0, 5, n).astype(np.int32),
                  label_prob=rng.dirichlet(np.ones(20), n).astype(np.float32),
                  sem_embedding=(rng.normal(size=(n, 96)) * 0.05).astype(
                      np.float32))
    jcloud = jpc.make_point_cloud(
        xyz, (rng.normal(size=(n, 32)) * 0.1).astype(np.float32),
        conf=rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32),
        color=(xyz * 0.4 + 0.5), dir=xyz, capacity=n + 512, **kw)
    spec_kw = dict(vsize=[0.04] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
                   max_o=65536, P=16)
    spec_kw.update(grid_kw)
    jgrid = jpc.build_grid(jcloud, jpc.grid_spec_for_cloud(jcloud, **spec_kw))
    tcloud = tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")
    tgrid = tpc.build_grid(tcloud, tpc.grid_spec_for_cloud(tcloud, **spec_kw))
    jparams = jagg.init_aggregator_params(
        jax.random.key(0), jagg.AggregatorConfig(fused_mlp="none"))
    return Pair(jcloud, jgrid, jparams, tcloud, tgrid,
                params_from_jax(jax.tree.map(np.asarray, jparams)), spec_kw)


def configs(**cfg_kw):
    """The JAX RenderConfig (its plain XLA paths) and the port's."""
    jcfg = jren.RenderConfig(
        agg=jagg.AggregatorConfig(fused_mlp="none", fused_bwd="xla"),
        **RENDER, **cfg_kw)
    return jcfg, tren.RenderConfig(agg=tagg.AggregatorConfig(), **RENDER,
                                   **cfg_kw)


def rays(R=128, seed=11):
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(1, R, 3)) * 0.3).astype(np.float32)
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"campos": np.asarray([[0.0, 0.0, -3.0]], np.float32),
            "raydir": d, "camrotc2w": np.eye(3, dtype=np.float32)[None],
            "near": np.float32(1.0), "far": np.float32(5.0),
            "bg_color": np.ones(3, np.float32),
            "gt_image": rng.uniform(0.2, 0.8, (1, R, 3)).astype(np.float32),
            "pixel_label": rng.integers(0, 5, (1, R)).astype(np.int32)}


def jax_batch(batch, keys=None):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if keys is None or k in keys}


def torch_batch(batch, keys=None):
    return {k: (float(v) if np.ndim(v) == 0 else torch.from_numpy(
        np.asarray(v))) for k, v in batch.items()
        if keys is None or k in keys}


def pspecs():
    """The frustum spec of INTR in both packages."""
    kw = dict(near=1.0, far=5.0, vsize=[0.06] * 3, vscale=[1, 1, 1],
              kernel_size=[3, 3, 3], max_o=65536, P=16)
    return (jqp.perspective_spec_from_camera(INTR, W, H, **kw),
            tqp.perspective_spec_from_camera(INTR, W, H, **kw))


def port_noise(jnoise):
    """A JAX noise dict (draw_render_noise) as the port's (without kg)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in jnoise.items()
            if k != "kg"}


def cpu_group(n):
    from sgnerf_tpu_torch.parallel import ShardGroup
    return ShardGroup(["cpu"] * n)


def close(a, b, what, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=what)


# ------------------------------------------------------------- SceneModel

FLAGS = [
    "--name", "rd", "--z_depth_dim", "32", "--SR", "4", "--K", "4",
    "--P", "8", "--max_o", "8192", "--vsize", "0.08", "0.08", "0.08",
    "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
    "--radius_limit_scale", "4", "--agg_dist_pers", "20",
    "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
    "--point_features_dim", "32", "--num_feat_freqs", "3",
    "--dist_xyz_freq", "5", "--num_viewdir_freqs", "4",
    "--act_type", "LeakyReLU", "--shading_color_mlp_layer", "4",
    "--which_ray_generation", "near_far_linear",
    "--which_render_func", "radiance", "--which_blend_func", "alpha",
    "--which_tonemap_func", "off", "--raydist_mode_unit", "1",
    "--color_loss_items", "ray_masked_coarse_raycolor",
    "--color_loss_weights", "1.0", "--ranges", "-3", "-3", "-3", "3", "3",
    "3", "--lr", "0.002", "--plr", "0.01", "--wcoord_query", "1",
    "--gpu_ids", "-1"]
FW, FH = 16, 12


SHARD_FLAGS = ("--ray_shards", "--scene_shards", "--gpu_ids")


def scene_models(tmp_path, extra):
    """A SceneModel with `extra` flags and one with the same flags but the
    shard flags, both on the same 2000-point shell."""
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(2000, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    plain = [a for i, a in enumerate(extra)
             if a not in SHARD_FLAGS and (i == 0
                                          or extra[i - 1] not in SHARD_FLAGS)]
    out = []
    for i, e in enumerate((extra, plain)):
        opt = TrainOptions().parse(FLAGS + ["--checkpoints_dir",
                                            str(tmp_path / str(i))] + e)
        m = SceneModel(opt, device="cpu")
        m.setup_from_points(xyz, None, None)
        out.append(m)
    return out


def frame(seed=0):
    """A FW x FH frame of the shell from z = -3 (the growing probes'
    item: pixel_idx, h, w), with seeded target colours."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(FH), np.arange(FW), indexing="ij")
    d = np.stack([(xs.ravel() - FW / 2) / 12.0, (ys.ravel() - FH / 2) / 12.0,
                  np.ones(FW * FH)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"raydir": d, "campos": np.array([0, 0, -3.0], np.float32),
            "camrotc2w": np.eye(3, dtype=np.float32), "near": 1.0,
            "far": 5.0, "bg_color": np.ones(3, np.float32),
            "gt_image": rng.uniform(0, 1, (FW * FH, 3)).astype(np.float32),
            "pixel_idx": np.stack([xs.ravel(), ys.ravel()], -1),
            "h": FH, "w": FW, "intrinsic": np.array(
                [[12.0, 0, FW / 2], [0, 12.0, FH / 2], [0, 0, 1]])}


def wiring(models, steps=3):
    """Train, save, prune, grow and render both models alike; the losses
    and the final frames of the sharded one against the unsharded one."""
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    item = frame()
    cols = []
    for m in models:
        m.ensure_pspec(item)
        losses = [float(m.optimize(batch_to_device(frame(s), "cpu"))["total"])
                  for s in range(steps)]
        m.save_checkpoint(steps)
        m.prune_points(0.3)
        rng = np.random.default_rng(4)
        g = rng.normal(size=(64, 3)).astype(np.float32) * 0.9
        m.grow_points(g, rng.normal(size=(64, 32)).astype(np.float32) * 0.1,
                      np.ones((64, 1), np.float32), np.full((64, 3), 0.5),
                      np.zeros((64, 3), np.float32))
        losses.append(float(m.optimize(batch_to_device(frame(9), "cpu"))
                            ["total"]))
        cols.append((losses, m.render_image(item, chunk_rays=64)))
    (ls, cs), (lu, cu) = cols
    np.testing.assert_allclose(ls, lu, rtol=1e-4)
    assert ls[-2] < ls[0]
    close(cs, cu, "frame after growing")
    return models
