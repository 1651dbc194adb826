"""The port's semantic branch against the JAX package on the CPU: the
guided query, block2_bpnet, one semantic train step, the dataset's pixel
labels, the companion _semanticEmbedding.pth, SemanticDriver and the
train_ft / test_ft CLIs with the semantic flags.

Tolerances: neighbour ids bit-equal (the same guide_u on both sides);
aggregate() rtol 1e-5, atol 1e-6 (f32, the same products, block2_bpnet's
input concatenated in the same order); the train step's losses rtol 1e-5
and parameters rtol 2e-3, atol 2e-6, tests/test_torch_train.py's limits;
BPNet's refresh through SemanticDriver against the JAX BPNet's train_bpnet:
labels equal, probabilities and embeddings within 1e-4 (absolute; the
forward's limits of tests/test_torch_bpnet.py at this scene's scale).
"""
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.models import train as jtrain
from sgnerf_tpu.ops.query import query_neighbors as jquery
from sgnerf_tpu.ops.raygen import near_far_linear_ray_generation as jraygen
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models import point_cloud as tpc
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models import train as ttrain
from sgnerf_tpu_torch.models.params import params_from_jax
from sgnerf_tpu_torch.ops.query import query_neighbors as tquery
from torch_threads import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES = 20


def _semantics(n, seed):
    """Labels 0..5 (0 void), probabilities whose int(10 p) spreads over
    0..9 at each point's own label, 96-d embeddings."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 6, n).astype(np.int32)
    prob = rng.uniform(0, 1, (n, N_CLASSES)).astype(np.float32)
    emb = (rng.normal(size=(n, 96)) * 0.5).astype(np.float32)
    return label, prob, emb


# ------------------------------------------------------------ guided query

def _query_scene(nbr_cache):
    rng = np.random.default_rng(3)
    n = 5000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz *= rng.uniform(0.9, 1.1, size=(n, 1)).astype(np.float32)
    emb = np.zeros((n, 4), np.float32)
    kw = dict(vsize=[0.04] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
              max_o=None, P=None, cache_dtype="bfloat16", coarse_factor=4,
              seg_len=4, seg_cap=24, nbr_cache=nbr_cache)
    jc = jpc.make_point_cloud(xyz, emb)
    tc = tpc.make_point_cloud(xyz, emb)
    jg = jpc.build_grid(jc, jpc.grid_spec_for_cloud(jc, **kw))
    tg = tpc.build_grid(tc, tpc.grid_spec_for_cloud(tc, **kw))
    return jc, jg, tg


@pytest.mark.parametrize("nbr_cache", [64, 0])     # cache path, bucket path
def test_guided_query_matches_jax(nbr_cache):
    """The same guide_u on both sides: ids bit-equal. knn_mode "fused"
    asks for K1, which guidance turns off in both packages."""
    jc, jg, tg = _query_scene(nbr_cache)
    R, D, SR, K = 96, 64, 8, 4
    rng = np.random.default_rng(11)
    d = (rng.normal(size=(1, R, 3)) * 0.3).astype(np.float32)
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    campos = np.asarray([[0.0, 0.0, -3.0]], np.float32)
    raypos, _, _, ts = jraygen(jnp.asarray(campos), jnp.asarray(d), D,
                               near=1.0, far=5.0)
    raypos, ts = np.array(raypos), np.array(ts)
    cap = jc.xyz.shape[0]
    label, prob, _ = _semantics(cap, 4)
    ray_label = rng.integers(0, 6, (1, R)).astype(np.int32)
    cfg = jren.RenderConfig(SR=SR, K=K, z_depth_dim=D, semantic_guidance=1)
    noise = jren.draw_render_noise(jax.random.key(2), cfg, 1, R, grid=jg,
                                   guidance=True, is_train=True)
    guide_u = np.array(noise["guide_u"])
    assert guide_u.shape == ((1, R, SR, 64) if nbr_cache
                             else (1, R, SR, 27, tg.spec.P))
    q0 = jquery(jg, jc.xyz, jnp.asarray(raypos), K=K, SR=SR,
                radius_limit=0.16, ray_label=jnp.asarray(ray_label),
                points_label=jnp.asarray(label),
                points_label_prob=jnp.asarray(prob), semantic_guidance=True,
                knn_mode="fused", campos=jnp.asarray(campos),
                raydir=jnp.asarray(d), tvals=jnp.asarray(ts),
                guide_u=jnp.asarray(guide_u))
    args = dict(K=K, SR=SR, radius_limit=0.16, knn_mode="fused",
                campos=torch.from_numpy(campos), raydir=torch.from_numpy(d),
                tvals=torch.from_numpy(ts))
    q1 = tquery(tg, torch.from_numpy(raypos),
                ray_label=torch.from_numpy(ray_label),
                points_label=torch.from_numpy(label),
                points_label_prob=torch.from_numpy(prob),
                guide_u=torch.from_numpy(guide_u), **args)
    np.testing.assert_array_equal(q1.sample_pidx.numpy(),
                                  np.asarray(q0.sample_pidx))
    np.testing.assert_array_equal(q1.sample_label.numpy(),
                                  np.asarray(q0.sample_label))
    np.testing.assert_array_equal(q1.ray_mask.numpy(),
                                  np.asarray(q0.ray_mask))
    assert int((q1.sample_pidx >= 0).sum()) > 200
    # the guidance rejects neighbours the unguided query keeps
    free = tquery(tg, torch.from_numpy(raypos), **args)
    assert not torch.equal(free.sample_pidx, q1.sample_pidx)
    # the port's draw has JAX's shape
    tnoise = tren.draw_render_noise(
        torch.Generator().manual_seed(0),
        tren.RenderConfig(SR=SR, K=K, z_depth_dim=D, semantic_guidance=1),
        1, R, grid=tg, guidance=True)
    assert tuple(tnoise["guide_u"].shape) == guide_u.shape


# ------------------------------------------------------- block2_bpnet

def _agg_inputs(seed, B=1, R=6, SR=5, K=4, F=32):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, R, SR, K, 3)).astype(np.float32)
    loc = rng.normal(size=(B, R, SR, 3)).astype(np.float32)
    return {
        "sampled_embedding": rng.normal(size=(B, R, SR, K, F)).astype(
            np.float32),
        "sampled_conf": rng.uniform(0.1, 1, (B, R, SR, K, 1)).astype(
            np.float32),
        "sampled_label_embedding": rng.normal(size=(B, R, SR, K, 96)).astype(
            np.float32),
        "sampled_xyz": xyz, "sampled_xyz_pers": xyz + 0.1,
        "sample_pnt_mask": rng.uniform(size=(B, R, SR, K)) > 0.3,
        "sample_loc": loc + 0.1, "sample_loc_w": loc,
        "sample_ray_dirs": rng.normal(size=(B, R, SR, 3)).astype(np.float32),
    }


def test_aggregate_block2_bpnet_matches_jax():
    kw = dict(shading_feature_mlp_layer2_bpnet=1, predict_semantic=1)
    jcfg = jagg.AggregatorConfig(**kw)
    tcfg = tagg.AggregatorConfig(**kw)
    jparams = jagg.init_aggregator_params(jax.random.key(1), jcfg)
    assert np.asarray(jparams["block2_bpnet"][0]["w"]).shape == (256 + 96,
                                                                 256)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    x = _agg_inputs(2)
    jout = jagg.aggregate(jparams, jcfg, sampled_color=None, sampled_dir=None,
                          **{k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        tout = tagg.aggregate(tparams, tcfg,
                              **{k: torch.from_numpy(v) for k, v in x.items()})
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # the port's own init has the same shapes
    own = tagg.init_aggregator_params(0, tcfg)
    assert sorted(own) == sorted(tparams)
    for blk in own:
        assert [tuple(layer["w"].shape) for layer in own[blk]] == [
            tuple(layer["w"].shape) for layer in tparams[blk]]


def test_block2_bpnet_turns_the_fused_kernels_off():
    cfg = tagg.AggregatorConfig(fused_mlp="cuda",
                                shading_feature_mlp_layer2_bpnet=1)
    params = tagg.init_aggregator_params(0, cfg)
    assert not tagg.use_fused(cfg)
    assert tagg.fused_paths(cfg, K=8, F=32, Dd=6,
                            color_branch=params["color_branch"],
                            training=True, device=torch.device("cpu")) \
        == "none"


# ------------------------------------------------------ semantic train step

def test_semantic_train_step_matches_jax():
    """One step of the canonical semantic config (guided query,
    block2_bpnet on the embedding) from the same params, cloud semantics,
    pixel labels and noise."""
    n, cap = 600, 640
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    label, prob, sem = _semantics(n, 5)
    jcloud = jpc.make_point_cloud(
        xyz, rng.normal(size=(n, 32)).astype(np.float32) * 0.1,
        conf=rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32),
        color=xyz * .5 + .5, dir=xyz, capacity=cap)
    jcloud = jpc.set_bpnet_feats(jcloud, jnp.asarray(prob),
                                 jnp.asarray(label), jnp.asarray(sem))
    akw = dict(shading_feature_mlp_layer2_bpnet=1, predict_semantic=1)
    rkw = dict(z_depth_dim=48, SR=6, K=4, vsize=(0.08,) * 3,
               semantic_guidance=1)
    jcfg = jren.RenderConfig(agg=jagg.AggregatorConfig(
        fused_mlp="none", fused_bwd="xla", **akw), **rkw)
    tcfg = tren.RenderConfig(agg=tagg.AggregatorConfig(**akw), **rkw)
    jtc, ttc = jtrain.TrainConfig(), ttrain.TrainConfig()
    gkw = dict(vsize=[0.08] * 3, vscale=[1, 1, 1], kernel_size=[3, 3, 3],
               max_o=8192, P=16)
    jgrid = jpc.build_grid(jcloud, jpc.grid_spec_for_cloud(jcloud, **gkw))
    jparams = jagg.init_aggregator_params(jax.random.key(0), jcfg.agg)
    tcloud = tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")
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
         "gt_image": rng.uniform(0.2, 0.8, (1, R, 3)).astype(np.float32),
         "pixel_label": rng.integers(0, 6, (1, R)).astype(np.int32)}
    key = jax.random.key(5)
    noise = jren.draw_render_noise(key, jcfg, 1, R, grid=jgrid,
                                   guidance=True, is_train=True)
    jstate, jl = jtrain.train_step(jstate, jgrid, jcfg, jtc,
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   key)
    tstate, tl = ttrain.train_step(
        tstate, tgrid, tcfg, ttc,
        {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
        noise={k: torch.from_numpy(np.array(noise[k]))
               for k in ("raygen_u", "guide_u")})
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, err_msg=k)
    jp = jax.tree.map(np.asarray, jstate.params)
    assert "block2_bpnet" in tstate.params
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
    # BPNet's outputs carry no gradient and stay as they were
    for f, want in (("label", label), ("label_prob", prob),
                    ("sem_embedding", sem)):
        np.testing.assert_array_equal(getattr(tstate.cloud, f).numpy()[:n],
                                      want)


# ------------------------------------------------- the export, the dataset

W, H = 48, 36
SCENE_IDS = [1, 2, 3, 4, 5, 6, 7, 8]          # ScanNet ids of the octants


def write_semantic_export(root, n_views=4, n_pts=3000, seed=0):
    """A ScanNet export of a unit sphere seen from n_views cameras on a
    ring: colour jpgs, poses, intrinsics, depth pngs (mm, uint16) and
    label pngs (ScanNet ids) from a z-buffer of the points, pcd.ply with
    seeded colours."""
    from PIL import Image
    from sgnerf_tpu_torch.utils.ply import write_ply
    scan = root / "scene_s" / "exported"
    for sub in ("color", "pose", "intrinsic", "depth", "label"):
        (scan / sub).mkdir(parents=True)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    intr = np.eye(4)
    intr[:3, :3] = K
    np.savetxt(scan / "intrinsic/intrinsic_color.txt", intr)
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n_pts, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    octant = ((xyz[:, 0] > 0) * 4 + (xyz[:, 1] > 0) * 2 + (xyz[:, 2] > 0))
    ids = np.asarray(SCENE_IDS)[octant]
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        campos = np.array([3 * np.sin(ang), 0.3, -3 * np.cos(ang)])
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross([0, 1, 0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = campos
        np.savetxt(scan / f"pose/{i}.txt", c2w)
        cam = (xyz - campos) @ c2w[:3, :3]
        px = np.round(cam[:, 0] * K[0, 0] / cam[:, 2] + K[0, 2]).astype(int)
        py = np.round(cam[:, 1] * K[1, 1] / cam[:, 2] + K[1, 2]).astype(int)
        ok = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (cam[:, 2] > 0)
        depth = np.full((H, W), np.inf)
        label = np.zeros((H, W), np.uint8)
        for j in np.argsort(-cam[:, 2]):          # far to near: near wins
            if ok[j]:
                depth[py[j], px[j]] = cam[j, 2]
                label[py[j], px[j]] = ids[j]
        dmm = np.where(np.isfinite(depth), depth * 1000, 0).astype(np.uint16)
        Image.fromarray(dmm).save(scan / f"depth/{i}.png")
        Image.fromarray(label).save(scan / f"label/{i}.png")
        Image.fromarray((rng.uniform(0, 1, (H, W, 3)) * 255).astype(
            np.uint8)).save(scan / f"color/{i}.jpg")
    rgb = rng.uniform(0, 255, (n_pts, 3)).astype(np.uint8)
    write_ply(str(scan / "pcd.ply"), {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2], "red": rgb[:, 0],
        "green": rgb[:, 1], "blue": rgb[:, 2]})
    return str(root) + "/"


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    return write_semantic_export(tmp_path_factory.mktemp("scans"))


GEOMETRY = [
    "--dataset_name", "scannet_ft", "--scan", "scene_s",
    "--img_wh", str(W), str(H), "--train_step", "2",
    "--random_sample", "random", "--random_sample_size", "6",
    "--z_depth_dim", "40", "--SR", "6", "--K", "4", "--P", "8",
    "--max_o", "40000", "--vsize", ".06", ".06", ".06",
    "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
    "--near_plane", "1", "--far_plane", "5", "--agg_dist_pers", "20",
    "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
    "--act_type", "LeakyReLU", "--which_ray_generation", "near_far_linear",
    "--which_render_func", "radiance", "--which_blend_func", "alpha",
    "--which_tonemap_func", "off", "--vox_res", "40",
    "--ranges", "-10", "-10", "-10", "10", "10", "10", "--bg_color", "white",
    "--edge_filter", "2", "--gpu_ids", "-1", "--wcoord_query", "1",
    "--shading_feature_mlp_layer2_bpnet", "1"]
# the scene0241_02_semanticGuidance.sh semantics, pruning and growing off
SEMANTIC = ["--semantic_guidance", "1", "--predict_semantic", "1",
            "--bpnet_dtype", "bfloat16", "--prune_thresh", "-1",
            "--prune_iter", "-1", "--prob_freq", "0",
            "--color_loss_items", "ray_masked_coarse_raycolor",
            "ray_miss_coarse_raycolor", "coarse_raycolor",
            "--color_loss_weights", "1.0", "0.0", "0.0"]


def test_dataset_pixel_labels_match_jax(scans, tmp_path):
    from sgnerf_tpu.data.scannet_ft_dataset import ScannetFtDataset as JDs
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu_torch.data.scannet_ft_dataset import (ScannetFtDataset,
                                                          label_remapper)
    from sgnerf_tpu.data.scannet_ft_dataset import label_remapper as jremap
    np.testing.assert_array_equal(label_remapper(), jremap())
    flags = GEOMETRY + ["--data_root", scans, "--checkpoints_dir",
                        str(tmp_path)]
    topt, jopt = _train_opt(flags), JOpts().parse(flags)
    topt.split = jopt.split = "train"
    td, jd = ScannetFtDataset(topt), JDs(jopt)
    for idx in range(2):
        a = td.get_item(idx, rng=np.random.default_rng(3))
        b = jd.get_item(idx, rng=np.random.default_rng(3))
        for k in ("pixel_label", "gt_semantic_img", "pixel_idx"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["image_path"] == b["image_path"]
        assert a["train_id_paths"] == b["train_id_paths"]
        assert set(np.unique(a["gt_semantic_img"])) <= set(range(8)) | {255}
    for a, b in zip(td.load_init_points(), jd.load_init_points()):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def _train_opt(flags):
    from sgnerf_tpu_torch.options import TrainOptions
    return TrainOptions().parse(flags)


def test_semantic_embedding_round_trip(scans, tmp_path):
    """export_reference writes {it}_semanticEmbedding.pth; the port and the
    JAX package load it back with the .pth checkpoint."""
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu.runtime import SceneModel as JaxSceneModel
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    flags = GEOMETRY + ["--data_root", scans, "--name", "r"]
    src = SceneModel(_train_opt(flags + ["--checkpoints_dir",
                                                 str(tmp_path / "a")]))
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    src.setup_from_points(xyz, rng.uniform(0, 255, (500, 3)), None)
    n = int(src.cloud.n_active)
    sem = torch.from_numpy(rng.normal(size=(n, 96)).astype(np.float32))
    src.set_semantics(torch.zeros(n, N_CLASSES), torch.zeros(n), sem)
    src.export_reference(7)
    path = str(tmp_path / "a" / "r" / "7_semanticEmbedding.pth")
    assert tuple(torch.load(path).shape) == (1, n, 96)
    pth = str(tmp_path / "a" / "r" / "7_net_ray_marching.pth")
    dst = SceneModel(_train_opt(flags + ["--checkpoints_dir",
                                                 str(tmp_path / "b")]))
    dst.load_checkpoint(pth)
    np.testing.assert_array_equal(dst.cloud.sem_embedding[:n].numpy(),
                                  sem.numpy())
    jdst = JaxSceneModel(JOpts().parse(flags + ["--checkpoints_dir",
                                                str(tmp_path / "c")]))
    jdst.load_checkpoint(pth)
    np.testing.assert_array_equal(
        np.asarray(jdst.state.cloud.sem_embedding)[:n], sem.numpy())
    # nothing is written while no refresh ran
    fresh = SceneModel(_train_opt(flags + ["--checkpoints_dir",
                                                   str(tmp_path / "d")]))
    fresh.setup_from_points(xyz, None, None)
    fresh.export_reference(1)
    assert not os.path.exists(tmp_path / "d" / "r" /
                              "1_semanticEmbedding.pth")


# ---------------------------------------------------------- SemanticDriver

def _semantic_setup(scans, tmp_path, extra=()):
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    from sgnerf_tpu_torch.runtime.semantic import SemanticDriver
    opt = _train_opt(GEOMETRY + SEMANTIC + [
        "--data_root", scans, "--checkpoints_dir", str(tmp_path),
        "--name", "d", "--bpnet_dtype", "float32"] + list(extra))
    opt.split = "train"
    ds = create_dataset(opt)
    model = SceneModel(opt)
    model.setup_from_points(*ds.load_init_points(), dataset=ds)
    drv = SemanticDriver(opt, model.device)
    return ds, model, drv


def test_refresh_matches_jax_train_bpnet(scans, tmp_path):
    """The first (synchronous) refresh on the port equals the JAX
    BPNet's train_bpnet on the same cloud, views and weights: views,
    links, voxelization, forward and devoxelize."""
    from sgnerf_tpu.models.bpnet.bpnet import BPNet as JBPNet
    from sgnerf_tpu.models.bpnet.bpnet import BPNetConfig as JCfg
    from sgnerf_tpu_torch.models.params import bpnet_params_to_jax
    ds, model, drv = _semantic_setup(scans, tmp_path)
    item = ds.get_item(0, rng=np.random.default_rng(0))
    drv.maybe_refresh(model, item)
    assert drv.n_applied == 1 and drv.n_background == 0
    n = int(model.cloud.n_active)
    jnet = JBPNet(JCfg(view_num=3, img_wh=(W, H)),
                  params=jax.tree.map(jnp.asarray,
                                      bpnet_params_to_jax(drv.bpnet.params)))
    locs, feats, paths, image_path, intr4 = drv._snapshot(model, item)
    labels, probs, labels2d, feat, _ = jnet.train_bpnet(
        locs, feats, paths, image_path, intr4)
    np.testing.assert_array_equal(model.cloud.label[:n].numpy(), labels)
    np.testing.assert_allclose(model.cloud.label_prob[:n].numpy(), probs,
                               atol=1e-4)
    np.testing.assert_allclose(model.cloud.sem_embedding[:n].numpy(), feat,
                               atol=1e-4 * max(1.0, np.abs(feat).max()))
    np.testing.assert_array_equal(drv._pixel_label_maps, labels2d)
    pl = drv.pixel_labels_for(item)
    assert pl.shape == (36,) and pl.dtype == np.int32


def test_background_refresh_every_and_flush(scans, tmp_path):
    ds, model, drv = _semantic_setup(scans, tmp_path,
                                   ["--bpnet_refresh_every", "2"])
    item = ds.get_item(0, rng=np.random.default_rng(0))
    gate = threading.Event()
    run = drv.bpnet.train_bpnet
    calls = []

    def gated(*a, **kw):
        calls.append(threading.current_thread().name)
        if len(calls) > 1:
            assert gate.wait(60)
        return run(*a, **kw)
    drv.bpnet.train_bpnet = gated
    drv.maybe_refresh(model, item)                  # step 0: synchronous
    assert drv.n_applied == 1 and calls == [threading.current_thread().name]
    model.cloud.label.zero_()
    drv.maybe_refresh(model, item)                  # step 1: not due
    assert drv.n_background == 0
    drv.maybe_refresh(model, item)                  # step 2: launched
    assert drv.n_background == 1 and drv.in_flight
    assert calls[-1] == "bpnet-refresh"
    drv.maybe_refresh(model, item)                  # step 3: still running
    assert drv.n_applied == 1 and int(model.cloud.label.abs().sum()) == 0
    gate.set()
    drv.flush(model)
    assert drv.n_applied == 2 and not drv.in_flight
    assert int(model.cloud.label.abs().sum()) > 0   # applied
    drv.maybe_refresh(model, item)                  # step 4: due, launched
    assert drv.n_background == 2
    drv._worker.join(60)
    drv.maybe_refresh(model, item)                  # step 5: harvested
    assert drv.n_applied == 3 and drv.n_background == 2


def test_refresh_worker_exception_reaches_the_caller(scans, tmp_path):
    ds, model, drv = _semantic_setup(scans, tmp_path)
    item = ds.get_item(0, rng=np.random.default_rng(0))
    drv.maybe_refresh(model, item)

    def broken(*a, **kw):
        raise ValueError("boom")
    drv.bpnet.train_bpnet = broken
    drv.maybe_refresh(model, item)                  # launched, fails
    drv._worker.join(60)
    with pytest.raises(RuntimeError, match="refresh failed") as e:
        drv.maybe_refresh(model, item)
    assert isinstance(e.value.__cause__, ValueError)
    assert drv.n_applied == 1


# ----------------------------------------------------------------- CLIs

def test_semantic_train_ft_then_test_ft_cli(scans, tmp_path):
    """train_ft with the canonical semantic flags on the CPU (4 steps, a
    save at 2 and 4), then test_ft on its checkpoint with the eval
    script's flags plus the two semantic flags (without them the JAX
    package cannot render it either: block2_bpnet's input needs the
    embedding)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    ckpt = str(tmp_path)
    base = GEOMETRY + ["--data_root", scans, "--checkpoints_dir", ckpt,
                       "--name", "sem"]
    proc = subprocess.run(
        [sys.executable, "-m", "sgnerf_tpu_torch.run.train_ft"] + base
        + SEMANTIC + ["--maximum_step", "4", "--save_iter_freq", "2",
                      "--print_freq", "2", "--test_freq", "0",
                      "--test_num", "1", "--n_threads", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "training from step 0 to 4" in out and "psnr" in out
    exp = os.path.join(ckpt, "sem")
    for f in ("2_net_ray_marching.npz", "4_net_ray_marching.npz",
              "4_net_ray_marching.pth", "4_semanticEmbedding.pth"):
        assert os.path.exists(os.path.join(exp, f)), f
    z = np.load(os.path.join(exp, "4_net_ray_marching.npz"))
    assert any("block2_bpnet" in k for k in z.files)
    sem = [k for k in z.files if k.endswith("sem_embedding")]
    assert sem and np.abs(z[sem[0]]).max() > 0
    eval_flags = base + ["--resume_iter", "latest", "--split", "test",
                         "--test_num_step", "2", "--gather_dtype", "bfloat16",
                         "--cache_dtype", "bfloat16", "--compute_dtype",
                         "bfloat16"]
    proc = subprocess.run(
        [sys.executable, "-m", "sgnerf_tpu_torch.run.test_ft"] + eval_flags
        + ["--semantic_guidance", "1", "--predict_semantic", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mean psnr" in proc.stdout
    assert "loaded checkpoint" in proc.stdout
    # the eval script's flags alone: block2_bpnet's 352-wide input meets
    # 256 features, as in the JAX package
    proc = subprocess.run(
        [sys.executable, "-m", "sgnerf_tpu_torch.run.test_ft"] + eval_flags,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "cannot be multiplied" in proc.stderr, proc.stderr[-2000:]
