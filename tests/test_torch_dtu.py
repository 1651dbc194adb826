"""The port's DTU data path and plane background against the JAX package
on the CPU: the DTU loaders (`dtu`, `dtu_ft` with its plane table),
`read_pfm`, the voxel and segment ops, ScanNet's `--load_points 2` cloud,
the plane background (ray/plane cross, the cloud's pixel masks, per-ray
colours, every frame's background), a frame rendered with `bg_image` and
a train step with `bg_ray`, and the train_ft CLI's MVS bootstrap with the
plane background at `--maximum_step 0`.

Tolerances: what the port copies from numpy (loaders, voxel ops, the
unprojected cloud) is bit-equal, ray directions within 1e-6 (the port
computes them in torch, as its ScanNet loader does); the plane colours
within 1e-6; the frame and the train step's losses as
tests/test_torch_render.py (1e-4 a ray) and tests/test_torch_train.py
(rtol 1e-5); the CLI's point count equal and its test frame as the
render's, but for the rays whose plane background the foreground test's
ceil() at exact integer pixels moves (at most 2% of the frame).

The DTU tree is tests/test_dtu_dataset.py's (five views orbiting the
origin, MVSNet layout) with a white band in each image, the colour of
plane 0, so the plane-colour fit keeps samples, and depth maps that vary
around its constant 4.0 (a constant depth on the pixel grid unprojects to
a lattice, whose equidistant neighbours the two packages' top-k order
differently).
"""
import contextlib
import copy
import importlib.util
import io
import os
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from torch_threads import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_pfm(path, img):
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(img).astype("<f").tofile(f)


def write_dtu_tree(root, n=5):
    rng = np.random.default_rng(0)
    camdir = root / "Cameras" / "train"
    rect = root / "Rectified" / "scan1_train"
    depths = root / "Depths" / "scan1_train"
    for d in (camdir, rect, depths):
        d.mkdir(parents=True)
    pair = [str(n)]
    for v in range(n):
        srcs = [s for s in range(n) if s != v][:3]
        pair.append(str(v))
        pair.append(" ".join([str(len(srcs))] +
                             [f"{s} {100 - i}" for i, s in enumerate(srcs)]))
        a = 2 * np.pi * v / n
        pos = np.array([4 * np.sin(a), 0.2, -4 * np.cos(a)])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0, 1.0, 0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
        c2w[:3, 3] = pos
        w2c = np.linalg.inv(c2w)
        intr = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]])
        cam = ("extrinsic\n"
               + "\n".join(" ".join(f"{x:.6f}" for x in row) for row in w2c)
               + "\n\nintrinsic\n"
               + "\n".join(" ".join(f"{x:.6f}" for x in row) for row in intr)
               + "\n\n2.0 0.01\n")
        (camdir / f"{v:08d}_cam.txt").write_text(cam)
        img = (rng.uniform(0, 255, (96, 128, 3))).astype(np.uint8)
        img[60:] = 255                       # plane 0's colour
        Image.fromarray(img).save(rect / f"rect_{v + 1:03d}_3_r5000.png")
        gy, gx = np.mgrid[0:24, 0:32]
        depth = 4.0 + 0.3 * np.sin(gx / 5.0 + v) * np.cos(gy / 4.0) \
            + rng.uniform(-0.02, 0.02, (24, 32))
        _write_pfm(str(depths / f"depth_map_{v:04d}.pfm"),
                   depth.astype(np.float32))
    (root / "Cameras" / "pair.txt").write_text("\n".join(pair) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    return write_dtu_tree(tmp_path_factory.mktemp("dtu"))


def _opt(root, **kw):
    o = types.SimpleNamespace(
        data_root=root, scan="scan1", img_wh=(64, 48), train_step=5,
        split="train", random_sample_size=4, init_view_num=3, dir_norm=1,
        bg_color="black", near_plane=0, far_plane=0,
        dtu_cam_scale=4.0, dtu_light_idx=3, bgmodel="plane")
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def _assert_items_equal(a, b, what):
    """Every key of the JAX item b equal in a (raydir within 1e-6)."""
    for k, v in b.items():
        assert k in a, (what, k)
        if k == "raydir":
            np.testing.assert_allclose(a[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {k}")
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(a[k], v, err_msg=f"{what} {k}")
        else:
            assert a[k] == v, (what, k, a[k], v)


# ------------------------------------------------------------- loaders

def test_read_pfm_matches_jax(dtu_tree):
    from sgnerf_tpu.data.dtu_dataset import read_pfm as jread
    from sgnerf_tpu_torch.data.dtu_dataset import read_pfm
    p = os.path.join(dtu_tree, "Depths", "scan1_train", "depth_map_0002.pfm")
    np.testing.assert_array_equal(read_pfm(p), jread(p))


@pytest.mark.parametrize("name", ["dtu", "dtu_ft"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_dtu_datasets_match_jax(dtu_tree, name, split):
    from sgnerf_tpu.data import find_dataset_class_by_name
    from sgnerf_tpu_torch.data import create_dataset
    o = _opt(dtu_tree, split=split, dataset_name=name)
    jd, td = find_dataset_class_by_name(name)(o), create_dataset(o)
    assert type(td).__name__ == type(jd).__name__ and len(td) == len(jd)
    assert td.near_far == jd.near_far and td.id_list == jd.id_list
    for i in range(len(jd)):
        _assert_items_equal(td.get_item(i, rng=np.random.default_rng(7)),
                            jd.get_item(i, rng=np.random.default_rng(7)),
                            f"item {i}")
        full = td.get_item(i, full_img=True)
        _assert_items_equal(full, jd.get_item(i, full_img=True), f"full {i}")
        assert full["full_image"].shape == (48, 64, 3)
        _assert_items_equal(td.get_init_item(i), jd.get_init_item(i),
                            f"init {i}")
    if name == "dtu_ft":
        assert "plane_pnt" in td.get_item(0)
    for a, b in zip(td.get_campos_ray(), jd.get_campos_ray()):
        np.testing.assert_array_equal(a, b)
    for vr in (0, 50):
        np.testing.assert_array_equal(td.load_init_depth_points(vox_res=vr),
                                      jd.load_init_depth_points(vox_res=vr))


def test_dtu_ft_plane_index_from_ground_list(dtu_tree, tmp_path):
    """dtu_test_ground.txt picks the scan's row of the plane table."""
    import shutil
    from sgnerf_tpu.data.dtu_ft_dataset import DtuFtDataset as JDs
    from sgnerf_tpu_torch.data.dtu_ft_dataset import DtuFtDataset
    root = str(tmp_path / "dtu")
    shutil.copytree(dtu_tree, root)
    with open(os.path.join(root, "dtu_test_ground.txt"), "w") as f:
        f.write("scan7 2\nscan1 1\n")
    o = _opt(root)
    a, b = DtuFtDataset(o).get_item(0), JDs(o).get_item(0)
    for k in ("plane_pnt", "plane_normal", "plane_color"):
        np.testing.assert_array_equal(a[k], b[k])
    o.bgmodel = "no"
    assert "plane_pnt" not in DtuFtDataset(o).get_item(0)


# ---------------------------------------------------------------- scatter

@pytest.mark.parametrize("n,res", [(500, 8), (4000, 30)])
def test_voxel_ops_match_jax(n, res):
    from sgnerf_tpu.ops import scatter as jsc
    from sgnerf_tpu_torch.ops import scatter as tsc
    xyz = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsc.construct_vox_points_xyz(xyz, res),
                                  jsc.construct_vox_points_xyz(xyz, res))
    np.testing.assert_array_equal(tsc.voxel_downsample_xyz(xyz, res),
                                  np.asarray(jsc.voxel_downsample_xyz(
                                      xyz, res)))
    for a, b in zip(tsc.construct_vox_points_closest(xyz, res),
                    jsc.construct_vox_points_closest(xyz, res)):
        np.testing.assert_array_equal(a, b)


def test_segment_reductions_match_jax():
    from sgnerf_tpu.ops import scatter as jsc
    from sgnerf_tpu_torch.ops import scatter as tsc
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 9, 200).astype(np.int32)      # some empty of 10
    for shape in ((200,), (200, 4)):
        v = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_allclose(
            tsc.segment_mean(torch.from_numpy(v), torch.from_numpy(ids),
                             10).numpy(),
            np.asarray(jsc.segment_mean(v, ids, 10)), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            tsc.segment_min(torch.from_numpy(v), torch.from_numpy(ids),
                            10).numpy(),
            np.asarray(jsc.segment_min(v, ids, 10)))


def _write_depth_export(root, W=40, H=30, with_depth_intr=True):
    """A ScanNet export with depth pngs (mm): four views of a sphere."""
    scan = root / "scene_d" / "exported"
    for sub in ("color", "pose", "intrinsic", "depth"):
        (scan / sub).mkdir(parents=True)
    intr = np.eye(4)
    intr[:3, :3] = [[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]
    np.savetxt(scan / "intrinsic/intrinsic_color.txt", intr)
    if with_depth_intr:
        d = intr.copy()
        d[:2] *= 0.5
        np.savetxt(scan / "intrinsic/intrinsic_depth.txt", d)
    rng = np.random.default_rng(1)
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
        Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
            scan / f"color/{i}.jpg")
        dm = rng.uniform(200, 9000, (H // 2, W // 2)).astype(np.uint16)
        Image.fromarray(dm).save(scan / f"depth/{i}.png")
    return str(root) + "/"


@pytest.mark.parametrize("vox_res,depth_intr", [(0, True), (100, True),
                                                (100, False)])
def test_scannet_load_points_2_cloud_matches_jax(tmp_path, vox_res,
                                                 depth_intr):
    """ScanNet --load_points 2: the unprojected depth cloud, bit-equal."""
    from sgnerf_tpu.data.scannet_ft_dataset import ScannetFtDataset as JDs
    from sgnerf_tpu_torch.data.scannet_ft_dataset import ScannetFtDataset
    root = _write_depth_export(tmp_path, with_depth_intr=depth_intr)
    o = types.SimpleNamespace(
        data_root=root, scan="scene_d", split="train", img_wh=(40, 30),
        near_plane=0.5, far_plane=8.0, bg_color="black", train_step=1,
        ranges=(-2.5, -2.5, -2.5, 2.5, 2.5, 2.5))
    a = ScannetFtDataset(o).load_init_depth_points(vox_res=vox_res)
    b = JDs(o).load_init_depth_points(vox_res=vox_res)
    assert len(b) > 100
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- plane background

def test_rayplane_cross_and_fg_mask_match_jax():
    from sgnerf_tpu.models import background as jbg
    from sgnerf_tpu_torch.models import background as tbg
    rng = np.random.default_rng(0)
    campos = np.array([0.0, 0.0, -3.0], np.float32)
    p_co = np.array([0.1, -0.2, 2.0], np.float32)
    p_no = np.array([0.1, 0.2, 0.95], np.float32)
    raydir = rng.normal(size=(256, 3)).astype(np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    a = tbg.rayplane_cross(*(torch.from_numpy(x) for x in
                             (campos, raydir, p_co, p_no))).numpy()
    b = np.asarray(jbg.rayplane_cross(campos, raydir, p_co, p_no))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (a == 0).all(-1).any() and (a != 0).any(-1).any()
    xyz = (rng.uniform(-1, 1, (500, 3)) + [0, 0, 3]).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    intr = np.array([[20.0, 0, 20], [0, 20.0, 15], [0, 0, 1]], np.float32)
    a = tbg.foreground_mask_image(*(torch.from_numpy(x) for x in
                                    (xyz, w2c, intr)), 30, 40).numpy()
    b = np.asarray(jbg.foreground_mask_image(xyz, w2c, intr, 30, 40))
    assert b.any()
    np.testing.assert_array_equal(a, b)


def test_plane_bg_matches_jax(dtu_tree):
    """Per-ray plane colours of full frames (the cloud's pixels suppressed)
    and every train frame's background, within 1e-6."""
    from sgnerf_tpu.data.dtu_ft_dataset import DtuFtDataset as JDs
    from sgnerf_tpu.models import background as jbg
    from sgnerf_tpu_torch.models import background as tbg
    o = _opt(dtu_tree)
    ds = JDs(o)
    init = ds.get_init_item(0)
    cloud = np.random.default_rng(2).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    hits = 0
    for i in range(len(ds)):
        item = ds.get_item(i, full_img=True)
        a = tbg.plane_bg_ray(item, init, cloud)
        b = np.asarray(jbg.plane_bg_ray(item, init, cloud))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        hits += int((b > 0).any(-1).sum())
    assert hits > 100, hits
    a, b = tbg.create_all_bg(ds, cloud), jbg.create_all_bg(ds, cloud)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)


def _dtu_flags(root, ckpt, extra=()):
    return [
        "--name", "p", "--data_root", root, "--checkpoints_dir", ckpt,
        "--scan", "scan1", "--dataset_name", "dtu_ft",
        "--img_wh", "64", "48", "--train_step", "5",
        "--random_sample", "random", "--random_sample_size", "8",
        "--which_ray_generation", "near_far_linear",
        "--which_render_func", "radiance", "--which_blend_func", "alpha",
        "--which_tonemap_func", "off", "--near_plane", "2.0",
        "--far_plane", "4.0", "--z_depth_dim", "32", "--SR", "4", "--K", "2",
        "--P", "8", "--max_o", "40000", "--vsize", "0.1", "0.1", "0.1",
        "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
        "--radius_limit_scale", "4", "--agg_dist_pers", "20",
        "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
        "--point_features_dim", "32", "--num_feat_freqs", "3",
        "--dist_xyz_freq", "5", "--num_viewdir_freqs", "4",
        "--act_type", "LeakyReLU", "--shading_color_mlp_layer", "4",
        "--shading_feature_mlp_layer1", "2", "--act_super", "1",
        "--color_loss_items", "ray_masked_coarse_raycolor", "coarse_raycolor",
        "--color_loss_weights", "1.0", "0.0", "--lr", "0.001",
        "--plr", "0.002", "--raydist_mode_unit", "1", "--bg_color", "black",
        "--vox_res", "0", "--ranges", "-10", "-10", "-10", "10", "10", "10",
        "--wcoord_query", "1", "--bgmodel", "plane", "--dir_norm", "1",
        "--gpu_ids", "-1", "--n_threads", "0", "--test_num", "1",
        "--print_freq", "1"] + list(extra)


def _jax_model(opt, xyz=None):
    """The JAX SceneModel set up from `xyz` (default: the DTU depth cloud,
    --load_points 2) and the dataset."""
    from sgnerf_tpu.data import create_dataset
    from sgnerf_tpu.runtime import SceneModel as JaxSceneModel
    ds = create_dataset(opt)
    jm = JaxSceneModel(opt)
    if xyz is None:
        xyz = ds.load_init_depth_points(vox_res=100)
    with contextlib.redirect_stdout(io.StringIO()):
        jm.setup_from_points(xyz, None, None, dataset=ds)
    return jm, ds


def _ball(n=3000, seed=4):
    """Points in a unit ball at the cameras' focus."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x *= rng.uniform(0, 1, (n, 1)) ** (1 / 3) / np.linalg.norm(
        x, axis=-1, keepdims=True)
    return x.astype(np.float32)


def _port_model(opt, jm):
    """The port's SceneModel on the JAX model's cloud and weights."""
    from sgnerf_tpu_torch.models.point_cloud import NeuralPointCloud
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    tm = SceneModel(opt, device="cpu")
    cloud = NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jm.state.cloud).items()}, "cpu")
    tm._finish_setup(jax.tree.map(np.asarray, jm.state.params), cloud)
    return tm


def test_load_points_2_setup_matches_jax(dtu_tree, tmp_path):
    """The DTU --load_points 2 bootstrap: the same cloud in both models."""
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    flags = _dtu_flags(dtu_tree, str(tmp_path))
    jopt, topt = JOpts().parse(flags), TrainOptions().parse(flags)
    jopt.split = topt.split = "train"
    jm, _ = _jax_model(jopt)
    ds = create_dataset(topt)
    tm = SceneModel(topt)
    with contextlib.redirect_stdout(io.StringIO()):
        tm.setup_from_points(ds.load_init_depth_points(vox_res=100), None,
                             None, dataset=ds)
    jc = jm.state.cloud
    assert int(tm.cloud.n_active) == int(jc.n_active) > 1000
    for f in ("xyz", "dir", "color", "conf", "active"):
        np.testing.assert_array_equal(getattr(tm.cloud, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


def test_render_image_with_plane_bg_matches_jax(dtu_tree, tmp_path):
    """A test frame with its plane background: colour + bgT * (bg -
    bg_color) on every ray, within 1e-4 (tests/test_torch_render.py)."""
    from sgnerf_tpu.models.background import plane_bg_ray
    from sgnerf_tpu.options.options import TestOptions as JOpts
    opt = JOpts().parse(_dtu_flags(dtu_tree, str(tmp_path)))
    opt.split, opt.random_sample = "test", "no_crop"
    jm, ds = _jax_model(opt, _ball())
    tm = _port_model(opt, jm)
    item = ds.get_item(0, full_img=True)
    act = np.asarray(jm.state.cloud.active)
    bg = np.asarray(plane_bg_ray(item, ds.get_init_item(0),
                                 np.asarray(jm.state.cloud.xyz)[act]))
    assert (bg > 0).any(-1).sum() > 50
    a = tm.render_image(item, chunk_rays=512, bg_image=bg)
    b = np.asarray(jm.render_image(item, chunk_rays=512, bg_image=bg))
    plain = tm.render_image(item, chunk_rays=512)
    assert np.abs(a - plain).max() > 1e-2          # the background shows
    bad = ~np.all(np.abs(a - b) <= 1e-4, axis=-1)
    assert bad.mean() <= 0.001, (bad.sum(), np.abs(a - b).max())


def test_train_step_with_bg_ray_matches_jax(dtu_tree, tmp_path):
    """Two train steps whose batches carry bg_ray (fed the noise JAX
    drew): losses within rtol 1e-5, as tests/test_torch_train.py."""
    from sgnerf_tpu.models import renderer as jren
    from sgnerf_tpu.models.background import create_all_bg
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu_torch.models.train import train_step
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    run_ft = _load_jax_script("train_ft")
    opt = JOpts().parse(_dtu_flags(dtu_tree, str(tmp_path)))
    opt.split = "train"
    jm, ds = _jax_model(opt, _ball())
    tm = _port_model(opt, jm)
    act = np.asarray(jm.state.cloud.active)
    bg_all = create_all_bg(ds, np.asarray(jm.state.cloud.xyz)[act])
    rng = np.random.default_rng(5)
    for i in range(2):
        item = ds.get_item(i % len(ds), rng=rng)
        px = item["pixel_idx"].astype(np.int64)
        item["bg_ray"] = np.asarray(bg_all[int(item["id"])])[px[:, 1],
                                                              px[:, 0]]
        key = jax.random.key(9 + i)
        jb = run_ft.make_batch(item)
        noise = jren.draw_render_noise(key, jm.cfg, 1, len(item["raydir"]),
                                       grid=jm.grid, is_train=True)
        jl = jm.optimize(jb, key)
        tb = batch_to_device(item, "cpu")
        assert "bg_ray" in tb
        tm.state, tl = train_step(
            tm.state, tm.grid, tm.cfg, tm.tcfg, tb,
            noise={"raygen_u": torch.from_numpy(np.array(
                noise["raygen_u"]))})
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")


# -------------------------------------------------------------------- CLI

def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_run_{name}", os.path.join(REPO, "run", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_full_image(monkeypatch):
    """The JAX DTU loader gives a full-frame item no `full_image`, which its
    bootstrap's embedding reads (KeyError); the port's loader adds it.
    For the comparison the JAX loader gets the same key."""
    from sgnerf_tpu.data.dtu_dataset import DtuDataset
    get_item = DtuDataset.get_item

    def with_image(self, idx, full_img=False, rng=None):
        item = get_item(self, idx, full_img, rng)
        if full_img:
            item["full_image"] = self._load_img(self.id_list[idx])
        return item
    monkeypatch.setattr(DtuDataset, "get_item", with_image)


def test_train_ft_mvs_bootstrap_plane_matches_jax(dtu_tree, tmp_path,
                                                  monkeypatch):
    """`train_ft --load_points 0 --bgmodel plane --maximum_step 0`: the
    port's CLI bootstraps the cloud (the dataset's depths, the
    consistency filter, the embeddings), builds the plane backgrounds and
    renders the test frame with its plane. The JAX side runs its driver's
    bootstrap branch and run_test on the same weights (JAX's
    `--maximum_step 0` means 100000 steps there). The same point count;
    the test frames equal within 1e-4 on all rays but those whose plane
    background moved (see below) and at most 0.1% more."""
    from sgnerf_tpu.data import create_dataset as jcreate
    from sgnerf_tpu.models.aggregator import init_aggregator_params as jagg
    from sgnerf_tpu.models.mvs import MVSConfig as JCfg
    from sgnerf_tpu.models.mvs import init_mvs_params as jmvs
    from sgnerf_tpu.models.point_cloud import make_point_cloud as jmake
    from sgnerf_tpu.options.options import TrainOptions as JOpts
    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu.runtime import SceneModel as JaxSceneModel
    from sgnerf_tpu.runtime.mvs_bootstrap import gen_points_filter_embeddings
    from sgnerf_tpu.utils.visualizer import Visualizer as JVis
    from sgnerf_tpu_torch.models.params import (mvs_params_from_jax,
                                                params_from_jax)
    from sgnerf_tpu_torch.run import train_ft
    from sgnerf_tpu_torch.runtime import mvs_bootstrap, scene_model
    monkeypatch.setenv("SGNERF_JAX_CACHE", str(tmp_path / "jax_cache"))
    flags = _dtu_flags(dtu_tree, str(tmp_path), [
        "--load_points", "0", "--manual_depth_view", "0",
        "--depth_conf_thresh", "0.5", "--geo_cnsst_num", "0"])
    jopt = JOpts().parse(flags)
    jopt.split = "train"
    jcfg = jconfigs(jopt)[0]

    # the JAX driver's bootstrap branch (run/train_ft.py:147-161), then its
    # run_test on the test split
    _jax_full_image(monkeypatch)
    run_ft = _load_jax_script("train_ft")
    psnrs = {"jax": [], "port": []}
    frames = {"jax": [], "port": []}

    def recorder(key, fn):
        def rec(a, b):
            frames[key].append(np.asarray(a).reshape(-1, 3))
            psnrs[key].append(float(fn(a, b)))
            return psnrs[key][-1]
        return rec
    monkeypatch.setattr(run_ft, "psnr", recorder("jax", run_ft.psnr))
    jds = jcreate(jopt)
    jm = JaxSceneModel(jopt)
    xyz, emb, color, dirs, conf = gen_points_filter_embeddings(
        jds, jopt, key=jax.random.key(11))
    jm._finish_setup(None, jmake(xyz, emb, conf=conf, dir=dirs, color=color,
                                 capacity=jm._capacity_for(len(xyz))))
    topt = copy.copy(jopt)
    topt.split, topt.random_sample = "test", "no_crop"
    with contextlib.redirect_stdout(io.StringIO()):
        run_ft.run_test(jm, jcreate(topt), JVis(jopt), 0,
                        num_images=jopt.test_num)

    # the port's CLI on the same weights
    def mvs_init(seed, cfg, device="cpu"):
        tree = jmvs(jax.random.key(11), JCfg(
            depth_grid=cfg.depth_grid, dprob_thresh=cfg.dprob_thresh,
            point_features_dim=cfg.point_features_dim,
            init_view_num=cfg.init_view_num))
        return mvs_params_from_jax(jax.tree.map(np.asarray, tree), device)

    def agg_init(seed, cfg, device="cpu"):
        return params_from_jax(jax.tree.map(
            np.asarray, jagg(jax.random.key(0), jcfg.agg)), device)
    monkeypatch.setattr(mvs_bootstrap, "init_mvs_params", mvs_init)
    monkeypatch.setattr(scene_model, "init_aggregator_params", agg_init)
    monkeypatch.setattr(train_ft, "psnr", recorder("port", train_ft.psnr))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_ft.main(flags + ["--maximum_step", "0"])
    out = buf.getvalue()
    assert f"MVS bootstrap produced {len(xyz)} points" in out, out[-2000:]
    assert "[bgmodel] plane backgrounds for 4 frames" in out
    assert "training from step 0 to 0" in out
    assert len(psnrs["port"]) == len(psnrs["jax"]) == 1
    # rays whose plane background differs between the packages' own
    # clouds and arithmetic: the foreground test takes ceil() of pixel
    # coordinates, and a cloud point unprojected from a view's pixel grid
    # projects back onto an exact integer there, so an ulp decides its
    # pixel. Every other ray within 1e-4, as tests/test_torch_render.py
    from sgnerf_tpu.models.background import plane_bg_ray as jbg_ray
    from sgnerf_tpu_torch.models.background import plane_bg_ray as tbg_ray
    from sgnerf_tpu_torch.models.checkpoint_io import load_native
    jds_test = jcreate(topt)
    item, init = jds_test.get_item(0, full_img=True), \
        jds_test.get_init_item(0)
    tc = load_native(str(tmp_path / "p" / "0_net_ray_marching.npz"))[0][
        "cloud"]
    jact = np.asarray(jm.state.cloud.active)
    moved = np.abs(
        tbg_ray(item, init, tc["xyz"][tc["active"]])
        - np.asarray(jbg_ray(item, init,
                             np.asarray(jm.state.cloud.xyz)[jact]))
    ).max(-1) > 1e-6
    bad = np.abs(frames["port"][0] - frames["jax"][0]).max(-1) > 1e-4
    print(f"test frame: {bad.sum()} of {bad.size} rays off by > 1e-4, "
          f"{moved.sum()} with a plane background that moved; PSNR "
          f"{psnrs}")
    assert (bad & ~moved).mean() <= 0.001, (bad.sum(), moved.sum())
    assert moved.mean() <= 0.02, moved.sum()
    for f in ("0_net_ray_marching.npz", "0_net_ray_marching.pth"):
        assert (tmp_path / "p" / f).exists(), f


def test_train_ft_load_points_2_and_test_ft_plane_cli(dtu_tree, tmp_path):
    """train_ft trains a few steps on the depth cloud with plane
    backgrounds in its batches; test_ft renders with the plane."""
    from sgnerf_tpu_torch.run import test_ft, train_ft
    flags = _dtu_flags(dtu_tree, str(tmp_path), ["--load_points", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_ft.main(flags + ["--maximum_step", "3", "--save_iter_freq",
                               "3", "--test_freq", "0"])
    out = buf.getvalue()
    assert "[bgmodel] plane backgrounds for 4 frames" in out
    assert "step: 3," in out and "test mean psnr over 1 imgs" in out
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        test_ft.main(flags + ["--resume_iter", "latest"])
    out = buf.getvalue()
    assert "loaded checkpoint" in out and "mean psnr" in out
    assert os.path.exists(tmp_path / "p" / "images" / "test_3"
                          / "scores.txt")
