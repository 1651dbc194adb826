"""The port's tool command lines on the CPU (--gpu_ids -1) on a tiny scene
(a 4-view ScanNet export of a unit sphere and its native checkpoint):
editing (identity and a rotated second part), test_edit with the label
cloud, result (IoU), render_vid (the ScanNet SLERP path and the blender
spin path), visualize, vis_grow_train, evaluate (with LPIPS weights) and
the viewer (boot, one /render GET).

Against the JAX command lines on the same checkpoint where cheap: the
two-part edit's frame 0 within 1/255 (its PNGs), visualize's cloud.txt equal, result's
mIoU equal, evaluate's PSNR/SSIM/RMSE equal and LPIPS within 1e-5, the
spin path's items (rays within 1e-6). The JAX command lines run in this
process (their main(), argv set).
"""
import importlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_lpips import _alex_backbone_state, _lin_state
from torch_threads import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 48, 36, 4000


def _c2w(campos):
    fwd = -campos / np.linalg.norm(campos)
    right = np.cross([0, 1, 0], fwd)
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
    c2w[:3, 3] = campos
    return c2w


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(data_root, checkpoints_dir): the export and, under <ckpt>/t, the
    native checkpoint 10_net_ray_marching.npz, its reference .pth p.pth and
    the edit files (an index file and two transforms)."""
    from sgnerf_tpu.models.aggregator import init_aggregator_params
    from sgnerf_tpu.models.checkpoint_io import (export_reference_checkpoint,
                                                 save_native)
    from sgnerf_tpu.models.point_cloud import make_point_cloud
    from sgnerf_tpu.options.options import TestOptions, configs_from_opt
    root = tmp_path_factory.mktemp("scans")
    ex = root / "scene_test" / "exported"
    for sub in ("color", "pose", "intrinsic"):
        (ex / sub).mkdir(parents=True)
    intr = np.eye(4)
    intr[:3, :3] = [[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]
    np.savetxt(ex / "intrinsic/intrinsic_color.txt", intr)
    rng = np.random.default_rng(0)
    for i in range(4):
        ang = 2 * np.pi * i / 4 + 0.3
        np.savetxt(ex / f"pose/{i}.txt", _c2w(np.array(
            [3 * np.sin(ang), 0.3, -3 * np.cos(ang)], np.float32)))
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(
            ex / f"color/{i}.jpg")
    xyz = rng.normal(size=(N, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    pts = dict(embedding=(rng.normal(size=(N, 32)) * 0.3).astype(np.float32),
               conf=rng.uniform(0.2, 1.0, (N, 1)).astype(np.float32),
               color=np.clip(xyz * 0.5 + 0.5, 0, 1).astype(np.float32),
               dir=xyz.copy())
    label = rng.integers(0, 20, N).astype(np.int32)
    cloud = make_point_cloud(xyz, label=label, capacity=N + 512, **pts)
    ckpt = tmp_path_factory.mktemp("ckpt")
    cfg = configs_from_opt(TestOptions().parse(flags((str(root), str(ckpt)))))[0]
    params = jax.tree.map(np.array, init_aggregator_params(
        jax.random.key(1), cfg.agg))
    # an opaque sphere: seeded weights alone shade it nearly transparent
    params["alpha_branch"][-1]["b"] += 4.0
    base = ckpt / "t"
    save_native(str(base / "10_net_ray_marching.npz"),
                {"params": params,
                 "cloud": {k: np.asarray(v) for k, v in vars(cloud).items()}},
                {"iter": 10, "best_psnr": 0.0, "best_iter": 0})
    export_reference_checkpoint(params, dict(
        pts, xyz=xyz, Rw2c=np.eye(3, dtype=np.float32)), str(base / "p.pth"))
    np.savetxt(base / "idx.txt", np.nonzero(xyz[:, 1] > 0.4)[0])
    a = np.deg2rad(30)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = [0.3, 0.1, -0.2]
    np.savetxt(base / "T.txt", T)
    np.savetxt(base / "I.txt", np.eye(4))
    return str(root) + "/", str(ckpt)


def flags(scene, name="t", extra=()):
    data_root, ckpt = scene
    return [
        "--name", name, "--data_root", data_root, "--scan", "scene_test",
        "--dataset_name", "scannet_ft", "--checkpoints_dir", ckpt,
        "--resume_iter", "latest", "--test_num_step", "2",
        "--train_step", "2", "--img_wh", str(W), str(H), "--edge_filter", "2",
        "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
        "--query_size", "3", "3", "3", "--vsize", "0.03", "0.03", "0.03",
        "--wcoord_query", "1", "--z_depth_dim", "64",
        "--ranges", "-10", "-10", "-10", "10", "10", "10",
        "--SR", "4", "--K", "2", "--P", "16",
        "--act_type", "LeakyReLU", "--agg_intrp_order", "2",
        "--agg_distance_kernel", "linear", "--agg_dist_pers", "20",
        "--radius_limit_scale", "4", "--point_features_dim", "32",
        "--shading_feature_mlp_layer1", "2", "--shading_alpha_mlp_layer", "1",
        "--shading_color_mlp_layer", "4", "--shading_feature_num", "64",
        "--dist_xyz_freq", "5", "--num_feat_freqs", "3",
        "--num_viewdir_freqs", "4", "--raydist_mode_unit", "1",
        "--near_plane", "1.0", "--far_plane", "5.0",
        "--which_ray_generation", "near_far_linear",
        "--which_tonemap_func", "off", "--which_render_func", "radiance",
        "--which_blend_func", "alpha", "--bg_color", "white",
        "--gather_dtype", "bfloat16", "--cache_dtype", "bfloat16",
        "--gpu_ids", "-1",
    ] + list(extra)


def run_jax_cli(module, args, monkeypatch):
    """The JAX package's run/<module>.py main() with argv = args."""
    mod = importlib.import_module(f"run.{module}")
    monkeypatch.setattr(sys, "argv", [f"{module}.py"] + list(args))
    return mod.main()


def png(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int32)


EDITS = {
    "identity": ["--neural_points_names", "p.pth"],
    # the scene, plus its y > 0.4 cap rotated 30 deg about y and moved
    "rotated": ["--neural_points_names", "p.pth", "p.pth",
                "--parts_index_names", "all", "idx.txt",
                "--Transformation_names", "I.txt", "T.txt"],
}


def _edit(scene, edit):
    """The port's editing CLI -> (model, frame 0 as uint8)."""
    from sgnerf_tpu_torch.run import editing
    base = os.path.join(scene[1], "t")
    model = editing.main(flags(scene, "t", ["--resume_dir", base,
                                            "--render_name", edit]
                               + EDITS[edit]))
    out = os.path.join(base, "images", edit)
    assert any(f.startswith("video") for f in os.listdir(out))
    return model, png(os.path.join(out, "step-0000-coarse_raycolor.png"))


def test_rotated_editing_frame_matches_the_jax_cli(scene, monkeypatch):
    """The two-part edit: a (2,3,3) table; frame 0 within 1/255 of the JAX
    command line's."""
    model, got = _edit(scene, "rotated")
    assert tuple(model.cloud.Rw2c.shape) == (2, 3, 3)
    run_jax_cli("editing", flags(scene, "j", [
        "--resume_dir", os.path.join(scene[1], "t"),
        "--render_name", "rotated"] + EDITS["rotated"]), monkeypatch)
    want = png(os.path.join(scene[1], "j", "images", "rotated",
                            "step-0000-coarse_raycolor.png"))
    assert np.abs(got - want).max() <= 1
    assert (got < 250).any(axis=-1).mean() > 0.2    # the sphere is in view


def test_rotated_edit_differs_from_identity(scene):
    model, identity = _edit(scene, "identity")
    assert model.cloud.Rw2c.dim() == 2
    frames = {"identity": identity, "rotated": png(os.path.join(
        scene[1], "t", "images", "rotated", "step-0000-coarse_raycolor.png"))
        if os.path.exists(os.path.join(scene[1], "t", "images", "rotated"))
        else _edit(scene, "rotated")[1]}
    diff = np.abs(frames["rotated"] - frames["identity"]).max(-1)
    # the moved cap covers more of the frame and changes its pixels
    assert diff.max() > 5 and (diff > 2).mean() > 0.05
    cover = {e: (f < 250).any(axis=-1).mean() for e, f in frames.items()}
    assert cover["rotated"] > cover["identity"] + 0.02, cover


def test_test_edit_label_cloud_and_result_match_jax(scene, tmp_path):
    from sgnerf_tpu.utils.ply import write_ply
    from sgnerf_tpu_torch.run import result, test_edit
    psnrs = test_edit.main(flags(scene, "t", ["--save_predict_label", "1"]))
    assert len(psnrs) >= 1 and np.isfinite(psnrs).all()
    base = os.path.join(scene[1], "t")
    assert os.path.exists(os.path.join(base, "images", "test_edit",
                                       "step-0000-coarse_raycolor.png"))
    pred = os.path.join(base, "images", "pred_label_cloud.txt")
    data = np.loadtxt(pred, delimiter=";")
    from sgnerf_tpu_torch.models.checkpoint_io import load_native
    c = load_native(os.path.join(base, "10_net_ray_marching.npz"))[0]["cloud"]
    act = c["active"].astype(bool)
    np.testing.assert_allclose(data[:, :3], c["xyz"][act], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(data[:, 3], c["label"][act])
    # a labelled mesh: the points moved a little, ScanNet ids of the 150
    rng = np.random.default_rng(11)
    ids = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                    33, 34, 36, 39, 0, 40])
    mesh = str(tmp_path / "gt.labels.ply")
    write_ply(mesh, {"x": data[:, 0] + 1e-3, "y": data[:, 1],
                     "z": data[:, 2],
                     "label": np.where(rng.random(len(data)) < 0.6,
                                       ids[data[:, 3].astype(int)],
                                       rng.choice(ids, len(data))).astype(
                         np.uint8)})
    m = result.main(["--pred", pred, "--gt_labels_ply", mesh])
    jresult = importlib.import_module("result")
    assert m == jresult.score(pred, mesh)
    assert 0.3 < m < 1.0


def test_render_vid_scannet_path(scene):
    from sgnerf_tpu_torch.run import render_vid
    n = render_vid.main(flags(scene, "t", ["--render_stride", "3"]))
    out = os.path.join(scene[1], "t", "images", "vid")
    frames = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert n == len(frames) == 4             # 2 x the 2 test views
    imgs = [png(os.path.join(out, f)) for f in frames]
    assert imgs[0].shape == (H - 4, W - 4, 3)         # --edge_filter 2
    assert np.abs(imgs[0] - imgs[1]).max() > 0          # the camera moves


def _write_blender(root, size=24):
    from PIL import Image as I
    root.mkdir()
    rng = np.random.default_rng(3)
    for split, n in (("train", 2), ("test", 2)):
        (root / split).mkdir()
        frames = []
        for i in range(n):
            pose = np.eye(4)
            pose[:3, 3] = [0.1 * i, 0.0, 4.0]
            I.fromarray(rng.integers(0, 255, (size, size, 4), np.uint8),
                        "RGBA").save(root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


def test_render_vid_blender_spin_path(scene, tmp_path):
    """The spin path's items equal the JAX dataset's (rays within 1e-6),
    and render_vid renders render_stride frames of it."""
    from sgnerf_tpu.data import create_dataset as jcreate
    from sgnerf_tpu.options.options import TestOptions as JOpts
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TestOptions
    from sgnerf_tpu_torch.run import render_vid
    _write_blender(tmp_path / "lego")
    args = flags(scene, "spin", ["--render_stride", "3", "--resume_dir",
                                 os.path.join(scene[1], "t")])
    args[args.index("--data_root") + 1] = str(tmp_path)
    args[args.index("--scan") + 1] = "lego"
    args[args.index("--dataset_name") + 1] = "nerf_synth_ft"
    args[args.index("--img_wh") + 1:args.index("--img_wh") + 3] = ["24", "24"]
    args[args.index("--far_plane") + 1] = "6.0"
    opt, jopt = TestOptions().parse(args), JOpts().parse(args)
    for o in (opt, jopt):
        o.split, o.random_sample = "test", "no_crop"
    td, jd = create_dataset(opt), jcreate(jopt)
    np.testing.assert_array_equal(td.render_poses, jd.render_poses)
    for i in (0, 7, 23):
        a, b = td.get_dummyrot_item(i), jd.get_dummyrot_item(i)
        for k in ("campos", "camrotc2w", "c2w", "pixel_idx"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["raydir"], b["raydir"], rtol=0,
                                   atol=1e-6)
    n = render_vid.main(args)
    out = os.path.join(scene[1], "spin", "images", "vid")
    spin = [png(os.path.join(out, f"step-{i:04d}-coarse_raycolor.png"))
            for i in range(n)]
    assert n == 3 and spin[0].shape == (24, 24, 3)
    assert (spin[0] < 250).any(axis=-1).mean() > 0.05   # the sphere shows


def test_visualize_cloud_txt_equals_the_jax_cli(scene, monkeypatch):
    from sgnerf_tpu_torch.run import visualize
    out = visualize.main(flags(scene, "t"))
    with open(os.path.join(out, "cloud.txt"), "rb") as f:
        got = f.read()
    got_ply = os.path.getsize(os.path.join(out, "cloud_neuralpcd.ply"))
    run_jax_cli("visualize", flags(scene, "t"), monkeypatch)
    with open(os.path.join(out, "cloud.txt"), "rb") as f:
        assert f.read() == got
    assert os.path.getsize(os.path.join(out, "cloud_neuralpcd.ply")) \
        == got_ply
    assert got.count(b"\n") == N


def test_vis_grow_train_dumps_probe_points(scene):
    from sgnerf_tpu_torch.run import vis_grow_train
    counts = vis_grow_train.main(flags(scene, "t", [
        "--test_num", "1", "--prob_thresh", "0.0"]))
    path = os.path.join(scene[1], "t", "grow_vis", "probe_0.txt")
    pts = np.loadtxt(path, delimiter=";").reshape(-1, 3)
    assert len(counts) == 1 and len(pts) == counts[0] > 0
    # the harvested samples lie near the unit sphere
    r = np.linalg.norm(pts, axis=-1)
    assert np.all(np.abs(r - 1) < 0.2), r.min()


def test_evaluate_cli_with_lpips_matches_jax(tmp_path):
    from sgnerf_tpu.utils.lpips import lpips_distance
    from sgnerf_tpu.utils.metrics import psnr, rmse, ssim
    w = tmp_path / "w"
    w.mkdir()
    rng = np.random.default_rng(0)
    torch.save(_alex_backbone_state(rng), w / "alexnet-test.pth")
    torch.save(_lin_state([64, 192, 384, 256, 256], rng), w / "alex.pth")
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        gt = rng.integers(0, 255, (40, 56, 3), np.uint8)
        im = np.clip(gt + rng.normal(0, 20, gt.shape), 0, 255).astype(
            np.uint8)
        Image.fromarray(gt).save(imgs / f"step-{i:04d}-gt_image.png")
        Image.fromarray(im).save(imgs / f"step-{i:04d}-coarse_raycolor.png")
    env = dict(os.environ, PYTHONPATH=REPO, SGNERF_LPIPS=str(w))
    proc = subprocess.run(
        [sys.executable, "-m", "sgnerf_tpu_torch.run.evaluate",
         "--gt_dir", str(imgs), "--img_dir", str(imgs), "--metrics", "psnr",
         "ssim", "lpips", "vgglpips", "rmse", "--gpu_ids", "-1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = dict(line.split(": ") for line in
               (imgs / "scores.txt").read_text().splitlines())
    from sgnerf_tpu_torch.run.evaluate import load_image
    want = {m: [] for m in ("psnr", "ssim", "rmse", "lpips")}
    for i in range(2):
        a = load_image(imgs / f"step-{i:04d}-coarse_raycolor.png")
        b = load_image(imgs / f"step-{i:04d}-gt_image.png")
        for m, fn in (("psnr", psnr), ("ssim", ssim), ("rmse", rmse)):
            want[m].append(fn(a, b))
        want["lpips"].append(lpips_distance(a, b, "alex", str(w)))
    for m in ("psnr", "ssim", "rmse"):
        assert got[m] == f"{np.mean(want[m]):.6f}", m
    assert abs(float(got["lpips"]) - np.mean(want["lpips"])) <= 1e-5
    assert got["vgglpips"] == "nan"          # no vgg weights given


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_viewer_boots_and_renders(scene):
    """The orbit camera about the first test view, turned to the sphere."""
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TestOptions
    opt = TestOptions().parse(flags(scene))
    opt.split, opt.random_sample = "test", "no_crop"
    c = create_dataset(opt).get_item(0)["campos"]
    fwd = -c / np.linalg.norm(c)
    az, el = np.arctan2(fwd[0], fwd[2]), np.arcsin(fwd[1])
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, GUI_PORT=str(port))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sgnerf_tpu_torch.run.gui"] + flags(scene),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        html = None
        deadline = time.time() + 120
        while time.time() < deadline and html is None:
            if proc.poll() is not None:
                raise AssertionError("viewer exited early:\n" + proc.stdout
                                     .read().decode(errors="replace")[-2000:])
            try:
                html = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/", timeout=5).read()
            except OSError:
                time.sleep(0.5)
        assert html and b"sgnerf_tpu viewer" in html
        jpeg = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/render?az={az}&el={el}&r=0.5",
            timeout=120).read()
        assert jpeg[:2] == b"\xff\xd8"
        with Image.open(__import__("io").BytesIO(jpeg)) as im:
            rgb = np.asarray(im)
        assert rgb.shape == (120, 160, 3)
        assert (rgb < 240).any(axis=-1).mean() > 0.05   # the sphere shows
    finally:
        proc.kill()
        proc.wait()


def test_gen_video_without_imageio(tmp_path, monkeypatch):
    """The card's machine has no imageio: the frames become a GIF by PIL."""
    import types
    from sgnerf_tpu_torch.utils.visualizer import Visualizer
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    vis = Visualizer(types.SimpleNamespace(checkpoints_dir=str(tmp_path),
                                           name="v"))
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 255, (12, 16, 3), np.uint8) for _ in range(3)]
    for i, f in enumerate(frames):
        vis.display_current_results({"coarse_raycolor": f}, i, subdir="vid")
    out = os.path.join(vis.image_dir, "vid")
    vis.gen_video(out, r"step-\d+-coarse_raycolor\.png",
                  os.path.join(out, "video.mp4"))
    with Image.open(os.path.join(out, "video.gif")) as im:
        assert im.n_frames == 3 and im.size == (16, 12)
