"""The port's editor and tool modules against the JAX package on the CPU,
on the same seeded numpy inputs: the editor's container (ply, .pth and
.npz round trips, select), crop / add / global and local transforms /
meshlab selection matching, the camera path, blur detection, the scene
resampler, ScanNet preparation (a .sens file the test writes, label
export, the mesh preprocessing, the CLI), the IoU score and the
NeRF-synthetic spin path's pose functions; all bit-equal (its rays and SH
basis within float32 rounding).
LPIPS (alex and vgg, on weight files of random values the test writes)
within 1e-5 of the JAX package's `lpips_distance`; missing weights give
None in both.
"""
import os

import numpy as np
import pytest
import torch

from tests.test_lpips import (_alex_backbone_state, _lin_state,
                              _vgg_backbone_state)
from tests.test_prepare_scannet import _fake_tsv, _make_sens
from torch_threads import one_cpu_thread  # noqa: F401


def _cloud(pkg, n=300, seed=0, F=8):
    mod = __import__(f"{pkg}.editor.pointcloud", fromlist=["x"])
    rng = np.random.default_rng(seed)
    return mod.NeuralPointCloudEdit(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        embedding=rng.normal(size=(n, F)).astype(np.float32),
        conf=rng.uniform(0, 1, n).astype(np.float32),
        dir=rng.normal(size=(n, 3)).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        label=rng.integers(0, 20, n).astype(np.int32),
        params={"block1": [{"w": rng.normal(size=(4, 3)).astype(np.float32),
                            "b": np.zeros(3, np.float32)}]})


FIELDS = ("xyz", "embedding", "conf", "dir", "color", "label")


def _assert_clouds_equal(a, b):
    assert a.n == b.n
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_ply_round_trip_matches_jax(tmp_path):
    """The same bytes written; each package reads the other's file to the
    same arrays."""
    a, b = _cloud("sgnerf_tpu_torch"), _cloud("sgnerf_tpu")
    a.save_as_ply(str(tmp_path / "t.ply"))
    b.save_as_ply(str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    from sgnerf_tpu.editor import NeuralPointCloudEdit as J
    from sgnerf_tpu_torch.editor import NeuralPointCloudEdit as T
    got, want = T.load_from_ply(str(tmp_path / "j.ply")), \
        J.load_from_ply(str(tmp_path / "t.ply"))
    _assert_clouds_equal(got, want)
    np.testing.assert_array_equal(got.xyz, a.xyz)
    np.testing.assert_array_equal(got.label, a.label)


def test_checkpoint_round_trips_match_jax(tmp_path):
    """to_checkpoint writes the same reference .pth; from_checkpoint reads a
    .pth and a native .npz (inactive rows dropped) as the JAX package."""
    from sgnerf_tpu.editor import NeuralPointCloudEdit as J
    from sgnerf_tpu.models.checkpoint_io import save_native
    from sgnerf_tpu.models.point_cloud import make_point_cloud
    from sgnerf_tpu_torch.editor import NeuralPointCloudEdit as T
    from sgnerf_tpu_torch.models.checkpoint_io import load_torch_state_dict
    _cloud("sgnerf_tpu_torch").to_checkpoint(str(tmp_path / "t.pth"))
    _cloud("sgnerf_tpu").to_checkpoint(str(tmp_path / "j.pth"))
    st, sj = (load_torch_state_dict(str(tmp_path / n)) for n in
              ("t.pth", "j.pth"))
    assert sorted(st) == sorted(sj)
    for k in st:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    got, want = T.from_checkpoint(str(tmp_path / "t.pth")), \
        J.from_checkpoint(str(tmp_path / "t.pth"))
    _assert_clouds_equal(got, want)
    np.testing.assert_array_equal(got.params["block1"][0]["w"],
                                  want.params["block1"][0]["w"])
    c = _cloud("sgnerf_tpu", n=200, seed=1)
    cloud = make_point_cloud(c.xyz, c.embedding, conf=c.conf[:, None],
                             dir=c.dir, color=c.color, label=c.label,
                             capacity=260)
    arrays = {k: np.array(v) for k, v in vars(cloud).items()}
    arrays["active"][::7] = False
    save_native(str(tmp_path / "c.npz"), {"params": c.params,
                                          "cloud": arrays})
    got, want = (P.from_checkpoint(str(tmp_path / "c.npz")) for P in (T, J))
    _assert_clouds_equal(got, want)
    assert got.n == int(arrays["active"].sum())


def _transform(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = q, rng.normal(size=3)
    return T


@pytest.mark.parametrize("op", ["crop", "add", "global", "local", "select",
                                "match"])
def test_edit_ops_match_jax(op):
    from sgnerf_tpu.editor import editor as jed
    from sgnerf_tpu_torch.editor import editor as ted
    outs = []
    for pkg, ed in (("sgnerf_tpu_torch", ted), ("sgnerf_tpu", jed)):
        father = _cloud(pkg, n=400, seed=2)
        child = father.select(np.arange(400) % 3 == 0)
        other = _cloud(pkg, n=50, seed=3)
        if op == "crop":
            outs.append(ed.crop_point_cloud(child, father))
        elif op == "add":
            outs.append(ed.add_point_cloud(other, father))
        elif op == "global":
            outs.append(ed.transform_point_cloud_global(father,
                                                        _transform(4)))
        elif op == "local":
            outs.append(ed.transform_point_cloud_local(father,
                                                       _transform(5)))
        elif op == "select":
            outs.append(father.select(np.array([5, 1, 399, 1])))
        else:
            sel = father.xyz[::11] + np.float32(5e-5)
            outs.append(ed.match_selection(father, np.concatenate(
                [sel, np.full((3, 3), 9.0, np.float32)])))
    if op == "match":
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[0], np.arange(0, 400, 11))
        return
    _assert_clouds_equal(*outs)
    assert outs[0].n == {"crop": 266, "add": 450}.get(op, outs[0].n)


def test_camera_path_matches_jax():
    from sgnerf_tpu.utils.camera_path import interpolate_poses as jinterp
    from sgnerf_tpu_torch.utils.camera_path import interpolate_poses
    keys = np.stack([_transform(s) for s in range(5)]).astype(np.float32)
    keys[2, :3, :3] = np.diag([1.0, -1.0, -1.0])   # the trace <= 0 branch
    keys[3, :3, :3] = keys[2, :3, :3]              # the near-equal branch
    for n in (2, 9, 17):
        got = interpolate_poses(keys, n)
        np.testing.assert_array_equal(got, jinterp(keys, n))
        assert got.shape == (n, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got[0], keys[0], atol=1e-6)
    np.testing.assert_allclose(got[-1], keys[-1], atol=1e-6)


def test_blur_matches_jax(tmp_path):
    from PIL import Image
    from sgnerf_tpu.utils import blur as jblur
    from sgnerf_tpu_torch.utils import blur
    rng = np.random.default_rng(6)
    paths = []
    for i in range(6):
        img = rng.uniform(0, 255, (24, 32, 3)).astype(np.uint8)
        im = Image.fromarray(img).resize((32 // (1 + i % 3), 24 // (1 + i % 3)))
        p = str(tmp_path / f"{i}.jpg")
        im.resize((32, 24)).save(p)
        paths.append(p)
    g = rng.normal(size=(20, 30))
    assert blur.variance_of_laplacian(g) == jblur.variance_of_laplacian(g)
    ids = blur.detect_blurry(paths, worst_n=3)
    assert ids == jblur.detect_blurry(paths, worst_n=3)
    a = blur.write_blur_list(str(tmp_path / "t"), ids)
    b = jblur.write_blur_list(str(tmp_path / "j"), ids)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def _scene(root, n=11):
    from PIL import Image
    ex = root / "exported"
    rng = np.random.default_rng(7)
    for sub in ("color", "depth", "pose", "label", "intrinsic"):
        (ex / sub).mkdir(parents=True)
    np.savetxt(ex / "intrinsic" / "intrinsic_color.txt", np.eye(4))
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (6, 8, 3), np.uint8)).save(
            ex / "color" / f"{i}.jpg")
        np.savetxt(ex / "pose" / f"{i}.txt", _transform(i))
        if i % 4:                           # some frames lack depth, label
            Image.fromarray(rng.integers(0, 9000, (6, 8), np.uint16)).save(
                ex / "depth" / f"{i}.png")
            Image.fromarray(rng.integers(0, 40, (6, 8), np.uint8)).save(
                ex / "label" / f"{i}.png")
    (ex / "blur_list.txt").write_text("3\n")


@pytest.mark.parametrize("step,max_frames", [(3, None), (2, 4)])
def test_resample_scene_matches_jax(tmp_path, step, max_frames):
    from sgnerf_tpu.data.resample import resample_scene as jresample
    from sgnerf_tpu_torch.data.resample import main
    _scene(tmp_path / "src")
    args = ["--src", str(tmp_path / "src"), "--dst", str(tmp_path / "t"),
            "--step", str(step)]
    if max_frames:
        args += ["--max_frames", str(max_frames)]
    kept = main(args)
    assert kept == jresample(str(tmp_path / "src"), str(tmp_path / "j"),
                             step, max_frames)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert kept == len(os.listdir(tmp_path / "t" / "exported" / "color"))


def test_prepare_scannet_matches_jax(tmp_path):
    """The .sens reader and export, the label mapping and export, the mesh
    preprocessing and the CLI write the same files as the JAX package."""
    from PIL import Image
    from sgnerf_tpu.data import prepare_scannet as jp
    from sgnerf_tpu.utils.ply import write_ply
    from sgnerf_tpu_torch.data import prepare_scannet as tp
    np.testing.assert_array_equal(tp.label_remapper_150(),
                                  jp.label_remapper_150())
    sens = str(tmp_path / "s.sens")
    _make_sens(sens, n_frames=3)
    a, b = tp.SensorData(sens), jp.SensorData(sens)
    for f in ("sensor_name", "color_width", "color_height", "depth_width",
              "depth_height", "depth_shift", "color_compression"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.intrinsic_color, b.intrinsic_color)
    for i in range(3):
        np.testing.assert_array_equal(a.decode_color(i), b.decode_color(i))
        np.testing.assert_array_equal(a.decode_depth(i), b.decode_depth(i))
    a.export(str(tmp_path / "et"), image_size=(6, 8), frame_skip=2)
    b.export(str(tmp_path / "ej"), image_size=(6, 8), frame_skip=2)
    assert _files(tmp_path / "et") == _files(tmp_path / "ej")

    tsv = str(tmp_path / "labels.tsv")
    _fake_tsv(tsv)
    assert tp.read_label_mapping(tsv) == jp.read_label_mapping(tsv)
    raw = np.random.default_rng(8).choice([0, 1, 3, 7, 50, 1163, 9],
                                          (6, 8)).astype(np.int32)
    mapping = tp.read_label_mapping(tsv)
    np.testing.assert_array_equal(tp.map_label_image(raw, mapping),
                                  jp.map_label_image(raw, mapping))
    (tmp_path / "lf").mkdir()
    for i in range(3):
        Image.fromarray(raw + i).save(tmp_path / "lf" / f"{i}.png")
    for pkg, out in ((tp, "lt"), (jp, "lj")):
        pkg.export_label_images(str(tmp_path / "lf"), str(tmp_path / out),
                                tsv, frame_skip=1, image_size=(3, 4))
    assert _files(tmp_path / "lt") == _files(tmp_path / "lj")

    rng = np.random.default_rng(9)
    n = 40
    mesh = str(tmp_path / "m.ply")
    write_ply(mesh, {k: rng.normal(size=n).astype(np.float32) for k in "xyz"}
              | {c: rng.integers(0, 255, n).astype(np.uint8)
                 for c in ("red", "green", "blue")})
    lab = str(tmp_path / "m.labels.ply")
    write_ply(lab, {k: np.zeros(n, np.float32) for k in "xyz"}
              | {"label": rng.integers(0, 160, n).astype(np.uint8)})
    for pkg, out in ((tp, "pt.pth"), (jp, "pj.pth")):
        for labels in (lab, None):
            pkg.preprocess_3d(mesh, labels, str(tmp_path / f"{labels}{out}"))
    for labels in (lab, None):
        got, want = (torch.load(str(tmp_path / f"{labels}{o}"),
                                weights_only=False) for o in ("pt.pth",
                                                              "pj.pth"))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    scans = tmp_path / "scans"
    (scans / "scene0000_00" / "label-filt").mkdir(parents=True)
    _make_sens(str(scans / "scene0000_00" / "scene0000_00.sens"))
    for i in range(2):
        Image.fromarray(raw).save(
            scans / "scene0000_00" / "label-filt" / f"{i}.png")
    for pkg, out in ((tp, "ct"), (jp, "cj")):
        pkg.main(["--scannet_path", str(scans), "--output_path",
                  str(tmp_path / out), "--export_label_images",
                  "--label_map_file", tsv, "--output_image_width", "8",
                  "--output_image_height", "6"])
    assert _files(tmp_path / "ct") == _files(tmp_path / "cj")
    assert len(_files(tmp_path / "ct")) == 2 * 4 + 2


@pytest.mark.parametrize("K,ignore", [(20, 255), (5, 3)])
def test_miou_matches_jax(K, ignore):
    from sgnerf_tpu.utils.util import intersection_and_union as jiau
    from sgnerf_tpu.utils.util import miou as jmiou
    from sgnerf_tpu_torch.utils.util import intersection_and_union, miou
    rng = np.random.default_rng(K)
    out = rng.integers(0, K, 500)
    tgt = np.where(rng.random(500) < 0.1, ignore, rng.integers(0, K, 500))
    tgt[tgt == 2] = 1                      # a class with no target
    for g, w in zip(intersection_and_union(out, tgt, K, ignore),
                    jiau(out, tgt, K, ignore)):
        np.testing.assert_array_equal(g, w)
    (m, per), (jm, jper) = miou(out, tgt, K, ignore), jmiou(out, tgt, K,
                                                            ignore)
    assert m == jm
    np.testing.assert_array_equal(per, jper)


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    rng = np.random.default_rng(0)
    torch.save(_alex_backbone_state(rng), d / "alexnet-test.pth")
    torch.save(_lin_state([64, 192, 384, 256, 256], rng), d / "alex.pth")
    torch.save(_vgg_backbone_state(rng), d / "vgg16-test.pth")
    torch.save(_lin_state([64, 128, 256, 512, 512], rng), d / "vgg.pth")
    return str(d)


@pytest.mark.parametrize("net,size", [("alex", 64), ("vgg", 32)])
def test_lpips_matches_jax(lpips_weights, net, size):
    from sgnerf_tpu.utils.lpips import lpips_distance as jlpips
    from sgnerf_tpu_torch.utils.lpips import lpips_distance
    from sgnerf_tpu_torch.utils.metrics import lpips
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (size, size + 8, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.2, size=a.shape), 0, 1).astype(
        np.float32)
    got = lpips_distance(a, b, net=net, weights_dir=lpips_weights)
    want = jlpips(a, b, net=net, weights_dir=lpips_weights)
    assert got > 1e-6
    assert abs(got - want) <= 1e-5, (got, want)
    assert lpips(a, b, net=net, weights_path=lpips_weights,
                 device="cpu") == got
    assert lpips_distance(a, a, net=net,
                          weights_dir=lpips_weights) == pytest.approx(
        0.0, abs=1e-9)


def test_lpips_missing_weights_is_none_in_both(tmp_path):
    from sgnerf_tpu.utils.lpips import lpips_distance as jlpips
    from sgnerf_tpu_torch.utils.lpips import lpips_distance
    a = np.zeros((16, 16, 3), np.float32)
    for net in ("alex", "vgg"):
        assert lpips_distance(a, a, net=net,
                              weights_dir=str(tmp_path)) is None
        assert jlpips(a, a, net=net, weights_dir=str(tmp_path)) is None


def test_spin_path_helpers_match_jax():
    """The NeRF-synthetic spin path's pieces: the pose functions and
    render_poses bit-equal, flip_z bit-equal, blender rays and the SH basis
    at flipped directions within float32 rounding."""
    import jax.numpy as jnp
    from sgnerf_tpu.data import data_utils as jdu
    from sgnerf_tpu.data import load_blender as jlb
    from sgnerf_tpu.utils.spherical import SphericalHarm_table as JSH
    from sgnerf_tpu_torch.data import data_utils as tdu
    from sgnerf_tpu_torch.data import load_blender as tlb
    from sgnerf_tpu_torch.utils.spherical import SphericalHarm_table as TSH
    for f in ("trans_t", "rot_phi", "rot_theta"):
        np.testing.assert_array_equal(getattr(tlb, f)(0.7),
                                      getattr(jlb, f)(0.7), err_msg=f)
    np.testing.assert_array_equal(tlb.pose_spherical(40.0, -30.0, 4.0),
                                  jlb.pose_spherical(40.0, -30.0, 4.0))
    want = np.stack([jlb.pose_spherical(a, -30.0, 4.0)
                     for a in np.linspace(-180, 180, 21)[:-1]], 0)
    np.testing.assert_array_equal(tlb.render_poses(), want)
    np.testing.assert_array_equal(tdu.flip_z(want), jdu.flip_z(want))
    rng = np.random.default_rng(12)
    pix = rng.uniform(0, 30, (50, 2)).astype(np.float32)
    for norm in (True, False):
        np.testing.assert_allclose(
            tdu.get_blender_raydir(pix, 24, 32, 30.0, want[3][:3, :3], norm),
            jdu.get_blender_raydir(pix, 24, 32, 30.0, want[3][:3, :3], norm),
            rtol=0, atol=1e-6)
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for flip in (False, True):
        np.testing.assert_allclose(
            TSH(5).sh_all(torch.from_numpy(dirs), filp_dir=flip).numpy(),
            np.asarray(JSH(5).sh_all(jnp.asarray(dirs), filp_dir=flip)),
            rtol=0, atol=1e-6)
