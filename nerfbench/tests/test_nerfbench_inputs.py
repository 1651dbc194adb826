"""The benchmark's inputs repeat for a seed and change with it."""
import numpy as np
import torch

from nerfbench import program, scene


def test_room_scan_is_the_configurations():
    a = scene.room_scan(0, 5000, "cpu")
    b = scene.room_scan(0, 5000, "cpu")
    c = scene.room_scan(1, 5000, "cpu")
    assert torch.equal(a.xyz, b.xyz) and torch.equal(a.surface, b.surface)
    assert not torch.equal(a.xyz, c.xyz)
    assert a.xyz.shape == (5000, 3) and len(a.boxes) == scene.N_BOXES
    # half the points on the shell's six faces, the rest on the boxes
    assert int((a.surface < 6).sum()) == 2500


def test_poses_repeat_for_a_seed_and_avoid_boxes():
    boxes = scene.room_scan(0, 100, "cpu").boxes
    p1 = scene.draw_poses(123456789012345, 10, 20, boxes, 0.5, 0.3)
    p2 = scene.draw_poses(123456789012345, 10, 20, boxes, 0.5, 0.3)
    p3 = scene.draw_poses(123456789012346, 10, 20, boxes, 0.5, 0.3)
    for (a, r), (b, s) in zip(p1, p2):
        assert np.array_equal(a, b) and np.array_equal(r, s)
    assert not np.array_equal(p1[0][0], p3[0][0])
    for pos, rot in p1:
        assert np.all(np.abs(pos[:2]) <= 2.0) and np.all(np.abs(pos[2]) <= 1.0)
        assert not any(scene.inside_box(pos, b, 0.1) for b in boxes)
        assert np.allclose(rot.T @ rot, np.eye(3), atol=1e-6)
        # the viewing direction's pitch within +-0.3 rad
        assert abs(np.arcsin(rot[2, 2])) <= 0.3 + 1e-6


def test_weights_attributes_semantics_repeat_for_a_seed():
    mlps = {"block1": {"per": "neighbour", "layers": [[8, 4], [4, 4]]}}
    w1 = program.mlp_weights(7, mlps, "cpu")
    w2 = program.mlp_weights(7, mlps, "cpu")
    w3 = program.mlp_weights(8, mlps, "cpu")
    assert torch.equal(w1["block1"][1]["w"], w2["block1"][1]["w"])
    assert not torch.equal(w1["block1"][0]["w"], w3["block1"][0]["w"])
    sc = scene.room_scan(0, 3000, "cpu")
    a1 = scene.point_attributes(sc, 7, 32)
    a2 = scene.point_attributes(sc, 7, 32)
    assert torch.equal(a1["embedding"], a2["embedding"])
    p, lab, emb = scene.semantics(sc, 7, 20, 96)
    p2, lab2, emb2 = scene.semantics(sc, 7, 20, 96)
    assert torch.equal(emb, emb2) and torch.equal(lab, lab2)
    # one class a surface, and it is the most probable
    for s in range(6 + scene.N_BOXES):
        assert lab[sc.surface == s].unique().numel() <= 1
    assert float((p.argmax(-1) == lab).float().mean()) > 0.9


def test_train_feed_repeats_for_a_seed(bench):
    from types import SimpleNamespace
    from nerfbench.drivers.train_steps import Driver
    cfg = bench.config("scannet0113-viewmlp")
    tr = dict(bench.traffic("train-steps-1024"), width=32, height=24,
              focal=30.0, rays=64)

    def feed(seed):
        d = Driver(SimpleNamespace(cfg=cfg, traffic=tr, seed=seed,
                                   device="cpu", workdir="", fault=None))
        d.dirs = scene.pixel_dirs(32, 24, 30.0)
        d.views = scene.draw_poses(seed, 20, 5, scene.room_scan(0, 100,
                                   "cpu").boxes, 0.5, 0.3)
        f = d.batches()
        return [next(f) for _ in range(4)]

    a, b, c = feed(99), feed(99), feed(100)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["gt"], c[0]["gt"])
    for x in a:
        # distinct pixels of one of the views, seen from its camera
        assert torch.unique(x["raydir"], dim=0).shape[0] == 64
        assert x["raydir"].shape == (64, 3) and x["gt"].shape == (64, 3)
