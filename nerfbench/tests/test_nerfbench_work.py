"""The yardstick's counts against numbers worked out by hand."""
import pytest

from nerfbench import yardstick as y

RAYS = 640 * 480
ROWS = RAYS * 24 * 8            # 58,982,400 neighbour rows a frame
POINTS = RAYS * 24              # 7,372,800 shading points a frame
BLOCK1 = 284 * 256 + 256 * 256  # 138,240 multiply-adds a row
ALPHA = 256
COLOUR = 280 * 128 + 128 * 128 + 128 * 128 + 128 * 3   # 68,992
BPNET = 352 * 256               # 90,112


def work(bench, name, cfg, rays, section="eval"):
    spec = {"section": section, "rays": rays}
    return bench.work(name).count(cfg, spec)


def test_model_flops_by_hand(bench):
    v = bench.config("scannet0113-viewmlp")
    s = bench.config("scannet0241-semantic")
    assert y.model_flops(RAYS, v) == 2.0 * ROWS * (BLOCK1 + ALPHA) \
        + 2.0 * POINTS * COLOUR
    assert y.model_flops(RAYS, s) == 2.0 * ROWS * (BLOCK1 + ALPHA + BPNET) \
        + 2.0 * POINTS * COLOUR
    # ~17.4 TFLOP a viewmlp frame, ~28.0 a semantic one
    assert 17.3e12 < y.model_flops(RAYS, v) < 17.4e12
    assert 27.9e12 < y.model_flops(RAYS, s) < 28.0e12


def test_k1_select_by_hand(bench):
    v = bench.config("scannet0113-viewmlp")
    pts, rows = 900_000, 250_000
    spec = {"section": "eval", "rays": RAYS, "query_points": pts,
            "query_rows": rows}
    nbytes, flops = bench.work("k1_select").count(v, spec)
    # a row a distinct voxel: 64 candidates of three bf16 offsets and an
    # int32 id; a point: its float32 position in, 8 int32 ids out
    assert nbytes == rows * 64 * 10 + pts * (12 + 32)
    assert flops == [(8.0 * pts * 64, "fp32")]
    t, by = y.bound(nbytes, flops)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # the train section's float32 cache: 16 bytes a candidate
    train = dict(spec, section="train")
    assert bench.work("k1_select").count(v, train)[0] == \
        rows * 64 * 16 + pts * 44
    # without the census there is nothing to count
    assert work(bench, "k1_select", v, RAYS) is None


def test_block1_alpha_by_hand(bench):
    v = bench.config("scannet0113-viewmlp")
    nbytes, flops = work(bench, "block1_alpha", v, RAYS)
    assert flops == [(2.0 * ROWS * BLOCK1, "tf32"), (4.0 * ROWS * 256, "fp32")]
    assert nbytes == ROWS * 39 * 4 + POINTS * 257 * 4
    t, by = y.bound(nbytes, flops)
    assert by == "operations"
    assert t == pytest.approx(2.0 * ROWS * BLOCK1 / 495e12
                              + 4.0 * ROWS * 256 / 67e12)


def test_block1_alpha_bwd_by_hand(bench):
    v = bench.config("scannet0113-viewmlp")
    nbytes, flops = work(bench, "block1_alpha_bwd", v, 1024, "train")
    rows = 1024 * 24 * 8
    assert flops == [(4.0 * rows * BLOCK1, "tf32"), (8.0 * rows * 256, "fp32")]
    assert y.bound(nbytes, flops)[1] == "operations"


def test_unfused_mlps_by_hand(bench):
    s = bench.config("scannet0241-semantic")
    nbytes, flops = work(bench, "unfused_mlps", s, RAYS)
    assert flops == [(2.0 * ROWS * (BLOCK1 + BPNET + ALPHA)
                      + 2.0 * POINTS * COLOUR, "bf16")]
    assert nbytes == ROWS * (32 + 6 + 96 + 1) * 4 + POINTS * 16
    assert y.bound(nbytes, flops)[1] == "operations"


def test_mfu_and_roofline_readers():
    v_cfg = {"widths": {"SR": 24, "K": 8},
             "mlps": {"block1": {"per": "neighbour", "layers": [[284, 256]]}},
             "eval": {"precision": {"peak": "tf32"}}}
    rec = {"section": "eval", "rays": RAYS, "traced_s": 2.0, "busy_s": 1.5,
           "layers": {"k": {"device_s": 0.5, "bytes": 0,
                            "flops": [(495e12 * 0.1, "tf32")]}}}
    assert y.mfu(rec, v_cfg, 1.0) == pytest.approx(
        100 * 2.0 * ROWS * 284 * 256 / (2.0 * 495e12))
    assert y.idle(rec) == pytest.approx(25.0)
    assert y.roofline(rec, "k") == pytest.approx(20.0)
    assert y.roofline(rec, "absent") is None
    assert y.idle({"busy_s": 0.0, "traced_s": 1.0}) is None


def test_the_census_counts_each_frames_samples_and_voxels(bench):
    from types import SimpleNamespace

    import torch
    from conftest import tiny
    from nerfbench import harness, scene
    from nerfbench.reference import pointnerf as ref_pn
    cfg, t = harness.resolve(bench, "viewmlp-eval",
                             tiny(bench, "viewmlp-eval"))
    h = SimpleNamespace(cfg=cfg, traffic=t, seed=2 ** 31 + 7, device="cpu",
                        workdir=None, fault=None)
    d = bench.driver(t["kind"])(h)
    boxes = scene.room_scan(0, int(cfg["scene"]["n_points"]), "cpu").boxes
    d.dirs = scene.pixel_dirs(t["width"], t["height"], t["focal"])
    d.poses = scene.draw_poses(h.seed, 10, 2, boxes, t["wall_margin"],
                               t["pitch"])
    d.tr = dict(t, ref_block_rays=100)       # blocks that split the frame
    one, two = d.census(1), d.census(2)
    SR = int(d.ref["SR"])
    assert 0 < one["query_rows"] <= one["query_points"] <= \
        t["width"] * t["height"] * SR
    assert two["query_points"] > one["query_points"]
    # the first frame's samples in one block, and their distinct voxels
    grid, _, _ = d.reference_scene()
    campos, _, raydir = d.camera(0)
    ts = ref_pn.sample_depths(d.ref, raydir.shape[0], "cpu")
    loc, smask = ref_pn.shading_points(grid, campos, raydir, ts, SR)
    assert one["query_points"] == int(smask.sum())
    vid = grid.lin(grid.coords(loc[smask]))
    assert one["query_rows"] == int(torch.unique(vid).numel())
