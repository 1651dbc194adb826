"""The port's spans and counters (sgnerf_tpu_torch/utils/spans.py) on a
small shell of points: off without a profiler (no record_function, no CUDA
event), on under one, nested by frame and step, on the profiler's clock,
and counting the shading layer's neighbour slots. The card test turns
them on with a profiler of the device's activity alone."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sgnerf_tpu_torch.models import renderer
from sgnerf_tpu_torch.utils import spans

FLAGS = [
    "--name", "spans", "--z_depth_dim", "32", "--SR", "4", "--K", "4",
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
    "3", "--wcoord_query", "1"]
W, H, CHUNK = 16, 12, 64          # three chunks a frame
SR, K = 4, 4


def make_model(tmp_path, gpu):
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    opt = TrainOptions().parse(FLAGS + ["--checkpoints_dir", str(tmp_path),
                                        "--gpu_ids", gpu])
    m = SceneModel(opt)
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(2000, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    m.setup_from_points(xyz, None, None)
    return m


def frame_item(seed=0):
    """A W x H frame of the shell from z = -3, with seeded targets."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = np.stack([(xs.ravel() - W / 2) / 12.0, (ys.ravel() - H / 2) / 12.0,
                  np.ones(W * H)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"raydir": d, "campos": np.array([0, 0, -3.0], np.float32),
            "camrotc2w": np.eye(3, dtype=np.float32), "near": 1.0,
            "far": 5.0, "bg_color": np.ones(3, np.float32),
            "gt_image": rng.uniform(0, 1, (W * H, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_model(tmp_path_factory.mktemp("spans"), "-1")


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def by_name(group):
    out = {}
    for s in group["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_without_a_profiler_records_nothing(model, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span made a record_function or an event")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "_range", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not spans.enabled()
    assert spans.span("sgnerf.query") is spans.NULL
    model.render_image(frame_item(), chunk_rays=CHUNK)
    s = spans.summary()
    assert s["frames"] == 0 and s["steps"] == 0
    assert s["spans"] == {} and s["counters"] == {}


def test_a_cpu_profiler_records_a_frame_by_chunk(model):
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.enabled()
        model.render_image(frame_item(), chunk_rays=CHUNK)
    s = spans.summary()
    assert s["frames"] == 1 and s["steps"] == 0
    assert {k: v["count"] for k, v in s["spans"].items()} == {
        "sgnerf.frame": 1, "sgnerf.frame.upload": 1,
        "sgnerf.frame.readback": 1, "sgnerf.query": 3, "sgnerf.shade": 3}
    g = s["groups"][0]
    names = by_name(g)
    root = names["sgnerf.frame"][0]
    assert root["id"] == g["id"] and root["parent"] is None
    for s_ in g["spans"]:
        assert s_["self_ns"] >= 0
        assert s_["dev_ms"] is None and s_["device"] == "cpu"
        if s_ is not root:
            assert s_["parent"] == root["id"]
            assert root["t0_ns"] <= s_["t0_ns"] <= s_["t1_ns"] \
                <= root["t1_ns"]
    # the chunks in order, each query before its shade
    chunks = sorted(names["sgnerf.query"] + names["sgnerf.shade"],
                    key=lambda x: x["t0_ns"])
    assert [c["name"] for c in chunks] == ["sgnerf.query",
                                           "sgnerf.shade"] * 3
    for a, b in zip(chunks, chunks[1:]):
        assert a["t1_ns"] <= b["t0_ns"]
    # the root's self time is its duration less its children's
    kids = sum(c["t1_ns"] - c["t0_ns"] for c in g["spans"] if c is not root)
    assert root["self_ns"] == root["t1_ns"] - root["t0_ns"] - kids
    assert s["spans"]["sgnerf.shade"]["device_s"] == 0.0


def test_spans_lie_on_the_profilers_clock(model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.render_image(frame_item(), chunk_rays=CHUNK)
        model.render_image(frame_item(1), chunk_rays=CHUNK)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sgnerf.") and \
                not str(e.device_type()).endswith("CUDA"):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    s = spans.summary()
    assert s["frames"] == 2
    mine = {}
    for g in s["groups"]:
        for x in g["spans"]:
            mine.setdefault(x["name"], []).append((x["t0_ns"], x["t1_ns"]))
    assert set(mine) == set(events)
    for name, ours in mine.items():
        theirs = sorted(events[name])
        assert len(ours) == len(theirs), name
        for (a0, a1), (b0, b1) in zip(sorted(ours), theirs):
            assert abs(a0 - b0) < 1_000_000 and abs(a1 - b1) < 1_000_000, \
                (name, a0 - b0, a1 - b1)


def test_counters_count_the_shading_slots(model, monkeypatch):
    found = []
    shade = renderer._shade_and_march

    def counting(params, cloud, cfg, table, sample_pidx, *a, **k):
        found.append(int((sample_pidx >= 0).sum()))
        return shade(params, cloud, cfg, table, sample_pidx, *a, **k)
    monkeypatch.setattr(renderer, "_shade_and_march", counting)
    with profile(activities=[ProfilerActivity.CPU]):
        model.render_image(frame_item(), chunk_rays=CHUNK)
    s = spans.summary()
    assert len(found) == 3 and sum(found) > 0
    assert s["counters"] == {"shade.rows": 3 * CHUNK * SR * K,
                             "shade.found": sum(found)}
    assert s["groups"][0]["counters"] == s["counters"]


def test_a_train_step_records_its_stages(model):
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    batch = batch_to_device(frame_item(2), model.device)
    with profile(activities=[ProfilerActivity.CPU]):
        model.optimize(batch)
    s = spans.summary()
    assert s["steps"] == 1 and s["frames"] == 0
    g = s["groups"][0]
    names = by_name(g)
    root = names["sgnerf.step"][0]
    for stage in ("forward", "loss", "backward", "update"):
        (x,) = names[f"sgnerf.step.{stage}"]
        assert x["parent"] == root["id"]
    fwd = names["sgnerf.step.forward"][0]
    assert [x["parent"] for x in names["sgnerf.query"]
            + names["sgnerf.shade"]] == [fwd["id"]] * 2
    assert g["counters"]["shade.rows"] == W * H * SR * K
    assert "sgnerf.step" in spans.table()


@pytest.mark.cuda
def test_a_cuda_only_profiler_turns_spans_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = make_model(tmp_path, "0")
    m.render_image(frame_item(), chunk_rays=CHUNK)       # warm
    with profile(activities=[ProfilerActivity.CUDA]):
        assert spans.enabled()
        m.render_image(frame_item(1), chunk_rays=CHUNK)
    s = spans.summary()
    assert s["frames"] == 1 and s["counters"]["shade.found"] > 0
    g = s["groups"][0]
    root = by_name(g)["sgnerf.frame"][0]
    r0, r1 = root["dev_ms"]
    assert r0 == 0.0 and r1 > 0
    for x in g["spans"]:
        d0, d1 = x["dev_ms"]
        assert x["device"].startswith("cuda")
        assert r0 <= d0 <= d1 <= r1, x
        if x["name"] in ("sgnerf.query", "sgnerf.shade"):
            assert d1 > d0, x
    assert s["spans"]["sgnerf.shade"]["device_s"] > 0
