"""`k2_rows_share.eval` on spans' summaries written out by hand: the rows
K2's tiles held over the slots the shading layer covers, summed over the
frames with device intervals; nothing where no frame counts `k2.rows` (a
program without the counter, frames without K2) or none has a device
interval (a CPU run)."""
import pytest

from nerfbench import harness


def frame(gid, rows, k2=None, dev=True):
    counters = {"shade.rows": rows, "shade.found": rows // 4}
    if k2 is not None:
        counters["k2.rows"] = k2
    span = (lambda name, a, b: {"name": name, "id": a, "parent": None,
                                "t0_ns": a * 10**6, "t1_ns": b * 10**6,
                                "self_ns": 0, "device": "cuda:0",
                                "dev_ms": (a, b) if dev else None})
    return {"kind": "frame", "id": gid, "counters": counters,
            "spans": [span("sgnerf.frame", 0, 12), span("sgnerf.query", 1, 3),
                      span("sgnerf.shade", 3, 11)]}


@pytest.mark.parametrize("groups,want", [
    ([frame(0, 1000, 300), frame(1, 3000, 900)], 30.0),
    ([frame(0, 1000, 300), frame(1, 3000, 900, dev=False)], 30.0),
    ([frame(0, 1000), frame(1, 3000)], None),
    ([frame(0, 1000, 300, dev=False)], None),
])
def test_k2_rows_share_reads_the_frames_counters(monkeypatch, groups, want):
    from sgnerf_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "summary", lambda: {"groups": groups})
    read = harness.Bench().metric_reader("k2_rows_share.eval").read
    assert read({"section": "eval"}) == want
    assert read({"section": "train"}) is None
