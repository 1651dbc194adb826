"""The four readers of the program's spans (`nerfbench/stages.py`) on a
whole traced run of each tiny eval cell on the CPU. The CPU has no device
intervals, so there the readers report nothing, as the harness's other
device metrics do; the same run's spans, their host intervals standing in
for the device's, give each reader a finite number, and the frame's
stages then add up to its duration."""
import math

import pytest

from conftest import tiny
from nerfbench import harness

SEED = 2 ** 31 + 777
READERS = ("query_ms.eval", "shade_ms.eval", "frame_edge_ms.eval",
           "shade_fill.eval")


def host_as_device(summ):
    """The summary with each span's host interval, in ms from its frame's
    start, in place of its device interval."""
    for g in summ["groups"]:
        t0 = min(s["t0_ns"] for s in g["spans"])
        for s in g["spans"]:
            s["dev_ms"] = ((s["t0_ns"] - t0) / 1e6, (s["t1_ns"] - t0) / 1e6)
    return summ


@pytest.mark.parametrize("cell", ["viewmlp-eval", "semantic-eval"])
def test_the_span_readers_on_a_traced_cpu_run(bench, cell, monkeypatch):
    from sgnerf_tpu_torch.utils import spans
    from nerfbench import stages
    spans.reset()
    out = harness.run_cell(cell, SEED, 0.5, True, "cpu", bench=bench,
                           overrides=tiny(bench, cell))
    assert out["correct"]
    assert not set(READERS) & set(out["metrics"])
    rec = {"section": "eval"}
    summ = host_as_device(spans.summary())
    assert summ["frames"] == out["attempted"] >= 1
    monkeypatch.setattr(spans, "summary", lambda: summ)
    vals = {m: bench.metric_reader(m).read(rec) for m in READERS}
    for m, v in vals.items():
        assert v is not None and math.isfinite(v), (m, v)
    assert 0 < vals["shade_fill.eval"] <= 100
    for f in stages.frames(rec):
        assert f["query"] > 0 and f["shade"] > 0 and f["edge"] > 0
        assert f["query"] + f["shade"] + f["edge"] + f["rest"] == \
            pytest.approx(f["host"])
        assert 0 <= f["rest"] < f["chunks"]
    assert bench.metric_reader("query_ms.eval").read(
        {"section": "train"}) is None
    spans.reset()
