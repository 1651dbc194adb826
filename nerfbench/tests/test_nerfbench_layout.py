"""Everything a cell needs is found by name, so a later change adds files
and entries only: the manifest's cells, configurations, traffic mixes,
checks, metric readers, layer maps and work counters all resolve, and a
throwaway set added to a temporary copy resolves the same way without an
edit to any file that was there."""
import json
import os
import shutil

import pytest

from nerfbench import harness

ROOT = harness.ROOT


def test_every_name_in_the_manifest_resolves(bench):
    m = bench.manifest
    for w in m["workloads"]:
        assert bench.config(w["config"])["name"] == w["config"]
        tr = bench.traffic(w["traffic"])
        assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                           tr["kind"] + ".py"))
        assert bench.driver(tr["kind"]) is not None
        assert bench.checks(w["name"])["limits"]
    for kind in ("end_to_end", "per_layer"):
        for metric in m[kind]:
            assert callable(bench.metric_reader(metric["name"]).read)
    for layer in bench.layers().values():
        assert callable(bench.work(layer["work"]).count)
    # every per-layer metric's cells report the end-to-end metric it moves
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        moved = e2e[metric["moves"]]
        for w in metric.get("workloads", [c["name"] for c in m["workloads"]]):
            assert "workloads" not in moved or w in moved["workloads"]


def test_a_parked_cell_resolves_outside_the_manifest(bench):
    names = [w["name"] for w in bench.manifest["workloads"]]
    for p in bench.parked:
        w = p["workload"]
        assert w["name"] not in names
        assert bench.cell(w["name"]) == w
        tr = bench.traffic(w["traffic"])
        assert bench.driver(tr["kind"]) is not None
        assert bench.checks(w["name"])["limits"]
        for kind in ("end_to_end", "per_layer"):
            mine = [m["name"] for m in bench.metrics_of(w["name"], kind)]
            for m in p.get(kind, []):
                assert m["name"] in mine
                assert callable(bench.metric_reader(m["name"]).read)
        # the manifest's metrics of every cell (set-up, memory) apply too
        assert "setup_s" in [m["name"] for m in
                             bench.metrics_of(w["name"], "end_to_end")]


def test_a_throwaway_set_added_by_files_only(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "nerfbench"), root / "nerfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (root / p).read_bytes() for p in
              [os.path.relpath(os.path.join(d, f), root)
               for d, _, fs in os.walk(root) for f in fs]}
    nb = root / "nerfbench"
    # a configuration, a traffic mix, a layer map with its work counter, a
    # per-layer metric reader and a cell's checks, each a new file
    cfg = json.loads((nb / "configs" / "scannet0113-viewmlp.json").read_text())
    cfg["name"] = "throwaway-config"
    (nb / "configs" / "throwaway-config.json").write_text(json.dumps(cfg))
    tr = json.loads((nb / "traffic" / "eval-frames-640x480.json").read_text())
    tr["width"] = 320
    (nb / "traffic" / "throwaway-mix.json").write_text(json.dumps(tr))
    (nb / "layers" / "throwaway.json").write_text(json.dumps(
        {"layer": "throwaway layer", "kernels": ["throwaway_kernel"],
         "work": "throwaway_work"}))
    (nb / "work" / "throwaway_work.py").write_text(
        "def count(cfg, rec):\n    return 8 * rec['rays'], [(1.0, 'fp32')]\n")
    (nb / "metrics" / "throwaway_roofline.eval.py").write_text(
        "from nerfbench import yardstick as y\n\n\n"
        "def read(rec):\n    return y.roofline(rec, 'throwaway')\n")
    (nb / "checks" / "throwaway-cell.json").write_text(
        json.dumps({"limits": {"frame_gap_max": 1e-6}}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="throwaway-config",
                             file="nerfbench/configs/throwaway-config.json"))
    m["workloads"].append({"name": "throwaway-cell",
                           "config": "throwaway-config",
                           "traffic": "throwaway-mix", "chips": 1,
                           "why": "a test's"})
    m["per_layer"].append({"name": "throwaway_roofline.eval", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "throwaway layer",
                           "moves": "render_rays_per_s",
                           "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    b = harness.Bench(str(root), str(nb))
    cell = b.cell("throwaway-cell")
    assert b.config(cell["config"])["name"] == "throwaway-config"
    assert b.traffic(cell["traffic"])["width"] == 320
    assert b.checks("throwaway-cell")["limits"] == {"frame_gap_max": 1e-6}
    assert b.layers()["throwaway"]["work"] == "throwaway_work"
    rec = {"section": "eval", "rays": 100,
           "layers": {"throwaway": {"device_s": 1.0, "bytes": 0.8 * 3.35e12,
                                    "flops": [(1.0, "fp32")]}}}
    assert b.work("throwaway_work").count({}, {"rays": 100}) == (
        800, [(1.0, "fp32")])
    assert b.metric_reader("throwaway_roofline.eval").read(rec) == \
        pytest.approx(80.0)
    names = [x["name"] for x in b.metrics_of("throwaway-cell", "per_layer")]
    assert "throwaway_roofline.eval" in names
    assert "k2_roofline.eval" not in names
    # no file that was there changed but the manifest
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert (root / p).read_bytes() == data, p
