"""The benchmark's runner: one run of one cell.

Everything a cell needs is found by name from `BENCHMARK.json` at the root
of the checkout: the cell's configuration file (`configs/<config>.json`),
its traffic mix (`traffic/<mix>.json`, whose `kind` names the driver module
`drivers/<kind>.py`), its correctness limits (`checks/<cell>.json`), the
kernel-to-layer maps (`layers/*.json`, each naming a work counter
`work/<name>.py`) and one reader a per-layer metric (`metrics/<metric>.py`).
Adding a configuration, a mix, a metric, a kernel or a cell adds files and
entries; no file here changes. A cell left out of the manifest keeps its
entries in `parked/<cell>.json` (its workload and the metrics only it
reports), and the same command runs it.

A run: set-up (inputs from the seed, the program built over them, the
cell's shapes warmed) -> the window (traced with `--trace 1`) -> the peak
memory read -> the program freed -> the check against the plain reference
-> (traced) the work of the traced frames or steps counted -> the result
line. setup_s runs from the process's start to the window's.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that must not be loaded in a run: JAX, the JAX package and its
# harness (compared by whole top-level name; the port's name starts with
# the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "sgnerf_tpu", "bench")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The manifest and the files it names."""

    def __init__(self, root: str = ROOT, here: str = HERE):
        self.root, self.here = root, here
        self.manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        d = os.path.join(here, "parked")
        self.parked = [load_json(os.path.join(d, f))
                       for f in sorted(os.listdir(d))
                       if f.endswith(".json")] if os.path.isdir(d) else []

    def cell(self, workload: str) -> Dict:
        for w in self.manifest["workloads"] + [p["workload"]
                                               for p in self.parked]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return load_json(os.path.join(self.here, "traffic", f"{name}.json"))

    def checks(self, workload: str) -> Dict:
        return load_json(os.path.join(self.here, "checks",
                                      f"{workload}.json"))

    def driver(self, kind: str):
        return importlib.import_module(f"nerfbench.drivers.{kind}").Driver

    def layers(self) -> Dict[str, Dict]:
        d = os.path.join(self.here, "layers")
        return {f[:-5]: load_json(os.path.join(d, f))
                for f in sorted(os.listdir(d)) if f.endswith(".json")}

    def work(self, name: str):
        return load_module(os.path.join(self.here, "work", f"{name}.py"),
                           f"nerfbench_work_{name}")

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.here, "metrics", f"{name}.py"),
                           f"nerfbench_metric_{name.replace('.', '_')}")

    def metrics_of(self, workload: str, kind: str):
        """The cell's end-to-end or per-layer metric entries."""
        out = []
        for m in self.manifest[kind] + [m for p in self.parked
                                        for m in p.get(kind, [])]:
            if "workloads" not in m or workload in m["workloads"]:
                out.append(m)
        return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device) -> Dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def resolve(bench: Bench, workload: str, overrides: Optional[Dict] = None):
    """The cell's configuration and traffic, with `overrides` ({"config":
    {...}, "traffic": {...}}) merged key by key one level deep."""
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    for key, tgt in (("config", cfg), ("traffic", traffic)):
        for k, v in ((overrides or {}).get(key) or {}).items():
            if isinstance(v, dict) and isinstance(tgt.get(k), dict):
                tgt[k] = {**tgt[k], **v}
            else:
                tgt[k] = v
    return cfg, traffic


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[Bench] = None, overrides: Optional[Dict] = None,
             control: Optional[str] = None, fault=None) -> Dict:
    """One run of `workload`; returns the result line as a dict. On the
    CPU (tests) `overrides` shrinks the configuration and the traffic
    ({"config": {...}, "traffic": {...}} merged key by key one level
    deep); `control` puts the reference at that precision in the program's
    place for the check; `fault(model)` breaks the program under the run
    once set-up has built it (faults.py). readings.py drives both on the
    card."""
    import torch
    t_start = time.time() if t_start is None else t_start
    bench = bench or Bench()
    cfg, traffic = resolve(bench, workload, overrides)
    limits = bench.checks(workload)
    workdir = os.path.join(bench.root, "build", "nerfbench", workload)
    h = SimpleNamespace(cfg=cfg, traffic=traffic, seed=int(seed),
                        device=device, workdir=workdir, fault=fault)
    drv = bench.driver(traffic["kind"])(h)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv.setup()
    program_sync(device)
    setup_s = time.time() - t_start
    layers = bench.layers()
    if trace:
        rec, summ = traced_window(drv, seconds, traffic, layers, device)
    else:
        rec = drv.window(seconds)
        summ = None
    dev = device_info(device)
    drv.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rec.update(setup_s=setup_s, scene_build_s=drv.scene_build_s,
               memory_peak_bytes=dev["memory_peak_bytes"], cfg=cfg,
               traffic=traffic)
    # the check, after the window, the peak read and the program freed
    from .reference.pointnerf import no_tf32
    no_tf32()
    numbers, compared = drv.check(control)
    if summ is not None:
        rec.update(busy_s=summ["busy_s"], traced_s=summ["window_s"],
                   layer_s=summ["layer_s"])
        if hasattr(drv, "census"):
            rec.update(drv.census(rec["traced"]))
        rec["layers"] = {}
        for name, spec in layers.items():
            if rec["layer_s"].get(name, 0) <= 0:
                continue
            work = bench.work(spec["work"]).count(cfg, rec)
            if work is not None:
                rec["layers"][name] = {"device_s": rec["layer_s"][name],
                                       "bytes": work[0], "flops": work[1]}
    checks = {}
    correct = True
    for k, lim in limits["limits"].items():
        ok = numbers[k] <= lim
        correct &= ok
        checks[k] = {"value": numbers[k], "limit": lim}
    shown = {k: v for k, v in numbers.items() if k not in checks}
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in bench.metrics_of(workload, kind):
        value = bench.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        dev.update(busy_s=summ["busy_s"], window_s=summ["window_s"])
    out = {"correct": bool(correct),
           "attempted": rec.get("frames", rec.get("steps")),
           "failed": 0 if correct else compared, "metrics": metrics,
           "device": dev}
    if trace:
        out["breakdown"] = summ["breakdown"]
    out["not_compared"] = shown
    out["checks"] = checks
    return out


def program_sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def traced_window(drv, seconds: float, traffic: Dict, layers: Dict, device):
    """The window, run its full length, with the profiler on over two
    spans that end at a synchronise. On a card: over the first
    `trace_seconds` (the traffic's; the whole window if it sets none) the
    device's activity alone, so that the host keeps its untraced pace,
    edged by two marker kernels: the busy time, the layers' kernel time,
    the device operations, and the work counts of the frames or steps in
    it; then over the next `gap_seconds` host and device activity, whose
    idle gaps the host's operations name. On the CPU (tests) one span
    with host activity. Returns (the window's record with `rays` and
    `traced`, the frames or steps of the first span, the summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import trace as tr
    cuda = torch.device(device).type == "cuda"
    first = float(traffic.get("trace_seconds", seconds))
    second = float(traffic.get("gap_seconds", 0)) if cuda else 0.0
    st = {"span": 0, "done": None, "t": None, "dprof": None, "hprof": None,
          "mark": None}

    def host_span():
        st["hprof"] = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        st["mark"] = record_function(tr.WINDOW)
        st["hprof"].start()
        st["mark"].__enter__()

    def end_first(elapsed, done):
        program_sync(device)
        if cuda:
            torch.cuda._sleep(tr.MARK_CYCLES)
            program_sync(device)
            st["dprof"].stop()
        else:
            st["mark"].__exit__(None, None, None)
            st["hprof"].stop()
        st.update(span=1, done=done, t=elapsed)
        if second > 0:
            host_span()

    def end_second():
        program_sync(device)
        st["mark"].__exit__(None, None, None)
        st["hprof"].stop()
        st["span"] = 2

    def tick(elapsed, done):
        if st["span"] == 0 and elapsed >= first:
            end_first(elapsed, done)
        elif st["span"] == 1 and second > 0 and elapsed >= st["t"] + second:
            end_second()

    if cuda:
        st["dprof"] = profile(activities=[ProfilerActivity.CUDA])
        st["dprof"].start()
        # the tracer sets itself up at the first launch: before the edge
        torch.zeros(1, device=device)
        program_sync(device)
        torch.cuda._sleep(tr.MARK_CYCLES)
    else:
        host_span()
    rec = drv.window(seconds, tick)
    n = rec.get("frames", rec.get("steps"))
    if st["span"] == 0:
        end_first(rec["window_s"], n)
    if st["span"] == 1 and second > 0:
        end_second()
    if cuda:
        summ = tr.summarize_device(st["dprof"], layers)
        if st["hprof"] is not None:
            gaps = tr.summarize(st["hprof"], {})
            summ["breakdown"]["idle_gaps"] = gaps["breakdown"]["idle_gaps"]
    else:
        summ = tr.summarize(st["hprof"], layers)
    per = rec["rays"] // n
    print(f"nerfbench: traced {st['done']} of {n} in {st['t']:.3f} s of "
          f"{rec['window_s']:.3f} s; longest idle gaps (s from the start, "
          f"s): {summ.get('longest_gaps')}", file=sys.stderr)
    return dict(rec, rays=st["done"] * per, traced=st["done"]), summ
