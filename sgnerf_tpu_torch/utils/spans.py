"""Spans and counters inside the frame and the train step.

Spans are on exactly while a `torch.profiler` records in the process,
whatever its activities (a profiler of the device's activity alone turns
them on too); there is no flag. Off, `span()` costs one check and returns
a shared null context: no profiler range, no CUDA event, no sync.

On, a span records its name, its start and end on the host (Unix-epoch
nanoseconds, the profiler's own time base: Kineto's `start_ns`), its
parent span, the frame or step it belongs to (all spans inside one
`frame()` or `step()` share its id), its host self time (its duration
minus what its child spans cover), a device interval (a pair of CUDA
events on the current stream of its device; none for a CPU device) and
the same range as a `record_function` of its name, so that it shows in the
profiler's trace. Events are read only when `summary()` is read, after a
synchronise there; the program never waits on them.

Counters add to the open frame or step. A device-side count (a 0-d
tensor) stays on the device until `settle()` (the frame's readback, after
its colours reached the host) or `summary()` reads it.

The names, and the metric or tool that reads each:

  sgnerf.frame            SceneModel.render_image, a frame
  sgnerf.frame.upload       the camera's host-to-device copies
  sgnerf.query              a chunk's ray samples and neighbour query
  sgnerf.shade              a chunk's table, gather, aggregation and march
  sgnerf.frame.readback     the colours joined and copied to the host
  sgnerf.step             train_step, a train step
  sgnerf.step.forward       the render (sgnerf.query, sgnerf.shade inside)
  sgnerf.step.loss          the losses
  sgnerf.step.backward      the gradients
  sgnerf.step.update        both Adams
  shade.rows              neighbour slots shaded (rays x SR x K, padding in)
  shade.found             the slots that hold a neighbour (one device sum)
  k2.rows                 the rows K2's tiles held (its plan's count, padding
                          in), a K2 launch

The benchmark's `query_ms.eval`, `shade_ms.eval`, `frame_edge_ms.eval`,
`shade_fill.eval` and `k2_rows_share.eval` read the frames;
`train_ft --profile_dir` prints `table()` for the steps it profiles.
Spans stay in memory; `reset()` clears them.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# the profiler's time base: Unix-epoch ns, advanced by the monotonic clock
_EPOCH_OFFSET = time.time_ns() - time.perf_counter_ns()


def _now_ns() -> int:
    return time.perf_counter_ns() + _EPOCH_OFFSET


def enabled() -> bool:
    """Whether a torch.profiler records in this process now."""
    return torch.autograd._profiler_enabled()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()

# a span's range in the profiler's trace: the RecordFunction binding made
# for Python callers (~2 us a span against record_function's ~14 on the
# CPU), or record_function where this torch lacks it
_range = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.autograd.profiler.record_function)

_local = threading.local()
_ids = itertools.count()
_records: List["_Span"] = []
_groups: Dict[int, Dict] = {}


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "id", "parent", "group", "t0", "t1", "child_ns",
                 "device", "stream", "events", "rf", "dev_ms")

    def __init__(self, name: str, device, kind: Optional[str]):
        self.name = name
        self.id = next(_ids)
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if kind is not None:
            self.group = self.id
            _groups[self.id] = {"kind": kind, "counters": defaultdict(int),
                                "pending": []}
        else:
            self.group = parent.group if parent is not None else None
        self.child_ns = 0
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.events = None
        self.dev_ms = None

    def __enter__(self):
        self.rf = _range(self.name)
        self.rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(self.stream)
            self.events = (e0, None)
        _stack().append(self)
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = _now_ns()
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += self.t1 - self.t0
        if self.events is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(self.stream)
            self.events = (self.events[0], e1)
        self.rf.__exit__(None, None, None)
        self.rf = None
        _records.append(self)
        return False


def span(name: str, device=None):
    """A span of `name` inside the open one; its device interval is taken
    on `device`'s current stream when that is a CUDA device."""
    if not torch.autograd._profiler_enabled():
        return NULL
    return _Span(name, device, None)


def frame(device=None):
    """`sgnerf.frame`: a new frame id for every span inside it."""
    if not torch.autograd._profiler_enabled():
        return NULL
    return _Span("sgnerf.frame", device, "frame")


def step(device=None):
    """`sgnerf.step`: a new step id for every span inside it."""
    if not torch.autograd._profiler_enabled():
        return NULL
    return _Span("sgnerf.step", device, "step")


def _open_group() -> Optional[Dict]:
    """The frame or step the innermost open span belongs to, if any."""
    stack = _stack()
    return _groups.get(stack[-1].group) if stack else None


def _count(name: str, value) -> None:
    """Add `value` (an int, or a 0-d tensor read later) to the open frame's
    or step's counter `name`."""
    g = _open_group()
    if g is None:
        return
    if isinstance(value, torch.Tensor):
        g["pending"].append((name, value))
    else:
        g["counters"][name] += int(value)


def count_slots(found: torch.Tensor) -> None:
    """The shading layer's counters of a chunk's neighbour slots, `found`
    true where a slot holds a neighbour, while spans are on."""
    if torch.autograd._profiler_enabled():
        _count("shade.rows", found.numel())
        _count("shade.found", found.sum())


def count_k2_rows(plan: torch.Tensor) -> None:
    """K2's counter of one launch, while spans are on: the rows its tiles
    held, word 1 of its plan (ops/fused_agg.py), copied so that the plan's
    memory goes back to the allocator."""
    if torch.autograd._profiler_enabled():
        _count("k2.rows", plan[1].clone())


def settle() -> None:
    """Read the device-side counts of the open frame or step (one copy a
    device), after a readback has waited for its work."""
    g = _open_group()
    if g is not None:
        _settle(g)


def _settle(g: Dict) -> None:
    by_dev = defaultdict(list)
    for name, t in g["pending"]:
        by_dev[t.device].append((name, t))
    for items in by_dev.values():
        vals = torch.stack([t for _, t in items]).tolist()
        for (name, _), v in zip(items, vals):
            g["counters"][name] += int(v)
    g["pending"] = []


def _resolve() -> None:
    """Device intervals of the finished spans, in ms from the first event
    their frame or step recorded on the same device (the span's own start
    for a span outside any)."""
    todo = [r for r in _records if r.events is not None]
    if not todo:
        return
    for d in {r.device for r in todo}:
        torch.cuda.synchronize(d)
    ref = {}
    for r in sorted(todo, key=lambda r: r.id):
        e0, e1 = r.events
        key = (r.group, r.device) if r.group is not None else r.id
        base = ref.setdefault(key, e0)
        r.dev_ms = (base.elapsed_time(e0), base.elapsed_time(e1))
    for r in todo:
        r.events = None


def summary() -> Dict:
    """Everything recorded: by span name its count and host, host-self and
    device seconds; the counters' totals; the number of frames and steps;
    and `groups`, each frame or step with its kind, counters and spans
    ({name, id, parent, t0_ns, t1_ns, self_ns, device, dev_ms}; dev_ms is
    (start, end) in ms from the group's first event on that device, None
    on a CPU device)."""
    _resolve()
    for g in _groups.values():
        if g["pending"]:
            _settle(g)
    by_name = {}
    groups = {gid: {"kind": g["kind"], "id": gid,
                    "counters": dict(g["counters"]), "spans": []}
              for gid, g in _groups.items()}
    totals = defaultdict(int)
    for g in groups.values():
        for k, v in g["counters"].items():
            totals[k] += v
    for r in sorted(_records, key=lambda r: r.id):
        s = by_name.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                        "self_s": 0.0, "device_s": 0.0})
        s["count"] += 1
        s["host_s"] += (r.t1 - r.t0) / 1e9
        s["self_s"] += (r.t1 - r.t0 - r.child_ns) / 1e9
        if r.dev_ms is not None:
            s["device_s"] += (r.dev_ms[1] - r.dev_ms[0]) / 1e3
        if r.group in groups:
            groups[r.group]["spans"].append({
                "name": r.name, "id": r.id, "parent": r.parent,
                "t0_ns": r.t0, "t1_ns": r.t1,
                "self_ns": r.t1 - r.t0 - r.child_ns,
                "device": str(r.device) if r.device is not None else None,
                "dev_ms": r.dev_ms})
    kinds = [g["kind"] for g in groups.values()]
    return {"spans": by_name, "counters": dict(totals),
            "frames": kinds.count("frame"), "steps": kinds.count("step"),
            "groups": sorted(groups.values(), key=lambda g: g["id"])}


def table() -> str:
    """The summary as text: a line a span name, then the counters."""
    summ = summary()
    lines = [f"spans: {summ['frames']} frames, {summ['steps']} steps",
             f"{'span':<26}{'count':>7}{'host ms':>12}{'self ms':>12}"
             f"{'device ms':>12}"]
    for name, s in sorted(summ["spans"].items()):
        lines.append(f"{name:<26}{s['count']:>7}{s['host_s'] * 1e3:>12.3f}"
                     f"{s['self_s'] * 1e3:>12.3f}"
                     f"{s['device_s'] * 1e3:>12.3f}")
    for name, v in sorted(summ["counters"].items()):
        lines.append(f"{name:<26}{v:>7}")
    return "\n".join(lines)


def reset() -> None:
    """Forget every span and counter recorded."""
    _records.clear()
    _groups.clear()
