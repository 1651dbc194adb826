"""Reduction of a `torch.profiler` trace of the measured window.

Device time is the union of the intervals in which any operation (kernel,
copy, set) ran on the card, clipped to the window, so overlapping streams
count once; the idle share is one minus its ratio to the window. Kernel
time by layer is the sum of the durations of the kernels whose names match
the layer's patterns. A trace of the device's activity alone (no host
operation recorded, so the host keeps its pace) takes its window from two
marker kernels; a trace with host activity takes it from the window's
annotation, and names each idle gap by the innermost host operation of the
window's thread that was running at its midpoint.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

WINDOW = "nerfbench.window"
MARK = "spin_kernel"     # torch.cuda._sleep's kernel: a device trace's edges
MARK_CYCLES = 1000
MIN_GAP_NS = 20_000      # shorter gaps are summed under one name


def events(prof):
    """(window (t0, t1, thread), device events [(t0, t1, name)], host events
    [(t0, t1, name)] of the window's thread), in ns."""
    raw = prof.profiler.kineto_results.events()
    win, dev, host = None, [], []
    for e in raw:
        kind = str(e.device_type())
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if kind.endswith("CUDA"):
            # the window's own annotation is mirrored on the device's
            # timeline; it is no device work
            if e.name() != WINDOW and not e.is_user_annotation():
                dev.append((t0, t1, e.name()))
        else:
            host.append((t0, t1, e.name(), e.start_thread_id()))
            if e.name() == WINDOW:
                win = (t0, t1, e.start_thread_id())
    if win is None:
        raise RuntimeError("the trace holds no window annotation")
    host = [(a, b, n) for a, b, n, tid in host
            if tid == win[2] and n != WINDOW and a < win[1] and b > win[0]]
    dev = [(max(a, win[0]), min(b, win[1]), n) for a, b, n in dev
           if a < win[1] and b > win[0]]
    return win, dev, host


def union(intervals):
    """Merged (t0, t1) intervals, sorted."""
    out = []
    for a, b in sorted((a, b) for a, b, *_ in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(win, busy, host) -> Dict[str, float]:
    """Seconds of idle device time by the host operation running then: the
    innermost of the (nested) host events of the window's thread open at
    each gap's midpoint, found by one sweep with a stack."""
    gaps = []
    t = win[0]
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if win[1] > t:
        gaps.append((t, win[1]))
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out = defaultdict(float)
    stack, i = [], 0
    for a, b in gaps:
        if b - a < MIN_GAP_NS:
            out["gaps under 20 us"] += (b - a) / 1e9
            continue
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host outside any operation"
        out[name] += (b - a) / 1e9
    return dict(out)


def top(d: Dict[str, float], n=10) -> List:
    return [[k[:160], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_events(prof):
    """(window (t0, t1), device events [(t0, t1, name)]) of a trace of the
    device's activity alone, its window from the first marker kernel's
    start to the last one's end, in ns."""
    marks, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") or \
                e.is_user_annotation():
            continue
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        (marks if MARK in e.name() else dev).append((t0, t1, e.name()))
    if len(marks) < 2:
        raise RuntimeError("the device trace holds no edge marks")
    win = (min(a for a, _, _ in marks), max(b for _, b, _ in marks))
    return win, [(max(a, win[0]), min(b, win[1]), n) for a, b, n in dev
                 if a < win[1] and b > win[0]]


def device_summary(win, dev, layers: Dict[str, Dict]) -> Dict:
    busy = union(dev)
    by_name = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += (b - a) / 1e9
    layer_s = {}
    for name, spec in layers.items():
        pats = [re.compile(p) for p in spec["kernels"]]
        layer_s[name] = sum(s for k, s in by_name.items()
                            if any(p.search(k) for p in pats))
    return {"window_s": (win[1] - win[0]) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9, "layer_s": layer_s,
            "breakdown": {"device_ops": top(by_name), "idle_gaps": []}}


def summarize_device(prof, layers: Dict[str, Dict]) -> Dict:
    """A device-only trace's window and busy seconds, per-layer kernel
    seconds, the device operations that took most time, and its five
    longest idle gaps as (seconds from the window's start, length)."""
    win, dev = device_events(prof)
    out = device_summary(win, dev, layers)
    gaps, t = [], win[0]
    for a, b in union(dev) + [[win[1], win[1]]]:
        if a > t:
            gaps.append(((t - win[0]) / 1e9, (a - t) / 1e9))
        t = max(t, b)
    out["longest_gaps"] = sorted(gaps, key=lambda g: -g[1])[:5]
    return out


def summarize(prof, layers: Dict[str, Dict]) -> Dict:
    """A host-and-device trace's window and busy seconds, per-layer kernel
    seconds, and the breakdown lists."""
    win, dev, host = events(prof)
    out = device_summary(win, dev, layers)
    gaps = idle_gaps(win, union(dev), host)
    out["breakdown"]["idle_gaps"] = top(gaps)
    return out
