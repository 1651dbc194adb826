"""The eval frames' stages from the program's own spans.

The port records spans while a `torch.profiler` records in the process
(`sgnerf_tpu_torch/utils/spans.py`): in a `--trace 1` run, every frame of
the two traced spans. A frame's numbers, in ms: `host` its `sgnerf.frame`
span on the host clock; `query` and `shade` the sums of its chunks'
`sgnerf.query` and `sgnerf.shade` device intervals (CUDA events on the
frame's stream); `chunks` the device interval from its first chunk's start
to its last chunk's end; `edge` = host - chunks, the time of the frame
outside its chunks (upload, readback, the host between); `rest` = chunks -
query - shade, the device time between the chunks' spans. `rows` and
`found` are its `shade.rows` and `shade.found` counters. Only frames with
device intervals count: a CPU run has none, and a program without spans
gives nothing.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

CHUNK_SPANS = ("sgnerf.query", "sgnerf.shade")


def frame_stages(group: Dict) -> Optional[Dict]:
    """One frame's numbers from its group in the spans' summary, or None
    when it holds no device interval."""
    root = next(s for s in group["spans"] if s["name"] == "sgnerf.frame")
    chunks = [s for s in group["spans"] if s["name"] in CHUNK_SPANS
              and s["device"] == root["device"] and s["dev_ms"] is not None]
    if root["dev_ms"] is None or not chunks:
        return None
    host = (root["t1_ns"] - root["t0_ns"]) / 1e6
    out = {name.split(".")[1]: sum(s["dev_ms"][1] - s["dev_ms"][0]
                                   for s in chunks if s["name"] == name)
           for name in CHUNK_SPANS}
    span = (max(s["dev_ms"][1] for s in chunks)
            - min(s["dev_ms"][0] for s in chunks))
    out.update(host=host, chunks=span, edge=host - span,
               rest=span - out["query"] - out["shade"],
               rows=group["counters"].get("shade.rows", 0),
               found=group["counters"].get("shade.found", 0))
    return out


def frames(rec) -> Optional[List[Dict]]:
    """The stages of every eval frame the spans recorded, or None."""
    if rec.get("section") != "eval":
        return None
    try:
        from sgnerf_tpu_torch.utils import spans
    except ImportError:
        return None
    out = [frame_stages(g) for g in spans.summary()["groups"]
           if g["kind"] == "frame"]
    out = [f for f in out if f is not None]
    return out or None


def median(rec, key: str) -> Optional[float]:
    """The median over the recorded frames of one number a frame."""
    fs = frames(rec)
    return None if fs is None else float(statistics.median(
        f[key] for f in fs))
