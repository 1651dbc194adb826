"""The benchmark's yardstick: the card's peaks, the least time a piece of
work can take on it, and the work of each model function counted from the
shapes a configuration and its traffic fix.

The peaks and `bound` are frozen copies of `chip_smoke.py`'s `HBM_BPS`,
`F32_FLOPS`, `BF16_FLOPS`, `TF32_FLOPS` and `bound()` (NVIDIA H100 SXM data
sheet, dense rates at 700 W). Work is counted for the function, never for
what one kernel happens to read or recompute, so the count stays the same
whatever implements a layer: a product of an (m, n) input with an (n, p)
weight is 2 m n p operations, counted once, at the peak of the precision
the configuration states for its products.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# bytes/s of HBM and FLOP/s by unit (NVIDIA H100 SXM, dense)
PEAKS = {
    "hbm": 3.35e12,
    "fp32": 67e12,      # CUDA cores, outside the tensor cores
    "tf32": 495e12,     # the card's fastest rate for float32 inputs
    "bf16": 989e12,
}


def bound(nbytes: float, flops: Sequence[Tuple[float, str]]):
    """(least seconds the card could take, what bounds it): the bytes the
    function must move over the HBM rate against its operations over the
    peak of the unit each part runs on (their times add)."""
    t_bytes = nbytes / PEAKS["hbm"]
    t_ops = sum(f / PEAKS[unit] for f, unit in flops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlp_macs(layers: Sequence[Sequence[int]]) -> int:
    """Multiply-adds of one row through an MLP given as [[in, out], ...]."""
    return sum(int(i) * int(o) for i, o in layers)


def shading_points(rays: int, cfg: Dict) -> int:
    return int(rays) * int(cfg["widths"]["SR"])


def neighbour_rows(rays: int, cfg: Dict) -> int:
    return shading_points(rays, cfg) * int(cfg["widths"]["K"])


def model_flops(rays: int, cfg: Dict) -> float:
    """Forward FLOPs of the shading MLPs for `rays` rays at the nominal
    work: every MLP marked "neighbour" over rays x SR x K rows (all K slots,
    found or not), every MLP marked "point" over rays x SR shading points."""
    total = 0.0
    for mlp in cfg["mlps"].values():
        rows = (neighbour_rows(rays, cfg) if mlp["per"] == "neighbour"
                else shading_points(rays, cfg))
        total += 2.0 * rows * mlp_macs(mlp["layers"])
    return total


def roofline(rec: Dict, layer: str):
    """A layer's share of its roofline in the traced window, in %: the
    least time its function's work could take over the device time of the
    kernels assigned to it; None where the trace holds none of them."""
    lay = rec.get("layers", {}).get(layer)
    if not lay or lay["device_s"] <= 0:
        return None
    t, _ = bound(lay["bytes"], lay["flops"])
    return 100.0 * t / lay["device_s"]


def mfu(rec: Dict, cfg: Dict, passes: float):
    """Model FLOPs of the window's work (`passes` times the forward's) over
    the traced window at the configuration's product peak, in %."""
    if rec.get("busy_s", 0) <= 0:
        return None
    sec = cfg[rec["section"]]
    flops = passes * model_flops(rec["rays"], cfg)
    return 100.0 * flops / (rec["traced_s"] * PEAKS[sec["precision"]["peak"]])


def idle(rec: Dict):
    """1 minus the device's busy share of the traced window, in %; None
    where no operation ran on a device."""
    if rec.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_s"])
