"""Row-gather probe on the card: K7 and its staged form against
`index_select` at the TPU probes' shapes.

    python -m sgnerf_tpu_torch.dev.probe_gather

Counterpart of the TPU-toolchain probes (`dev_scripts/probe_pallas_gather*.py`
and `probe_pallas_bisect*.py`), which asked whether a hand-written per-row
copy beats the library gather. Two shapes, each an int16 table with ids
drawn from a seeded generator:
  * cache: 221,184 rows of 640 B from a (1,200,000, 320) table (the KNN
    cache rows of one 9216-ray chunk);
  * attr: 1,769,472 rows of 128 B from a (1,048,576, 64) table (the
    attribute rows of that chunk).
Each is timed with CUDA events for K7 (`gather_rows_pallas`) and the
staged form (`gather_rows_staged`) at wave 8, 16 and 32, and for
`index_select`; the bisect probes' static-index copies (every id s) run
once at the cache shape. One line per case: ms, GB/s, and the share of the
bound (the bytes read and written over the card's 3.35 TB/s). Needs an
NVIDIA GPU.
"""
from __future__ import annotations

import statistics
import sys

import torch

from ..ops.pallas_gather import gather_rows_pallas, gather_rows_staged

SHAPES = {"cache": dict(S=221_184, T=1_200_000, ROW=320),
          "attr": dict(S=1_769_472, T=1_048_576, ROW=64)}
WAVES = (8, 16, 32)
REPS = 20               # back-to-back calls a timed round
HBM_BPS = 3.35e12       # NVIDIA H100 SXM data sheet


def make_case(shape: str, device, seed: int = 0, static: bool = False):
    """(table (T, ROW) int16, idx (S,) int32) on `device`; static: idx = s."""
    c = SHAPES[shape]
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randint(-100, 100, (c["T"], c["ROW"]), dtype=torch.int16,
                          device=device, generator=gen)
    idx = (torch.arange(c["S"], dtype=torch.int32, device=device) if static
           else torch.randint(0, c["T"], (c["S"],), dtype=torch.int32,
                              device=device, generator=gen))
    return table, idx


def moved_bytes(table: torch.Tensor, idx: torch.Tensor) -> int:
    """Each gathered row read once and written once, and the ids."""
    return (2 * idx.numel() * table.shape[1] * table.element_size()
            + idx.numel() * idx.element_size())


def bound_ms(table: torch.Tensor, idx: torch.Tensor) -> float:
    return moved_bytes(table, idx) / HBM_BPS * 1e3


def cuda_ms(fn, rounds: int = 5) -> float:
    """Median over `rounds` of the mean ms of REPS back-to-back calls, by
    CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / REPS)
    return statistics.median(times)


def forms():
    """(form name, wave, function of (table, idx))."""
    out = [("gather_rows_pallas", w,
            lambda t, i, w=w: gather_rows_pallas(t, i, wave=w))
           for w in WAVES]
    out += [("gather_rows_staged", w,
             lambda t, i, w=w: gather_rows_staged(t, i, wave=w))
            for w in WAVES]
    out.append(("index_select", None, lambda t, i: t.index_select(0, i)))
    return out


def run(device="cuda", log=print):
    """Time every form at both shapes (random ids) and at the cache shape
    with static ids; returns one record per case."""
    records = []
    for shape, static in (("cache", False), ("attr", False),
                          ("cache", True)):
        table, idx = make_case(shape, device, static=static)
        nbytes, bms = moved_bytes(table, idx), bound_ms(table, idx)
        name = f"{shape}{' static' if static else ''}"
        for form, wave, fn in forms():
            ms = cuda_ms(lambda: fn(table, idx))
            rec = dict(case=name, form=form, wave=wave, ms=ms,
                       gbps=nbytes / ms / 1e6, bound_ms=bms,
                       bound_share=bms / ms)
            records.append(rec)
            log(f"probe_gather {name:12s} S={idx.numel()} rows of "
                f"{table.shape[1] * table.element_size()} B  {form:18s} "
                f"wave={str(wave):4s} {ms:.4f} ms  {rec['gbps']:.1f} GB/s  "
                f"{rec['bound_share']:.1%} of the {bms:.4f} ms bound")
        del table, idx
    return records


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather: torch.cuda.is_available() is false: this "
                 "probe needs an NVIDIA GPU")
    print(f"device {torch.cuda.get_device_name(0)}")
    run("cuda")


if __name__ == "__main__":
    main()
