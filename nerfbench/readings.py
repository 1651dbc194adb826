"""Readings for a cell's correctness limits, on the card at the cell's own
size, each through the harness's own run and comparison
(`harness.run_cell`): for each seed a run of the program and a run of each
control (the reference at a lower precision in the program's place), and
for each fault of faults.py a run with the program broken underneath, on
the first `--fault-seeds` seeds. One JSON line a run: its numbers, each
beside the cell's limit, and whether the run came out correct.

    python3 nerfbench/readings.py --workload <cell> --seeds 11 12 ... \
        --controls tf32 --faults stale half altered --fault-seeds 3 \
        --seconds 3 [--no-program]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from nerfbench import faults, harness
    bench = harness.Bench()
    kind = bench.traffic(bench.cell(args.workload)["traffic"])["kind"]
    runs = [(s, {}) for s in args.seeds if not args.no_program]
    runs += [(s, {"control": c}) for s in args.seeds for c in args.controls]
    runs += [(s, {"fault": f}) for f in args.faults
             for s in args.seeds[:args.fault_seeds]]
    for seed, what in runs:
        t0 = time.perf_counter()
        kw = dict(what)
        if "fault" in kw:
            kw["fault"] = faults.FAULTS[kind][kw["fault"]]
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda", bench=bench, **kw)
        print(json.dumps({"seed": seed, **what, "correct": out["correct"],
                          "checks": out["checks"],
                          "not_compared": out["not_compared"],
                          "s": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
