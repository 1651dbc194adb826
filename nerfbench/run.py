"""Run one cell of the benchmark of the PyTorch port on this machine's card.

    python3 nerfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` `breakdown`,
then the numbers compared, each beside its limit (`checks`, last; also the
last lines of standard error). Exits non-zero, printing no result, without
a CUDA card, or when JAX or the JAX package was loaded. Build caches stay
under `build/` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HOST_THREADS = 2


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def main(argv=None) -> int:
    t_start = process_start()
    # one process on the card with few host threads: steadier host timing
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    build = os.path.join(root, "build")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(build, sub)
    sys.path.insert(0, root)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(HOST_THREADS)
    from nerfbench import harness
    bench = harness.Bench(root, here)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"nerfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start, bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"nerfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
