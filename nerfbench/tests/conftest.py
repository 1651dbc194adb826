"""Shared set-up of the benchmark's own tests: the repository root on the
path, and a tiny size at which a whole run of a cell fits on the CPU."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(bench, workload):
    """Overrides that shrink a cell to a CPU test: 20,000 points, 32 mm
    voxels (the room's grid and neighbour cache an eighth of the size), a
    24x18 frame in one chunk, 128-ray steps; the eval cells take the K1
    select's plain statement (`--knn_mode fused` on the CPU), as the card
    runs K1."""
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    sec = "train" if bench.traffic(cell["traffic"])["kind"] == "train_steps" \
        else "eval"
    flags = list(cfg[sec]["flags"]) + ["--vsize", "0.032", "0.032", "0.032"] \
        + (["--knn_mode", "fused"] if sec == "eval" else [])
    ref = dict(cfg[sec]["ref"], vsize=[0.032] * 3)
    return {"config": {"scene": {"n_points": 20000},
                       sec: {"flags": flags, "ref": ref}},
            "traffic": {"width": 24, "height": 18, "focal": 22.0,
                        "chunk_rays": 432, "views": 3, "rays": 128}}


@pytest.fixture(scope="session")
def bench():
    from nerfbench import harness
    return harness.Bench()
