"""A whole run of each cell on the CPU at a tiny size, the chip's look
skipped: the program as it is comes out correct; the control (the
reference at the precision below the stated one in the program's place)
and each fault that a cell can have, planted under the timed path, come
out not correct. The limits are the cells' own (checks/<cell>.json)."""
import pytest
import torch

from conftest import tiny
from nerfbench import faults, harness

CONTROL = {"viewmlp-eval": "tf32", "semantic-eval": "fp8",
           "viewmlp-train": "tf32"}
CELLS = list(CONTROL)
FAULTS = [(c, f) for c in CELLS for f in sorted(faults.FAULTS[
    "train_steps" if c.endswith("train") else "eval_frames"])]
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(bench, cell, **kw):
    return harness.run_cell(cell, SEED, 0.5, False, "cpu", bench=bench,
                            overrides=tiny(bench, cell), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(bench, cell):
    out = run(bench, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    out = run(bench, cell, control=CONTROL[cell])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(bench, cell, fault):
    kind = "train_steps" if cell.endswith("train") else "eval_frames"
    out = run(bench, cell, fault=faults.FAULTS[kind][fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_trace_run_reports_the_cells_per_layer_metrics(bench, cell):
    out = harness.run_cell(
        cell, SEED, 0.5, True, "cpu", bench=bench,
        overrides=tiny(bench, cell))
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert "breakdown" in out and len(out["breakdown"]["idle_gaps"]) <= 10
    # a CPU run holds no device time: no device metric is reported
    assert set(out["metrics"]) == {"scene_build_s"}
