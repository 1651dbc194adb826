"""On the card: a short run of each cell through the benchmark's command,
with the result line's keys. Marked `cuda`; skips without a card."""
import json
import os
import subprocess
import sys

import pytest

from nerfbench import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["viewmlp-eval", "semantic-eval",
                                  "viewmlp-train"])
def test_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "nerfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 5), "--seconds", "5", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"] and "peak_mem_gib" in line["metrics"]


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "nerfbench/run.py", "--workload", "viewmlp-eval",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
