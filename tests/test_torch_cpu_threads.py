"""The port's float parity tests run PyTorch on one CPU thread
(`tests/torch_threads.py`): with the BLAS's thread split fixed, the plain
versions give the same bits in every process, so a parity check passes or
fails the same way in every run."""
import ast
import glob
import os

import pytest
import torch

from torch_threads import one_thread

HERE = os.path.dirname(os.path.abspath(__file__))


def _imports(path):
    """Top-level imported module names of a test file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


PARITY_FILES = sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(HERE, "test_torch_*.py"))
    if any(n == "jax" or n.split(".")[0] == "sgnerf_tpu"
           for n in _imports(p)))


def test_the_parity_files_are_found():
    assert {"test_torch_fused_agg_bwd.py",
            "test_torch_fused_color.py"} <= set(PARITY_FILES)


@pytest.mark.parametrize("name", PARITY_FILES)
def test_parity_file_pins_one_cpu_thread(name):
    """Every test file that runs the JAX package beside the port takes the
    fixture, which pins the thread count for its whole module."""
    assert "torch_threads.one_cpu_thread" in _imports(os.path.join(HERE,
                                                                   name))


def test_one_thread_pins_the_count_and_restores_it():
    n = torch.get_num_threads()
    try:
        torch.set_num_threads(3)
        with one_thread():
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == 3
        with pytest.raises(RuntimeError):
            with one_thread():
                raise RuntimeError
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(n)

