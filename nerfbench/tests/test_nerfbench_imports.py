"""The import rule: nothing under nerfbench/ imports JAX, the JAX package
or its harness (top-level names compared whole: the port's name begins
with the JAX package's), nor reads the JAX harness's files; the reference
imports nothing of the port."""
import ast
import os
import subprocess
import sys

from nerfbench import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "sgnerf_tpu", "bench"}


def sources():
    for d, _, fs in os.walk(HERE):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every module a file imports (relative imports
    resolve inside nerfbench)."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("nerfbench" if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_top_level_names_are_compared_whole():
    assert "sgnerf_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "sgnerf_tpu.ops".split(".")[0] in FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        bad = imported(path) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = imported(os.path.join(ref, f))
            assert "sgnerf_tpu_torch" not in names, f
            assert names <= {"__future__", "math", "typing", "numpy",
                             "torch", "nerfbench"}, (f, names)


def test_no_source_reads_the_jax_harness_files():
    for path in sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        text = open(path).read()
        for name in ("bench.py", "BENCH_r", "MULTICHIP_", "BASELINE.json"):
            assert name not in text, (path, name)


def test_a_process_that_loads_the_harness_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import nerfbench.harness, nerfbench.trace, nerfbench.faults\n"
        "import nerfbench.drivers.eval_frames, nerfbench.drivers.train_steps\n"
        "import nerfbench.reference.train, sgnerf_tpu_torch.runtime.scene_model\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % (harness.ROOT, FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
