"""The PyTorch port's examples (examples/torch/) run on the CPU, each in its
own process: the quickstart (the paper's policies on the port's simulator,
20 training steps, 6 served requests) and the elastic-serving driver
(phase A on two gloo ranks, phase B on the port's fleet simulator)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *args: str, timeout: float) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch" / script), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_on_the_cpu():
    out = _run("quickstart.py", "--device", "cpu", timeout=120)
    assert "threshold(60%)" in out and "appdata(+5)" in out
    assert "step  19  loss" in out
    assert "served 6 requests" in out and "on cpu" in out


def test_elastic_serving_on_gloo_ranks():
    out = _run("elastic_serving.py", "--world", "2", timeout=120)
    assert "measured provision delay" in out
    for name in ("threshold60", "target75 ", "target75+appdata"):
        assert name in out
    assert "ROADMAP item 1" in out


@pytest.mark.parametrize("script", ["quickstart.py", "train_losscurve.py", "elastic_serving.py"])
def test_examples_import_no_jax(script):
    """The port's examples, like the port, import neither JAX nor the JAX
    package."""
    import ast
    tree = ast.parse((ROOT / "examples" / "torch" / script).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots
