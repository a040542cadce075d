"""What the benchmark may load and what it refuses: no JAX and nothing of the
JAX package (top-level names compared whole, ``repro_torch`` begins with
``repro``), no result without a card, no result without the program, and
a manifest whose every name has its files."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import run
from bench.spec import BENCH, ROOT, load_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "ml_dtypes", "repro"}
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = _imports(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert run.forbidden_modules() == [] or set(run.forbidden_modules()) <= FORBIDDEN
    assert "reprox" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in run.forbidden_modules()


def _bench_run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "qwen2.5-3b.chat-long",
         "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)


def test_no_card_no_result():
    p = _bench_run(ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout and "CUDA" in p.stderr


def test_without_the_program_no_result(tmp_path):
    """Only BENCHMARK.json and bench/: the run stops where it needs
    repro_torch (here past the look for a card, on the CPU)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json; from bench import run; from bench._small import small_cell; "
            "print(json.dumps(run.run_cell(small_cell('qwen2.5-3b.chat-long'), 1, 1.0, "
            "False, device='cpu')))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode != 0 and "{" not in p.stdout
    assert "repro_torch" in p.stderr


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_has_its_files_and_readers(cell):
    c = load_cell(cell)
    assert cell == f"{c.config_name}.{c.traffic_name}"
    assert any(m.name == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(run.reader(m.name))
    wl = c.workload
    from bench.check import NAMES
    assert wl["limits"] and set(wl["limits"]) <= set(NAMES)
    assert ("rate_per_s" in wl) == (c.loop == "open")
    assert ("backlog_per_s" in wl) == (c.loop == "offline")


def test_manifest_names_and_moves():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
    assert MANIFEST["paths"] == ["bench"]
