"""The PyTorch port's import boundary: nothing under src/repro_torch/ and
nothing in chip_smoke.py imports JAX, ml_dtypes or the JAX package, and the
numpy-only control plane and data pipeline copied from the JAX package stay
verbatim copies (``repro_torch.`` for ``repro.``), so the two cannot drift
silently."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
JAX_PKG = ROOT / "src" / "repro"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}
COPIED = ("core/__init__.py", "core/scaling", "core/autoscaler", "core/convergence",
          "core/simulator", "core/chaos", "core/signals", "utils",
          "core/elastic/__init__.py", "core/elastic/cluster.py", "data/pipeline.py")
# The one port-written file under core/: the JAX module rebuilds a device
# mesh and reshards through jax and repro.distributed.sharding; the port's
# rebuilds a torch DeviceMesh and reshards through
# repro_torch.distributed.sharding.  It keeps the five names the JAX module
# exports, so core/elastic/__init__.py stays a verbatim copy (the MoE
# expert-parallel layout that remains is ROADMAP.md Queue 1 item 8b).
PORT_WRITTEN = ("core/elastic/remesh.py",)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists(), path
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _copied_files():
    out = []
    for entry in COPIED:
        p = PORT / entry
        out += sorted(p.glob("*.py")) if p.is_dir() else [p]
    return out


@pytest.mark.parametrize("path", _copied_files(), ids=lambda p: str(p.relative_to(PORT)))
def test_control_plane_copy_is_verbatim(path):
    src = JAX_PKG / path.relative_to(PORT)
    assert src.exists(), f"{src} vanished: the copy has no reference"
    back = re.sub(r"\brepro_torch\.", "repro.", path.read_text())
    assert back == src.read_text(), f"{path.relative_to(ROOT)} drifted from {src.relative_to(ROOT)}"


def test_every_control_plane_module_is_copied():
    for entry in COPIED[1:]:
        if (JAX_PKG / entry).is_dir():
            names = {p.name for p in (JAX_PKG / entry).glob("*.py")}
            assert names == {p.name for p in (PORT / entry).glob("*.py")}, entry


def test_core_is_copied_but_for_the_port_written_remesh():
    """Every module under the JAX package's core/ has its counterpart in the
    port, and each is a checked verbatim copy except PORT_WRITTEN."""
    def rel(root):
        return {str(p.relative_to(root)) for p in (root / "core").rglob("*.py")}
    assert rel(PORT) == rel(JAX_PKG)
    copied = {str(p.relative_to(PORT)) for p in _copied_files()}
    assert rel(PORT) - copied == set(PORT_WRITTEN)
    assert not copied & set(PORT_WRITTEN)
