"""Build patched copies of a kernel source beside the production one: the
shared builder of the ``tools/*_variants.py`` scripts.

A variant is the production source with text patches applied, each an
``(old, new)`` pair whose ``old`` must still match.  :func:`build` starts one
``nvcc`` per variant, all together, with the production flags
(``repro_torch.kernels.build.NVCC_FLAGS``), into ``build/<name>/``, and
loads each library with ctypes.  Needs ``nvcc``; the caller puts ``src/`` on
the path (importing ``chip_smoke`` does).
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def patched(source: str, patches, label: str = "") -> str:
    """``csrc/<source>.cu`` with every ``(old, new)`` of ``patches`` applied."""
    text = (CSRC / f"{source}.cu").read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {label}: patch {old[:60]!r} no longer matches "
                               f"csrc/{source}.cu")
        text = text.replace(old, new)
    return text


def build(out: str, sources: dict) -> dict:
    """nvcc of every source text at once into ``build/<out>/``; name -> its
    ctypes library."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    out_dir = ROOT / "build" / out
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name.replace(' ', '_')}.cu"
        cu.write_text(text)
        lib = cu.with_name(f"lib{cu.stem}.so")
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs
