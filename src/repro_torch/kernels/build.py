"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``lib<name>.so`` under
``build/repro_torch/<hash>/`` at the repository root, where ``<hash>`` covers
every source and the flags: an edited source builds anew, an unchanged one
loads from disk.  :func:`build_all` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("paged_mixed_attention", "lmhead_greedy", "paged_decode_attention",
           "flash_attention", "ssd_intra", "dense_decode_attention", "greedy_epilogue")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library in parallel; returns name -> .so path.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``lib<name>.log``.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {n: out_dir / f"lib{n}.so" for n in names}
    procs = {}
    for n, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".so.{os.getpid()}.tmp")
        with open(lib.with_suffix(".log"), "w") as log:
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        if proc.wait() != 0:
            failed.append(n)
            continue
        os.replace(tmp, libs[n])      # atomic: a concurrent loader sees all or nothing
    if failed:
        logs = "\n".join(libs[n].with_suffix(".log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building it first if needed."""
    return ctypes.CDLL(str(build_all((name,))[name]))


__all__ = ["SOURCES", "build_all", "load"]
