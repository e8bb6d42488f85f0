"""Build one CUDA source of the port into a shared library with ``nvcc``.

Every Hopper kernel of the port is a ``.cu`` file with a plain C entry
point, compiled for ``sm_90a`` into ``build/`` at the root of the checkout
at first use and loaded with ``ctypes`` by its ``kernel.py``.  Importing
this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

#: <checkout>/build — three levels up from src/repro_torch/kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: nvcc's ``-Xptxas -v`` report of the last verbose build, by source stem
REPORTS: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "their CUDA sources at first use on a CUDA machine")


def build_library(source: Path, verbose: bool = False) -> Path:
    """Compile ``source`` (once per source digest) and return the library's
    path.  ``verbose`` rebuilds with ``-Xptxas -v`` and prints nvcc's report
    (registers, shared memory, spills per kernel) to stderr."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(source)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    if verbose:
        REPORTS[source.stem] = res.stderr
        print(res.stderr, end="", file=sys.stderr)
    os.replace(tmp, out)
    return out
