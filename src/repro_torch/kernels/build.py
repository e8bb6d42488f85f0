"""Build one CUDA source of the port into a shared library with ``nvcc``.

Every Hopper kernel of the port is a ``.cu`` file with a plain C entry
point, compiled for ``sm_90a`` into ``build/`` at the root of the checkout
at first use and loaded with ``ctypes`` by its ``kernel.py``.  Importing
this module needs no ``nvcc`` and no card.
"""
from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

#: <checkout>/build — three levels up from src/repro_torch/kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: the kernels' package: each kernel's sources are ``<kernel>/csrc/*.cu*``
KERNELS_DIR = Path(__file__).resolve().parent

#: nvcc's ``-Xptxas -v`` report of the last verbose build, by source stem
REPORTS: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "their CUDA sources at first use on a CUDA machine")


def build_library(source: Path, verbose: bool = False,
                  defines: tuple = ()) -> Path:
    """Compile ``source`` (once per digest of it, the ``*.cuh`` headers
    beside it, which it may include, and ``defines``, each passed as
    ``-D``) and return the library's path.  ``verbose`` rebuilds with
    ``-Xptxas -v`` and prints nvcc's report (registers, shared memory,
    spills per kernel) to stderr."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    for name in defines:
        h.update(f"-D{name}".encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(source)] + [f"-D{name}" for name in defines]
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


@functools.lru_cache(maxsize=None)
def source_digest(root: Path = KERNELS_DIR) -> str:
    """sha256 over every ``.cu`` / ``.cuh`` under ``root/*/csrc`` (path
    relative to ``root``, then bytes, in sorted order): the kernels' source
    identity, part of every on-disk program cache key, so an entry written
    before a kernel edit misses after it.  Computed once a process."""
    h = hashlib.sha256()
    for path in sorted(p for p in root.glob("*/csrc/*")
                       if p.suffix in (".cu", ".cuh")):
        rel = path.relative_to(root).as_posix().encode()
        data = path.read_bytes()
        h.update(f"{len(rel)}:".encode() + rel + f"{len(data)}:".encode())
        h.update(data)
    return h.hexdigest()
