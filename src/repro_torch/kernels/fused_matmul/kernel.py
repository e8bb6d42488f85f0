"""Build, load and launch the Hopper fused-epilogue GEMM (``csrc/fused_matmul.cu``).

The CUDA source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/`` at the root
of the checkout (``kernels.build``), and loaded with ``ctypes``.
Importing this module needs no ``nvcc`` and no card; nothing is compiled
until a CUDA tensor reaches :func:`launch`.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..build import BUILD_DIR, build_library  # noqa: F401 (BUILD_DIR: re-export)

MAX_STAGES = 8
DT = {torch.float32: 0, torch.bfloat16: 1}
KIND = {"none": 0, "row": 1, "full": 2}
FN = {name: i for i, name in enumerate(
    ["add", "sub", "mul", "div", "maximum", "minimum", "neg", "exp",
     "square", "tanh", "sigmoid", "relu", "gelu", "silu"])}
CAST = {None: -1, "float32": 0, "bfloat16": 1}

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_matmul.cu"

_lock = threading.Lock()
_lib = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel library (once per source digest) and return its
    path; ``verbose`` prints nvcc's ptxas report to stderr."""
    return build_library(SOURCE, verbose)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.fused_matmul_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
           spec: tuple, operands: list) -> None:
    """Launch the GEMM on the current stream: ``y[m,n] = chain(x[m,k] @
    w[k,n])``.  ``spec`` is the static chain ``((fn, kind, head_pos,
    dtype), ...)`` and ``operands`` the row/full operand tensors in spec
    order; the caller has checked devices, dtypes, shapes and contiguity."""
    if len(spec) > MAX_STAGES:
        raise ValueError(f"epilogue has {len(spec)} stages; the kernel takes "
                         f"at most {MAX_STAGES}")
    m, k = x.shape
    n = w.shape[1]
    codes = (ctypes.c_int * (5 * MAX_STAGES))()
    ptrs = (ctypes.c_void_p * MAX_STAGES)()
    it = iter(operands)
    for s, (fn, kind, head_pos, edt) in enumerate(spec):
        codes[s] = FN[fn]
        codes[MAX_STAGES + s] = KIND[kind]
        codes[2 * MAX_STAGES + s] = int(head_pos)
        codes[3 * MAX_STAGES + s] = CAST[edt]
        if kind != "none":
            op = next(it)
            codes[4 * MAX_STAGES + s] = DT[op.dtype]
            ptrs[s] = op.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().fused_matmul_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, DT[x.dtype],
        DT[y.dtype], len(spec), codes, ptrs, stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul launch failed: CUDA error {err}")
