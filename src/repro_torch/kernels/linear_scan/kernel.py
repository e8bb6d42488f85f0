"""Build, load and launch the Hopper chunked linear-scan kernel
(``csrc/linear_scan.cu``).

Compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at first use
(``kernels.build``) and loaded with ``ctypes``.  Importing this module needs
no ``nvcc`` and no card; nothing is compiled until a CUDA tensor reaches
:func:`launch`.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..build import build_library

DT = {torch.float32: 0, torch.bfloat16: 1}
#: the largest key dim the kernel was built for (bf16 pads Dk to 64, fp32
#: to 16, 32 or 64)
MAX_DK = 64

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"

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
            fn = lib.linear_scan_launch
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u, o: torch.Tensor, chunk: int,
           s0=None, s1=None) -> None:
    """Launch on the current stream: ``o = scan(q, k, v, w, u)`` with
    q/k/w ``[B,S,H,Dk]`` and v ``[B,S,H,Dv]`` read through their strides
    (the last dim contiguous), u ``[H, Dk]`` fp32 contiguous or None, and
    ``o`` contiguous ``[B,S,H,Dv]``; ``chunk`` is ``min(chunk, S)``.  ``s0``
    (the initial carry) and ``s1`` (the final carry) are fp32 contiguous
    ``[B,H,Dk,Dv]`` or None.  The caller has checked devices, dtypes and
    shapes."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (q, k, v, w) for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().linear_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        None if u is None else u.data_ptr(),
        None if s0 is None else s0.data_ptr(),
        None if s1 is None else s1.data_ptr(), o.data_ptr(), DT[v.dtype],
        b, s, h, dk, dv, chunk, int(u is not None), strides, stream)
    if err != 0:
        raise RuntimeError(f"linear_scan launch failed: CUDA error {err}")
