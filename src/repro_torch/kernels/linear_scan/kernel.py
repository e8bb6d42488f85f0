"""Build, load and launch the Hopper chunked linear-scan kernel
(``csrc/linear_scan.cu``) and its backward (``csrc/linear_scan_bwd.cu``,
a library of its own).

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
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "linear_scan_bwd.cu"

_lock = threading.Lock()
_lib = None
_lib_bwd = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel library (once per source digest) and return its
    path; ``verbose`` prints nvcc's ptxas report to stderr."""
    return build_library(SOURCE, verbose)


def build_bwd(verbose: bool = False) -> Path:
    """Compile the backward's library; as :func:`build`."""
    return build_library(SOURCE_BWD, verbose)


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


def library_bwd() -> ctypes.CDLL:
    """The loaded backward library (built on first call)."""
    global _lib_bwd
    with _lock:
        if _lib_bwd is None:
            lib = ctypes.CDLL(str(build_bwd()))
            fn = lib.linear_scan_bwd_launch
            fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib_bwd = lib
    return _lib_bwd


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


def launch_bwd(q, k, v, w, u, do, chunk: int, s0, ds1, ws, dup, dq, dk, dv,
               dw, du, ds0) -> None:
    """Launch the backward on the current stream.  q/k/w ``[B,S,H,Dk]``,
    v and ``do`` ``[B,S,H,Dv]`` are read through their strides (the last
    dim contiguous); u ``[H, Dk]``, ``s0`` (the initial carry) and ``ds1``
    (the final carry's cotangent) fp32 contiguous or None; ``ws`` fp32
    contiguous ``[2, B, H, N, Dk, Dv]`` scratch (each chunk's starting
    carry, then the gradient of its final one; N chunks of ``chunk``
    rows), ``dup``
    fp32 ``[B, H, N, Dk]`` scratch for du's partials (None without u);
    dq/dk/dv contiguous in q/k/v's dtype, dw contiguous fp32, du ``[H,
    Dk]`` and ds0 ``[B,H,Dk,Dv]`` fp32 or None, all written.  The caller
    has checked devices, dtypes and shapes."""
    b, s, h, dk_ = q.shape
    dv_ = v.shape[-1]
    strides = (ctypes.c_longlong * 15)(*(
        st for t in (q, k, v, w, do) for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = library_bwd().linear_scan_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), ptr(u),
        do.data_ptr(), ptr(s0), ptr(ds1), ws[0].data_ptr(),
        ws[1].data_ptr(), ptr(dup), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), ptr(du), ptr(ds0), DT[v.dtype],
        b, s, h, dk_, dv_, chunk, int(u is not None), strides, stream)
    if err != 0:
        raise RuntimeError(f"linear_scan backward launch failed: CUDA "
                           f"error {err}")
