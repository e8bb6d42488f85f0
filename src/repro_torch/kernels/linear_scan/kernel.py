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
from typing import NamedTuple

import torch

from ..build import build_library

DT = {torch.float32: 0, torch.bfloat16: 1}
#: the largest key dim the kernel was built for (bf16 pads Dk to 64, fp32
#: to 16, 32 or 64)
MAX_DK = 64

#: the bf16 backward's checkpoint interval: its chains store the carry
#: every BWD_GROUP chunks, and each chunk block recomputes the carries of
#: its group from there (the kernel takes 1 .. 4: room for 3 neighbours)
BWD_GROUP = 4

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


def library_bwd(defines: tuple = ()) -> ctypes.CDLL:
    """The loaded backward library (built on first call).  ``defines``
    builds a variant (``-D`` each, e.g. ``SCAN_BWD_PHASES``, a measurement
    build) and loads it in the library's place."""
    global _lib_bwd
    with _lock:
        if _lib_bwd is None or defines:
            lib = ctypes.CDLL(str(build_library(SOURCE_BWD,
                                                defines=tuple(defines))))
            fn = lib.linear_scan_bwd_launch
            fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
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


class PlanBwd(NamedTuple):
    """The backward's route and checkpoint interval: its chains store the
    carry and its gradient every ``group`` chunks."""
    route: str    # "mma" (bf16: tensor cores) or "fma" (fp32 FMAs)
    group: int


def plan_bwd(dtype) -> PlanBwd:
    """bf16: the tensor-core kernels, a checkpoint every BWD_GROUP chunks;
    fp32: the FMA kernels, which keep every chunk's carries (group 1).  A
    function of the dtype alone, so a row's sums never depend on B or S."""
    if dtype == torch.bfloat16:
        return PlanBwd("mma", BWD_GROUP)
    return PlanBwd("fma", 1)


def bwd_scratch(dtype, b: int, s: int, h: int, dk: int, dv: int,
                chunk: int) -> tuple:
    """The shape of the fp32 workspace the wrapper allocates for a backward
    call, ``(2, B, H, NG, Dk, Dv)``: for each of the ``NG = ceil(N /
    group)`` groups of ``chunk``-row chunks (``chunk`` at most S) the carry
    entering its first chunk, then the gradient of the one leaving its
    last."""
    n = -(-s // min(chunk, s))
    return (2, b, h, -(-n // plan_bwd(dtype).group), dk, dv)


def launch_bwd(q, k, v, w, u, do, chunk: int, s0, ds1, ws, dup, dq, dk, dv,
               dw, du, ds0) -> None:
    """Launch the backward on the current stream.  q/k/w ``[B,S,H,Dk]``,
    v and ``do`` ``[B,S,H,Dv]`` are read through their strides (the last
    dim contiguous); u ``[H, Dk]``, ``s0`` (the initial carry) and ``ds1``
    (the final carry's cotangent) fp32 contiguous or None; ``ws`` fp32
    contiguous scratch of :func:`bwd_scratch`'s shape (the checkpoints of
    :func:`plan_bwd`'s group), ``dup`` fp32 ``[B, H, N, Dk]`` scratch for
    du's partials (None without u; N chunks of ``chunk`` rows); dq/dk/dv
    contiguous in q/k/v's dtype, dw contiguous fp32, du ``[H, Dk]`` and ds0
    ``[B,H,Dk,Dv]`` fp32 or None, all written.  The caller has checked
    devices, dtypes and shapes."""
    b, s, h, dk_ = q.shape
    dv_ = v.shape[-1]
    group = plan_bwd(v.dtype).group
    want = bwd_scratch(v.dtype, b, s, h, dk_, dv_, chunk)
    if tuple(ws.shape) != want or not ws.is_contiguous():
        raise ValueError(f"linear_scan_bwd: scratch {tuple(ws.shape)}, the "
                         f"plan wants {want} contiguous")
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
        b, s, h, dk_, dv_, chunk, int(u is not None), group, strides, stream)
    if err != 0:
        raise RuntimeError(f"linear_scan backward launch failed: CUDA "
                           f"error {err}")
