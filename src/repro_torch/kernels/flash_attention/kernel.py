"""Build, load and launch the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

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
#: the largest head dim the kernel was built for (it pads D to 32, 64, 128)
MAX_HEAD_DIM = 128

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

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
            fn = lib.flash_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, causal: bool) -> None:
    """Launch on the current stream: ``o = attention(q, k, v)`` with q
    ``[B,Sq,Hq,D]`` and k/v ``[B,Skv,Hkv,D]`` read through their strides
    (the head dim contiguous) and ``o`` contiguous ``[B,Sq,Hq,D]``.  The
    caller has checked devices, dtypes and shapes."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 9)(*(
        s for t in (q, k, v) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), DT[q.dtype],
        b, sq, skv, hq, hkv, d, strides, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
