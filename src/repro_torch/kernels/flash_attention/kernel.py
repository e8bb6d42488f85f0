"""Build, load and launch the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

Compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at first use
(``kernels.build``) and loaded with ``ctypes``.  Importing this module needs
no ``nvcc`` and no card; nothing is compiled until a CUDA tensor reaches
:func:`launch`.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from ..build import build_library

DT = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim the kernel was built for
MAX_HEAD_DIM = 128
#: TMA rows: head dims and strides a multiple of 16 bytes, 8 bf16 elements
ALIGN = 8

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: the backward's kernels (delta, dK/dV, dQ), a library of their own
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"


class Plan(NamedTuple):
    """One launch's route and tiles.  ``route``: ``"wgmma"`` (the TMA +
    wgmma kernel) or ``"fma"`` (plain fp32 FMAs); ``block_q`` query rows
    per block; ``block_kv`` keys per K/V tile, the tile the online softmax
    steps over (``ref.flash_attention_ref`` steps over the same);
    ``head_pad`` the head dim a tile holds (D zero-padded to it);
    ``base2``: scores are scaled by ``log2(e) / sqrt(D)`` and exponentiated
    in base 2 (one hardware ``ex2`` each), else by ``1 / sqrt(D)`` and
    ``expf``."""
    route: str
    block_q: int
    block_kv: int
    head_pad: int
    base2: bool


@functools.lru_cache(maxsize=None)
def plan(dtype, d: int) -> Plan:
    """The route and tiles of an attention call with head dim ``d``.  It
    takes no batch or length: a query row's K/V tiles are the same set in
    the same order whatever B, Sq or Skv are, so its result is bitwise the
    same whether 1 or 4096 rows run.  bf16: 128 x 128 tiles, the head dim in
    64-column TMA boxes (the JAX reference's own block_kv, 128).  Every
    other dtype: the fp32 FMA kernel's 64 x 64 tiles, the head dim padded
    to 32, 64 or 128.  A bf16 layout TMA cannot address is copied into one
    it can first (:func:`tma_operand`), so it takes the same route.  The
    kernel states the same tiles (:func:`kernel_tiles`)."""
    if dtype == torch.bfloat16:
        return Plan("wgmma", 128, 128, 64 if d <= 64 else 128, True)
    return Plan("fma", 64, 64, 32 if d <= 32 else 64 if d <= 64 else 128,
                False)


def score_scale(dtype, d: int) -> float:
    """The factor the route multiplies ``q . k`` by (see ``Plan.base2``);
    the plain version multiplies by the same."""
    scale = 1.0 / math.sqrt(d)
    return scale * math.log2(math.e) if plan(dtype, d).base2 else scale


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t [B, S, H, D]`` with rows of whole 16-byte pieces, as the bf16
    route's TMA boxes and the backward's ``cp.async`` copies read it:
    itself when it is so (the head dim contiguous, D and every stride of a
    dim longer than 1 a multiple of 16 bytes, the base 16-byte aligned),
    else a contiguous copy whose head dim is zero-padded to the next
    multiple of 16 bytes (a zero column adds nothing to a score or a
    delta, and the padded output columns are dropped).  A function of D,
    the dtype and alignment alone."""
    per = 16 // t.element_size()
    d = t.shape[-1]
    dp = -(-d // per) * per
    if (dp == d and t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in strides(t))):
        return t
    out = t.new_zeros(t.shape[:-1] + (dp,))
    out[..., :d] = t
    return out


def strides(t: torch.Tensor) -> tuple:
    """``t``'s (batch, position, head) strides in elements, a dim of size 1
    given its contiguous stride (its one coordinate is 0, so the value is
    never used; TMA still wants a multiple of 16 bytes)."""
    contig = (math.prod(t.shape[1:]), math.prod(t.shape[2:]), t.shape[3])
    return tuple(s if n > 1 else c
                 for n, s, c in zip(t.shape[:3], t.stride()[:3], contig))


_lock = threading.Lock()
_lib = None
_lib_bwd = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel library (once per source digest) and return its
    path; ``verbose`` prints nvcc's ptxas report to stderr."""
    return build_library(SOURCE, verbose)


def build_bwd(verbose: bool = False) -> Path:
    """Compile the backward's library (once per source digest)."""
    return build_library(SOURCE_BWD, verbose)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.flash_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            tiles = lib.flash_attention_tiles
            tiles.argtypes = [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)]
            tiles.restype = ctypes.c_int
            _lib = lib
    return _lib


def library_bwd() -> ctypes.CDLL:
    """The loaded backward library (built on first call)."""
    global _lib_bwd
    with _lock:
        if _lib_bwd is None:
            lib = ctypes.CDLL(str(build_bwd()))
            fn = lib.flash_attention_bwd_launch
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib_bwd = lib
    return _lib_bwd


def kernel_tiles(dtype, d: int) -> Plan:
    """The route and tiles the built kernel itself launches at head dim
    ``d`` (``flash_attention_tiles``), as a :class:`Plan` to hold against
    :func:`plan`."""
    out = (ctypes.c_int * 4)()
    err = library().flash_attention_tiles(DT[dtype], d, out)
    if err != 0:
        raise ValueError(f"flash_attention_tiles: CUDA error {err}")
    return Plan("wgmma" if dtype == torch.bfloat16 else "fma", out[0],
                out[1], out[2], bool(out[3]))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, causal: bool, scale: float,
           lse: torch.Tensor = None) -> None:
    """Launch on the current stream: ``o = attention(q, k, v)`` with q
    ``[B,Sq,Hq,D]`` and k/v ``[B,Skv,Hkv,D]`` read through their strides
    (the head dim contiguous), scores scaled by ``scale``, and ``o``
    contiguous ``[B,Sq,Hq,D]``; with ``lse`` (fp32 ``[B, Hq, Sq]``) also
    each row's natural log-sum-exp.  The caller has checked devices,
    dtypes and shapes, and made bf16 operands TMA-addressable."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    strd = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                     for s in strides(t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), DT[q.dtype],
        b, sq, skv, hq, hkv, d, strd, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")


def launch_bwd(q, k, v, o, do, lse, delta, dq, dk, dv, causal: bool,
               scale: float) -> None:
    """Launch the backward on the current stream: ``delta`` (fp32 ``[B, Hq,
    Sq]`` scratch) = rowsum(do * o), then dk, dv and dq (contiguous, in the
    operands' dtype) from q, k, v, o, do (``[B, S, H, D]`` through their
    strides, rows of 16-byte pieces: ``tma_operand``) and the forward's
    ``lse``; scores scaled by ``scale`` = 1 / sqrt(D).  The caller has
    checked devices, dtypes and shapes."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    strd = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, o, do)
                                      for s in strides(t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library_bwd().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), DT[q.dtype], b, sq, skv, hq, hkv, d, strd,
        int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
