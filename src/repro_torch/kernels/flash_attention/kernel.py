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


class PlanBwd(NamedTuple):
    """The backward's route and tiles.  ``route``: ``"wgmma"`` (the TMA +
    wgmma kernels) or ``"fma"`` (plain fp32 FMAs); the dK/dV kernel's unit
    holds ``block_kv`` keys and steps over ``block_q`` query rows at a
    time, for ``heads`` query heads of one K/V group (0: the whole group);
    the dQ kernel's unit holds ``dq_block_q`` query rows and steps over
    ``dq_block_kv`` keys at a time; ``head_pad`` the head dim a tile holds.
    The plain version (``ref.flash_attention_bwd_ref``) reads none of it."""
    route: str
    block_kv: int
    block_q: int
    dq_block_q: int
    dq_block_kv: int
    heads: int
    head_pad: int


@functools.lru_cache(maxsize=None)
def plan_bwd(dtype, d: int) -> PlanBwd:
    """The route and tiles of a backward call with head dim ``d``, never of
    B, Sq or Skv.  bf16: dK/dV units of 128 keys x 2 query heads stepping
    over 64 query rows, dQ units of 128 query rows stepping over 64 keys.
    fp32: 64-key dK/dV blocks over the whole group, 64-row dQ blocks.  The
    kernels state the same tiles (:func:`kernel_tiles_bwd`)."""
    pad = 64 if d <= 64 else 128
    if dtype == torch.bfloat16:
        return PlanBwd("wgmma", 128, 64, 128, 64, 2, pad)
    return PlanBwd("fma", 64, 64, 64, 64, 0, pad)


def bwd_splits(p: PlanBwd, hq: int, hkv: int) -> int:
    """The dK/dV units a K/V tile and head has: its group's query heads in
    runs of ``p.heads``."""
    grp = hq // hkv
    return -(-grp // p.heads) if p.heads else 1


def bwd_scratch(dtype, d: int, b: int, skv: int, hq: int, hkv: int):
    """The shape of the fp32 scratch the backward's dK/dV units write their
    partial sums into, ``(2, splits, B, Skv, Hkv, d)`` (dK's, then dV's;
    ``d`` as the kernels read it), which the wrapper allocates; None for a
    route that needs none."""
    p = plan_bwd(dtype, d)
    if p.route != "wgmma":
        return None
    return (2, bwd_splits(p, hq, hkv), b, skv, hkv, d)


def bwd_units(dtype, d: int, b: int, sq: int, skv: int, hq: int, hkv: int,
              causal: bool) -> tuple:
    """The bf16 backward's units in the order its kernels number their
    blocks (the block scheduler hands them out in that order), each with
    the steps it runs: ``(dkdv, dq)``, ``dkdv`` a list of ``(key tile,
    split, K/V head, batch, steps)`` by key tile ascending (under causal a
    key tile sees the query rows from its own position on: the longest
    first, unless the group is odd, when a tile's last split holds one
    head and may be shorter than the next tile's units), ``dq`` a list of
    ``(query tile, head, batch, steps)`` from the last query tile down."""
    p = plan_bwd(dtype, d)
    grp = hq // hkv
    q_off = skv - sq if causal else 0
    n_q = -(-sq // p.block_q)
    dkdv = []
    for kt in range(-(-skv // p.block_kv)):
        qt0 = max(0, kt * p.block_kv - q_off) // p.block_q if causal else 0
        for split in range(bwd_splits(p, hq, hkv)):
            heads = min(p.heads, grp - split * p.heads)
            for hk in range(hkv):
                for bi in range(b):
                    dkdv.append((kt, split, hk, bi, heads * (n_q - qt0)))
    dq = []
    n_dq = -(-sq // p.dq_block_q)
    for qt in range(n_dq - 1, -1, -1):
        last = min((qt + 1) * p.dq_block_q, sq) - 1
        end = min(skv, q_off + last + 1) if causal else skv
        for bh in range(hq * b):
            dq.append((qt, bh % hq, bh // hq, -(-end // p.dq_block_kv)))
    return dkdv, dq


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
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            tiles = lib.flash_attention_bwd_tiles
            tiles.argtypes = [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)]
            tiles.restype = ctypes.c_int
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


def kernel_tiles_bwd(dtype, d: int) -> PlanBwd:
    """The route and tiles the built backward launches at head dim ``d``
    (``flash_attention_bwd_tiles``), to hold against :func:`plan_bwd`."""
    out = (ctypes.c_int * 6)()
    err = library_bwd().flash_attention_bwd_tiles(DT[dtype], d, out)
    if err != 0:
        raise ValueError(f"flash_attention_bwd_tiles: CUDA error {err}")
    return PlanBwd("wgmma" if dtype == torch.bfloat16 else "fma", *out)


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


def launch_bwd(q, k, v, o, do, lse, delta, dkv_acc, dq, dk, dv,
               causal: bool, scale: float) -> None:
    """Launch the backward on the current stream: ``delta`` (fp32 ``[B, Hq,
    Sq]`` scratch) = rowsum(do * o), then dk, dv and dq (contiguous, in the
    operands' dtype) from q, k, v, o, do (``[B, S, H, D]`` through their
    strides, rows of 16-byte pieces: ``tma_operand``) and the forward's
    ``lse``; scores scaled by ``scale`` = 1 / sqrt(D).  ``dkv_acc`` is the
    fp32 scratch of :func:`bwd_scratch` (None where the route needs none).
    The caller has checked devices, dtypes and shapes."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    strd = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, o, do)
                                      for s in strides(t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library_bwd().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if dkv_acc is None else dkv_acc.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), DT[q.dtype], b, sq, skv, hq, hkv, d,
        strd, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
