"""Build, load and launch the Hopper fused-epilogue GEMM (``csrc/fused_matmul.cu``).

The CUDA source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/`` at the root
of the checkout (``kernels.build``), and loaded with ``ctypes``.
Importing this module needs no ``nvcc`` and no card; nothing is compiled
until a CUDA tensor reaches :func:`launch`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

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

BK = 64        #: the bf16 route's k tile (one 128-byte swizzle row)
SMS = 132      #: streaming multiprocessors of an H100 SXM
MAX_SPLIT = 8  #: blocks in a cluster (the portable limit)
ALIGN = 8      #: TMA rows: a multiple of 16 bytes, 8 bf16 elements


class Plan(NamedTuple):
    """One launch's tile plan.  ``bn``: output columns per block;
    ``split``: blocks of one cluster that share the k range, their partial
    sums added in rank order; ``stages``: TMA ring depth (0: the fp32 FMA
    kernel, which has no ring)."""
    bn: int
    split: int
    stages: int


@functools.lru_cache(maxsize=None)
def plan(n: int, k: int, dtype) -> Plan:
    """The tile plan of an ``[m, k] @ [k, n]`` product.  It takes no m:
    every output element sees the same k ranges and the same instruction
    sequence at every m, so a row's result is bitwise the same whether 1 or
    4096 rows run.

    bf16, chosen from a sweep of plans at the full-width paths' shapes on
    the H100 (``chip_smoke.py --gemm-times ... --plan``): 256-column tiles
    where the weight is 4096 or more on a side, 128 for the 2048-wide
    projections and shallow k, 64 for n <= 64.  k is split between the
    blocks of a cluster only where one block would walk more than 8192 of
    k (qwen wd, RWKV wcv) or the output is a single tile (RWKV wA): on the
    other shapes a split costs the m = 4096 forward more than it gains at
    decode.  Each rank of a split keeps at least 16 whole k tiles (64 where
    there are several output tiles).  fp32: the FMA kernel's fixed 64x64
    tile."""
    if dtype == torch.float32:
        return Plan(64, 1, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_matmul kernel takes float32/bfloat16, "
                         f"got {dtype}")
    if n <= 64:
        bn = 64
    elif max(n, k) >= 4096 and k >= 256:
        bn = 256
    else:
        bn = 128
    n_tiles = -(-n // bn)
    k_tiles = -(-k // BK)
    min_tiles = 16 if n_tiles == 1 else 64   # k tiles each rank keeps
    split = 1
    while (split < MAX_SPLIT and n_tiles * split * 2 <= SMS
           and k_tiles >= 2 * split * min_tiles):
        split *= 2
    return Plan(bn, split, 4 if bn == 256 else 6)


def pad_cols(t: torch.Tensor) -> torch.Tensor:
    """``t [r, c]`` as a TMA operand: itself when its rows are a multiple
    of ``ALIGN`` elements and its base is 16-byte aligned, else a copy
    whose columns are zero-padded to the next multiple of ``ALIGN`` (a
    function of ``c`` alone).  ``pad_cols(t)[:, :c]`` equals ``t``."""
    r, c = t.shape
    cp = -(-c // ALIGN) * ALIGN
    if cp == c and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((r, cp))
    out[:, :c] = t
    return out


def tma_operands(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """``(x, w, k)`` as the bf16 route launches them: ``x [m, k]`` and
    ``w [k, n]`` through :func:`pad_cols`, and the k the kernel walks.  An
    empty k becomes one ``ALIGN``-wide slice of zeros (TMA takes no empty
    box), so the product stays ``x @ w`` exactly: zeros, as the padded k
    columns of x meet the rows of w past k, which TMA reads as zeros."""
    m, k = x.shape
    if k == 0:
        x, w, k = (x.new_zeros((m, ALIGN)),
                   w.new_zeros((ALIGN, w.shape[1])), ALIGN)
    return pad_cols(x), pad_cols(w), k


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
                           ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, m: int,
           n: int, k: int, p: Plan, spec: tuple, operands: list,
           ta: bool = False, tb: bool = False) -> None:
    """Launch the GEMM on the current stream: ``y[m,n] = chain(A @ B)``
    with A = ``x[:m, :k]`` (with ``ta``: x stored ``[k, m]``, A =
    ``x[:k, :m]^T``) and B = ``w[:k, :n]`` (with ``tb``: w stored ``[n,
    k]``, B = ``w[:n, :k]^T``).  x and w are row-major buffers whose rows
    may be longer than the stored width (``pad_cols``); ``p`` is ``plan(n,
    k, dtype)``.  ``spec`` is the static chain ``((fn, kind, head_pos,
    dtype), ...)`` and ``operands`` the row/full operand tensors in spec
    order; the caller has checked devices, dtypes, shapes and
    contiguity."""
    if len(spec) > MAX_STAGES:
        raise ValueError(f"epilogue has {len(spec)} stages; the kernel takes "
                         f"at most {MAX_STAGES}")
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
        x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, x.shape[1],
        w.shape[1], int(ta), int(tb), DT[x.dtype], DT[y.dtype], p.bn,
        p.split, p.stages,
        len(spec), codes, ptrs, stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul launch failed: CUDA error {err}")
