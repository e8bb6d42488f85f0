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
import math
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
SPLIT_K_TILES = 128  #: k tiles a bf16 block walks at most before k splits
ALIGN = 8      #: TMA rows: a multiple of 16 bytes, 8 bf16 elements

#: the fp32 route's tiles (``csrc/fused_matmul.cu``'s F32_TILE_LIST, in
#: order): (BM, BN) outputs a block, BK the k depth of one ring stage, TM x
#: TN outputs a thread
F32_TILES = ((64, 64, 32, 4, 4), (32, 32, 32, 4, 4))
F32_STAGES = 2     #: the fp32 route's cp.async ring depth (double buffering)
F32_STEP = 64      #: a rank's k range is whole steps of this (every BK)
F32_MIN_K = 32     #: k each rank of an fp32 split keeps, the last included
F32_MAX_SPLIT = 128  #: ranks at most (bounds the workspace)


class Plan(NamedTuple):
    """One launch's tile plan.  bf16: ``bn`` output columns per block;
    ``split`` blocks of one cluster that share the k range, their partial
    sums added in rank order; ``stages`` the TMA ring depth.  fp32: ``bn``
    is 0 (the tile follows m and n: :func:`f32_tile`), ``split`` the ranks
    over k (:func:`k_ranges`), ``stages`` the cp.async ring depth."""
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
    projections and shallow k, 64 for n <= 64.  The split is a function of
    k alone: k is cut in two between the blocks of a cluster where one
    block would walk more than ``SPLIT_K_TILES`` k tiles (8192 of k: qwen
    wd, RWKV wcv, ChatGLM3 wd, the 104B / 110B down projections).  An
    output column's k ranges, and so its bits, then do not depend on how
    many columns the product has: a fused QKV or gate|up product gives the
    bits of its unfused parts, so the fusion pass is bitwise invisible.  A
    split by the output's tile count would feed more SMs at decode on
    narrow products (RWKV's wA, m = 4: 12.2 µs split four ways, 20.1-20.8
    unsplit) but sums a narrow unfused projection's columns in another
    order than the fused product's; more than two ranks cost the m = 2048
    forward more than they gain (Command R+ wd, k = 33792: 2.43 ms in two,
    3.93-3.96 in eight; ``chip_smoke.py --gemm-times`` on the H100).

    fp32 (the FMA route, every product of the paper's nets): what bounds
    it at the nets' shapes is how many SMs have work and how long each
    waits on its loads, not the FMA rate (67 TFLOP/s is 0.6-9 µs of their
    work).  So k is cut into ``split`` contiguous ranges of whole
    ``F32_STEP`` steps (:func:`k_ranges`): enough ranks to bring ``ceil(n
    / 64)`` column tiles of a 64-row output to ``SMS`` blocks, but no more
    than about sqrt(k) * 0.4 (a sweep of splits at the nets' 65 shapes on
    the H100, ``chip_smoke.py --gemm-times ... --plan f32:S,T``: more ranks
    shorten each rank's walk over k but add partials for the tile's last
    block to add), each rank, the last included, keeping at least
    ``F32_MIN_K`` of k; k <= 64 never splits.  Each output element is one
    ascending fmaf chain within each range, the ranges' partials added in
    rank order, then the epilogue: a function of (n, k) alone, so M-stable
    and the same bits on every call; with one range, one chain over all of
    k."""
    if dtype == torch.float32:
        return Plan(0, _f32_split(n, k), F32_STAGES)
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_matmul kernel takes float32/bfloat16, "
                         f"got {dtype}")
    if n <= 64:
        bn = 64
    elif max(n, k) >= 4096 and k >= 256:
        bn = 256
    else:
        bn = 128
    split = 2 if -(-k // BK) > SPLIT_K_TILES else 1
    return Plan(bn, split, 4 if bn == 256 else 6)


def k_per_rank(k: int, split: int) -> int:
    """The k of each rank of an fp32 launch cut into ``split`` ranges:
    whole ``F32_STEP`` steps (the last rank takes what is left)."""
    per = -(-k // max(split, 1))
    return max(F32_STEP, -(-per // F32_STEP) * F32_STEP)


def k_ranges(k: int, split: int) -> list:
    """The ``[lo, hi)`` k ranges of an fp32 launch's ranks, in rank order:
    together ``[0, k)`` (one empty range where k = 0)."""
    per = k_per_rank(k, split)
    return [(lo, min(k, lo + per)) for lo in range(0, max(k, 1), per)]


def _f32_split(n: int, k: int) -> int:
    want = -(-SMS // -(-n // 64))     # ranks that bring 64-wide tiles to SMS
    split = max(1, min(want, round(math.isqrt(k) * 0.4), F32_MAX_SPLIT))
    while split > 1:
        r = k_ranges(k, split)
        if r[-1][1] - r[-1][0] >= F32_MIN_K:
            return len(r)
        split -= 1
    return 1


def f32_tile(m: int, n: int, split: int) -> int:
    """Index into ``F32_TILES`` of an fp32 launch: 64 x 64, or 32 x 32 for
    a split of more than 32 columns whose 64 x 64 tiles leave a tenth of
    the SMs or more idle and whose 32 x 32 tiles give more blocks (the
    LSTM cells and the CNN head at m = 64; a sweep on the H100, as for the
    split).  Every tile gives the same bits (the order of each element's
    sum is the plan's), so the tile follows m freely."""
    def blocks(bm, bn):
        return -(-m // bm) * -(-n // bn) * split
    wide, small = blocks(*F32_TILES[0][:2]), blocks(*F32_TILES[1][:2])
    return 1 if (split > 1 and n > 32 and 10 * wide < 9 * SMS
                 and small > wide) else 0


def workspace(m: int, n: int, p: Plan, device,
              groups: int = 1) -> torch.Tensor | None:
    """The fp32 partial tiles of a split launch, ``[groups * split, m,
    n4]`` (n4: n rounded up to 4, so the last block reads each partial row
    in 16-byte pieces; ``groups``: the grouped route's experts, each with
    its own ``split`` planes); None without a split."""
    if p.bn != 0 or p.split == 1:
        return None
    return torch.empty((groups * p.split, m, -(-n // 4) * 4),
                       dtype=torch.float32, device=device)


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
            i, p = ctypes.c_int, ctypes.c_void_p
            fn.argtypes = [p, p, p, p,        # x, w, y, ws
                           i, i, i, i, i,     # m, n, k, ldx, ldw
                           i, i, i, i,        # ta, tb, in_dt, out_dt
                           i, i, i, i, i,     # bn, split, stages, tile, kper
                           i, ctypes.POINTER(i), ctypes.POINTER(p), p]
            fn.restype = ctypes.c_int
            fn = lib.fused_matmul_grouped_launch
            fn.argtypes = [p, p, p, p,        # x, w, y, ws
                           i, i, i, i, i, i,  # groups, m, n, k, ldx, ldw
                           i, i, i, i,        # ta, tb, in_dt, out_dt
                           i, i, i, i, i,     # bn, split, stages, tile, kper
                           i, ctypes.POINTER(i), ctypes.POINTER(p), p]
            fn.restype = ctypes.c_int
            lib.fused_matmul_f32_tiles.argtypes = [ctypes.POINTER(i), i]
            lib.fused_matmul_f32_tiles.restype = i
            _lib = lib
    return _lib


def kernel_f32_tiles() -> tuple:
    """The fp32 tiles as the built library states them, in the order of
    ``F32_TILES`` (which ``f32_tile`` indexes and must equal)."""
    out = (ctypes.c_int * (5 * 16))()
    count = library().fused_matmul_f32_tiles(out, 16)
    return tuple(tuple(out[5 * t:5 * t + 5]) for t in range(count))


def _chain_codes(spec: tuple, operands: list) -> tuple:
    """The epilogue chain as the library takes it: ``codes`` (5 x
    ``MAX_STAGES`` ints: fn, kind, head, cast, operand dtype) and the
    operand pointers in stage order."""
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
    return codes, ptrs


def launch_grouped(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                   groups: int, m: int, n: int, k: int, p: Plan,
                   spec: tuple, operands: list, ta: bool = False,
                   tb: bool = False,
                   ws: torch.Tensor | None = None) -> None:
    """Launch the grouped route on the current stream: ``y[g] = chain(A[g]
    @ B[g])`` for each of ``groups`` experts in one launch, each expert's A
    and B stored as :func:`launch` stores its own with the same ``ta`` /
    ``tb``, the experts' back to back: ``x`` ``[groups * m, ldx]`` (with
    ``ta``: ``[groups * k, ldx]``), ``w`` ``[groups * k, ldw]`` (with
    ``tb``: ``[groups * n, ldw]``), ``y [groups * m, n]``.  The forward
    takes neither; the grouped dX ``tb`` and the grouped dW ``ta``.  ``p``
    is ``plan(n, k, dtype)``, every expert's own 2-D plan, and ``ws`` the
    fp32 route's ``workspace(m, n, p, groups=groups)``.  A full epilogue
    operand is ``[groups * m, n]``, a row operand ``[n]``; the caller has
    checked devices, dtypes, shapes and contiguity."""
    if (ws is None) != (x.dtype != torch.float32 or p.split == 1):
        raise ValueError(f"fused_matmul: an fp32 split of {p.split} takes a "
                         f"workspace, and nothing else does")
    codes, ptrs = _chain_codes(spec, operands)
    tile = kper = 0
    if x.dtype == torch.float32:
        tile, kper = f32_tile(m, n, p.split), k_per_rank(k, p.split)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().fused_matmul_grouped_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, groups, m, n, k,
        x.shape[1], w.shape[1], int(ta), int(tb), DT[x.dtype], DT[y.dtype],
        p.bn, p.split, p.stages, tile, kper, len(spec), codes, ptrs, stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul grouped launch failed: CUDA error "
                           f"{err}")


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, m: int,
           n: int, k: int, p: Plan, spec: tuple, operands: list,
           ta: bool = False, tb: bool = False,
           ws: torch.Tensor | None = None) -> None:
    """Launch the GEMM on the current stream: ``y[m,n] = chain(A @ B)``
    with A = ``x[:m, :k]`` (with ``ta``: x stored ``[k, m]``, A =
    ``x[:k, :m]^T``) and B = ``w[:k, :n]`` (with ``tb``: w stored ``[n,
    k]``, B = ``w[:n, :k]^T``).  x and w are row-major buffers whose rows
    may be longer than the stored width (``pad_cols``); ``p`` is ``plan(n,
    k, dtype)``, and ``ws`` the fp32 route's ``workspace(m, n, p)``.
    ``spec`` is the static chain ``((fn, kind, head_pos, dtype), ...)``
    and ``operands`` the row/full operand tensors in spec order; the
    caller has checked devices, dtypes, shapes and contiguity."""
    if (ws is None) != (x.dtype != torch.float32 or p.split == 1):
        raise ValueError(f"fused_matmul: an fp32 split of {p.split} takes a "
                         f"workspace, and nothing else does")
    codes, ptrs = _chain_codes(spec, operands)
    tile = kper = 0
    if x.dtype == torch.float32:
        tile, kper = f32_tile(m, n, p.split), k_per_rank(k, p.split)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().fused_matmul_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k, x.shape[1],
        w.shape[1], int(ta), int(tb), DT[x.dtype], DT[y.dtype], p.bn,
        p.split, p.stages, tile, kper, len(spec), codes, ptrs, stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul launch failed: CUDA error {err}")
