"""Public wrapper for the fused GEMM: the contract of the JAX package's
``kernels/fused_matmul/ops.py::fused_matmul``.

Leading dims of ``x`` are flattened, the epilogue is split into the static
chain the kernel takes and its operand tensors (``_classify``), and then:

* a CPU tensor runs the plain version (``ref.fused_matmul_ref``);
* a CUDA tensor launches the hand-written kernel, or raises.  There is no
  fallback: a launch that fails is an error.

``launches`` counts kernel launches (incremented where the kernel launches
and nowhere else); ``launches_by_shape`` splits it by ``(m, n, k, x dtype,
chain)``.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ...core.dtypes import to_torch_dtype
from . import kernel, ref

launches = 0
launches_by_shape: collections.Counter = collections.Counter()


def reset_counts() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def _classify(epilogue, m: int, n: int):
    """(static chain, operand tensors): each stage is unary ("none"), a
    ``[n]`` row operand ("row") or an ``[m, n]`` full operand ("full")."""
    spec, operands = [], []
    for fn, vals, at in epilogue or []:
        hp = at.get("head_pos", 0)
        edt = at.get("dtype")
        if not vals:
            spec.append((fn, "none", hp, edt))
            continue
        (v,) = vals   # one operand per epilogue stage
        v = torch.as_tensor(v)
        if v.ndim <= 1 or (v.ndim == 2 and v.shape[0] == 1):
            spec.append((fn, "row", hp, edt))
            operands.append(v.reshape(-1).expand(n).contiguous())
        else:
            spec.append((fn, "full", hp, edt))
            operands.append(
                v.reshape(-1, v.shape[-1]).expand(m, n).contiguous())
    return tuple(spec), operands


def fused_matmul(x, w, epilogue=None, tile=None, out_dtype=None):
    """y = epilogue(x @ w);  x: [..., k], w: [k, n].

    ``tile`` is the schedule's tile choice, accepted for the reference's
    contract: the Hopper kernel's tiles are fixed, so the order in which a
    row's k-sum is taken never depends on how many rows run."""
    out_dt = to_torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    if x.device.type == "cpu":
        return ref.fused_matmul_ref(x, w, epilogue=epilogue, out_dtype=out_dt)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul runs on cpu or cuda, got {x.device}")
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[-1]
    m = int(np.prod(lead)) if lead else 1
    if w.ndim != 2 or w.shape[0] != k:
        raise ValueError(f"fused_matmul: w must be [k={k}, n], got "
                         f"{tuple(w.shape)}")
    if w.device != x.device or x.dtype != w.dtype:
        raise ValueError(f"fused_matmul: x {x.dtype}@{x.device} and w "
                         f"{w.dtype}@{w.device} must share device and dtype")
    if x.dtype not in kernel.DT or out_dt not in kernel.DT:
        raise ValueError(f"fused_matmul kernel takes float32/bfloat16, got "
                         f"{x.dtype} -> {out_dt}")
    spec, operands = _classify(epilogue, m, n)
    for op in operands:
        if op.device != x.device or op.dtype not in kernel.DT:
            raise ValueError(f"fused_matmul: epilogue operand {op.dtype}@"
                             f"{op.device} not supported")
    x2 = x.reshape(m, k).contiguous()
    w2 = w.contiguous()
    y = torch.empty((m, n), dtype=out_dt, device=x.device)
    global launches
    if m > 0 and n > 0:
        kernel.launch(x2, w2, y, spec, operands)
        launches += 1
        launches_by_shape[(m, n, k, str(x.dtype), spec)] += 1
    return y.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Roofline cost descriptor (read by core.schedule's matmul impl registry)
# ---------------------------------------------------------------------------


def matmul_cost(m, n, k, eb):
    """Roofline terms of one kernel launch, ``dict(flops, io_bytes)``:
    x ``[m, k]`` and w ``[k, n]`` read once, the output written once (the
    epilogue runs on the resident output tile)."""
    return dict(flops=2.0 * m * n * k, io_bytes=eb * (m * k + k * n + m * n))
