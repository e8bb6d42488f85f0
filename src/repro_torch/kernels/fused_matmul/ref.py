"""Plain PyTorch version of the fused GEMM + open epilogue: the kernel's
reference on the card and the path a CPU tensor takes."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.dtypes import to_torch_dtype

#: elements per call of ``_lanes``: a multiple of every CPU vector loop's
#: step, and below ATen's grain, so one call runs on one thread
_LANE_BLOCK = 16384


def _lanes(f):
    """``f`` (a unary transcendental) whose bits on a CPU tensor depend on
    the element alone.  ATen's CPU loops take the last elements of a row
    that do not fill two vector widths through a scalar path that rounds
    otherwise, so a strided column slice (a fused GEMM's member) and a
    contiguous block of the same values could differ.  Here the values
    are copied flat, zero-padded to whole blocks and run block by block,
    so every element takes the vector path."""
    def lanes(x):
        if x.device.type != "cpu" or not x.is_floating_point() \
                or x.numel() == 0:
            return f(x)
        flat = x.reshape(-1)
        pad = (-flat.numel()) % 64
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        out = torch.cat([f(c) for c in flat.split(_LANE_BLOCK)])
        return out[:x.numel()].reshape(x.shape)
    return lanes


_EW = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "maximum": torch.maximum, "minimum": torch.minimum, "neg": torch.neg,
    "exp": _lanes(torch.exp), "log": _lanes(torch.log),
    "rsqrt": _lanes(torch.rsqrt), "square": torch.square,
    "tanh": _lanes(torch.tanh), "sigmoid": _lanes(torch.sigmoid),
    "relu": torch.relu,
    # jax.nn.gelu's default is the tanh approximation; torch's is not
    "gelu": _lanes(lambda x: F.gelu(x, approximate="tanh")),
    "silu": _lanes(F.silu),
    "abs": lambda x: _abs(x), "sqrt": torch.sqrt,
}


def _abs(x):
    """|x| with jnp.abs's gradient at 0, +1 (torch.abs's is 0); the
    ``+ 0.0`` turns the -0.0 that -0.0 >= 0 keeps into jnp.abs's +0.0."""
    return torch.where(x >= 0, x, -x) + 0.0


def apply_epilogue(y, epilogue):
    """epilogue: list of (fn_name, [operand tensors], attrs).

    An attrs ``dtype`` casts the running value first — the dtype the
    un-fused consumer op computed in — so fusing is bitwise-invisible."""
    for fn, vals, at in epilogue or []:
        edt = at.get("dtype")
        if edt is not None:
            y = y.to(to_torch_dtype(edt))
        vals = [torch.as_tensor(v).to(y.dtype) for v in vals]
        f = _EW[fn]
        if at.get("head_pos", 0) == 0:
            y = f(y, *vals)
        else:
            y = f(vals[0], y, *vals[1:])
    return y


def matmul_f32(x, w):
    """``x [..., k] @ w [k, n]`` in fp32 whose every row and column is the
    same bits whatever the row count or the column range asked for: BLAS
    takes a one-row product to its gemv path, which sums in another order
    than its gemm, so one row goes through a two-row call.  A column or
    row shard of a product (a rank's block on a mesh) then equals that
    block of the whole product."""
    if x.numel() == x.shape[-1] and x.numel() > 0:
        x2 = x.reshape(1, x.shape[-1])
        y = torch.matmul(torch.cat([x2, torch.zeros_like(x2)]), w)[:1]
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x, w)


def fused_matmul_ref(x, w, epilogue=None, out_dtype=None):
    """x: [..., m, k] @ w: [k, n] with fp32 accumulation, then epilogue."""
    out_dtype = to_torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    y = matmul_f32(x.to(torch.float32), w.to(torch.float32))
    y = apply_epilogue(y, epilogue)
    return y.to(out_dtype)


def grouped_matmul_ref(x, w, epilogue=None, out_dtype=None):
    """The grouped route's plain version: ``x [E, ..., m, k] @ w [E, k,
    n]``, expert by expert, fp32 accumulation, then the epilogue (a full
    operand ``[E, ..., m, n]``, a row operand ``[n]`` every expert
    shares)."""
    out_dtype = to_torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    xf = x.to(torch.float32)
    y = torch.stack([matmul_f32(xf[e], w[e].to(torch.float32))
                     for e in range(w.shape[0])])
    y = apply_epilogue(y, epilogue)
    return y.to(out_dtype)


def matmul_dx_ref(dy, w, out_dtype=None):
    """The input gradient's product ``dy [m, n] @ w [k, n]^T`` with fp32
    accumulation, in ``out_dtype`` (default ``dy``'s)."""
    out_dtype = to_torch_dtype(out_dtype) if out_dtype is not None else dy.dtype
    return torch.matmul(dy.to(torch.float32),
                        w.to(torch.float32).T).to(out_dtype)


def matmul_dw_ref(x, dy, out_dtype=None):
    """The weight gradient's product ``x [m, k]^T @ dy [m, n]`` with fp32
    accumulation, in ``out_dtype`` (default ``x``'s)."""
    out_dtype = to_torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    return torch.matmul(x.to(torch.float32).T,
                        dy.to(torch.float32)).to(out_dtype)


def grouped_matmul_dx_ref(dy, w, out_dtype=None):
    """The grouped input gradient's plain version: ``dy [E, ..., n] @ w[e]
    [k, n]^T`` expert by expert (``matmul_dx_ref`` on each), in
    ``out_dtype`` (default ``dy``'s)."""
    return torch.stack([matmul_dx_ref(dy[e].reshape(-1, dy.shape[-1]), w[e],
                                      out_dtype).reshape(
                                          *dy.shape[1:-1], w.shape[1])
                        for e in range(w.shape[0])])


def grouped_matmul_dw_ref(x, dy, out_dtype=None):
    """The grouped weight gradient's plain version: ``x[e] [C, k]^T @
    dy[e] [C, n]`` expert by expert (``matmul_dw_ref`` on each), in
    ``out_dtype`` (default ``x``'s)."""
    return torch.stack([matmul_dw_ref(x[e].reshape(-1, x.shape[-1]),
                                      dy[e].reshape(-1, dy.shape[-1]),
                                      out_dtype)
                        for e in range(x.shape[0])])
