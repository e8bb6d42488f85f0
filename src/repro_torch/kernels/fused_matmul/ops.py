"""Public wrapper for the fused GEMM: the contract of the JAX package's
``kernels/fused_matmul/ops.py::fused_matmul``.

Leading dims of ``x`` are flattened, the epilogue is split into the static
chain the kernel takes and its operand tensors (``_classify``), and then:

* a CPU tensor runs the plain version (``ref.fused_matmul_ref``);
* a CUDA tensor launches the hand-written kernel, or raises.  There is no
  fallback: a launch that fails is an error.  A ``w`` that is the
  transpose of a contiguous ``[n, k]`` tensor (a tied head's
  ``embed.T``) is read in place as the kernel's K-major B operand, the
  dX route's layout, with the same plan and the same sums as its
  contiguous copy would take; any other strided ``w`` is copied.

A 3-D ``w [E, k, n]`` with ``x [E, ..., k]`` is the grouped route (the MoE
expert FFN): ONE launch computes every expert's product, each with the plan
of its own 2-D launch, so it equals E launches of the 2-D route bitwise.
Its plain version is ``ref.grouped_matmul_ref``.  Its backward is the 2-D
route's, grouped: dX and dW are one launch each of the kernel's grouped
route in the dX / dW layouts (``matmul_dx_grouped``,
``matmul_dw_grouped``), each expert with the plan of its own 2-D
backward launch, so they equal E per-expert ``matmul_dx`` / ``matmul_dw``
launches bitwise.

``launches`` counts kernel launches (incremented where the kernel launches
and nowhere else); ``launches_by_shape`` splits it by ``(m, n, k, x dtype,
chain)``, a grouped launch by ``("grouped", E, m, n, k, x dtype, chain)``
(m: each expert's rows).

Gradients.  Under grad mode, when an input requires grad, ``fused_matmul``
goes through ``FusedMatmulFn`` (an ``autograd.Function``) on every device:
its forward is the same wrapper, its backward the reference's
``fused_matmul_vjp`` (``kernels/fused_matmul/ops.py`` of the JAX package):

* the epilogue chain's VJP gives dY0, the gradient of the pre-epilogue
  fp32 product, and each operand's gradient, every stage's cast kept
  (``epilogue_vjp``).  A chain of adds needs no values and is walked
  backwards directly; any other chain first recomputes the product with
  one launch that has no epilogue and an fp32 output, then differentiates
  the plain ``apply_epilogue`` on it;
* dX = dY0 W^T and dW = X^T dY0 are launches of the same kernel on the
  operands in place (``matmul_dx``, ``matmul_dw``: TMA reads w^T and
  x^T, and wgmma's transpose bits take them; nothing is transposed in
  memory), fp32 accumulation, each rounded once to its input's dtype (as
  the reference's VJP returns them; autograd would round a wider result
  to that dtype anyway).  dY0 enters them in x's dtype: in bf16 it is
  rounded once, as a TPU's default-precision fp32 product rounds it.  The
  plan is a function of (output columns, contraction) alone, so dX's rows
  are M-stable and dW's split-K sums in a fixed order: the backward is
  deterministic.

On a CPU tensor the same backward runs the plain versions
(``ref.matmul_dx_ref``, ``ref.matmul_dw_ref``, and grouped
``ref.grouped_matmul_dx_ref``, ``ref.grouped_matmul_dw_ref``).
``bwd_launches`` counts the backward routes' launches by route (``"dx"``,
``"dw"``, ``"grouped_dx"``, ``"grouped_dw"``) and ``bwd_launches_by_shape``
by ``(route, m, n, k, dtype)`` of the launched product, a grouped one by
``("grouped", route, E, m, n, k, dtype)`` (m, n, k: each expert's);
``function_calls`` counts ``FusedMatmulFn``'s forward and backward on any
device.
"""
from __future__ import annotations

import collections
import math

import torch

from ...core.dtypes import to_torch_dtype
from . import kernel, ref

launches = 0
launches_by_shape: collections.Counter = collections.Counter()
bwd_launches: collections.Counter = collections.Counter()
bwd_launches_by_shape: collections.Counter = collections.Counter()
function_calls: collections.Counter = collections.Counter()


def reset_counts() -> None:
    global launches
    launches = 0
    for c in (launches_by_shape, bwd_launches, bwd_launches_by_shape,
              function_calls):
        c.clear()


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


def _requires_grad(x, w, epilogue) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (x, w, *(v for _, vals, _ in epilogue or [] for v in vals)))


def fused_matmul(x, w, epilogue=None, tile=None, out_dtype=None):
    """y = epilogue(x @ w);  x: [..., k], w: [k, n].

    ``tile`` is the schedule's tile choice, accepted for the reference's
    contract and not read: the Hopper kernel's plan (``kernel.plan``) is a
    function of ``(n, k, dtype)`` alone, so the order in which a row's
    k-sum is taken never depends on how many rows run.  Under grad mode,
    with an input that requires grad, the call goes through
    ``FusedMatmulFn``."""
    out_dt = to_torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    if _requires_grad(x, w, epilogue):
        chain = tuple((fn, len(vals), at) for fn, vals, at in epilogue or [])
        vals = [v for _, vs, _ in epilogue or [] for v in vs]
        return FusedMatmulFn.apply(x, w, chain, out_dt, *vals)
    return _product(x, w, epilogue, out_dt)


def _product(x, w, epilogue, out_dt):
    """The forward product, the 2-D or (a 3-D ``w``) the grouped route."""
    if w.ndim == 3:
        return _grouped_matmul(x, w, epilogue, out_dt)
    return _fused_matmul(x, w, epilogue, out_dt)


def _fused_matmul(x, w, epilogue, out_dt):
    """The forward product on the device ``x`` lies on (no autograd)."""
    if x.device.type == "cpu":
        return ref.fused_matmul_ref(x, w, epilogue=epilogue, out_dtype=out_dt)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul runs on cpu or cuda, got {x.device}")
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[-1]
    m = math.prod(lead)
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
    w2, tb = weight_operand(w)
    kk = k
    if x.dtype == torch.bfloat16:   # TMA rows: copies where (n, k) need it
        if tb:
            x2, w2 = kernel.pad_cols(x2), kernel.pad_cols(w2)
        else:
            x2, w2, kk = kernel.tma_operands(x2, w2)
    y = torch.empty((m, n), dtype=out_dt, device=x.device)
    global launches
    if m > 0 and n > 0:
        p = kernel.plan(n, kk, x.dtype)
        kernel.launch(x2, w2, y, m, n, kk, p, spec, operands, tb=tb,
                      ws=kernel.workspace(m, n, p, x.device))
        launches += 1
        launches_by_shape[(m, n, k, str(x.dtype), spec)] += 1
    return y.reshape(*lead, n)


def _grouped_matmul(x, w, epilogue, out_dt):
    """``x [E, ..., k] @ w [E, k, n]`` with the epilogue, one launch of the
    grouped route on a CUDA tensor (the plain version on a CPU one)."""
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w, epilogue=epilogue,
                                      out_dtype=out_dt)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul runs on cpu or cuda, got {x.device}")
    E, k, n = w.shape
    if x.ndim < 2 or x.shape[0] != E or x.shape[-1] != k:
        raise ValueError(f"fused_matmul: x must be [E={E}, ..., k={k}] for "
                         f"w {tuple(w.shape)}, got {tuple(x.shape)}")
    if w.device != x.device or x.dtype != w.dtype:
        raise ValueError(f"fused_matmul: x {x.dtype}@{x.device} and w "
                         f"{w.dtype}@{w.device} must share device and dtype")
    if x.dtype not in kernel.DT or out_dt not in kernel.DT:
        raise ValueError(f"fused_matmul kernel takes float32/bfloat16, got "
                         f"{x.dtype} -> {out_dt}")
    if k == 0:
        raise ValueError("fused_matmul: the grouped route takes no empty "
                         "contraction")
    lead = x.shape[1:-1]
    m = math.prod(lead)
    spec, operands = _classify(epilogue, E * m, n)
    for op in operands:
        if op.device != x.device or op.dtype not in kernel.DT:
            raise ValueError(f"fused_matmul: epilogue operand {op.dtype}@"
                             f"{op.device} not supported")
    x2 = x.reshape(E * m, k).contiguous()
    w2 = w.reshape(E * k, n).contiguous()
    if x.dtype == torch.bfloat16:   # TMA rows: copies where (n, k) need it
        x2, w2 = kernel.pad_cols(x2), kernel.pad_cols(w2)
    y = torch.empty((E, *lead, n), dtype=out_dt, device=x.device)
    global launches
    if m > 0 and n > 0:
        p = kernel.plan(n, k, x.dtype)
        kernel.launch_grouped(x2, w2, y, E, m, n, k, p, spec, operands,
                              ws=kernel.workspace(m, n, p, x.device,
                                                  groups=E))
        launches += 1
        launches_by_shape[("grouped", E, m, n, k, str(x.dtype), spec)] += 1
    return y


def weight_operand(w):
    """``(b, tb)``: the buffer the kernel reads for ``w [k, n]`` and
    whether it is stored ``[n, k]`` (the K-major B operand, the dX route's
    layout).  ``w = v.T`` of a contiguous ``v [n, k]`` (a tied head's
    ``embed.T``) gives ``(v, True)``: read in place, where a copy would
    move all of ``w`` on every call; any other ``w`` its contiguous
    self."""
    if w.shape[0] > 0 and not w.is_contiguous() and w.T.is_contiguous():
        return w.T, True
    return w.contiguous(), False


# ---------------------------------------------------------------------------
# The backward routes: dX = dY W^T and dW = X^T dY on the same kernel
# ---------------------------------------------------------------------------


def _check_pair(a, b, what: str) -> None:
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"{what}: 2-D operands expected, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError(f"{what}: {a.dtype}@{a.device} and {b.dtype}@"
                         f"{b.device} must share device and dtype")
    if a.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {a.device}")
    if a.dtype not in kernel.DT:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got "
                         f"{a.dtype}")


def _launch_bwd(route, a, b, m, n, k, out_dt, ta, tb, groups: int = 0):
    """One launch of the kernel for a backward product ``y [m, n]`` over a
    contraction of ``k`` (``a``, ``b`` stored as ``kernel.launch`` takes
    them with ``ta`` / ``tb``); with ``groups``, one launch of the grouped
    route for that many such products (``a [groups, ., .]``, ``b``
    likewise, ``y [groups, m, n]``), every group the plan of its own 2-D
    launch."""
    if out_dt not in kernel.DT:
        raise ValueError(f"{route}: output dtype {out_dt} not supported")
    lead = (groups,) if groups else ()
    y = torch.empty(lead + (m, n), dtype=out_dt, device=a.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    a = a.reshape(-1, a.shape[-1]).contiguous()
    b = b.reshape(-1, b.shape[-1]).contiguous()
    if a.dtype == torch.bfloat16:   # TMA rows: copies where widths need it
        a, b = kernel.pad_cols(a), kernel.pad_cols(b)
    p = kernel.plan(n, k, a.dtype)
    ws = kernel.workspace(m, n, p, a.device, groups=max(groups, 1))
    if groups:
        kernel.launch_grouped(a, b, y, groups, m, n, k, p, (), [], ta=ta,
                              tb=tb, ws=ws)
        bwd_launches["grouped_" + route] += 1
        bwd_launches_by_shape[("grouped", route, groups, m, n, k,
                               str(a.dtype))] += 1
    else:
        kernel.launch(a, b, y, m, n, k, p, (), [], ta=ta, tb=tb, ws=ws)
        bwd_launches[route] += 1
        bwd_launches_by_shape[(route, m, n, k, str(a.dtype))] += 1
    return y


def _check_grouped(a, b, what: str) -> None:
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"{what}: [E, rows, cols] operands expected, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    _check_pair(a[0], b[0], what)


def matmul_dx_grouped(dy, w, out_dtype=None):
    """The grouped input gradient ``dy [E, ..., n] @ w[e] [k, n]^T -> [E,
    ..., k]``, fp32 accumulation, in ``out_dtype`` (default ``dy``'s): ONE
    launch of the grouped route with each ``w[e]`` read as the K-major B
    operand, each expert the plan of its own ``matmul_dx`` launch (=
    those E launches bitwise).  A CPU tensor runs
    ``ref.grouped_matmul_dx_ref``; a CUDA tensor launches, or raises."""
    out_dt = to_torch_dtype(out_dtype) if out_dtype is not None else dy.dtype
    if dy.device.type == "cpu":
        return ref.grouped_matmul_dx_ref(dy, w, out_dt)
    E, n = dy.shape[0], dy.shape[-1]
    dy3 = dy.reshape(E, -1, n)
    _check_grouped(dy3, w, "matmul_dx_grouped")
    if w.shape[2] != n:
        raise ValueError(f"matmul_dx_grouped: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} do not share n")
    k = w.shape[1]
    y = _launch_bwd("dx", dy3, w, dy3.shape[1], k, n, out_dt, False, True,
                    groups=E)
    return y.reshape(*dy.shape[:-1], k)


def matmul_dw_grouped(x, dy, out_dtype=None):
    """The grouped weight gradient ``x[e] [C, k]^T @ dy[e] [C, n] -> [E,
    k, n]``, fp32 accumulation over each expert's C rows (a fixed-order
    split where the plan splits), in ``out_dtype`` (default ``x``'s): ONE
    launch of the grouped route with each ``x[e]`` read as the MN-major A
    operand, each expert the plan of its own ``matmul_dw`` launch (= those
    E launches bitwise).  A CPU tensor runs ``ref.grouped_matmul_dw_ref``;
    a CUDA tensor launches, or raises."""
    out_dt = to_torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    if x.device.type == "cpu":
        return ref.grouped_matmul_dw_ref(x, dy, out_dt)
    E = x.shape[0]
    x3 = x.reshape(E, -1, x.shape[-1])
    dy3 = dy.reshape(E, -1, dy.shape[-1])
    _check_grouped(x3, dy3, "matmul_dw_grouped")
    if x3.shape[1] != dy3.shape[1]:
        raise ValueError(f"matmul_dw_grouped: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} do not share C")
    C, k = x3.shape[1:]
    return _launch_bwd("dw", x3, dy3, k, dy3.shape[2], C, out_dt, True,
                       False, groups=E)


def matmul_dx(dy, w, out_dtype=None):
    """The input gradient's product ``dy [m, n] @ w [k, n]^T -> [m, k]``,
    fp32 accumulation, in ``out_dtype`` (default ``dy``'s).  A CPU tensor
    runs ``ref.matmul_dx_ref``; a CUDA tensor launches the kernel with w
    read as the K-major B operand (``tb``), or raises.  A ``w`` that is
    ``v.T`` of a contiguous ``v [n, k]`` (a tied head's ``embed.T``) is
    ``dy @ v``, the forward's layout: ``v`` is read in place, where a
    contiguous copy of ``w`` would move all of it on every call."""
    out_dt = to_torch_dtype(out_dtype) if out_dtype is not None else dy.dtype
    if dy.device.type == "cpu":
        return ref.matmul_dx_ref(dy, w, out_dt)
    _check_pair(dy, w, "matmul_dx")
    if dy.shape[1] != w.shape[1]:
        raise ValueError(f"matmul_dx: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} do not share n")
    m, n = dy.shape
    b, transposed = weight_operand(w)
    return _launch_bwd("dx", dy, b, m, w.shape[0], n, out_dt, False,
                       not transposed)


def matmul_dw(x, dy, out_dtype=None):
    """The weight gradient's product ``x [m, k]^T @ dy [m, n] -> [k, n]``,
    fp32 accumulation over the m rows (a fixed-order split where the plan
    splits), in ``out_dtype`` (default ``x``'s).  A CPU tensor runs
    ``ref.matmul_dw_ref``; a CUDA tensor launches the kernel with x read
    as the MN-major A operand (``ta``), or raises."""
    out_dt = to_torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    if x.device.type == "cpu":
        return ref.matmul_dw_ref(x, dy, out_dt)
    _check_pair(x, dy, "matmul_dw")
    if x.shape[0] != dy.shape[0]:
        raise ValueError(f"matmul_dw: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} do not share m")
    m, k = x.shape
    return _launch_bwd("dw", x, dy, k, dy.shape[1], m, out_dt, True, False)


def epilogue_vjp(x2, w, chain, vals, out_dt, dy2):
    """(dY0, operand gradients) of ``y = apply_epilogue(x2 @ w, chain,
    vals).to(out_dt)`` at the cotangent ``dy2 [m, n]`` (grouped: ``x2 [E,
    C, k] @ w [E, k, n]``, its rows ``m = E C`` in expert order).  dY0
    comes in the dtype of the chain's last stage (fp32 where it has none):
    its values are the fp32 dY0's, exactly.  An operand gradient is None
    where its operand needs none."""
    n = w.shape[-1]
    if all(fn == "add" for fn, _, _ in chain):
        # an add's gradient needs no values: walk the chain backwards
        run = [torch.float32]            # running dtype before each stage
        for _, _, at in chain:
            edt = at.get("dtype")
            run.append(to_torch_dtype(edt) if edt is not None else run[-1])
        g = dy2.to(run[-1])
        grads = [None] * len(vals)
        it = len(vals)
        for s in range(len(chain) - 1, -1, -1):
            _, nv, _ = chain[s]
            for j in range(it - nv, it):
                v = vals[j]
                if v.requires_grad:
                    gv = g if v.numel() == g.numel() else \
                        g.reshape(-1, n).sum(0)
                    grads[j] = gv.reshape(v.shape).to(v.dtype)
            it -= nv
            g = g.to(run[s])
        return g, grads
    # the recompute launch
    y0 = _product(x2, w, None, torch.float32).reshape(-1, n)
    with torch.enable_grad():
        y0 = y0.requires_grad_()
        leaves = [v.detach().requires_grad_(v.requires_grad) for v in vals]
        it = iter(leaves)
        epi = [(fn, [next(it).reshape(-1, n) for _ in range(nv)], at)
               for fn, nv, at in chain]
        y = ref.apply_epilogue(y0, epi).to(out_dt)
        want = [y0] + [t for t in leaves if t.requires_grad]
        got = list(torch.autograd.grad(y, want, dy2))
    dy0 = got.pop(0)
    return dy0, [got.pop(0) if t.requires_grad else None for t in leaves]


class FusedMatmulFn(torch.autograd.Function):
    """``fused_matmul`` with the reference's ``fused_matmul_vjp`` as its
    backward (see the module docstring), for a 2-D ``w`` and for the
    grouped route's 3-D one.  Device-agnostic: the kernel's routes on the
    card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, w, chain, out_dt, *vals):
        function_calls["forward"] += 1
        it = iter(vals)
        epi = [(fn, [next(it) for _ in range(nv)], at)
               for fn, nv, at in chain]
        y = _product(x, w, epi, out_dt)
        ctx.chain, ctx.out_dt = chain, out_dt
        ctx.save_for_backward(x, w, *vals)
        return y

    @staticmethod
    def backward(ctx, dy):
        function_calls["backward"] += 1
        x, w, *vals = ctx.saved_tensors
        k, n = x.shape[-1], w.shape[-1]
        grouped = w.ndim == 3
        # grouped: each expert's rows [E, C, k]
        x2 = x.reshape(w.shape[0], -1, k) if grouped else x.reshape(-1, k)
        dy2 = dy.reshape(-1, n)
        vals = [v.detach().requires_grad_(need)
                for v, need in zip(vals, ctx.needs_input_grad[4:])]
        dy0, dvals = epilogue_vjp(x2, w, ctx.chain, vals, ctx.out_dt, dy2)
        dy0 = dy0.to(x.dtype)
        if grouped:
            dy0 = dy0.reshape(w.shape[0], -1, n)
        dx_of, dw_of = ((matmul_dx_grouped, matmul_dw_grouped) if grouped
                        else (matmul_dx, matmul_dw))
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dx_of(dy0, w, x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = dw_of(x2, dy0, w.dtype)
        return (dx, dw, None, None, *dvals)


# ---------------------------------------------------------------------------
# Roofline cost descriptor (read by core.schedule's matmul impl registry)
# ---------------------------------------------------------------------------


def matmul_cost(m, n, k, eb, groups: int = 1):
    """Roofline terms of one kernel launch, ``dict(flops, io_bytes)``:
    x ``[m, k]`` and w ``[k, n]`` read once, the output written once (the
    epilogue runs on the resident output tile); ``groups`` such products
    (the grouped route, ``m`` rows each) cost that many times one."""
    return dict(flops=2.0 * groups * m * n * k,
                io_bytes=eb * groups * (m * k + k * n + m * n))
