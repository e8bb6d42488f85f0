"""Public wrapper for the chunked linear scan: the contract of the JAX
package's ``kernels/linear_scan/ops.py::linear_scan_chunked`` in its
layout, q/k/w ``[B,S,H,Dk]``, v ``[B,S,H,Dv]``, u ``[H,Dk]`` or None in,
``[B,S,H,Dv]`` in ``v.dtype`` out; ``init_state`` ``[B,H,Dk,Dv]`` seeds
the carry and ``return_state`` also returns the final carry in fp32.

* ``chunk`` above ``SAFE_CHUNK`` raises on any device: past it the
  factored score block is no longer exact (``kernels/costs.py``);
* a CPU tensor runs the plain version ``ref.linear_scan_chunked`` at the
  same chunk, with the same state arguments;
* a meta tensor (the region tracer's shape inference) gets outputs of
  the right shape and dtype and computes nothing;
* a CUDA tensor launches the hand-written kernel, or raises.  There is
  no fallback: q/k/v in another dtype than bf16/fp32 (or not all one
  dtype), ``w``, ``u`` or ``init_state`` not in fp32, or a ``Dk`` past the
  kernel's raise.  Mixed dtypes are the normal case: the RWKV6 forward
  passes bf16 r/k/v beside fp32 w and u.

``launches`` counts kernel launches (incremented where the kernel launches
and nowhere else); ``launches_by_shape`` splits it by
``(B, S, H, Dk, Dv, dtype, variant, chunk)``, the variant ``rwkv6`` or
``gla``, with ``+state`` where the call carries a state in or out.

Gradients.  Under grad mode, when q, k, v, w, u or ``init_state``
requires grad, ``linear_scan`` goes through ``LinearScanFn`` on every
device: its forward is this wrapper, its backward ``linear_scan_bwd``
(the gradients of q, k, v, w, u and ``init_state`` at the cotangents of
the output and of the returned carry): on a CUDA tensor the hand-written
backward (``csrc/linear_scan_bwd.cu``: the chunk-start carries and their
gradients by two serial passes, stored every ``kernel.plan_bwd(dtype)
.group`` chunks into fp32 workspaces this wrapper allocates
(``kernel.bwd_scratch``), then every chunk's gradients from its own rows
and the carries recomputed from its group's checkpoint, then ``du``'s
per-chunk partials summed in a fixed order; deterministic, no atomics),
on a CPU tensor the plain ``ref.linear_scan_bwd_ref``.  The reference's
``linear_scan_vjp`` differentiates its sequential oracle; the values
agree.  ``bwd_launches`` / ``bwd_launches_by_shape`` count the backward's
launches (one a call, however many kernels it launches; keyed as
``launches_by_shape``); ``function_calls`` counts ``LinearScanFn``'s
forward and backward on any device.
"""
from __future__ import annotations

import collections

import torch

from ..costs import SAFE_CHUNK
from . import kernel, ref

launches = 0
launches_by_shape: collections.Counter = collections.Counter()
bwd_launches = 0
bwd_launches_by_shape: collections.Counter = collections.Counter()
function_calls: collections.Counter = collections.Counter()


def reset_counts() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0
    for c in (launches_by_shape, bwd_launches_by_shape, function_calls):
        c.clear()


def _shape_key(q, v, u, chunk, stateful: bool) -> tuple:
    b, s, h, dk = q.shape
    variant = "gla" if u is None else "rwkv6"
    if stateful:
        variant += "+state"
    return (b, s, h, dk, v.shape[-1], str(v.dtype), variant,
            min(chunk, s))


def linear_scan(q, k, v, w, u=None, chunk: int = SAFE_CHUNK,
                init_state=None, return_state: bool = False):
    """q, k, w: [B, S, H, Dk]; v: [B, S, H, Dv]; u: [H, Dk] or None (GLA);
    init_state: [B, H, Dk, Dv] or None (zeros).  Returns [B, S, H, Dv] in
    v.dtype, and with ``return_state`` also the final [B, H, Dk, Dv]
    carry in fp32."""
    chunk = int(chunk)
    if not 1 <= chunk <= SAFE_CHUNK:
        raise ValueError(f"linear_scan: chunk {chunk} outside 1.."
                         f"{SAFE_CHUNK}, where the factored form is exact")
    if q.ndim != 4 or k.shape != q.shape or w.shape != q.shape \
            or v.ndim != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"linear_scan: q/k/w [B,S,H,Dk], v [B,S,H,Dv] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if u is not None and tuple(u.shape) != (h, dk):
        raise ValueError(f"linear_scan: u must be [H, Dk] = {(h, dk)}, got "
                         f"{tuple(u.shape)}")
    if init_state is not None and tuple(init_state.shape) != (b, h, dk, dv):
        raise ValueError(f"linear_scan: init_state must be [B, H, Dk, Dv] = "
                         f"{(b, h, dk, dv)}, got {tuple(init_state.shape)}")
    if q.device.type != "meta" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, w, u, init_state)):
        return LinearScanFn.apply(q, k, v, w, u, init_state, chunk,
                                  bool(return_state))
    return _linear_scan(q, k, v, w, u, chunk, init_state, return_state)


def _linear_scan(q, k, v, w, u, chunk, init_state, return_state):
    """The forward on the device ``q`` lies on (no autograd); the caller
    has checked the chunk and the shapes."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if q.device.type == "cpu":
        return ref.linear_scan_chunked(q, k, v, w, u=u, chunk=chunk,
                                       init_state=init_state,
                                       return_state=return_state)
    if q.device.type == "meta":
        o = torch.empty(v.shape, dtype=v.dtype, device="meta")
        if not return_state:
            return o
        return o, torch.empty((b, h, dk, dv), dtype=torch.float32,
                              device="meta")
    _check(q, k, v, w, u, init_state)
    q, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q, k, v, w))
    if u is not None:
        u = u.contiguous()
    if init_state is not None:
        init_state = init_state.contiguous()
    o = v.new_empty(v.shape)
    state = (v.new_empty((b, h, dk, dv), dtype=torch.float32)
             if return_state else None)
    if o.numel() == 0:
        if state is not None:
            if init_state is None:
                state.zero_()
            else:
                state.copy_(init_state)
        return (o, state) if return_state else o
    kernel.launch(q, k, v, w, u, o, min(chunk, s), s0=init_state, s1=state)
    global launches
    launches += 1
    launches_by_shape[_shape_key(q, v, u, chunk, init_state is not None
                                 or return_state)] += 1
    return (o, state) if return_state else o


def _check(q, k, v, w, u, init_state) -> None:
    """The kernels' refusals (forward and backward alike)."""
    if q.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cpu or cuda, got {q.device}")
    if any(t.device != q.device for t in (k, v, w)) or any(
            t is not None and t.device != q.device for t in (u, init_state)):
        raise ValueError("linear_scan: every operand must share a device")
    if q.dtype not in kernel.DT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"linear_scan kernel takes q/k/v in one of "
                         f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if any(t is not None and t.dtype != torch.float32
           for t in (w, u, init_state)):
        raise ValueError(
            f"linear_scan kernel takes w, u and init_state in float32, got "
            f"{w.dtype}, {None if u is None else u.dtype}, "
            f"{None if init_state is None else init_state.dtype}")
    if not 1 <= q.shape[-1] <= kernel.MAX_DK:
        raise ValueError(f"linear_scan: Dk {q.shape[-1]} (the kernel takes "
                         f"1..{kernel.MAX_DK})")


def linear_scan_bwd(q, k, v, w, u, do, chunk: int = SAFE_CHUNK,
                    init_state=None, d_state=None):
    """``(dq, dk, dv, dw, du, dS0)`` of ``linear_scan(q, k, v, w, u,
    chunk, init_state, return_state)`` at the cotangents ``do`` ``[B, S,
    H, Dv]`` (in v's dtype) and ``d_state`` ``[B, H, Dk, Dv]`` (fp32, the
    returned carry's; None for zero): dq/dk/dv in their operands' dtypes,
    dw fp32, du fp32 ``[H, Dk]`` (None without ``u``), dS0 fp32 (None
    without ``init_state``).  A CPU tensor runs
    ``ref.linear_scan_bwd_ref``; a CUDA tensor launches the backward
    kernels, or raises where the forward raises."""
    chunk = int(chunk)
    if not 1 <= chunk <= SAFE_CHUNK:
        raise ValueError(f"linear_scan_bwd: chunk {chunk} outside 1.."
                         f"{SAFE_CHUNK}, where the factored form is exact")
    if do.shape != v.shape:
        raise ValueError(f"linear_scan_bwd: do {tuple(do.shape)} must match "
                         f"v {tuple(v.shape)}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if d_state is not None and tuple(d_state.shape) != (b, h, dk, dv):
        raise ValueError(f"linear_scan_bwd: d_state must be [B, H, Dk, Dv] "
                         f"= {(b, h, dk, dv)}, got {tuple(d_state.shape)}")
    if q.device.type == "cpu":
        return ref.linear_scan_bwd_ref(q, k, v, w, u, do, chunk=chunk,
                                       init_state=init_state,
                                       d_state=d_state)
    _check(q, k, v, w, u, init_state)
    if do.device != q.device or do.dtype != v.dtype:
        raise ValueError(f"linear_scan_bwd: do {do.dtype}@{do.device} must "
                         f"match v {v.dtype}@{v.device}")
    if d_state is not None and (d_state.device != q.device
                                or d_state.dtype != torch.float32):
        raise ValueError(f"linear_scan_bwd: d_state must be fp32 on "
                         f"{q.device}, got {d_state.dtype}@{d_state.device}")
    q, k, v, w, do = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (q, k, v, w, do))
    u, init_state, d_state = (None if t is None else t.contiguous()
                              for t in (u, init_state, d_state))
    f32 = torch.float32
    dq = q.new_empty((b, s, h, dk))
    dk_ = k.new_empty((b, s, h, dk))
    dv_ = v.new_empty((b, s, h, dv))
    dw = q.new_empty((b, s, h, dk), dtype=f32)
    du = None if u is None else q.new_empty((h, dk), dtype=f32)
    ds0 = (None if init_state is None
           else q.new_empty((b, h, dk, dv), dtype=f32))
    if dq.numel() == 0 or dv_.numel() == 0:
        for t in (dq, dk_, dv_, dw, du):
            if t is not None:
                t.zero_()
        if ds0 is not None:
            if d_state is None:
                ds0.zero_()
            else:
                ds0.copy_(d_state)
        return dq, dk_, dv_, dw, du, ds0
    c = min(chunk, s)
    n = -(-s // c)
    # the checkpointed carries and their gradients, and du's partials
    ws = q.new_empty(kernel.bwd_scratch(v.dtype, b, s, h, dk, dv, c),
                     dtype=f32)
    dup = None if u is None else q.new_empty((b, h, n, dk), dtype=f32)
    kernel.launch_bwd(q, k, v, w, u, do, c, init_state, d_state, ws, dup,
                      dq, dk_, dv_, dw, du, ds0)
    global bwd_launches
    bwd_launches += 1
    bwd_launches_by_shape[_shape_key(q, v, u, chunk, init_state is not None
                                     or d_state is not None)] += 1
    return dq, dk_, dv_, dw, du, ds0


class LinearScanFn(torch.autograd.Function):
    """``linear_scan`` with ``linear_scan_bwd`` as its backward (see the
    module docstring).  Device-agnostic: the kernels on the card, the
    plain versions on the CPU.  The carry's cotangent is None where the
    returned carry took no part in the loss, and the output's where only
    the carry did (it is then zero)."""

    @staticmethod
    def forward(ctx, q, k, v, w, u, init_state, chunk, return_state):
        function_calls["forward"] += 1
        out = _linear_scan(q, k, v, w, u, chunk, init_state, return_state)
        ctx.chunk, ctx.return_state = chunk, return_state
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, w, u, init_state)
        return out

    @staticmethod
    def backward(ctx, do, d_state=None):
        function_calls["backward"] += 1
        q, k, v, w, u, s0 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(v)
        dq, dk, dv, dw, du, ds0 = linear_scan_bwd(
            q, k, v, w, u, do, ctx.chunk, init_state=s0, d_state=d_state)
        return (dq, dk, dv, dw.to(w.dtype),
                None if du is None else du.to(u.dtype),
                None if ds0 is None else ds0.to(s0.dtype), None, None)
