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
* a CUDA tensor launches the hand-written kernel, or raises.  The scan
  has no backward kernel yet (it comes with RWKV6 training, the next
  slice), so under grad mode an operand that requires grad raises
  ``NotImplementedError``: the kernel's output would carry no gradient.
  There is no fallback: q/k/v in another dtype than bf16/fp32 (or not all one dtype),
  ``w``, ``u`` or ``init_state`` not in fp32, or a ``Dk`` past the
  kernel's raise.  Mixed dtypes are the normal case: the RWKV6 forward
  passes bf16 r/k/v beside fp32 w and u.

``launches`` counts kernel launches (incremented where the kernel launches
and nowhere else); ``launches_by_shape`` splits it by
``(B, S, H, Dk, Dv, dtype, variant, chunk)``, the variant ``rwkv6`` or
``gla``, with ``+state`` where the call carries a state in or out.
"""
from __future__ import annotations

import collections

import torch

from ..costs import SAFE_CHUNK
from . import kernel, ref

launches = 0
launches_by_shape: collections.Counter = collections.Counter()


def reset_counts() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


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
    if q.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cpu or cuda, got {q.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, w, u, init_state)):
        raise NotImplementedError(
            "linear_scan has no backward on the card yet: the chunked scan "
            "backward kernel comes with RWKV6 training (the next slice); "
            "run under torch.no_grad() or on the CPU")
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
    if not 1 <= dk <= kernel.MAX_DK:
        raise ValueError(f"linear_scan: Dk {dk} (the kernel takes "
                         f"1..{kernel.MAX_DK})")
    q, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q, k, v, w))
    if u is not None:
        u = u.contiguous()
    if init_state is not None:
        init_state = init_state.contiguous()
    o = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    state = (torch.empty((b, h, dk, dv), dtype=torch.float32,
                         device=v.device) if return_state else None)
    if o.numel() == 0:
        if state is not None:
            if init_state is None:
                state.zero_()
            else:
                state.copy_(init_state)
        return (o, state) if return_state else o
    c = min(chunk, s)
    kernel.launch(q, k, v, w, u, o, c, s0=init_state, s1=state)
    global launches
    launches += 1
    variant = "gla" if u is None else "rwkv6"
    if init_state is not None or return_state:
        variant += "+state"
    launches_by_shape[(b, s, h, dk, dv, str(v.dtype), variant, c)] += 1
    return (o, state) if return_state else o
