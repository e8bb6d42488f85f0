"""Public wrapper for the chunked linear scan: the contract of the JAX
package's ``kernels/linear_scan/ops.py::linear_scan`` in its layout, q/k/w
``[B,S,H,Dk]``, v ``[B,S,H,Dv]``, u ``[H,Dk]`` or None in, ``[B,S,H,Dv]``
in ``v.dtype`` out.

* ``chunk`` above ``SAFE_CHUNK`` raises on any device: past it the
  factored score block is no longer exact (``kernels/costs.py``);
* a CPU tensor runs the plain version ``ref.linear_scan_chunked`` at the
  same chunk;
* a CUDA tensor launches the hand-written kernel, or raises.  There is no
  fallback: q/k/v in another dtype than bf16/fp32 (or not all one dtype),
  ``w`` or ``u`` not in fp32, or a ``Dk`` past the kernel's raise.  Mixed
  dtypes are the normal case: the RWKV6 forward passes bf16 r/k/v beside
  fp32 w and u.

``launches`` counts kernel launches (incremented where the kernel launches
and nowhere else); ``launches_by_shape`` splits it by
``(B, S, H, Dk, Dv, dtype, variant, chunk)``.
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


def linear_scan(q, k, v, w, u=None, chunk: int = SAFE_CHUNK):
    """q, k, w: [B, S, H, Dk]; v: [B, S, H, Dv]; u: [H, Dk] or None (GLA).
    Returns [B, S, H, Dv] in v.dtype."""
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
    if u is not None and tuple(u.shape) != (h, dk):
        raise ValueError(f"linear_scan: u must be [H, Dk] = {(h, dk)}, got "
                         f"{tuple(u.shape)}")
    if q.device.type == "cpu":
        return ref.linear_scan_chunked(q, k, v, w, u=u, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cpu or cuda, got {q.device}")
    if any(t.device != q.device for t in (k, v, w)) or (
            u is not None and u.device != q.device):
        raise ValueError("linear_scan: every operand must share a device")
    if q.dtype not in kernel.DT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"linear_scan kernel takes q/k/v in one of "
                         f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if w.dtype != torch.float32 or (u is not None
                                    and u.dtype != torch.float32):
        raise ValueError(f"linear_scan kernel takes w and u in float32, got "
                         f"{w.dtype}, {None if u is None else u.dtype}")
    if not 1 <= dk <= kernel.MAX_DK:
        raise ValueError(f"linear_scan: Dk {dk} (the kernel takes "
                         f"1..{kernel.MAX_DK})")
    q, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q, k, v, w))
    if u is not None:
        u = u.contiguous()
    o = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if o.numel() == 0:
        return o
    c = min(chunk, s)
    kernel.launch(q, k, v, w, u, o, c)
    global launches
    launches += 1
    launches_by_shape[(b, s, h, dk, v.shape[-1], str(v.dtype),
                       "gla" if u is None else "rwkv6", c)] += 1
    return o
