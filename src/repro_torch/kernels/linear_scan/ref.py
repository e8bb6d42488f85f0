"""Plain PyTorch versions of the gated linear-attention scan: the kernel's
reference on the card and the path a CPU tensor takes.

State ``S_t`` in ``R^{Dk x Dv}`` per (batch, head)::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t

GLA / Mamba2-SSD (``u is None``):   ``o_t = q_t S_t``
RWKV6 (``u`` given, the bonus):     ``o_t = q_t (S_{t-1} + diag(u) k_t^T v_t)``

q, k, w: ``[B, S, H, Dk]``; v: ``[B, S, H, Dv]``; u: ``[H, Dk]`` or None.
Everything accumulates in fp32; the output is in ``v.dtype``.

* ``linear_scan_ref`` is the JAX package's oracle
  (``kernels/linear_scan/ref.py``): the sequential element recurrence.
* ``linear_scan_chunked`` is its chunked form
  (``kernels/linear_scan/ops.py::linear_scan_chunked``), the arithmetic the
  Hopper kernel follows (its bf16 route in base 2, with bf16 tensor-core
  operands): ``C = min(chunk, S)``; ``w`` padded with 1 and
  q/k/v with 0 to a multiple of ``C``; inside a chunk the inclusive prefix
  sum ``lb`` of ``log w``, the mid-chunk normalizer ``lb[C // 2]``, both
  factor exponents clamped at 80, the inclusive triangle (GLA) or the
  strict one plus the bonus (RWKV6); the carry ``dC S0 + kE^T v``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..costs import SAFE_CHUNK


def linear_scan_ref(q, k, v, w, u=None):
    """The sequential fp32 recurrence, one timestep at a time."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    qf, kf, vf, wf = (t.to(f32) for t in (q, k, v, w))
    uf = u.to(f32)[None, :, :, None] if u is not None else None
    state = torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # [B,H,Dk,Dv]
        if uf is not None:
            att = state + uf * kv
            outs.append(torch.einsum("bhk,bhkv->bhv", qf[:, t], att))
            state = wf[:, t, :, :, None] * state + kv
        else:
            state = wf[:, t, :, :, None] * state + kv
            outs.append(torch.einsum("bhk,bhkv->bhv", qf[:, t], state))
    return torch.stack(outs, dim=1).to(v.dtype)


def linear_scan_chunked(q, k, v, w, u=None, chunk: int = SAFE_CHUNK,
                        init_state=None, return_state: bool = False):
    """The chunk-parallel form.  ``init_state`` (``[B, H, Dk, Dv]``) seeds
    the carry; ``return_state`` also returns the final carry in fp32."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    C = max(1, min(int(chunk), S))
    N = -(-S // C)
    pad = N * C - S
    f32 = torch.float32
    qf, kf, vf, wf = (t.to(f32) for t in (q, k, v, w))
    if pad:
        qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        wf = F.pad(wf, (0, 0, 0, 0, 0, pad), value=1.0)
    qc, kc, wc = (t.reshape(B, N, C, H, Dk) for t in (qf, kf, wf))
    vc = vf.reshape(B, N, C, H, Dv)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=q.device),
                     diagonal=-1 if u is not None else 0)
    uf = u.to(f32) if u is not None else None
    S0 = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
          if init_state is None else init_state.to(f32))
    outs = []
    for n in range(N):
        q_n, k_n, v_n, w_n = qc[:, n], kc[:, n], vc[:, n], wc[:, n]
        lw = torch.log(w_n)
        lb = torch.cumsum(lw, dim=1)                  # inclusive [B,C,H,Dk]
        lbq = lb - lw if uf is not None else lb       # RWKV6 reads S_{t-1}
        mid = lb[:, C // 2][:, None]                  # normalizer [B,1,H,Dk]
        # each factor is bounded by exp(C * L / 2) for a per-step log-decay
        # >= -L, exact in fp32 for C <= 21 at the RWKV6 clip L = e^2; the
        # masked (upper-triangle) products may still overflow, and the
        # where() drops them before they meet v
        qt = q_n * torch.exp(torch.clamp(lbq - mid, max=80.0))
        kt = k_n * torch.exp(torch.clamp(mid - lb, max=80.0))
        A = torch.einsum("bchd,bjhd->bhcj", qt, kt)   # [B,H,C,C]
        A = torch.where(tri, A, torch.zeros((), dtype=f32, device=A.device))
        o = torch.einsum("bhcj,bjhe->bche", A, v_n)   # intra
        if uf is not None:
            bonus = torch.einsum("bchd,hd,bchd->bch", q_n, uf, k_n)
            o = o + bonus[..., None] * v_n
        o = o + torch.einsum("bchd,bhde->bche",       # inter (carry read)
                             q_n * torch.exp(lbq), S0)
        dC = torch.exp(lb[:, -1])                     # [B,H,Dk] chunk decay
        kE = k_n * torch.exp(lb[:, -1][:, None] - lb)
        S0 = dC[..., None] * S0 + torch.einsum("bchd,bche->bhde", kE, v_n)
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(B, N * C, H, Dv)[:, :S].to(v.dtype)
    return (o, S0) if return_state else o
