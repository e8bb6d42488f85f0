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
* ``linear_scan_bwd_ref`` is the chunked form's gradient written out by
  hand, the arithmetic of the Hopper backward (``csrc/linear_scan_bwd.cu``):
  the backward a CPU tensor runs and the kernel's yardstick on the card.
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


def _rev_cumsum(x, dim: int):
    """Inclusive sums from the end along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def linear_scan_bwd_ref(q, k, v, w, u, do, chunk: int = SAFE_CHUNK,
                        init_state=None, d_state=None):
    """The gradients of ``linear_scan_chunked(q, k, v, w, u, chunk,
    init_state, return_state)`` at the cotangents ``do`` (of the output)
    and ``d_state`` (of the final carry, or None), written out by hand in
    the arithmetic the Hopper backward follows (``csrc/linear_scan_bwd.cu``):
    the same chunk, padding, normalizer, clamp and triangle, all in fp32.

    (a) the chunk-start carries ``S_0 .. S_N`` (the forward's carry
    recurrence); (b) their gradients ``dS_N = d_state`` (or 0) ``..
    dS_0`` by ``dS_n = exp(lbc) dS_{n+1} + (q exp(lbq))^T do``; (c) per
    chunk, from its own rows, ``S_n``, ``S_{n+1}`` and ``dS_{n+1}``::

        dA  = mask(do v^T)                       dqt = dA kt,  dkt = dA^T qt
        dv  = A^T do (+ bonus do) + kE dS_{n+1}
        dq  = dqt fq + (do S_n^T) exp(lbq)       (+ (do.v) u k)
        dk  = dkt fk + (v dS_{n+1}^T) exp(lbc - lb)  (+ (do.v) u q)

    and the decay's, through log w only (``dw = dlog w / w``): each term
    of the chunk reaches ``dlog w_s`` through the exponent it carries --
    a pair ``(t, j)`` of the triangle, ``M = dA qt kt``, for ``j < s < t``
    (GLA ``j < s <= t``); the carry read, ``(q exp(lbq)) (do S_n^T)``, for
    ``t > s`` (GLA ``t >= s``); the carry written, ``(k exp(lbc - lb))
    (v dS_{n+1}^T)``, for ``j < s``; the chunk's decay ``exp(lbc)
    sum_e dS_{n+1} S_n`` for every ``s``.  This is the global identity
    ``dL_s = q dq - k dk`` with each pair's two halves taken together:
    written as that difference, the leading terms of neighbouring rows
    cancel (at the decay clip, to 1 part in 1e3) and fp32 loses three
    digits of ``dw``.  The normalizer's gradient is zero (the factors'
    products do not depend on it) and is not formed.  Masked score
    entries are selected away, never multiplied, as in the forward.

    Returns ``(dq, dk, dv, dw, du, dS0)``: dq/dk/dv in q/k/v's dtypes, dw
    in fp32, du fp32 ``[H, Dk]`` (None without ``u``), dS0 fp32 ``[B, H,
    Dk, Dv]`` (None without ``init_state``)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    C = max(1, min(int(chunk), S))
    N = -(-S // C)
    pad = N * C - S
    f32 = torch.float32
    rwkv = u is not None
    qf, kf, vf, wf, dof = (t.to(f32) for t in (q, k, v, w, do))
    if pad:
        qf, kf, vf, dof = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (qf, kf, vf, dof))
        wf = F.pad(wf, (0, 0, 0, 0, 0, pad), value=1.0)
    qc, kc, wc = (t.reshape(B, N, C, H, Dk) for t in (qf, kf, wf))
    vc, doc = (t.reshape(B, N, C, H, Dv) for t in (vf, dof))
    lw = torch.log(wc)
    lb = torch.cumsum(lw, dim=2)                      # inclusive
    lbq = lb - lw if rwkv else lb
    mid = lb[:, :, C // 2][:, :, None]
    lbc = lb[:, :, -1]                                # [B,N,H,Dk]
    fq = torch.exp(torch.clamp(lbq - mid, max=80.0))
    fk = torch.exp(torch.clamp(mid - lb, max=80.0))
    qt, kt = qc * fq, kc * fk
    eq = torch.exp(lbq)
    ek = torch.exp(lbc[:, :, None] - lb)
    dC = torch.exp(lbc)
    kE, qi = kc * ek, qc * eq

    # (a) the chunk-start carries, (b) their gradients
    st = [torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
          if init_state is None else init_state.to(f32)]
    for n in range(N):
        st.append(dC[:, n, :, :, None] * st[-1]
                  + torch.einsum("bchd,bche->bhde", kE[:, n], vc[:, n]))
    dst = [torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
           if d_state is None else d_state.to(f32)]
    for n in range(N - 1, -1, -1):
        dst.append(dC[:, n, :, :, None] * dst[-1]
                   + torch.einsum("bchd,bche->bhde", qi[:, n], doc[:, n]))
    dst.reverse()                                     # dst[n] = dS_n
    Sn = torch.stack(st[:-1], dim=1)                  # [B,N,H,Dk,Dv]
    S1 = torch.stack(st[1:], dim=1)
    dS1 = torch.stack(dst[1:], dim=1)

    # (c) every chunk from its own rows and carries
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=q.device),
                     diagonal=-1 if rwkv else 0)
    zero = torch.zeros((), dtype=f32, device=q.device)
    A = torch.where(tri, torch.einsum("bnchd,bnjhd->bnhcj", qt, kt), zero)
    dA_full = torch.einsum("bnche,bnjhe->bnhcj", doc, vc)
    dA = torch.where(tri, dA_full, zero)
    dbon = torch.diagonal(dA_full, dim1=-2, dim2=-1)  # [B,N,H,C]: do.v
    dbon = dbon.permute(0, 1, 3, 2)                   # [B,N,C,H]
    dv = torch.einsum("bnhcj,bnche->bnjhe", A, doc)
    if rwkv:
        uf = u.to(f32)
        bonus = torch.einsum("bnchd,hd,bnchd->bnch", qc, uf, kc)
        dv = dv + bonus[..., None] * doc
    dv = dv + torch.einsum("bnjhd,bnhde->bnjhe", kE, dS1)
    dqt = torch.einsum("bnhcj,bnjhd->bnchd", dA, kt)
    dkt = torch.einsum("bnhcj,bnchd->bnjhd", dA, qt)
    gq = torch.einsum("bnche,bnhde->bnchd", doc, Sn)   # do S_n^T
    gk = torch.einsum("bnche,bnhde->bnchd", vc, dS1)   # v dS_{n+1}^T
    dq = dqt * fq + gq * eq
    dk = dkt * fk + gk * ek
    # dlog w_s, each term through the exponent it carries, none cancelling
    # another: a pair (t, j) of the triangle through lbq_t - lb_j (s in
    # (j, t), or (j, t] for GLA); the carry read through lbq_t (t > s, or
    # t >= s); the carry written through lbc - lb_j (j < s); the chunk's
    # decay through lbc (every s)
    qtp, ktp = qt.transpose(2, 3), kt.transpose(2, 3)  # [B,N,H,C,Dk]
    M = torch.where(tri[..., None],
                    dA[..., None] * qtp[:, :, :, :, None] * ktp[:, :, :, None],
                    zero)                              # [B,N,H,t,j,Dk]
    R = F.pad(torch.cumsum(M, dim=4)[:, :, :, :, :-1],
              (0, 0, 1, 0))                            # sum over j < s
    X = torch.where(tri[..., None], R, zero).sum(3)    # over t: [B,N,H,s,Dk]
    gqi = qi * gq
    rq = _rev_cumsum(gqi, 2)
    if rwkv:   # exclusive: t > s
        rq = F.pad(rq[:, :, 1:], (0, 0, 0, 0, 0, 1))
    gke = kE * gk
    pk = F.pad(torch.cumsum(gke, dim=2)[:, :, :-1], (0, 0, 0, 0, 1, 0))
    gdc = (dC * (dS1 * Sn).sum(-1))[:, :, None]        # [B,N,1,H,Dk]
    dlw = X.transpose(2, 3) + rq + pk + gdc
    du = None
    if rwkv:
        g = dbon[..., None] * uf
        dq = dq + g * kc
        dk = dk + g * qc
        du = torch.einsum("bnch,bnchd,bnchd->hd", dbon, qc, kc)
    dw = dlw / wc

    def out(t, d, dt):
        return t.reshape(B, N * C, H, d)[:, :S].to(dt)

    return (out(dq, Dk, q.dtype), out(dk, Dk, k.dtype), out(dv, Dv, v.dtype),
            out(dw, Dk, f32), du,
            dst[0] if init_state is not None else None)
