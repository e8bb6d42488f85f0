"""Plain PyTorch versions of attention: the kernel's reference on the card
and the path a CPU tensor takes.

* ``attention_ref`` is the JAX package's oracle
  (``kernels/flash_attention/ref.py``): grouped, fp32 scores and softmax,
  a ``-inf`` causal mask, output in ``q.dtype``.
* ``flash_attention_ref`` follows the Hopper kernel's own arithmetic: an
  online softmax over the fixed K/V tiles of the route the call takes
  (``kernel.plan(dtype, D)``: 128 keys in bf16, 64 in fp32), in base 2
  with the scale folded in where the route does so (bf16), masked scores
  at ``finfo(float32).min``, ``p`` rounded to ``v``'s dtype before the PV
  product, and ``l == 0 -> 1`` at the end; with ``return_lse`` also each
  row's natural log-sum-exp from the same m and l, as the kernel writes
  it for the backward.
* ``flash_attention_bwd_ref`` is the backward's plain version: dQ, dK and
  dV in explicit fp32 over the materialised scores, the probabilities
  recomputed from the forward's log-sum-exp.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import plan, score_scale

NEG_INF = float(np.finfo(np.float32).min)


def attention_ref(q, k, v, causal: bool = False, bias=None):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]; Hq % Hkv == 0.  Returns
    [B, Sq, Hq, D] in q.dtype.  Queries align to the end of the keys."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    grp = hq // hkv
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, grp, d).to(f32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(f32)) * (1.0 / np.sqrt(d))
    if bias is not None:
        s = s + (bias.reshape(b, hkv, grp, sq, skv) if bias.ndim == 4
                 else bias)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(f32), v.to(f32))
    return o.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention_ref(q, k, v, causal: bool = False,
                        return_lse: bool = False):
    """The kernel's arithmetic, tile by tile, over the K/V tile of the
    route the call takes (``kernel.plan``).  q: [B, Sq, Hq, D]; k, v:
    [B, Skv, Hkv, D].  Causal queries align to the end of the keys
    (``q_offset = Skv - Sq``); keys past ``Skv`` never exist here (the
    kernel masks its padded tile, which changes no value).  With
    ``return_lse`` returns ``(o, lse)``, lse fp32 [B, Hq, Sq] in natural
    log (the bf16 route's m is in base 2: lse = (m + log2 l) ln 2)."""
    b, sq, hq, d = q.shape
    route = plan(q.dtype, d)
    block_kv = route.block_kv
    exp = torch.exp2 if route.base2 else torch.exp
    skv, hkv = k.shape[1], k.shape[2]
    grp = hq // hkv
    f32 = torch.float32
    dev = q.device
    qg = q.reshape(b, sq, hkv, grp, d).permute(0, 2, 3, 1, 4).to(f32)
    kt = k.permute(0, 2, 1, 3)          # [B, Hkv, Skv, D]
    vt = v.permute(0, 2, 1, 3)
    scale = score_scale(q.dtype, d)
    q_off = skv - sq if causal else 0
    qpos = q_off + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, grp, sq, 1), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, hkv, grp, sq, 1), dtype=f32, device=dev)
    acc = torch.zeros((b, hkv, grp, sq, d), dtype=f32, device=dev)
    end = min(skv, q_off + sq) if causal else skv
    for kv0 in range(0, end, block_kv):
        kb = kt[:, :, kv0:kv0 + block_kv]
        vb = vt[:, :, kv0:kv0 + block_kv]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb.to(f32)) * scale
        if causal:
            kpos = kv0 + torch.arange(kb.shape[2], device=dev)
            s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = exp(s - m_new)
        alpha = exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v.dtype).to(f32), vb.to(f32))
        m = m_new
    o = acc / torch.where(l == 0, torch.ones_like(l), l)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log2(l)) * float(np.log(2.0)) if route.base2 \
        else m + torch.log(l)
    return o, lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = False):
    """(dq, dk, dv) of attention at the cotangent ``do``, in explicit fp32
    over the materialised [Sq, Skv] scores: P = exp(S / sqrt(D) - lse)
    from the forward's natural log-sum-exp ``lse [B, Hq, Sq]``, D_i =
    rowsum(do * o), dS = P (dO V^T - D), dQ = dS K / sqrt(D), dK = dS^T Q /
    sqrt(D) and dV = P^T dO summed over each K/V head's query group.  Each
    gradient comes in its operand's dtype.  Causal queries align to the
    end of the keys; causal ``Sq > Skv`` raises, as the kernel's wrapper
    does."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if causal and sq > skv:
        raise ValueError(f"flash_attention backward: causal Sq={sq} > "
                         f"Skv={skv} leaves query rows with no visible key")
    grp = hq // hkv
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, grp, d).to(f32)
    dog = do.reshape(b, sq, hkv, grp, d).to(f32)
    og = o.reshape(b, sq, hkv, grp, d).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    scale = 1.0 / float(np.sqrt(d))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    p = torch.exp(s - lse.reshape(b, hkv, grp, sq, 1).to(f32))
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        p = torch.where(mask, p, 0.0)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dog, og)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
