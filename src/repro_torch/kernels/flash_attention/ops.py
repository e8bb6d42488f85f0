"""Public wrapper for flash attention: the contract of the JAX package's
``kernels/flash_attention/ops.py::flash_attention`` in its layout, q
``[B,Sq,Hq,D]`` and k/v ``[B,Skv,Hkv,D]`` in, ``[B,Sq,Hq,D]`` out.

* a CPU tensor runs the plain version (``ref.flash_attention_ref``; with a
  ``bias``, the oracle ``ref.attention_ref``, as the reference does);
* a CUDA tensor launches the hand-written kernel, or raises.  There is no
  fallback: a bias, another dtype than bf16/fp32, ``Hq % Hkv != 0``, a head
  dim past the kernel's, or causal ``Sq > Skv`` (a query row with no
  visible key, which the reference leaves ill-defined) raise.

The route and tiles are ``kernel.plan(dtype, D)``: bf16 runs the TMA +
``wgmma`` kernel (a layout TMA cannot address is first copied into one it
can, ``kernel.tma_operand``), fp32 the FMA kernel.  The kernel masks keys
past ``Skv`` itself, so ragged non-causal lengths need no fallback either.
``launches`` counts kernel launches (incremented where the kernel launches
and nowhere else); ``launches_by_shape`` splits it by ``(B, Sq, Skv, Hq,
Hkv, D, dtype, causal)``.

Gradients.  Under grad mode, when q, k or v requires grad (and there is
no bias), ``flash_attention`` goes through ``FlashAttentionFn`` on every
device: its forward is this wrapper asked for the rows' log-sum-exp
(``return_lse``: the kernel writes it from the m and l it holds), its
backward ``flash_attention_bwd``: on a CUDA tensor the hand-written
backward kernels (``csrc/flash_attention_bwd.cu``: delta, then dK/dV and
dQ, and in bf16 the sum of the dK/dV partials of the group's head splits,
fp32 scratch this wrapper allocates (``kernel.bwd_scratch``);
deterministic, no atomics), on a CPU tensor the plain
``ref.flash_attention_bwd_ref``.  The reference's ``flash_attention_vjp``
takes the VJP of its materialising oracle; the values agree.
``bwd_launches`` / ``bwd_launches_by_shape`` count the backward's launches
(one a call, however many kernels it launches); ``function_calls``
counts ``FlashAttentionFn``'s forward and backward on any device.
"""
from __future__ import annotations

import collections
import math

import torch

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


def flash_attention(q, k, v, causal: bool = False, bias=None,
                    return_lse: bool = False):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D].  Returns [B, Sq, Hq, D]
    in q.dtype; with ``return_lse`` also each row's natural log-sum-exp,
    fp32 [B, Hq, Sq] (no bias)."""
    if bias is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        if return_lse:
            raise ValueError("flash_attention: return_lse is the autograd "
                             "Function's own; it takes no grad")
        return FlashAttentionFn.apply(q, k, v, bool(causal))
    if return_lse and bias is not None:
        raise ValueError("flash_attention: no lse with a bias")
    if q.device.type == "cpu":
        if bias is not None:
            return ref.attention_ref(q, k, v, causal=causal, bias=bias)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=return_lse)
    _check(q, k, v, causal, bias)
    return _launch(q, k, v, causal, return_lse)


def _check(q, k, v, causal, bias) -> None:
    """The kernels' refusals (forward and backward alike)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    if bias is not None:
        raise ValueError("flash_attention: the kernel takes no bias")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D]"
                         f" expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in kernel.DT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share a device")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if not 1 <= d <= kernel.MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} (the kernel takes "
                         f"1..{kernel.MAX_HEAD_DIM})")
    if causal and sq > skv:
        raise ValueError(f"flash_attention: causal Sq={sq} > Skv={skv} "
                         f"leaves query rows with no visible key")


def _launch(q, k, v, causal, return_lse):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or sq == 0 or hq == 0:
        return (o, lse) if return_lse else o
    if skv == 0:
        if return_lse:
            lse.fill_(-torch.inf)
        return (o.zero_(), lse) if return_lse else o.zero_()
    if kernel.plan(q.dtype, d).route == "wgmma":
        q, k, v = (kernel.tma_operand(t) for t in (q, k, v))
    # the head dim zero-padded for TMA: the padded columns are dropped
    out = o if q.shape[-1] == d else torch.empty(q.shape, dtype=q.dtype,
                                                  device=q.device)
    kernel.launch(q, k, v, out, causal, kernel.score_scale(q.dtype, d), lse)
    if out is not o:
        o.copy_(out[..., :d])
    global launches
    launches += 1
    launches_by_shape[(b, sq, skv, hq, hkv, d, str(q.dtype), bool(causal))] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False):
    """(dq, dk, dv) of ``o = flash_attention(q, k, v, causal)`` at the
    cotangent ``do``, from the forward's ``lse``; each in its operand's
    dtype.  A CPU tensor runs ``ref.flash_attention_bwd_ref``; a CUDA
    tensor launches the backward kernels, or raises where the forward
    raises (causal Sq > Skv, a head dim past the kernel's, another dtype
    than bf16/fp32)."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    _check(q, k, v, causal, None)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)} "
                         f"{o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be fp32 "
                         f"{(b, hq, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v, o, do = (kernel.tma_operand(t) for t in (q, k, v, o, do))
    dp = q.shape[-1]   # the head dim the kernels read (D, or D padded)
    if dp != d:
        dq, dk, dv = (t.new_empty(t.shape[:-1] + (dp,)) for t in (dq, dk, dv))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    scratch = kernel.bwd_scratch(q.dtype, dp, b, skv, hq, hkv)
    acc = None if scratch is None else torch.empty(   # dK/dV's partials
        scratch, dtype=torch.float32, device=q.device)
    kernel.launch_bwd(q, k, v, o, do, lse.contiguous(), delta, acc, dq, dk,
                      dv, causal, 1.0 / math.sqrt(d))
    global bwd_launches
    bwd_launches += 1
    bwd_launches_by_shape[(b, sq, skv, hq, hkv, d, str(q.dtype),
                           bool(causal))] += 1
    if dp != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` (no bias) with ``flash_attention_bwd`` as its
    backward.  Device-agnostic: the kernels on the card, the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        function_calls["forward"] += 1
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        function_calls["backward"] += 1
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None
