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
"""
from __future__ import annotations

import collections

import torch

from . import kernel, ref

launches = 0
launches_by_shape: collections.Counter = collections.Counter()


def reset_counts() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def flash_attention(q, k, v, causal: bool = False, bias=None):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D].  Returns [B, Sq, Hq, D]
    in q.dtype."""
    if q.device.type == "cpu":
        if bias is not None:
            return ref.attention_ref(q, k, v, causal=causal, bias=bias)
        return ref.flash_attention_ref(q, k, v, causal=causal)
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
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or hq == 0:
        return o
    if skv == 0:
        return o.zero_()
    if kernel.plan(q.dtype, d).route == "wgmma":
        q, k, v = (kernel.tma_operand(t) for t in (q, k, v))
    # the head dim zero-padded for TMA: the padded columns are dropped
    out = o if q.shape[-1] == d else torch.empty(q.shape, dtype=q.dtype,
                                                  device=q.device)
    kernel.launch(q, k, v, out, causal, kernel.score_scale(q.dtype, d))
    if out is not o:
        o.copy_(out[..., :d])
    global launches
    launches += 1
    launches_by_shape[(b, sq, skv, hq, hkv, d, str(q.dtype), bool(causal))] += 1
    return o
