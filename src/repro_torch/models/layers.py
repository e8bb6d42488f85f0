"""Shared layer primitives (norms, RoPE, the RWKV token shift, Mamba2's
causal conv) — plain torch; the GEMM-heavy paths live behind
``repro_torch.core.tapir`` ops.

Inside an open region these entry points dispatch through
``tapir.lift``: the same torch function becomes ONE node of the region
graph (identical numerics), so a whole block captures as one TaskGraph."""
from __future__ import annotations

import numpy as np
import torch

from ..core import tapir


def _rmsnorm_impl(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    if tapir.is_traced(x) or tapir.is_traced(scale):
        return tapir.lift(_rmsnorm_impl, x, scale, eps=eps)
    return _rmsnorm_impl(x, scale, eps=eps)


def _layernorm_impl(x, scale, bias=None, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    if tapir.is_traced(x) or tapir.is_traced(scale):
        if bias is None:
            return tapir.lift(_layernorm_impl, x, scale, eps=eps)
        return tapir.lift(_layernorm_impl, x, scale, bias, eps=eps)
    return _layernorm_impl(x, scale, bias, eps=eps)


def rope_table(positions, head_dim: int, base: float = 10000.0,
               fraction: float = 1.0):
    """cos/sin tables for the rotated ``fraction`` of head dims.
    positions: [S] (or [B,S]) tensor.  Returns cos, sin of [..., S, rot/2]
    in float32."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / base ** (np.arange(0, rot, 2, dtype=np.float32) / rot)
    inv = torch.as_tensor(inv.astype(np.float32), device=positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def bucket_pow2(n: int, lo: int = 8) -> int:
    """Round ``n`` up to the next power of two (floor ``lo``) — the shape
    bucketing serving uses so region programs replay across lengths."""
    m = lo
    while m < n:
        m *= 2
    return m


#: bucketed full RoPE tables by (bucket_len, head_dim, base, fraction,
#: device).  Cached so their tensor IDENTITIES are stable across decode
#: steps — a region that takes the table as an input binds the same
#: leaves every call and replays from the program cache.
_FULL_ROPE: dict = {}


def full_rope_table(max_len: int, head_dim: int, base: float = 10000.0,
                    fraction: float = 1.0, device="cpu"):
    """cos/sin for ALL positions ``[0, bucket_pow2(max_len))`` on
    ``device``; serving gathers per-slot rows from it."""
    Lb = bucket_pow2(int(max_len))
    dev = torch.device(device)
    key = (Lb, int(head_dim), float(base), float(fraction), str(dev))
    tab = _FULL_ROPE.get(key)
    if tab is None:
        tab = rope_table(torch.arange(Lb, device=dev), head_dim, base,
                         fraction)
        _FULL_ROPE[key] = tab
    return tab


#: arange tables by (seq_len, head_dim, base, fraction, device)
_ARANGE_ROPE: dict = {}


def arange_rope_table(seq_len: int, head_dim: int, base: float = 10000.0,
                      fraction: float = 1.0, device="cpu"):
    """cos/sin for positions ``arange(seq_len)`` exactly (no bucketing) on
    ``device``, memoized so the tensor IDENTITIES are stable across calls:
    a region that binds them as inputs replays instead of re-tracing.
    Values are those of ``rope_table(arange(seq_len))`` (it is that call,
    made once)."""
    dev = torch.device(device)
    key = (int(seq_len), int(head_dim), float(base), float(fraction),
           str(dev))
    tab = _ARANGE_ROPE.get(key)
    if tab is None:
        tab = rope_table(torch.arange(int(seq_len), device=dev), head_dim,
                         base, fraction)
        _ARANGE_ROPE[key] = tab
    return tab


def apply_rope(x, cos, sin, fraction: float = 1.0):
    """x: [B,S,H,D]; cos/sin [S, rot/2] or [B, S, rot/2].  ``fraction=0.5``
    rotates only the first half of the head dims."""
    if tapir.is_traced(x) or tapir.is_traced(cos):
        return tapir.lift(_apply_rope_impl, x, cos, sin, fraction=fraction)
    return _apply_rope_impl(x, cos, sin, fraction=fraction)


def _apply_rope_impl(x, cos, sin, fraction: float = 1.0):
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    elif cos.ndim == 3:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    # the reference multiplies the compute-dtype halves by the fp32 table:
    # jnp promotes, so the arithmetic is fp32 and the result casts back
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(*x1.shape[:-1], rot)
    return torch.cat([yr.to(x.dtype), xp], dim=-1).to(x.dtype)


def _groupnorm_heads_impl(x, scale, eps: float = 64e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def groupnorm_heads(x, scale, eps: float = 64e-5):
    """Per-head groupnorm (the RWKV6 wkv output norm).  x: [B,S,H,D],
    scale: [H,D]; eps is RWKV6's 64e-5, not the rmsnorm default."""
    if tapir.is_traced(x) or tapir.is_traced(scale):
        return tapir.lift(_groupnorm_heads_impl, x, scale, eps=eps)
    return _groupnorm_heads_impl(x, scale, eps=eps)


def _token_shift_shifted(x, state):
    return torch.cat([state, x[:, :-1]], dim=1)


def _token_shift_zero(x):
    # the zero initial state is made INSIDE the lifted fn: a fresh zeros
    # tensor as a region input would disable program replay (its identity
    # cannot be rebound to an argument leaf)
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def token_shift(x, state=None):
    """RWKV token shift: x_{t-1}, with zeros (or ``state`` [B,1,D]) at
    t = 0.  Returns (shifted, new_state [B,1,D])."""
    if tapir.is_traced(x) or tapir.is_traced(state):
        if state is None:
            shifted = tapir.lift(_token_shift_zero, x)
        else:
            shifted = tapir.lift(_token_shift_shifted, x, state)
        return shifted, x[:, -1:]
    if state is None:
        return _token_shift_zero(x), x[:, -1:]
    return _token_shift_shifted(x, state), x[:, -1:]


def _causal_conv_y(x, state, w):
    K = w.shape[0]
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return y.to(x.dtype)


def _causal_conv_state(x, state):
    xp = torch.cat([state, x], dim=1)
    return xp[:, x.shape[1]:] if state.shape[1] else state


def _causal_conv_y_zero(x, w):
    # the zero state is made INSIDE the lifted fn (keeps program replay
    # alive, as ``_token_shift_zero`` does)
    K = w.shape[0]
    zero = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    return _causal_conv_y(x, zero, w)


def _causal_conv_state_zero(x, w):
    K = w.shape[0]
    zero = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    return _causal_conv_state(x, zero)


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv (Mamba2's).  x: [B,S,D], w: [K,D]; ``state``:
    the [B,K-1,D] carry of the previous tokens (zeros when None).  Returns
    (y, new_state [B,K-1,D]).  The taps sum in the reference's order (one
    product per tap, added left to right in x's dtype)."""
    if any(tapir.is_traced(t) for t in (x, state, w)):
        if state is None:
            return (tapir.lift(_causal_conv_y_zero, x, w),
                    tapir.lift(_causal_conv_state_zero, x, w))
        return (tapir.lift(_causal_conv_y, x, state, w),
                tapir.lift(_causal_conv_state, x, state))
    if state is None:
        return _causal_conv_y_zero(x, w), _causal_conv_state_zero(x, w)
    return _causal_conv_y(x, state, w), _causal_conv_state(x, state)
