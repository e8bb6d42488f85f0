"""Roofline cost descriptors the scheduler's impl registry reads for
attention and the linear scan.

They are plain arithmetic over shapes, copied from the JAX package's
``kernels/flash_attention/ops.py`` and ``kernels/linear_scan/ops.py`` so the
port's schedule costs every candidate exactly as the reference does.  The
GEMM's descriptor lives with its kernel (``fused_matmul.ops.matmul_cost``).
"""
from __future__ import annotations

#: Largest numerically-exact chunk for the mid-normalized factored score
#: matmul of the chunked linear scan (chunk * e^2 / 2 < 80 => chunk <= 21;
#: 16 is the aligned choice).
SAFE_CHUNK = 16


def attention_cost(b, sq, skv, h, hkv, d, eb, impl, block_kv=1024):
    """Roofline terms for one candidate implementation of an attention node:
    ``dict(flops, io_bytes, score_bytes, copy_bytes, steps)`` — work, the
    q/k/v/o streaming, ONE pass over the fp32 score matrix (impls that
    materialize it pay it several times, a CostModel knob), the GQA K/V
    repeat copy, and the serial step count of the blockwise scan."""
    grp = max(h // max(hkv, 1), 1)
    flops = 4.0 * b * h * sq * skv * d
    io = eb * (2.0 * b * sq * h * d + 2.0 * b * skv * hkv * d)
    score = 4.0 * b * h * sq * skv
    out = dict(flops=flops, io_bytes=io, score_bytes=0.0, copy_bytes=0.0,
               steps=0)
    if impl in ("materialized_grouped", "materialized_repeat", "ref",
                "opaque"):
        out["score_bytes"] = score
        if impl == "materialized_repeat" and grp > 1:
            out["copy_bytes"] = 2.0 * (grp - 1) * b * skv * hkv * d * eb
    elif impl == "blockwise":
        bkv = max(1, min(block_kv, skv))
        out["steps"] = -(-skv // bkv)
        out["flops"] += 2.0 * b * h * sq * d * out["steps"]
    elif impl != "flash_kernel":
        raise ValueError(f"unknown attention impl {impl!r}")
    return out


def scan_cost(b, seq, h, d_k, d_v, eb, impl, chunk=SAFE_CHUNK):
    """Roofline terms for one candidate implementation of a linear_scan
    node: ``dict(flops, io_bytes, steps)`` (``steps`` is the serial trip
    count: every timestep for ``ref``, every chunk for ``chunked``)."""
    flops = 8.0 * b * seq * h * d_v
    io = eb * b * seq * h * (2.0 * d_k + 2.0 * d_v)
    if impl == "ref":
        return dict(flops=flops, io_bytes=io, steps=int(seq))
    c = max(1, min(chunk, max(seq, 1)))
    flops += 2.0 * b * h * (-(-seq // c)) * c * c * (d_k + d_v)
    if impl == "chunked":
        return dict(flops=flops, io_bytes=io, steps=int(-(-seq // c)))
    if impl == "kernel":
        return dict(flops=flops, io_bytes=io, steps=0)
    raise ValueError(f"unknown linear_scan impl {impl!r}")
