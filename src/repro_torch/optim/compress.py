"""int8 block quantization with error feedback — the port of the JAX
package's ``optim/compress.py``.

Each leaf is quantized per ``BLOCK``-element block against an fp32 scale
(the block's largest magnitude over 127; 1.0 for an all-zero block),
rounded half to even and clipped to [-127, 127].  The captured training
step folds the quantize-dequantize with error feedback into its program
(``train/region_step.py::_ef_quantize``): the residual ``g - deq`` is
carried to the next step and added back first, so the gradient signal is
unbiased over time.  On one card there is no pod axis to send the int8
payload over: ``compressed_allreduce`` (the cross-pod mean over a shared
scale) waits for the mesh port.
"""
from __future__ import annotations

import torch

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened and zero-padded to a ``[-1, BLOCK]`` view."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def compress_int8(g: torch.Tensor, scale=None):
    """g -> (q int8 ``[Nb, BLOCK]``, scale fp32 ``[Nb, 1]``).  Pass
    ``scale`` to quantize against an agreed scale."""
    blocks = _blocks(g.to(torch.float32))
    if scale is None:
        amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0,
                            torch.ones((), dtype=torch.float32,
                                       device=amax.device))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape):
    """The fp32 values of ``compress_int8``'s payload, as ``shape``."""
    n = 1
    for s in shape:
        n *= int(s)
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(tuple(shape))


def compressed_allreduce(grads, state, axis_name: str, n_shards: int):
    """The error-feedback int8 mean over a pod axis: it needs a mesh."""
    raise NotImplementedError(
        "compressed_allreduce reduces over a pod axis, which needs the mesh "
        "port (ROADMAP queue 1, item 8); on one card the captured step "
        "folds the quantize-dequantize with error feedback "
        "(train/region_step.py::_ef_quantize)")
