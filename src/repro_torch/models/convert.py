"""Weights carried across from the JAX package: its parameter tree, as
numpy arrays, becomes the config's family (``DenseLM``, ``MoELM``,
``RWKV6``, ``Zamba2``, ``InternVLM``, ``WhisperED``) on ``device``.  bf16 leaves arrive as float32 (exact) and are
stored in the config's ``param_dtype``.  ``paper_params_from_numpy`` does
the same for the paper's four networks, whose parameters are a plain
tree."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from .base import BaseModel, ModelConfig, get_model, resolve_device


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device="cuda") -> BaseModel:
    """``tree``: ``{"embed", "blocks": {...}, "ln_f", "lm_head"}`` of numpy
    arrays (the reference's ``init_params`` output, leaf by leaf); a tied
    family has no ``lm_head``, and Zamba2's tree also holds ``shared``,
    its shared block's un-stacked leaves.  A sub-tree (``blocks``,
    ``shared``) is a flat dict of leaves, or for the MoE family ``blocks``
    a dict of two such (``dense``, where the config has first dense layers,
    and ``moe``: ``router [L, d, E]``, ``ewg`` / ``ewu [L, E, d, f]``,
    ``ewd [L, E, f, d]`` beside the attention leaves).  The VLM's tree is
    the dense one; the encoder-decoder's is ``{"embed", "enc_pos",
    "dec_pos", "enc", "dec", "enc_ln_f", "dec_ln_f"}``, ``enc`` / ``dec``
    flat dicts of stacked leaves with ``sa_`` / ``ca_`` prefixes."""
    dev = resolve_device(device)
    pdt = to_torch_dtype(cfg.param_dtype)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        return torch.from_numpy(np.array(a, np.float32)).to(pdt).to(dev)

    params = conv(tree)
    return get_model(cfg, device=dev, params=params)


def paper_params_from_numpy(name: str, tree, device="cuda"):
    """The parameter tree of the paper net ``name`` ("cnn", "lstm1",
    "lstm2", "ncf") from the reference's (nested dicts and lists of numpy
    arrays), as fp32 tensors on ``device``.  The tree must have the net's
    structure and shapes (``param_spec``): every layout is the
    reference's (NHWC activations, HWIO kernels, ``[in, out]`` weights),
    so no leaf is permuted."""
    from .paper_nets import get_paper_net
    dev = resolve_device(device)

    def conv(t, spec, path):
        if isinstance(spec, (list, dict)):
            if type(t) is not type(spec) or len(t) != len(spec) or (
                    isinstance(spec, dict) and set(t) != set(spec)):
                raise ValueError(f"{name}{path}: expected {spec!r}")
            keys = spec if isinstance(spec, dict) else range(len(spec))
            out = {k: conv(t[k], spec[k], f"{path}[{k!r}]") for k in keys}
            return out if isinstance(spec, dict) else list(out.values())
        a = np.asarray(t, np.float32)
        if a.shape != tuple(spec[0]):
            raise ValueError(f"{name}{path}: shape {a.shape}, expected "
                             f"{tuple(spec[0])}")
        return torch.from_numpy(a.copy()).to(dev)

    return conv(tree, get_paper_net(name).param_spec(), "")
