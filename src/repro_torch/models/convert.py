"""Weights carried across from the JAX package: its parameter tree, as
numpy arrays, becomes the config's family (``DenseLM``, ``RWKV6``) on
``device``.  bf16 leaves arrive as float32 (exact) and are stored in the
config's ``param_dtype``."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from .base import BaseModel, ModelConfig, get_model, resolve_device


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device="cuda") -> BaseModel:
    """``tree``: ``{"embed", "blocks": {...}, "ln_f", "lm_head"}`` of numpy
    arrays (the reference's ``init_params`` output, leaf by leaf)."""
    dev = resolve_device(device)
    pdt = to_torch_dtype(cfg.param_dtype)

    def conv(a):
        return torch.from_numpy(np.array(a, np.float32)).to(pdt).to(dev)

    params = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = {k: conv(v) for k, v in tree["blocks"].items()}
    return get_model(cfg, device=dev, params=params)
