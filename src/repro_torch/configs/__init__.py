"""Architecture registry of the port (the dense, ssm and hybrid families
so far)."""
from __future__ import annotations

import importlib

from ..models.base import ModelConfig

ARCH_IDS = ["qwen2_5_3b", "rwkv6_7b", "zamba2_7b"]


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{arch_id}").SMOKE
