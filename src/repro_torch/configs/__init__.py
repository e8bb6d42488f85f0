"""Architecture registry of the port (the dense, MoE, ssm and hybrid
families so far)."""
from __future__ import annotations

import importlib

from ..models.base import ModelConfig

ARCH_IDS = ["qwen1_5_110b", "command_r_plus_104b", "qwen2_5_3b",
            "chatglm3_6b", "moonshot_v1_16b_a3b", "granite_moe_1b_a400m",
            "rwkv6_7b", "zamba2_7b"]


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{arch_id}").SMOKE
