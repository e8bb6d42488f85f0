"""Architecture registry of the port: the reference's ten architectures
(dense, MoE, ssm, hybrid, encoder-decoder and VLM families)."""
from __future__ import annotations

import importlib

from ..models.base import ModelConfig

ARCH_IDS = ["qwen1_5_110b", "command_r_plus_104b", "qwen2_5_3b",
            "chatglm3_6b", "whisper_small", "moonshot_v1_16b_a3b",
            "granite_moe_1b_a400m", "rwkv6_7b", "internvl2_76b",
            "zamba2_7b"]


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{arch_id}").SMOKE
