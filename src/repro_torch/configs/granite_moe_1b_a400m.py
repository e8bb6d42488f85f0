"""Granite-3.0-1B-A400M [moe; hf:ibm-granite] — 32e top-8 — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='granite-moe-1b-a400m',
    family='moe',
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=32,
    top_k=8,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='granite-moe-smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab=512,
    head_dim=16,
    n_experts=8,
    top_k=2,
    max_seq=128,
)
