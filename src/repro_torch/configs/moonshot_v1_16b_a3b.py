"""Moonlight-16B-A3B [moe; hf:moonshotai/Moonlight-16B-A3B] — 64e top-6 — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='moonshot-v1-16b-a3b',
    family='moe',
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    head_dim=128,
    n_experts=64,
    top_k=6,
    first_dense_layers=1,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='moonshot-smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=512,
    head_dim=16,
    n_experts=8,
    top_k=2,
    first_dense_layers=1,
    max_seq=128,
)
