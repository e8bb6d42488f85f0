"""Qwen2.5-3B [dense; hf:Qwen/Qwen2.5-0.5B family] — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='qwen2.5-3b',
    family='dense',
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='qwen2.5-3b-smoke',
    family='dense',
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
    head_dim=24,
    qkv_bias=True,
    max_seq=128,
)
