"""Qwen1.5-110B [dense; hf:Qwen/Qwen1.5-0.5B family] — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='qwen1.5-110b',
    family='dense',
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='qwen1.5-110b-smoke',
    family='dense',
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=32,
    qkv_bias=True,
    max_seq=128,
)
