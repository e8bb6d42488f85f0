"""RWKV6-7B Finch [ssm; arXiv:2404.05892] — data-dependent decay — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='rwkv6-7b',
    family='ssm',
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    head_dim=64,
    max_seq=1048576,
)

SMOKE = ModelConfig(
    name='rwkv6-smoke',
    family='ssm',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    max_seq=256,
)
