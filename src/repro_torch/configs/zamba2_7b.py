"""Zamba2-7B [hybrid; arXiv:2411.15242] — Mamba2 + shared attn block — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='zamba2-7b',
    family='hybrid',
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    tie_embeddings=True,
    max_seq=1048576,
)

SMOKE = ModelConfig(
    name='zamba2-smoke',
    family='hybrid',
    n_layers=7,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    shared_attn_every=3,
    tie_embeddings=True,
    max_seq=256,
)
