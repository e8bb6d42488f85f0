"""ChatGLM3-6B [dense; arXiv:2406.12793] — 2d/half RoPE, GQA — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='chatglm3-6b',
    family='dense',
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    head_dim=128,
    qkv_bias=True,
    rope='half',
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='chatglm3-smoke',
    family='dense',
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
    head_dim=24,
    qkv_bias=True,
    rope='half',
    max_seq=128,
)
