"""InternVL2-76B [vlm; arXiv:2404.16821] — InternViT STUB + InternLM2 backbone — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='internvl2-76b',
    family='vlm',
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    n_img_tokens=256,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='internvl2-smoke',
    family='vlm',
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=32,
    n_img_tokens=8,
    max_seq=128,
)
