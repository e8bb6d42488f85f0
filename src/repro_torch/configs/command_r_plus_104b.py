"""Command R+ 104B [dense; hf:CohereForAI/c4ai-command-r-v01] — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='command-r-plus-104b',
    family='dense',
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    qkv_bias=False,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='command-r-plus-smoke',
    family='dense',
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=16,
    qkv_bias=False,
    max_seq=128,
)
