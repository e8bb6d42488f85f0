"""Whisper-small [audio enc-dec; arXiv:2212.04356] — conv frontend STUB — exact assigned config + reduced smoke variant."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name='whisper-small',
    family='encdec',
    n_layers=12,
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    norm='layernorm',
    act='gelu',
    gated_mlp=False,
    tie_embeddings=True,
    n_frames=1500,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name='whisper-smoke',
    family='encdec',
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    norm='layernorm',
    act='gelu',
    gated_mlp=False,
    tie_embeddings=True,
    n_frames=32,
    max_seq=128,
)
