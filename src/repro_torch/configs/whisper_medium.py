"""whisper-medium [audio]: 24+24L enc-dec d=1024 16H d_ff=4096 vocab=51865 —
conv frontend stubbed (precomputed frame embeddings). [arXiv:2212.04356]"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51872, act="gelu", gated=False,  # vocab padded 51865->51872 (16-shardable)
    n_encoder_layers=24, n_audio_frames=1500,
)
SMOKE = make_smoke(CONFIG)
