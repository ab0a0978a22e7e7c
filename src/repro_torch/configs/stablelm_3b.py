"""stablelm-3b [dense]: 32L d=2560 32H MHA d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304, act="silu", gated=True,
)
SMOKE = make_smoke(CONFIG)
