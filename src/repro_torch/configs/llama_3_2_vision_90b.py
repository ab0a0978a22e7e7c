"""llama-3.2-vision-90b [vlm]: 100L (80 self + 20 cross) d=8192 64H GQA(8)
d_ff=28672 vocab=128256 — cross-attn image layers every 5th position.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, act="silu", gated=True, rope_theta=500000.0,
    cross_attn_every=5, n_vision_tokens=1024,
)
SMOKE = make_smoke(CONFIG)
