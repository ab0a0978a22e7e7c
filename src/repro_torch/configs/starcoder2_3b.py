"""starcoder2-3b [dense]: 30L d=3072 24H GQA(kv=2) d_ff=12288 vocab=49152 —
GQA + RoPE. [arXiv:2402.19173; hf]"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152, act="gelu", gated=False, rope_theta=100000.0,
)
SMOKE = make_smoke(CONFIG)
