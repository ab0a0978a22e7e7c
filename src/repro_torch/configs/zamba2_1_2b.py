"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d=2048 + shared attention block
(32H) every 6 layers, d_ff=8192, vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, act="gelu", gated=True,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    attn_every=6,
)
SMOKE = make_smoke(CONFIG)
