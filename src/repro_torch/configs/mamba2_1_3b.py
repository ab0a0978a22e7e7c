"""mamba2-1.3b [ssm]: 48 SSD layers d=2048 (attention-free), ssm_state=128,
vocab=50288, tied embeddings. [arXiv:2405.21060] (vocab padded 50280->50288, 16-shardable)"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50288, tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    head_dim=64,
)
SMOKE = make_smoke(CONFIG, n_heads=0, n_kv_heads=0, d_ff=0)
