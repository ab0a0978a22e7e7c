"""~100M-parameter dense LM for the end-to-end training example."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="lm100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=8192, act="silu", gated=True, tie_embeddings=True,
)
SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab=256)
