"""granite-20b [dense]: 52L d=6144 48H MQA(kv=1) d_ff=24576 vocab=49152 —
llama-arch code model. [arXiv:2405.04324; hf]"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, act="gelu", gated=False,
)
SMOKE = make_smoke(CONFIG)
