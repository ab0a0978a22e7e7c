"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H MLA(kv_lora=512)
d_ff_expert=1408, 64 routed experts top-6 + 2 shared, vocab=102400.
[arXiv:2405.04434; hf]"""
from .base import ModelConfig, make_smoke

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=1408, vocab=102400, act="silu", gated=True,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    use_mla=True, kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128,
)
SMOKE = make_smoke(CONFIG)
