"""--arch <id> registry.  The port carries only the architectures whose
model family it implements (dense, MoE with MLA among them, SSM and
hybrid); the cross-attention configs are queued in ROADMAP.md."""
from . import (deepseek_v2_lite_16b, gemma_2b, granite_20b,
               llama4_scout_17b_a16e, lm100m, mamba2_1_3b, stablelm_3b,
               starcoder2_3b, zamba2_1_2b)

ARCHS = {
    "gemma-2b": gemma_2b,
    "stablelm-3b": stablelm_3b,
    "granite-20b": granite_20b,
    "starcoder2-3b": starcoder2_3b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "zamba2-1.2b": zamba2_1_2b,
    "mamba2-1.3b": mamba2_1_3b,
    "lm100m": lm100m,
}


def get_config(name: str, smoke: bool = False):
    if name not in ARCHS:
        raise ValueError(
            f"arch {name!r} is not ported yet (the port serves "
            f"{sorted(ARCHS)}); see ROADMAP.md for the order of the rest")
    mod = ARCHS[name]
    return mod.SMOKE if smoke else mod.CONFIG
