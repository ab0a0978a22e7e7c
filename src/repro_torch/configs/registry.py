"""--arch <id> registry: the 11 architectures of the JAX package's
registry, every family ported."""
from . import (deepseek_v2_lite_16b, gemma_2b, granite_20b,
               llama4_scout_17b_a16e, llama_3_2_vision_90b, lm100m,
               mamba2_1_3b, stablelm_3b, starcoder2_3b, whisper_medium,
               zamba2_1_2b)

ARCHS = {
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
    "gemma-2b": gemma_2b,
    "stablelm-3b": stablelm_3b,
    "granite-20b": granite_20b,
    "starcoder2-3b": starcoder2_3b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "whisper-medium": whisper_medium,
    "zamba2-1.2b": zamba2_1_2b,
    "mamba2-1.3b": mamba2_1_3b,
    "lm100m": lm100m,
}
#: The assigned architectures of the dry run's grid (the reference's
#: ``ASSIGNED``): every one but lm100m.
ASSIGNED = [k for k in ARCHS if k != "lm100m"]


def get_config(name: str, smoke: bool = False):
    mod = ARCHS[name]
    return mod.SMOKE if smoke else mod.CONFIG
