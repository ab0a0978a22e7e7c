"""--arch <id> registry.  The port carries only the architectures whose
model family it implements; the rest of the zoo is queued in ROADMAP.md."""
from . import lm100m

ARCHS = {"lm100m": lm100m}


def get_config(name: str, smoke: bool = False):
    if name not in ARCHS:
        raise ValueError(
            f"arch {name!r} is not ported yet (the port serves "
            f"{sorted(ARCHS)}); see ROADMAP.md for the order of the rest")
    mod = ARCHS[name]
    return mod.SMOKE if smoke else mod.CONFIG
