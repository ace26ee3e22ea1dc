"""Architecture registry of the port.

``get_config(name)`` returns the full published configuration;
``get_config(name, tiny=True)`` the reduced same-family config the CPU tests
use; ``all_configs(tiny=)`` every family's, keyed by module name.  Every
family of the JAX package is registered; asking for another name raises a
``ValueError`` that names what is available.
"""
from __future__ import annotations

import importlib

ARCHS = ("deepseek_coder_33b", "command_r_plus_104b", "olmo_1b",
         "granite_20b", "phi35_moe_42b", "granite_moe_1b",
         "recurrentgemma_2b", "llava_next_mistral_7b", "rwkv6_3b",
         "whisper_small")

# CLI ids (--arch <id>) -> module names
ALIASES = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "command-r-plus-104b": "command_r_plus_104b",
    "olmo-1b": "olmo_1b",
    "granite-20b": "granite_20b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-small": "whisper_small",
}

# families of the JAX package that the port does not run yet: none
NOT_PORTED = ()


def get_config(name: str, *, tiny: bool = False):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in ARCHS:
        raise ValueError(f"{name!r} is not a known architecture; the port "
                         f"runs: {', '.join(sorted(ALIASES))}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.tiny() if tiny else mod.CONFIG


def all_configs(*, tiny: bool = False):
    return {a: get_config(a, tiny=tiny) for a in ARCHS}
