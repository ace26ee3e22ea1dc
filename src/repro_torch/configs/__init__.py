"""Architecture registry of the port.

``get_config(name)`` returns the full published configuration;
``get_config(name, tiny=True)`` the reduced same-family config the CPU tests
use.  Only the families the port runs are registered; asking for another
raises a ``ValueError`` that names what is available.
"""
from __future__ import annotations

import importlib

ARCHS = ("olmo_1b", "rwkv6_3b", "recurrentgemma_2b")

# CLI ids (--arch <id>) -> module names
ALIASES = {"olmo-1b": "olmo_1b", "rwkv6-3b": "rwkv6_3b",
           "recurrentgemma-2b": "recurrentgemma_2b"}

# families of the JAX package that the port does not run yet
NOT_PORTED = (
    "deepseek_coder_33b", "command_r_plus_104b", "granite_20b",
    "phi35_moe_42b", "granite_moe_1b", "llava_next_mistral_7b",
    "whisper_small",
)


def get_config(name: str, *, tiny: bool = False):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in ARCHS:
        why = ("is not ported to PyTorch yet" if mod_name in NOT_PORTED
               else "is not a known architecture")
        raise ValueError(f"{name!r} {why}; the port runs: "
                         f"{', '.join(sorted(ALIASES))}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.tiny() if tiny else mod.CONFIG
