"""Assigned-architecture configs.  ``get(name)`` → full ModelConfig;
``get_smoke(name)`` → reduced same-family config for CPU smoke tests.

The names and aliases are the reference's (``repro.configs``).  Only the
architectures whose layers the port has are importable; the other one
(seamless-m4t-medium, enc-dec) raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings it.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "mixtral_8x22b",
    "granite_moe_3b_a800m",
    "gemma3_1b",
    "gemma2_9b",
    "minitron_4b",
    "phi3_mini_3p8b",
    "falcon_mamba_7b",
    "zamba2_1p2b",
    "seamless_m4t_medium",
    "internvl2_2b",
)

# canonical ids (assignment spelling) → module names
ALIASES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "gemma3-1b": "gemma3_1b",
    "gemma2-9b": "gemma2_9b",
    "minitron-4b": "minitron_4b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-2b": "internvl2_2b",
}

#: architectures whose layers the port has: the Mamba-1 ssm, dense, moe,
#: hybrid (Mamba-2 with shared attention) and vlm families
PORTED = ("falcon_mamba_7b", "gemma2_9b", "gemma3_1b", "phi3_mini_3p8b",
          "minitron_4b", "granite_moe_3b_a800m", "mixtral_8x22b",
          "zamba2_1p2b", "internvl2_2b")


def _mod(name: str):
    name = canonical(name)
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name}: its layers (the enc-dec family) are not ported yet; "
            "ROADMAP.md Queue 1 item 11.4 brings them")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).SMOKE


def canonical(name: str) -> str:
    return ALIASES.get(name, name)
