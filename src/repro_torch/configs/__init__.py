"""Assigned-architecture configs.  ``get(name)`` → full ModelConfig;
``get_smoke(name)`` → reduced same-family config for CPU smoke tests.

The names, aliases, ``LONG_CONTEXT_OK`` and ``supports_shape`` are the
reference's (``repro.configs``); every architecture is ported.
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

#: architectures whose layers the port has: all of them
PORTED = ARCHS

# archs that run the ``long_500k`` shape (sub-quadratic / bounded cache)
LONG_CONTEXT_OK = {
    "mixtral_8x22b",      # SWA window caps the cache
    "gemma3_1b",          # 5:1 local:global
    "gemma2_9b",          # 1:1 local:global
    "falcon_mamba_7b",    # O(1) state
    "zamba2_1p2b",        # hybrid
}


def _mod(name: str):
    name = canonical(name)
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).SMOKE


def canonical(name: str) -> str:
    return ALIASES.get(name, name)


def supports_shape(name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return canonical(name) in LONG_CONTEXT_OK
    return True
