"""The check that a run loaded nothing of the JAX package or of JAX.

Modules are compared by their whole top-level name (the part before the
first dot): the port, ``repro_torch``, begins with the letters of the JAX
package, ``repro``, and is not it.
"""

from __future__ import annotations

import sys

#: top-level names a run of the benchmark must never load: JAX, and the JAX
#: package with its benchmarks and the bring-up's scripts
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks",
                       "chip_smoke", "chip_diag"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
