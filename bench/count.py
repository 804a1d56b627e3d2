"""The frozen bound of a Tucker solve and the peaks of the card it is held to.

The bound depends on the tensor's shape and ranks alone, never on which
solver, route or mode order the program picks: the least work that any
st-HOSVD at these ranks has to do.

* bytes: the input read once, the factors and the core written once;
* operations: the first step's contraction of the whole input against at
  least the smallest rank, 2 · min(R) · |X|, at the dense TF32 peak.

The bound is the larger of bytes ÷ HBM bandwidth and operations ÷ peak.
No implementation can run faster, so a share above 100% means that a count
here is wrong or that the time left out part of the work.

The operations are timed at the TF32 tensor-core peak although the
configurations state float32 with TF32 off: a bound on time takes the
fastest rate any route could use, and split-TF32 products (float32-exact,
on tensor cores) run above the 67 TFLOP/s of float32 FFMA.  The byte term
binds at either rate for the configurations here.
"""

from __future__ import annotations

import math

#: published dense peaks of one NVIDIA H100 SXM ("NVIDIA H100 80GB HBM3"),
#: the card the benchmark is defined on, at its full power limit of 700 W:
#: HBM3 bytes/s and TF32 operations/s (half the "with sparsity" figure)
HBM_BYTES_S = 3.35e12
TF32_OPS_S = 495e12


def solve_bytes(shape, ranks, itemsize: int = 4) -> int:
    """The input read once, plus the factors and the core written once."""
    elems = math.prod(shape) + sum(i * r for i, r in zip(shape, ranks)) \
        + math.prod(ranks)
    return elems * itemsize


def solve_flops(shape, ranks) -> int:
    """2 · min(R) · |X|: the cheapest first step any solver could take."""
    return 2 * min(ranks) * math.prod(shape)


def solve_bound(shape, ranks) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time of one solve."""
    t_bytes = solve_bytes(shape, ranks) / HBM_BYTES_S
    t_ops = solve_flops(shape, ranks) / TF32_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
