"""Shape buckets for the streaming Tucker service.

The port of ``repro/serve/buckets.py``.  Production decomposition traffic
is a stream of tensors whose shapes cluster but rarely repeat exactly.
Planning (selector + schedule) and capturing a sweep into CUDA graphs are
per-shape costs, so a service that treats every odd shape as its own group
pays them on the tail of the shape distribution forever.  Buckets quantize
that tail: each incoming shape is rounded up to a bucket (every dim to the
next multiple of ``grid``), the request's tensor is zero-padded into the
bucket's slot buffer, and the bucket holds one warm
:class:`~repro_torch.core.api.TuckerPlan` plus one cached batched sweep.

Padding correctness — the two pad modes
---------------------------------------

Zero slack contributes *exact zeros* to every Gram and TTM reduction (the
mode-n Gram of a zero-padded tensor is the unpadded Gram with zero rows and
columns appended; a TTM against it only ever multiplies the slack by zero),
so masking is free arithmetically.  What is NOT free is running the
*eigendecomposition* at the padded size: ``eigh`` on a (B, B) matrix is a
different computation than on the embedded (I, I) block, so factors come
out equal-in-exact-arithmetic but not bit-identical.  Hence two modes:

``pad_mode="exact"`` (default)
    The slot buffer stays bucket-shaped, but each lane's valid block is
    sliced back out before the solve (a zero-pad → slice roundtrip is
    bitwise lossless) and runs through the plan the request's TRUE shape
    resolves to — the *same* cached sweep a direct ``decompose(x, cfg)``
    would run, so results are **bitwise-equal to unpadded execution**.

``pad_mode="mask"``
    The whole wave — mixed true shapes included — runs the bucket plan's
    one batched sweep at the bucket shape; the zero slack is masked out of
    every Gram/TTM contribution by construction, factors come back with
    zero slack rows (zero rows propagate through the EIG eigenvector
    deflation, the ALS normal equations and Householder QR), and
    :func:`trim_result` crops them to the true shape.  Results are
    approximately (not bitwise) equal to unpadded execution — the
    throughput mode for latency-tolerant traffic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.sthosvd import SthosvdResult, TuckerTensor

PAD_MODES = ("exact", "mask")


@dataclass(frozen=True)
class BucketPolicy:
    """How the service quantizes shapes and forms waves.

    ``grid`` rounds every dim up to its next multiple (an int applies to
    all modes; a tuple gives a per-mode grid).  ``grid=1`` is the identity
    policy: every shape is its own bucket and no request is ever padded —
    the compatibility mode :class:`~repro_torch.serve.engine.TuckerBatchEngine`
    runs under.

    ``max_pad_ratio`` caps the padding overhead: a shape whose bucket
    would hold more than ``max_pad_ratio``× its true element count gets an
    exact (unpadded) bucket of its own instead.

    ``pad_mode`` picks the padded-execution strategy (see module
    docstring): ``"exact"`` for bitwise parity with unpadded execution,
    ``"mask"`` for one batched sweep per bucket.

    ``wave_slots`` bounds the lanes one wave takes from the queue
    (``None`` = take everything queued — the offline/batch setting).
    ``lane_pow2`` and :meth:`lanes_for` are the reference's power-of-two
    lane rounding, kept for parity: the port's batched sweep runs item by
    item, one cache entry whatever the wave size, so the service adds no
    zero-filled lanes.
    """
    grid: int | tuple[int, ...] = 8
    max_pad_ratio: float = 2.0
    pad_mode: str = "exact"
    wave_slots: int | None = 8
    lane_pow2: bool = True

    def __post_init__(self):
        if isinstance(self.grid, Sequence):
            object.__setattr__(self, "grid",
                               tuple(int(g) for g in self.grid))
            grids = self.grid
        else:
            object.__setattr__(self, "grid", int(self.grid))
            grids = (self.grid,)
        if any(g < 1 for g in grids):
            raise ValueError(f"grid must be >= 1, got {self.grid}")
        if self.pad_mode not in PAD_MODES:
            raise ValueError(f"pad_mode {self.pad_mode!r} not in {PAD_MODES}")
        if self.max_pad_ratio < 1.0:
            raise ValueError("max_pad_ratio < 1 would forbid the identity "
                             f"bucket, got {self.max_pad_ratio}")
        if self.wave_slots is not None and self.wave_slots < 1:
            raise ValueError("wave_slots must be >= 1 or None (unbounded)")

    @classmethod
    def exact(cls) -> "BucketPolicy":
        """Identity policy: per-shape buckets, unbounded waves, no lane
        padding — one batch per (shape, dtype, config)."""
        return cls(grid=1, wave_slots=None, lane_pow2=False)

    def _grid_for(self, mode: int) -> int:
        if isinstance(self.grid, tuple):
            if mode >= len(self.grid):
                raise ValueError(f"per-mode grid {self.grid} has no entry "
                                 f"for mode {mode}")
            return self.grid[mode]
        return self.grid

    def bucket_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The bucket ``shape`` routes to: every dim rounded up to its
        grid, unless the padding overhead breaches ``max_pad_ratio`` (then
        the shape is its own exact bucket)."""
        shape = tuple(int(s) for s in shape)
        up = tuple(-(-s // self._grid_for(m)) * self._grid_for(m)
                   for m, s in enumerate(shape))
        if math.prod(up) > self.max_pad_ratio * math.prod(shape):
            return shape
        return up

    def lanes_for(self, n: int) -> int:
        """Lane count the reference gives a wave of ``n`` requests: ``n``
        itself, or the next power of two capped at ``wave_slots`` when
        ``lane_pow2`` is on."""
        if not self.lane_pow2:
            return n
        lanes = 1 << max(0, (n - 1).bit_length())
        return min(lanes, self.wave_slots) if self.wave_slots else lanes


def pad_waste(true_shape: Sequence[int], bucket: Sequence[int]) -> float:
    """Fraction of the bucket's elements that are slack for this member
    (0.0 for an exact fit)."""
    return 1.0 - math.prod(true_shape) / math.prod(bucket)


def pad_block(x: torch.Tensor, bucket: Sequence[int]) -> torch.Tensor:
    """Zero-pad ``x`` up to the bucket shape (trailing slack per mode)."""
    widths = [b - s for s, b in zip(x.shape, bucket)]
    if any(w < 0 for w in widths):
        raise ValueError(f"shape {tuple(x.shape)} does not fit bucket "
                         f"{tuple(bucket)}")
    if not any(widths):
        return x
    # F.pad takes (before, after) pairs from the LAST dim backwards
    pad = []
    for w in reversed(widths):
        pad += [0, w]
    return F.pad(x, pad)


def slice_valid(x: torch.Tensor, true_shape: Sequence[int]) -> torch.Tensor:
    """The valid block of a padded tensor — bitwise the original values
    (zero-pad then slice is a lossless roundtrip)."""
    if tuple(x.shape) == tuple(true_shape):
        return x
    return x[tuple(slice(0, s) for s in true_shape)]


def trim_result(res: SthosvdResult, true_shape: Sequence[int]) -> SthosvdResult:
    """Crop a mask-mode result (factors at bucket size) to the true shape.

    The core is already (R_0, ..., R_{N-1}) — rank-shaped, bucket-blind —
    so only the factors' slack rows are dropped.  Those rows are zero (see
    module docstring), so the trimmed factors keep orthonormal columns and
    ``core ×_n U_n`` reconstructs the unpadded tensor.
    """
    tt = res.tucker
    trimmed = [u[:s] for u, s in zip(tt.factors, true_shape)]
    return SthosvdResult(
        tucker=TuckerTensor(core=tt.core, factors=trimmed),
        trace=res.trace, select_overhead_s=res.select_overhead_s,
        error_bound=res.error_bound)
