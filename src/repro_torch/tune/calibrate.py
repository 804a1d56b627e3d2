"""Hardware calibration of the Eq. 4/5 cost model from measured records.

The paper leaves the LAPACK-kernel constants f_eig/f_qr/f_inv symbolic;
the textbook values (9n³, 2mn²−(2/3)n³, 2n³) assume every FLOP costs the
same, which no real device does — an eigendecomposition FLOP is far slower
than a GEMM FLOP, and each ops backend shifts the balance again.  This
module fits, per (platform, backend), a non-negative least-squares
decomposition of measured seconds onto the model's term structure:

    eig seconds ≈ o_e + α_e·(I²J + 2IRJ)       + β_e·I³
    als seconds ≈ o_a + α_a·(GEMM-family terms) + β_a·(iters·R³) + γ_a·QR(I,R)

which recovers c_eig = β_e/α_e, c_inv = β_a/(2α_a), c_qr = γ_a/α_a and —
because the fit is against *seconds* — the per-FLOP scales α_e, α_a and
per-solve overheads o_e, o_a that make ``CostModel.predict_seconds`` real
wall-clock and ``predicted_best`` a seconds comparison instead of a FLOP
comparison.  The result feeds the trained selector's out-of-range
guardrail and prices every step's ``predicted_s``.

A constant whose fitted coefficient comes back non-positive (collinear or
starved design) keeps its textbook value — calibration degrades toward the
default, never past it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from ..core.cost_model import CostModel
from ..core.selector import calibration_path
from .records import Measurement, RecordStore
from .train import default_platform

#: minimum records per method before a fit is attempted
MIN_RECORDS = 8


def _eig_basis(i, r, j):
    """(intercept, GEMM-family, I³) columns of the Eq. 4 decomposition."""
    i, r, j = float(i), float(r), float(j)
    return np.array([1.0, i * i * j + 2.0 * i * r * j, i ** 3])


def _als_basis(i, r, j, iters):
    """(intercept, GEMM-family, iters·R³, QR-count) columns of the Eq. 5
    decomposition — the iters·R³ column carries the inversions (textbook
    contribution 2·c_inv·iters·R³) and the QR column the Householder count
    at c_qr = 1."""
    i, r, j = float(i), float(r), float(j)
    gemm = (4.0 * i * j * r + 4.0 * j * r * r + 4.0 * i * r * r) * iters \
        + 2.0 * j * r * r
    return np.array([1.0, gemm, iters * r ** 3,
                     2.0 * i * r * r - (2.0 / 3.0) * r ** 3])


def _nonneg_lstsq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """lstsq with a poor man's non-negativity: columns whose coefficient
    comes back negative are dropped (zeroed) and the rest refit, so one
    collinear term cannot poison the whole calibration."""
    cols = list(range(a.shape[1]))
    coef = np.zeros(a.shape[1])
    for _ in range(a.shape[1]):
        c, *_ = np.linalg.lstsq(a[:, cols], b, rcond=None)
        if (c >= 0).all():
            coef[cols] = c
            return coef
        cols = [cols[k] for k in range(len(cols)) if c[k] >= 0]
        if not cols:
            return coef
    coef[cols] = np.linalg.lstsq(a[:, cols], b, rcond=None)[0]
    return np.maximum(coef, 0.0)


def fit_cost_model(measurements: Iterable[Measurement],
                   min_records: int = MIN_RECORDS) -> CostModel | None:
    """Fit a calibrated :class:`CostModel` from eig/als measurements.

    Returns None when either method has fewer than ``min_records`` deduped
    records (a starved fit is worse than the textbook default).  Records
    should come from ONE (platform, backend) stratum — mixing hardware
    mixes the very constants being fitted.
    """
    eig, als = {}, {}
    for m in measurements:
        slot = eig if m.method == "eig" else als if m.method == "als" else None
        if slot is None:
            continue
        cur = slot.get(m.problem_key())
        if cur is None or m.seconds < cur.seconds:
            slot[m.problem_key()] = m
    if len(eig) < min_records or len(als) < min_records:
        return None

    a_e = np.stack([_eig_basis(m.i_n, m.r_n, m.j_n) for m in eig.values()])
    b_e = np.array([m.seconds for m in eig.values()])
    ce = _nonneg_lstsq(a_e, b_e)

    a_a = np.stack([_als_basis(m.i_n, m.r_n, m.j_n, m.als_iters)
                    for m in als.values()])
    b_a = np.array([m.seconds for m in als.values()])
    ca = _nonneg_lstsq(a_a, b_a)

    o_e, a_e1, b_e1 = ce
    o_a, a_a1, b_a1, g_a1 = ca
    if a_e1 <= 0 and a_a1 <= 0:
        return None   # no usable per-FLOP signal — not a calibration
    default = CostModel()
    # constants are RATIOS to the GEMM coefficient; a zeroed GEMM column
    # (degenerate fit) keeps every dependent constant at textbook
    c_eig = b_e1 / a_e1 if a_e1 > 0 and b_e1 > 0 else default.c_eig
    c_inv = b_a1 / (2.0 * a_a1) if a_a1 > 0 and b_a1 > 0 else default.c_inv
    c_qr = g_a1 / a_a1 if a_a1 > 0 and g_a1 > 0 else default.c_qr
    return CostModel(c_eig=float(c_eig), c_qr=float(c_qr),
                     c_inv=float(c_inv),
                     eig_scale=float(a_e1) if a_e1 > 0 else 1.0,
                     als_scale=float(a_a1) if a_a1 > 0 else 1.0,
                     eig_overhead_s=float(max(o_e, 0.0)),
                     als_overhead_s=float(max(o_a, 0.0)),
                     source="calibrated")


def calibrate_store(store: RecordStore, *, platform: str | None = None,
                    backends: Sequence[str] | None = None, model_dir=None,
                    min_records: int = MIN_RECORDS,
                    meta: dict | None = None) -> dict[str, dict]:
    """Fit + save one calibration file per (platform, backend) stratum in
    the store (``backends`` restricts the strata; ``platform`` as in
    :func:`~repro_torch.tune.train.default_platform`).  ``meta`` is merged
    into every file.  Returns {written path: cost-model dict}."""
    platform = default_platform(platform)
    records = store.filter(platform=platform)
    digest = store.digest()
    written: dict[str, dict] = {}
    for backend in sorted({m.backend for m in records}):
        if backends is not None and backend not in backends:
            continue
        recs = [m for m in records if m.backend == backend]
        cm = fit_cost_model(recs, min_records=min_records)
        if cm is None:
            continue
        path = calibration_path(platform, backend)
        if model_dir is not None:
            path = Path(model_dir) / path.name
        path.parent.mkdir(parents=True, exist_ok=True)
        doc = {**cm.to_dict(), "platform": platform, "backend": backend,
               "n_records": len(recs), "store_digest": digest,
               "devices": sorted({m.device for m in recs}), **(meta or {})}
        path.write_text(json.dumps(doc, indent=1))
        written[str(path)] = doc
    return written
