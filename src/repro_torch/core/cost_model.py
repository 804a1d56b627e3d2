"""FLOP cost model for the flexible st-HOSVD solvers (a-Tucker Eq. 4/5).

Used (a) as the analytic fallback of the adaptive selector when no trained
decision tree is available for the current platform, and (b) to derive the
Table-I features.  The paper leaves the LAPACK-kernel constants f_eig/f_qr/
f_inv symbolic; :class:`CostModel` makes them *data*: the textbook defaults
(Golub & Van Loan operation counts) ship as ``DEFAULT_COST_MODEL``, and the
tune flywheel fits hardware-specific constants — plus a
seconds-per-FLOP scale per solver — from measured records, so the same
Eq. 4/5 structure predicts wall-clock on the box it was calibrated on.

The module-level functions (``eig_flops`` & friends) delegate to
``DEFAULT_COST_MODEL`` and keep the pre-CostModel call sites working.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .solvers import DEFAULT_ALS_ITERS, DEFAULT_OVERSAMPLE, DEFAULT_POWER_ITERS

#: model JSON schema version (bumped when the constant set changes)
COST_MODEL_VERSION = 1


@dataclass(frozen=True)
class CostModel:
    """Eq. 4/5 with explicit (calibratable) kernel constants.

    c_eig
        Symmetric eigendecomposition constant: f_eig(n) = c_eig·n³
        (textbook tridiagonalization + QL: 9).
    c_qr
        Scale on the Householder QR count 2mn² − (2/3)n³ (textbook: 1).
    c_inv
        SPD inverse constant: f_inv(n) = c_inv·n³ (textbook Cholesky +
        triangular solves: 2).
    eig_scale / als_scale
        Seconds per modeled FLOP for each solver, fitted by calibration.
        At the textbook default (1.0) the "seconds" methods return plain
        FLOP counts — ``predicted_best`` still works (a common scale
        cancels) but ``predict_seconds`` is only meaningful once
        ``source == "calibrated"``.
    eig_overhead_s / als_overhead_s
        Fitted per-solve constant overhead (dispatch/launch cost) in
        seconds.  Pure FLOP models mispredict small modes badly — ALS
        launches many more kernels per solve than EIG — so the intercept is
        part of the model, not noise (textbook default: 0).
    source
        ``"textbook"`` or ``"calibrated"`` — whether the constants came
        from operation counts or from measured records
        (the tune flywheel's calibration).
    """
    c_eig: float = 9.0
    c_qr: float = 1.0
    c_inv: float = 2.0
    eig_scale: float = 1.0
    als_scale: float = 1.0
    rand_scale: float | None = None
    eig_overhead_s: float = 0.0
    als_overhead_s: float = 0.0
    rand_overhead_s: float = 0.0
    source: str = "textbook"

    @property
    def rand_scale_eff(self) -> float:
        """rand seconds-per-FLOP actually used for pricing: the fitted
        value when a rand calibration exists, else eig's scale — the sketch
        is the same GEMM-bound TTM/TTT/QR kernel mix, so eig's per-FLOP
        rate is the closest proxy (and a calibrated model stays sane for
        rand instead of falling back to 1 s/FLOP).  Textbook models degrade
        to plain FLOP counts either way."""
        return self.eig_scale if self.rand_scale is None else self.rand_scale

    # -- kernel counts -------------------------------------------------------
    def f_eig(self, n: int) -> float:
        return self.c_eig * float(n) ** 3

    def f_qr(self, m: int, n: int) -> float:
        return self.c_qr * (2.0 * m * float(n) * n - (2.0 / 3.0) * float(n) ** 3)

    def f_inv(self, n: int) -> float:
        return self.c_inv * float(n) ** 3

    # -- Eq. 4/5 -------------------------------------------------------------
    def eig_flops(self, i_n: int, r_n: int, j_n: int) -> float:
        """Eq. (4): Gram (I_n² J_n) + TTM (2 I_n R_n J_n) + eig."""
        return float(i_n) * i_n * j_n + 2.0 * i_n * r_n * j_n + self.f_eig(i_n)

    def als_flops(self, i_n: int, r_n: int, j_n: int,
                  num_iters: int = DEFAULT_ALS_ITERS) -> float:
        """Eq. (5): per-iteration 2 TTM + 2 TTT + 2 GEMM + 2 inversions,
        plus the closing TTM and QR."""
        per_iter = (
            2.0 * i_n * j_n * r_n + 2.0 * j_n * r_n * r_n   # R-update TTM + scale
            + 2.0 * i_n * j_n * r_n + 2.0 * j_n * r_n * r_n  # L-update TTT + scale
            + 4.0 * i_n * r_n * r_n                          # GEMMs with inverses
            + 2.0 * self.f_inv(r_n)
        )
        return per_iter * num_iters + 2.0 * j_n * r_n * r_n \
            + self.f_qr(i_n, r_n)

    def rand_flops(self, i_n: int, r_n: int, j_n: int,
                   oversample: int = DEFAULT_OVERSAMPLE,
                   power_iters: int = DEFAULT_POWER_ITERS) -> float:
        """Randomized range finder at sketch width ℓ = min(I_n, R_n + p):
        range sample TTT (2 I_n ℓ J_n) + QR, per power iteration a
        project-TTM + expand-TTT + QR (4 I_n ℓ J_n + QR), the final
        projection TTM (2 I_n ℓ J_n), the ℓ×ℓ sketched Gram (ℓ² J_n) +
        eig, and the ℓ→R_n core rotation (2 ℓ R_n J_n).  Linear in I_n
        where EIG's Gram is quadratic — this is the whole point."""
        ell = min(i_n, r_n + oversample)
        sketch = 2.0 * i_n * ell * j_n + self.f_qr(i_n, ell)
        power = power_iters * (4.0 * i_n * ell * j_n + self.f_qr(i_n, ell))
        project = 2.0 * i_n * ell * j_n
        ritz = float(ell) * ell * j_n + self.f_eig(ell) + i_n * ell * r_n
        rotate = 2.0 * ell * r_n * j_n
        return sketch + power + project + ritz + rotate

    def svd_flops(self, i_n: int, r_n: int, j_n: int) -> float:
        """Thin SVD of the I_n×J_n unfolding (Golub–Van Loan R-SVD count,
        2mn² + 11n³ with n = min dim) plus the Σ·Vᵀ core update.  Only used
        for schedule cost annotations — never the predicted-best solver."""
        m, n = max(i_n, j_n), min(i_n, j_n)
        return 2.0 * m * n * n + 11.0 * n ** 3 + float(r_n) * j_n

    # -- predictions ---------------------------------------------------------
    @property
    def calibrated(self) -> bool:
        return self.source == "calibrated"

    def predict_seconds(self, method: str, i_n: int, r_n: int, j_n: int,
                        num_iters: int = DEFAULT_ALS_ITERS) -> float:
        """Predicted wall-clock for one mode solve.  Only meaningful for a
        calibrated model (the scales are then seconds per modeled FLOP)."""
        if method == "eig":
            return self.eig_overhead_s \
                + self.eig_scale * self.eig_flops(i_n, r_n, j_n)
        if method == "als":
            return self.als_overhead_s \
                + self.als_scale * self.als_flops(i_n, r_n, j_n, num_iters)
        if method == "rand":
            return self.rand_overhead_s \
                + self.rand_scale_eff * self.rand_flops(i_n, r_n, j_n)
        # svd has no dedicated scale; the eig scale is the closest GEMM proxy
        return self.eig_scale * self.svd_flops(i_n, r_n, j_n)

    def predicted_best(self, i_n: int, r_n: int, j_n: int,
                       num_iters: int = DEFAULT_ALS_ITERS,
                       methods: tuple = ("eig", "als")) -> str:
        """Analytic solver choice over ``methods``: smallest scaled cost wins
        (ties break toward the earlier entry, so the default keeps the
        historical eig-on-tie behavior)."""
        return min(methods, key=lambda m: (
            self.predict_seconds(m, i_n, r_n, j_n, num_iters),
            methods.index(m)))

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": COST_MODEL_VERSION, "c_eig": self.c_eig,
                "c_qr": self.c_qr, "c_inv": self.c_inv,
                "eig_scale": self.eig_scale, "als_scale": self.als_scale,
                "rand_scale": self.rand_scale,
                "eig_overhead_s": self.eig_overhead_s,
                "als_overhead_s": self.als_overhead_s,
                "rand_overhead_s": self.rand_overhead_s,
                "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        return cls(c_eig=float(d.get("c_eig", 9.0)),
                   c_qr=float(d.get("c_qr", 1.0)),
                   c_inv=float(d.get("c_inv", 2.0)),
                   eig_scale=float(d.get("eig_scale", 1.0)),
                   als_scale=float(d.get("als_scale", 1.0)),
                   rand_scale=(None if d.get("rand_scale") is None
                               else float(d["rand_scale"])),
                   eig_overhead_s=float(d.get("eig_overhead_s", 0.0)),
                   als_overhead_s=float(d.get("als_overhead_s", 0.0)),
                   rand_overhead_s=float(d.get("rand_overhead_s", 0.0)),
                   source=str(d.get("source", "textbook")))

    def with_(self, **kw) -> "CostModel":
        return replace(self, **kw)


DEFAULT_COST_MODEL = CostModel()


# ---------------------------------------------------------------------------
# Module-level back-compat surface (textbook constants)
# ---------------------------------------------------------------------------

def f_eig(n: int) -> float:
    """Symmetric eigendecomposition (tridiagonalization + QL): ~9n^3."""
    return DEFAULT_COST_MODEL.f_eig(n)


def f_qr(m: int, n: int) -> float:
    """Householder QR of an m×n (m ≥ n) matrix: 2mn² − (2/3)n³."""
    return DEFAULT_COST_MODEL.f_qr(m, n)


def f_inv(n: int) -> float:
    """Inverse of an n×n SPD matrix (Cholesky + triangular solves): 2n³."""
    return DEFAULT_COST_MODEL.f_inv(n)


def eig_flops(i_n: int, r_n: int, j_n: int) -> float:
    return DEFAULT_COST_MODEL.eig_flops(i_n, r_n, j_n)


def als_flops(i_n: int, r_n: int, j_n: int,
              num_iters: int = DEFAULT_ALS_ITERS) -> float:
    return DEFAULT_COST_MODEL.als_flops(i_n, r_n, j_n, num_iters)


def svd_flops(i_n: int, r_n: int, j_n: int) -> float:
    return DEFAULT_COST_MODEL.svd_flops(i_n, r_n, j_n)


def rand_flops(i_n: int, r_n: int, j_n: int,
               oversample: int = DEFAULT_OVERSAMPLE,
               power_iters: int = DEFAULT_POWER_ITERS) -> float:
    return DEFAULT_COST_MODEL.rand_flops(i_n, r_n, j_n, oversample, power_iters)


def predicted_best(i_n: int, r_n: int, j_n: int,
                   num_iters: int = DEFAULT_ALS_ITERS) -> str:
    """Analytic solver choice: smaller modeled FLOP count wins."""
    return DEFAULT_COST_MODEL.predicted_best(i_n, r_n, j_n, num_iters)
