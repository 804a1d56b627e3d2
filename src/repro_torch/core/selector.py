"""Adaptive solver selector (a-Tucker Sec. IV).

Features (paper Table I), label = argmin(measured time of EIG vs ALS) on the
current platform.  A trained :class:`repro_torch.core.dtree.DecisionTree` is
stored as JSON per ``(platform, backend)`` — ``matfree`` vs ``explicit`` vs
``hopper`` shift the EIG/ALS crossover, so the hardware axis the paper's
selector absorbs includes the ops backend, not just the chip.  Resolution
falls back gracefully: exact ``(platform, backend)`` model → platform-only
model → analytic Eq.4/5 cost model (hardware-calibrated when a
calibration file exists, textbook constants otherwise), so the flexible
algorithm never blocks on training data.

Platforms are the ``torch.device`` types, ``"cpu"`` and ``"cuda"``, passed
in by the planner.  The shipped CPU models (``models/selector_cpu*.json``,
``cost_cpu_*.json``) are copies of the reference's, so ``methods="auto"``
on the CPU picks what the reference picks.  The shipped CUDA models
(``selector_cuda.json``, ``selector_cuda_{hopper,matfree}.json``,
``cost_cuda_{hopper,matfree}.json``) were trained on an H100 by the tune
flywheel (:mod:`repro_torch.tune`, run by ``chip_smoke.py``'s ``tune``
phase) from solves timed the way a plan runs them on the card, captured
into CUDA graphs and replayed; their ``meta`` names the card, its power
limit and the measurement store's digest.  Training and calibration live
in :mod:`repro_torch.tune`; the shims at the bottom keep the legacy
entry points.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .cost_model import DEFAULT_COST_MODEL, CostModel
from .dtree import DecisionTree

FEATURE_NAMES = (
    "I_n", "R_n", "J_n",
    "I_n*I_n", "R_n*R_n", "I_n*R_n",
    "R_n*R_n/I_n", "R_n*R_n/J_n", "I_n/J_n", "R_n/J_n",
)

_DEFAULT_MODEL_DIR = Path(os.environ.get(
    "ATUCKER_MODEL_DIR", Path(__file__).resolve().parent / "models"))

LABELS = ("eig", "als")   # class 0 = eig, class 1 = als

SELECTOR_FORMAT_VERSION = 2


def extract_features(i_n: int, r_n: int, j_n: int) -> np.ndarray:
    """Paper Table I: 3 raw shape features + 7 derived."""
    i_n, r_n, j_n = float(i_n), float(r_n), float(j_n)
    return np.array([
        i_n, r_n, j_n,
        i_n * i_n, r_n * r_n, i_n * r_n,
        r_n * r_n / i_n, r_n * r_n / j_n, i_n / j_n, r_n / j_n,
    ])


@dataclass
class Selector:
    """Callable solver selector: (i_n, r_n, j_n) → 'eig' | 'als'.

    Guardrail: decision trees extrapolate badly; queries outside the trained
    feature range (× margin) defer to the analytic Eq.4/5 cost model — the
    paper's huge-mode regime (Air: I_n = 30648) must never be mispredicted
    by a tree that was trained on smaller dims.  ``cost_model`` is that
    fallback's constants: textbook by default, hardware-fitted when the
    model file embeds a calibration.

    ``backend`` records which ops backend the training measurements ran
    through (None = pooled across backends / unknown); ``meta`` carries the
    training provenance written by the tune flywheel (sample counts,
    CV/test accuracy, store digest, trained dim range).
    """
    tree: DecisionTree | None = None
    platform: str = "unknown"
    backend: str | None = None
    trained_range: tuple | None = None   # ((min_i, min_r, min_j), (max_i, max_r, max_j))
    range_margin: float = 2.0
    cost_model: CostModel = field(default_factory=lambda: DEFAULT_COST_MODEL)
    meta: dict = field(default_factory=dict)

    def __call__(self, *, i_n: int, r_n: int, j_n: int,
                 candidates: tuple[str, ...] | None = None) -> str:
        """Solver for one mode solve.  ``candidates=None`` is the legacy
        EIG-vs-ALS decision (what the trained tree answers directly).  A
        wider tuple — e.g. ``("eig", "als", "rand")`` — keeps the tree's
        eig/als call but lets the calibrated cost model overrule it with
        any extra candidate it prices cheaper (backend capability gating
        is the planner's job; candidates passed here are assumed runnable).
        """
        if self.tree is None or self._out_of_range(i_n, r_n, j_n):
            return self.cost_model.predicted_best(
                i_n, r_n, j_n, methods=candidates or ("eig", "als"))
        pick = LABELS[self.tree.predict_one(
            extract_features(i_n, r_n, j_n))]
        extras = tuple(c for c in candidates or () if c not in LABELS)
        if not extras:
            return pick
        # tree's winner first: ties and un-priceable cases keep the tree
        return self.cost_model.predicted_best(
            i_n, r_n, j_n, methods=(pick,) + extras)

    def _out_of_range(self, i_n, r_n, j_n) -> bool:
        if self.trained_range is None:
            return False
        lo, hi = self.trained_range
        m = self.range_margin
        for v, l, h in zip((i_n, r_n, j_n), lo, hi):
            if v < l / m or v > h * m:
                return True
        return False

    # -- persistence ---------------------------------------------------------
    def save(self, path: str | Path) -> None:
        if self.tree is None:
            raise ValueError(
                "cannot save a selector with no trained tree (the cost-model "
                "fallback needs no file); train one first")
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"version": SELECTOR_FORMAT_VERSION,
             "platform": self.platform, "backend": self.backend,
             "tree": self.tree.to_dict(),
             "trained_range": self.trained_range,
             "cost_model": self.cost_model.to_dict(),
             "meta": self.meta}, indent=1))

    @classmethod
    def load(cls, path: str | Path) -> "Selector":
        d = json.loads(Path(path).read_text())
        rng = d.get("trained_range")
        if rng is not None:
            rng = (tuple(rng[0]), tuple(rng[1]))
        cm = d.get("cost_model")
        return cls(tree=DecisionTree.from_dict(d["tree"]),
                   platform=d["platform"], backend=d.get("backend"),
                   trained_range=rng,
                   cost_model=(CostModel.from_dict(cm) if cm
                               else DEFAULT_COST_MODEL),
                   meta=d.get("meta", {}))


def model_dir() -> Path:
    """The selector/calibration model directory (``ATUCKER_MODEL_DIR`` env
    override, default ``repro_torch/core/models`` — where the shipped CPU
    and CUDA models live)."""
    return _DEFAULT_MODEL_DIR


def model_path(platform: str, backend: str | None = None) -> Path:
    stem = f"selector_{platform}" + (f"_{backend}" if backend else "")
    return _DEFAULT_MODEL_DIR / f"{stem}.json"


def calibration_path(platform: str, backend: str) -> Path:
    """Standalone calibrated-cost-model file (written by the tune
    flywheel's calibration); also embedded into selector files at train
    time."""
    return _DEFAULT_MODEL_DIR / f"cost_{platform}_{backend}.json"


def load_calibration(platform: str, backend: str | None) -> CostModel | None:
    """The fitted CostModel for (platform, backend) if one is on disk."""
    if backend is None:
        return None
    p = calibration_path(platform, backend)
    if not p.exists():
        return None
    return CostModel.from_dict(json.loads(p.read_text()))


_DEFAULT_BY_PLATFORM: dict[tuple[str, str | None], Selector] = {}


def default_selector(platform: str, backend: str | None = None) -> Selector:
    """Trained tree for ``(platform, backend)`` if present, else the
    platform-pooled tree, else cost-model fallback (hardware-calibrated when
    a calibration file exists for the pair).  Cached per (platform, backend),
    so CPU and GPU model files — and per-backend refinements — resolve
    correctly side by side in one process.
    """
    key = (platform, backend)
    sel = _DEFAULT_BY_PLATFORM.get(key)
    if sel is None:
        for p in ([model_path(platform, backend)] if backend else []) + \
                [model_path(platform)]:
            if p.exists():
                sel = Selector.load(p)
                break
        if sel is None:
            sel = Selector(platform=platform, backend=backend,
                           cost_model=load_calibration(platform, backend)
                           or DEFAULT_COST_MODEL)
        _DEFAULT_BY_PLATFORM[key] = sel
    return sel


def clear_selector_cache() -> None:
    """Drop cached default selectors (tests / after retraining in-process)."""
    _DEFAULT_BY_PLATFORM.clear()


# ---------------------------------------------------------------------------
# Training pipeline — thin wrappers over repro_torch.tune
# ---------------------------------------------------------------------------

def collect_samples(*args, **kw):
    """Legacy shim → :func:`repro_torch.tune.collect.collect_samples` (same
    return: ``(features, labels, times)`` arrays)."""
    from ..tune.collect import collect_samples as _collect
    return _collect(*args, **kw)


def train_selector(*args, **kw):
    """Legacy shim → :func:`repro_torch.tune.train.train_selector`."""
    from ..tune.train import train_selector as _train
    return _train(*args, **kw)


def train_and_save(platform: str | None = None, **collect_kw) -> dict:
    """Legacy shim → :func:`repro_torch.tune.train.train_and_save`.  The
    trained selector is labeled with, saved under, and cached for ONE
    platform string: ``platform`` if given, else the type of the device
    ``collect_kw`` names (``cuda:0`` by default)."""
    from ..tune.train import train_and_save as _tas
    return _tas(platform=platform, **collect_kw)
