"""Selector training over the measurement store (paper Sec. IV-B).

Pairing: a labeled example needs BOTH solvers measured on the same problem
on the same hardware — records are grouped by their problem key (platform,
backend, device, dtype, order, als_iters, I_n, R_n, J_n), the fastest
observation per method wins, and the label is argmin(eig, als).  One-sided
harvest records stay in the store unlabeled until traffic (or a collect
run) supplies the opposing method.

Stratification: one tree per ``(platform, backend)`` stratum — the backend
axis shifts the EIG/ALS crossover (each backend has its own cost profile) —
plus one platform-pooled tree as the graceful-fallback tier
``default_selector`` resolves when no per-backend model exists.  Every
model file embeds provenance metadata: sample counts, grid-search CV and
held-out test accuracy, the trained feature range (the out-of-range
guardrail), the store digest it was trained from and the device
fingerprints of its records.

``platform`` None means the port's default device's type, ``"cuda"``, and
raises without CUDA; pass ``"cpu"`` (or any platform string) to train that
slice of a store.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from ..core.cost_model import DEFAULT_COST_MODEL, CostModel
from ..core.dtree import grid_search_cv
from ..core.selector import Selector, extract_features, model_path
from .records import Measurement, RecordStore

#: below this many labeled examples a stratum is skipped (a tree fit on a
#: handful of points is worse than the cost-model fallback it replaces)
MIN_EXAMPLES = 12


def default_platform(platform: str | None) -> str:
    """``platform``, or the type of the port's default device (``cuda:0``,
    raising when CUDA is not available)."""
    if platform is not None:
        return platform
    from ..core.api import resolve_device
    return resolve_device(None).type


def labeled_examples(measurements: Iterable[Measurement], *,
                     rel_err_tolerance: float | None = None):
    """Pair eig/als records per problem → (features, labels, times) arrays.

    ``times[k] = (eig_seconds, als_seconds)`` for example k; unpaired
    records are simply not emitted.  ``rel_err_tolerance`` drops records
    whose achieved-error label (``Measurement.rel_err``) exceeds it before
    pairing, so a fast-but-out-of-budget observation can never win a speed
    comparison; eig/als records carry ``rel_err=0.0`` and always pass.
    """
    best: dict[tuple, dict[str, Measurement]] = {}
    for m in measurements:
        if rel_err_tolerance is not None and m.rel_err > rel_err_tolerance:
            continue
        slot = best.setdefault(m.problem_key(), {})
        cur = slot.get(m.method)
        if cur is None or m.seconds < cur.seconds:
            slot[m.method] = m
    feats, labels, times = [], [], []
    for slot in best.values():
        if "eig" not in slot or "als" not in slot:
            continue
        e, a = slot["eig"], slot["als"]
        feats.append(extract_features(e.i_n, e.r_n, e.j_n))
        labels.append(0 if e.seconds <= a.seconds else 1)
        times.append((e.seconds, a.seconds))
    if not feats:
        return (np.empty((0, len(extract_features(2, 1, 2)))),
                np.empty((0,), np.int64), np.empty((0, 2)))
    return np.array(feats), np.array(labels), np.array(times)


def train_selector(
    feats: np.ndarray,
    labels: np.ndarray,
    test_split: float = 0.3,
    seed: int = 0,
    *,
    platform: str | None = None,
    backend: str | None = None,
    cost_model: CostModel | None = None,
    meta: dict | None = None,
) -> tuple[Selector, dict]:
    """70/30 split + grid-search CV (paper defaults) → (Selector, info).

    ``platform`` labels the resulting selector (:func:`default_platform`)
    — the SAME string callers must use to save/cache it, so
    train/label/save never disagree.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(labels))
    n_test = int(len(labels) * test_split)
    test, train = perm[:n_test], perm[n_test:]
    tree, info = grid_search_cv(feats[train], labels[train])
    info["test_accuracy"] = tree.score(feats[test], labels[test]) \
        if n_test else None
    info["n_train"], info["n_test"] = len(train), len(test)
    platform = default_platform(platform)
    rng3 = (tuple(float(v) for v in feats[:, :3].min(0)),
            tuple(float(v) for v in feats[:, :3].max(0)))
    sel = Selector(tree=tree, platform=platform, backend=backend,
                   trained_range=rng3,
                   cost_model=cost_model or DEFAULT_COST_MODEL,
                   meta={**info, **(meta or {})})
    return sel, info


def train_stratified(
    store: RecordStore,
    *,
    platform: str | None = None,
    backends: Sequence[str] | None = None,
    model_dir=None,
    min_examples: int = MIN_EXAMPLES,
    test_split: float = 0.3,
    seed: int = 0,
    calibrate: bool = True,
    meta: dict | None = None,
) -> dict[str, dict]:
    """Train per-(platform, backend) trees + the platform-pooled tree and
    write versioned model files.  Returns {written path: info}.

    ``platform`` restricts training to one platform's records
    (:func:`default_platform`).  ``backends`` restricts the per-backend
    strata (default: every backend present in the store); the pooled tree
    always sees every backend's records.  ``calibrate=True`` additionally
    fits each stratum's cost-model constants
    (:mod:`repro_torch.tune.calibrate`) and embeds them as the trained
    model's out-of-range guardrail fallback.  ``meta`` is merged into every
    model's metadata (the card's name and power limit, the sampling
    arguments).
    """
    from ..core import selector as sel_mod
    platform = default_platform(platform)
    records = store.filter(platform=platform)
    digest = store.digest()
    present = sorted({m.backend for m in records})
    if backends is not None:
        present = [b for b in present if b in backends]

    written: dict[str, dict] = {}

    def _fit(recs, backend: str | None):
        feats, labels, times = labeled_examples(recs)
        if len(labels) < min_examples:
            return None
        cm = None
        if calibrate:
            from .calibrate import fit_cost_model
            cm = fit_cost_model(recs if backend is not None else records)
        info_meta = {"format": "selector", "platform": platform,
                     "backend": backend, "n_records": len(recs),
                     "n_examples": int(len(labels)),
                     "label_balance_als": float(labels.mean()),
                     "store_digest": digest,
                     "devices": sorted({m.device for m in recs}),
                     "trained_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                 time.gmtime()),
                     **(meta or {})}
        sel, info = train_selector(feats, labels, test_split, seed,
                                   platform=platform, backend=backend,
                                   cost_model=cm, meta=info_meta)
        path = model_path(platform, backend)
        if model_dir is not None:
            path = Path(model_dir) / path.name
        sel.save(path)
        # retraining must be visible in-process: refresh the resolution cache
        sel_mod._DEFAULT_BY_PLATFORM[(platform, backend)] = sel
        if backend is None:
            # the pooled model also serves (platform, b) lookups that found
            # no per-backend file — evict entries serving any fallback (an
            # old pooled tree: selector.backend None; the bare cost model:
            # tree None) so they re-resolve against the fresh pooled model
            for k in [k for k in sel_mod._DEFAULT_BY_PLATFORM
                      if k[0] == platform and k[1] is not None
                      and (sel_mod._DEFAULT_BY_PLATFORM[k].backend is None
                           or sel_mod._DEFAULT_BY_PLATFORM[k].tree is None)]:
                del sel_mod._DEFAULT_BY_PLATFORM[k]
        return path, {**info, **info_meta}

    for b in present:
        got = _fit([m for m in records if m.backend == b], b)
        if got:
            written[str(got[0])] = got[1]
    got = _fit(records, None)           # platform-pooled fallback tier
    if got:
        written[str(got[0])] = got[1]
    return written


def train_and_save(platform: str | None = None, **collect_kw) -> dict:
    """Legacy one-shot: collect on this box → train → save under ONE
    platform string (the passed ``platform``, else the type of the device
    ``collect_kw`` names, ``cuda:0`` by default) — the model's label, file
    name, and cache key all agree."""
    from ..core import selector as sel_mod
    from ..core.api import resolve_device
    from .collect import collect_samples
    platform = platform or resolve_device(collect_kw.get("device")).type
    feats, labels, _ = collect_samples(**collect_kw)
    sel, info = train_selector(feats, labels, platform=platform)
    sel.save(model_path(platform))
    sel_mod._DEFAULT_BY_PLATFORM[(platform, None)] = sel
    return info
