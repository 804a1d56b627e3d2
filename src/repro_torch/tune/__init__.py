"""Autotune subsystem: the measurement flywheel behind the adaptive selector.

The paper's selector is trained once, offline (Sec. IV-B).  This package
turns that into a loop, as the reference's ``repro.tune`` does:

  * :mod:`repro_torch.tune.records` — append-only JSONL measurement store
    (platform + backend + device fingerprint, (I_n, R_n, J_n), method,
    seconds) with dedup/merge/digest, in the reference's schema.
  * :mod:`repro_torch.tune.collect` — offline sampling harness across
    registered ops backends and tensor orders (on the card each solve is
    timed captured into CUDA graphs and replayed, as a plan runs it), plus
    the ONLINE harvester: ``recording()`` / ``plan.execute(record=True)``
    convert the ModeTrace records of production executions into training
    records.
  * :mod:`repro_torch.tune.train` — (platform, backend)-stratified decision
    trees with embedded provenance metadata, resolved by
    ``repro_torch.core.selector.default_selector`` per (platform, backend)
    with graceful fallback.
  * :mod:`repro_torch.tune.calibrate` — least-squares fit of the Eq. 4/5
    cost model's constants and seconds-per-FLOP scales per backend.

CLI: ``python -m repro_torch.tune {collect | harvest | train | calibrate |
report} [--device cpu]``.
"""

from .calibrate import calibrate_store, fit_cost_model
from .collect import (
    active_sink,
    collect,
    collect_into,
    harvest_result,
    harvest_results,
    recording,
)
from .records import Measurement, RecordStore, default_store_path
from .train import labeled_examples, train_selector, train_stratified

__all__ = [
    "Measurement", "RecordStore", "active_sink", "calibrate_store",
    "collect", "collect_into", "default_store_path", "fit_cost_model",
    "harvest_result", "harvest_results", "labeled_examples", "recording",
    "train_selector", "train_stratified",
]
