"""Append-only JSONL measurement store for the autotune flywheel.

One :class:`Measurement` = one timed mode solve: where it ran (platform +
ops backend + device fingerprint), what it solved (``(I_n, R_n, J_n)``,
tensor order, dtype, ALS iteration count), which solver, and the measured
seconds.  Records come from two producers — the offline sampling harness
(:mod:`repro_torch.tune.collect`) and the online harvester that converts
the ``ModeTrace`` records of executed plans — and accumulate in a
:class:`RecordStore`, a plain JSONL file that is safe to append to from
repeated runs and to merge across boxes.

The schema is the reference's (``SCHEMA_VERSION`` 1), so a store written by
either package reads in the other.  The platform is the torch device type
(``"cuda"`` or ``"cpu"``), and :func:`device_fingerprint` names the card.

Dedup identity is everything except the measurement itself (seconds,
source): re-measuring the same problem on the same hardware *merges* by
keeping the fastest observation (best-of semantics, matching how the
collector times solvers).  ``digest()`` hashes the deduped canonical
content so trained models can pin the exact store state they saw.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, replace
from pathlib import Path
from typing import Iterable, Iterator

import torch

SCHEMA_VERSION = 1

#: record sources
COLLECT, HARVEST = "collect", "harvest"


def device_fingerprint(device="cuda") -> str:
    """Coarse hardware identity a measurement is valid for: device type +
    device name + host core count, ``cuda/<torch.cuda.get_device_name>/x<cores>``
    on the card and ``cpu/cpu/x<cores>`` (the reference's CPU form) on the
    CPU.  Deliberately NOT a serial number — any identical box may reuse
    the records.  Asking for ``cuda`` without CUDA raises."""
    dev = torch.device(device)
    cores = os.cpu_count() or 1
    if dev.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(dev)}/x{cores}"
    return f"{dev.type}/{dev.type}/x{cores}"


@dataclass(frozen=True)
class Measurement:
    """One timed mode solve (see module docstring)."""
    platform: str            # torch device type ("cuda" | "cpu")
    backend: str             # ops backend the solve ran through
    device: str              # device_fingerprint() of the measuring box
    i_n: int
    r_n: int
    j_n: int
    method: str              # "eig" | "als" | "svd"
    seconds: float           # measured wall-clock (best-of-reps)
    dtype: str = "float32"
    order: int = 3           # tensor order the (I_n, J_n) pair came from
    als_iters: int = 5       # ALS iteration count (ignored for eig/svd)
    source: str = COLLECT    # "collect" | "harvest"
    predicted_s: float = 0.0  # plan-time calibrated prediction the schedule
                              # optimizer priced this step at (0.0 = none) —
                              # harvested records make DP decisions auditable
                              # and expose calibration drift (see `report`)
    rel_err: float = 0.0     # achieved-error label: discarded energy of this
                             # step as a fraction of ||X||² (rank-adaptive
                             # rand executions; 0.0 = exact-at-rank / not
                             # measured).  A measurement VALUE, not part of
                             # key(): re-observations of the same problem
                             # merge as usual.

    def key(self) -> tuple:
        """Dedup/merge identity: everything but (seconds, source)."""
        return (self.platform, self.backend, self.device, self.dtype,
                self.order, self.als_iters, self.i_n, self.r_n, self.j_n,
                self.method)

    def problem_key(self) -> tuple:
        """Pairing identity across methods (for labeling): key() sans
        method."""
        return self.key()[:-1]

    def to_dict(self) -> dict:
        d = asdict(self)
        d["v"] = SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Measurement":
        return cls(platform=str(d["platform"]), backend=str(d["backend"]),
                   device=str(d.get("device", "unknown")),
                   i_n=int(d["i_n"]), r_n=int(d["r_n"]), j_n=int(d["j_n"]),
                   method=str(d["method"]), seconds=float(d["seconds"]),
                   dtype=str(d.get("dtype", "float32")),
                   order=int(d.get("order", 3)),
                   als_iters=int(d.get("als_iters", 5)),
                   source=str(d.get("source", COLLECT)),
                   predicted_s=float(d.get("predicted_s", 0.0)),
                   rel_err=float(d.get("rel_err", 0.0)))


class RecordStore:
    """Append-only JSONL store of :class:`Measurement` rows.

    The file format is one JSON object per line — append-safe (interrupted
    runs lose at most their own tail; a trailing partial line is skipped on
    load), diff-able, and mergeable with ``cat``.  All read APIs parse the
    file fresh so concurrent appenders in one process see each other's
    records.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)

    # -- write ---------------------------------------------------------------
    def append(self, measurements: Iterable[Measurement]) -> int:
        """Append records; returns how many were written."""
        rows = [json.dumps(m.to_dict()) for m in measurements]
        if rows:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a+b") as f:
                # a prior interrupted append may have left a partial line
                # with no trailing newline; never concatenate onto it
                f.seek(0, 2)
                lead = b"\n" if f.tell() and not self._ends_newline(f) else b""
                f.write(lead + ("\n".join(rows) + "\n").encode())
        return len(rows)

    @staticmethod
    def _ends_newline(f) -> bool:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(0, 2)
        return last == b"\n"

    def merge_from(self, other: "RecordStore | str | Path") -> int:
        """Append the OTHER store's records whose dedup key is absent here
        (or strictly faster than our best for that key).  Returns the count
        appended."""
        other = other if isinstance(other, RecordStore) else RecordStore(other)
        best = {m.key(): m.seconds for m in self}
        fresh = [m for m in other
                 if m.seconds < best.get(m.key(), float("inf"))]
        return self.append(fresh)

    # -- read ----------------------------------------------------------------
    def __iter__(self) -> Iterator[Measurement]:
        if not self.path.exists():
            return
        with self.path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield Measurement.from_dict(json.loads(line))
                except (json.JSONDecodeError, KeyError, ValueError):
                    continue   # partial tail line from an interrupted append

    def load(self) -> list[Measurement]:
        return list(self)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def filter(self, *, platform: str | None = None,
               backend: str | None = None, dtype: str | None = None,
               method: str | None = None,
               source: str | None = None) -> list[Measurement]:
        want = dict(platform=platform, backend=backend, dtype=dtype,
                    method=method, source=source)
        return [m for m in self
                if all(v is None or getattr(m, k) == v
                       for k, v in want.items())]

    def dedup(self) -> dict[tuple, Measurement]:
        """Best (fastest) measurement per dedup key — merge semantics for
        repeated observations of the same problem on the same hardware."""
        best: dict[tuple, Measurement] = {}
        for m in self:
            cur = best.get(m.key())
            if cur is None or m.seconds < cur.seconds:
                best[m.key()] = m
        return best

    def compact(self) -> int:
        """Rewrite the file as its deduped content; returns rows dropped."""
        before = len(self)
        kept = sorted(self.dedup().values(), key=lambda m: m.key())
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text("".join(json.dumps(m.to_dict()) + "\n" for m in kept))
        tmp.replace(self.path)
        return before - len(kept)

    def digest(self) -> str:
        """sha256 over the canonical (deduped, key-sorted) content — stable
        under append order, duplicate re-measurement that didn't improve,
        and compaction; equal to the reference's for the same records."""
        h = hashlib.sha256()
        for _, m in sorted(self.dedup().items()):
            h.update(json.dumps(m.to_dict(), sort_keys=True).encode())
        return h.hexdigest()

    def stats(self) -> dict:
        """Summary counts for ``python -m repro_torch.tune report``, plus
        predicted-vs-actual drift over harvested rows that carry a
        calibrated plan-time prediction — the health signal for the
        schedule optimizer's cost model."""
        strata: dict[str, int] = {}
        methods: dict[str, int] = {}
        sources: dict[str, int] = {}
        n = 0
        drift_n, drift_sum = 0, 0.0
        for m in self:
            n += 1
            strata_key = f"{m.platform}/{m.backend}"
            strata[strata_key] = strata.get(strata_key, 0) + 1
            methods[m.method] = methods.get(m.method, 0) + 1
            sources[m.source] = sources.get(m.source, 0) + 1
            if m.predicted_s > 0.0 and m.seconds > 0.0:
                drift_n += 1
                drift_sum += abs(m.seconds - m.predicted_s) / m.seconds
        out = {"path": str(self.path), "records": n,
               "unique": len(self.dedup()), "strata": strata,
               "methods": methods, "sources": sources,
               "digest": self.digest() if n else None}
        if drift_n:
            out["prediction_drift"] = {
                "records_with_prediction": drift_n,
                "mean_abs_rel_error": drift_sum / drift_n}
        return out


def default_store_path() -> Path:
    """Default store location: ``ATUCKER_TUNE_STORE`` env override, else
    ``tune_store.jsonl`` in the working directory (kept OUT of the models
    dir so model dirs stay pure)."""
    env = os.environ.get("ATUCKER_TUNE_STORE")
    if env:
        return Path(env)
    return Path.cwd() / "tune_store.jsonl"


def mark_harvested(m: Measurement) -> Measurement:
    return replace(m, source=HARVEST)
