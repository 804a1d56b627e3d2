"""Deterministic fault injection for the port of the a-Tucker stack.

The port's copy of ``repro/chaos``.  The execution layers call :func:`fire`
/ :func:`poison` at well-known **seams** — ``"sweep"`` (a fixed-rank
plan's cached sweep), ``"sweep_out"`` / ``"solve_out"`` (result poisoning
points), ``"solve"`` (each recorded mode solve), ``"sketch"`` (adaptive
range finder) and the serve service's (:mod:`repro_torch.serve.service`):
``"wave"`` (each fused wave), ``"wave_job"`` (each lane and each isolated
run), ``"wave_job_data"`` (poisoning one lane's data) and ``"worker"``
(each turn of the background pump).  With no rules installed both calls
are a single list check, so the clean path pays nothing.

A :class:`Rule` is deterministic and seed-addressable: it matches one
seam (plus optional context-field equality via ``match=``), fires on the
``at``-th hit / every ``every``-th hit / with seeded pseudo-probability
``p``, and stops after ``times`` firings.  Actions:

  * ``"raise"`` — raise :class:`ChaosFault` (a ``RuntimeError``; set
    ``message=`` to shape how the taxonomy classifies it),
  * ``"oom"``   — raise :class:`SyntheticOOM`, whose message carries the
    ``RESOURCE_EXHAUSTED`` / ``Out of memory`` markers, so
    :func:`repro_torch.core.errors.classify_exception` makes it a
    :class:`~repro_torch.core.errors.ResourceError` and the fallback ladder
    is exercised end to end,
  * ``"nan"``   — make the matching :func:`poison` call return True (the
    seam site corrupts its own data; this module never imports torch),
  * ``"slow"`` / ``"wedge"`` — sleep ``delay_s`` (wedge defaults long).

Install programmatically (:func:`install`, :func:`reset`) or via the
``ATUCKER_CHAOS=`` env var naming a profile from :data:`PROFILES`
(``numerical`` | ``oom`` | ``serve-poison``).
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field

__all__ = [
    "ChaosFault", "PROFILES", "Rule", "SyntheticOOM", "active", "fire",
    "fired", "install", "install_profile", "poison", "reset",
]


class ChaosFault(RuntimeError):
    """A synthetic fault raised by an injector rule."""


class SyntheticOOM(ChaosFault):
    """A synthetic allocation failure whose message carries the markers of
    a real one, so the taxonomy classifies it as a device OOM."""

    def __init__(self, seam: str):
        super().__init__(
            f"RESOURCE_EXHAUSTED: Out of memory (synthetic fault injected "
            f"at seam {seam!r})")


@dataclass
class Rule:
    """One injector: *where* (seam + context match), *when* (at/every/p),
    *what* (action), *how often* (times)."""

    seam: str
    action: str                       # raise | oom | nan | slow | wedge
    at: int | None = None             # fire on the at-th hit (0-based)
    every: int | None = None          # fire on every N-th hit
    p: float | None = None            # seeded per-hit probability
    times: int | None = 1             # max firings (None = unlimited)
    seed: int = 0
    match: dict = field(default_factory=dict)   # ctx equality filters
    message: str | None = None        # override for action="raise"
    delay_s: float | None = None      # for slow/wedge
    fired_count: int = 0              # mutated under the registry lock

    def _due(self, hit: int) -> bool:
        if self.times is not None and self.fired_count >= self.times:
            return False
        due = self.at is None and self.every is None and self.p is None
        if self.at is not None and hit == self.at:
            due = True
        if self.every is not None and self.every > 0 and \
                hit % self.every == 0:
            due = True
        if self.p is not None:
            roll = random.Random(f"{self.seed}:{self.seam}:{hit}").random()
            due = due or roll < self.p
        return due

    def _matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())


_lock = threading.Lock()
_rules: list[Rule] = []
_hits: dict[str, int] = {}
_fired: dict[str, int] = {}


def active() -> bool:
    """Whether any injector rules are installed."""
    return bool(_rules)


def install(rule: "Rule | list[Rule] | tuple[Rule, ...]"):
    """Register an injector rule, or an iterable of them; returns what was
    passed (for later inspection of ``fired_count``)."""
    with _lock:
        if isinstance(rule, Rule):
            _rules.append(rule)
        else:
            _rules.extend(rule)
    return rule


def reset() -> None:
    """Remove every rule and zero the hit/fired accounting."""
    with _lock:
        _rules.clear()
        _hits.clear()
        _fired.clear()


def fired() -> dict[str, int]:
    """``{"seam:action": count}`` of faults actually injected so far."""
    with _lock:
        return dict(_fired)


def _consume(seam: str, ctx: dict, want_nan: bool) -> Rule | None:
    """Advance the seam's hit counter and return the first due rule of the
    requested family (data-poisoning vs. control-flow), marking it fired."""
    with _lock:
        if not _rules:
            return None
        hit = _hits.get(seam, 0)
        _hits[seam] = hit + 1
        for r in _rules:
            if r.seam != seam or (r.action == "nan") != want_nan:
                continue
            if r._matches(ctx) and r._due(hit):
                r.fired_count += 1
                key = f"{seam}:{r.action}"
                _fired[key] = _fired.get(key, 0) + 1
                return r
        return None


def fire(seam: str, **ctx) -> None:
    """Injection point for control-flow faults (raise/oom/slow/wedge).
    A no-op unless a due rule matches this seam + context."""
    if not _rules:
        return
    r = _consume(seam, ctx, want_nan=False)
    if r is None:
        return
    if r.action == "oom":
        raise SyntheticOOM(seam)
    if r.action == "raise":
        raise ChaosFault(
            r.message or f"synthetic fault injected at seam {seam!r}")
    if r.action in ("slow", "wedge"):
        time.sleep(r.delay_s if r.delay_s is not None
                   else (30.0 if r.action == "wedge" else 0.05))
        return
    raise ValueError(f"unknown chaos action {r.action!r}")


def poison(seam: str, **ctx) -> bool:
    """Injection point for data corruption: returns True when the seam
    site should replace its data with NaNs (the caller does the actual
    poisoning — this module stays torch-free)."""
    if not _rules:
        return False
    return _consume(seam, ctx, want_nan=True) is not None


#: env-selectable fault families (``ATUCKER_CHAOS=<name>``); each fault
#: either gets recovered by a fallback-ladder hop / wave isolation or
#: surfaces as a classified TuckerError.
PROFILES: dict[str, list[Rule]] = {
    # poison one fused sweep's outputs → NumericalError → als→eig hop
    "numerical": [Rule(seam="sweep_out", action="nan", at=0, times=1)],
    # synthetic device OOM on one dispatch → ResourceError → the
    # replan-under-a-tighter-cap hop
    "oom": [Rule(seam="sweep", action="oom", at=0, times=1)],
    # one serve request poisons every fused wave containing it → wave
    # bisection quarantines it alone, the rest of the wave completes
    "serve-poison": [Rule(seam="wave_job", action="raise", times=None,
                          match={"rid": 2},
                          message="synthetic poisoned request")],
}


def install_profile(name: str) -> list[Rule]:
    """Install the named :data:`PROFILES` entry (fresh Rule copies, so a
    profile can be installed repeatedly)."""
    try:
        rules = PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown chaos profile {name!r}; "
            f"known: {sorted(PROFILES)}") from None
    out = []
    for r in rules:
        out.append(install(Rule(
            seam=r.seam, action=r.action, at=r.at, every=r.every, p=r.p,
            times=r.times, seed=r.seed, match=dict(r.match),
            message=r.message, delay_s=r.delay_s)))
    return out


_env = os.environ.get("ATUCKER_CHAOS")
if _env:
    # opt-in only ever via the env var; a bad name should fail loudly at
    # import so CI misconfiguration can't silently run a clean suite
    install_profile(_env)
