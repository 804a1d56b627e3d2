"""Failure taxonomy for the a-Tucker stack: every failure classified.

The execution layers (``plan.execute``, the serve waves, the eager
runners) raise — or wrap foreign exceptions into — one hierarchy rooted at
:class:`TuckerError`, so callers can catch by failure CLASS instead of
pattern-matching runtime message strings:

  * :class:`InputError`       — the caller's tensor/config is bad (NaN/Inf
    inputs, shape/dtype mismatch).  Subclasses ``ValueError``.
  * :class:`NumericalError`   — the computation broke down (Cholesky
    failure in ALS, non-finite solver outputs).  Subclasses
    ``FloatingPointError``.
  * :class:`ResourceError`    — the runtime ran out of something
    (``torch.cuda.OutOfMemoryError``, a dead or abandoned worker).
  * :class:`DeadlineError`    — a serve request missed its ``deadline_s``
    before dispatch.  Subclasses ``TimeoutError``.
  * :class:`CancelledError`   — the caller retracted the request via
    ``TuckerService.cancel``.

:func:`classify_exception` maps raw PyTorch/CUDA exceptions onto the taxonomy
(`None` when it cannot — programming errors stay themselves), and
:func:`coerce_exception` always returns a ``TuckerError`` (wrapping
unclassifiable failures in the base class) — the serve layer's guarantee
that no unclassified exception escapes to a caller.  The subclassing of
the matching builtins keeps every pre-taxonomy ``except ValueError`` /
``except TimeoutError`` call site working unchanged.

``TuckerPlan.execute`` drives a failed fixed-rank sweep through the
fallback ladder (``core/api.py``: als→eig on a :class:`NumericalError`, a
replan under a tighter cap on a :class:`ResourceError`) and re-raises the
classified error when no rung is left.  The reference's ``pallas → matfree``
rung has no ``hopper → matfree`` counterpart: on the card a kernel that
fails raises.
"""

from __future__ import annotations

__all__ = [
    "CancelledError", "DeadlineError", "InputError", "NumericalError",
    "ResourceError", "TuckerError", "check_finite", "check_result_finite",
    "classify_exception", "coerce_exception",
]


class TuckerError(RuntimeError):
    """Base of the classified-failure hierarchy (see module docstring)."""


class InputError(TuckerError, ValueError):
    """The caller's input is unusable: non-finite entries, or a tensor that
    does not match the plan's shape/dtype.  ``mode`` names the tensor mode
    whose slices concentrate the corruption (None when not applicable)."""

    def __init__(self, message: str, *, mode: int | None = None):
        super().__init__(message)
        self.mode = mode


class NumericalError(TuckerError, FloatingPointError):
    """The computation broke down numerically: a Cholesky factorization
    failed past its re-regularization ladder, or a solver produced
    non-finite factors from a finite input."""


class ResourceError(TuckerError):
    """The runtime ran out of a resource: ``torch.cuda.OutOfMemoryError``,
    an allocation failure, or a serve worker that died/was abandoned."""


class DeadlineError(TuckerError, TimeoutError):
    """A served request's ``deadline_s`` expired before it was dispatched
    (checked at admission and again at wave formation)."""


class CancelledError(TuckerError):
    """The request was retracted via ``TuckerService.cancel`` before it
    was dispatched."""


#: message fragments that mark a runtime allocation failure
_RESOURCE_MARKERS = (
    "RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "Out of memory",
    "out of memory", "OOM", "failed to allocate", "Failed to allocate",
    "Resource exhausted",
)
#: message fragments that mark a numerical breakdown
_NUMERICAL_MARKERS = (
    "Cholesky", "cholesky", "not positive definite", "non-finite",
    "not finite", "NaN", "nan produced", "singular matrix",
    "did not converge",
)


def classify_exception(exc: BaseException) -> TuckerError | None:
    """Map a raw exception onto the taxonomy, or None when it defies
    classification (shape errors, programming bugs — those should stay
    themselves).  Already-classified errors pass through unchanged; a
    fresh wrapper chains the original via ``__cause__``.

    ``torch.cuda.OutOfMemoryError`` is a :class:`ResourceError` and
    ``torch.linalg.LinAlgError`` a :class:`NumericalError`, whatever their
    messages say."""
    import torch
    if isinstance(exc, TuckerError):
        return exc
    msg = str(exc)
    wrapped: TuckerError | None = None
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)) or \
            any(m in msg for m in _RESOURCE_MARKERS):
        wrapped = ResourceError(f"resource exhausted: {msg}")
    elif isinstance(exc, (FloatingPointError, ZeroDivisionError,
                          torch.linalg.LinAlgError)) or \
            any(m in msg for m in _NUMERICAL_MARKERS):
        wrapped = NumericalError(f"numerical breakdown: {msg}")
    if wrapped is not None:
        wrapped.__cause__ = exc
    return wrapped


def coerce_exception(exc: BaseException) -> TuckerError:
    """Like :func:`classify_exception`, but total: unclassifiable failures
    come back wrapped in the :class:`TuckerError` base (original chained
    via ``__cause__``) — the serve layer's no-unclassified-escapes
    guarantee."""
    t = classify_exception(exc)
    if t is None:
        t = TuckerError(f"unclassified failure: {exc!r}")
        t.__cause__ = exc
    return t


def check_finite(x, *, name: str = "input") -> None:
    """Raise :class:`InputError` when ``x`` holds NaN/Inf, naming the
    tensor mode whose slices concentrate the corruption (the diagnosis
    walk runs only on the failure path; the pass path is one fused
    ``isfinite`` reduction)."""
    import torch
    x = torch.as_tensor(x)
    finite = torch.isfinite(x)
    if bool(finite.all()):
        return
    bad = ~finite
    n_bad = int(bad.sum())
    if x.ndim == 0:
        raise InputError(f"{name} is non-finite ({float(x)!r})")
    worst = (0, 0, -1)   # (mode, slice index, bad count in that slice)
    for mode in range(x.ndim):
        axes = tuple(a for a in range(x.ndim) if a != mode)
        per_slice = bad.sum(dim=axes) if axes else bad.to(torch.int64)
        idx = int(per_slice.argmax())
        cnt = int(per_slice[idx])
        if cnt > worst[2]:
            worst = (mode, idx, cnt)
    mode, idx, cnt = worst
    raise InputError(
        f"{name} contains {n_bad} non-finite value(s); the worst "
        f"concentration is mode {mode} (slice {idx} holds {cnt} of them)",
        mode=mode)


def check_result_finite(core, factors, *, context: str = "sweep") -> None:
    """Raise :class:`NumericalError` when a solve's outputs carry NaN/Inf
    (the post-execution guard of the ``validate="finite"`` path)."""
    import torch
    if not bool(torch.isfinite(core).all()):
        raise NumericalError(
            f"{context} produced a non-finite core tensor")
    for m, u in enumerate(factors):
        if not bool(torch.isfinite(u).all()):
            raise NumericalError(
                f"{context} produced a non-finite mode-{m} factor")
