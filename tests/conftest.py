"""Settings shared by every test under ``tests/``.

* **Thread pools.** Each process of a run gets its share of the cores:
  ``os.cpu_count() // n`` threads, where ``n`` is the number of pytest-xdist
  workers (1 without xdist), for torch, OpenMP and BLAS. The variables are
  set before the test modules import torch, numpy or jax, and child
  processes the tests start inherit them; a setting already made is left
  as it is.
* **Hypothesis.** A profile loaded here, before any test module is imported:
  no deadline (a first example that compiles takes seconds), 10 examples,
  drawn from a fixed seed, and no saved example replayed. It holds for each
  ``@given`` test without ``@settings`` of its own; ``test_sthosvd.py`` and
  ``test_tensor_ops.py`` load their own ``"ci"`` profile at import, which
  is built on this one and holds for the modules imported after them.
* **A time limit on every test.** Each test's set-up, call and tear-down run
  under an alarm of ``TIME_LIMIT_S`` seconds (``@pytest.mark.time_limit(s)``
  sets another for one test, 0 none). A phase that runs out of time fails
  with the line it was waiting on, all threads' stacks are written to
  stderr, and the run goes on. If the alarm cannot interrupt the phase (a
  call into C that never returns), the process dumps its stacks and exits
  ``EXIT_GRACE_S`` later: under xdist the worker is replaced and the run
  goes on. A test that runs off the main thread, where no alarm can be
  set, gets only that exit, at its limit.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import threading

import pytest

from _hypothesis_compat import settings

settings.register_profile("tests", max_examples=10, deadline=None,
                          derandomize=True, database=None)
settings.load_profile("tests")

TIME_LIMIT_S = 240.0   # the slowest test measured at -n 6 on 8 cores: 56 s
EXIT_GRACE_S = 60.0
_STDERR = None   # a copy of the terminal's stderr, made before capture


def _pin_threads(config):
    """Before the test modules import torch or numpy (they do so at
    collection, after this). The xdist controller sets the variables before
    it starts the workers, which inherit them."""
    if hasattr(config, "workerinput"):
        workers = config.workerinput["workercount"]
    else:
        n = config.getoption("numprocesses", None)
        workers = n if isinstance(n, int) and n > 0 else 1
    threads = str(max(1, (os.cpu_count() or 1) // workers))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, threads)
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


def pytest_configure(config):
    global _STDERR
    _pin_threads(config)
    config.addinivalue_line(
        "markers", "time_limit(seconds): this test's own limit for each of "
        "its set-up, call and tear-down, in place of the default (0: none)")
    with contextlib.suppress(OSError, ValueError):
        _STDERR = os.fdopen(os.dup(sys.__stderr__.fileno()), "w")


def pytest_unconfigure(config):
    global _STDERR
    if _STDERR is not None:
        _STDERR.close()
        _STDERR = None


@contextlib.contextmanager
def _time_limit(item, phase: str):
    mark = item.get_closest_marker("time_limit")
    limit = float(mark.args[0]) if mark else TIME_LIMIT_S
    if limit <= 0:
        yield
        return
    stderr = _STDERR or sys.__stderr__
    if threading.current_thread() is not threading.main_thread():
        faulthandler.dump_traceback_later(limit, exit=True, file=stderr)
        try:
            yield
        finally:
            faulthandler.cancel_dump_traceback_later()
        return

    def expired(signum, frame):
        __tracebackhide__ = True
        if _STDERR is not None:
            print(f"\n{item.nodeid}: {phase} ran past its time limit of "
                  f"{limit:g} s; the stacks of all threads:", file=_STDERR,
                  flush=True)
            faulthandler.dump_traceback(file=_STDERR, all_threads=True)
        pytest.fail(f"{phase} ran past its time limit of {limit:g} s "
                    "(the time_limit marker raises it)", pytrace=True)

    previous = signal.signal(signal.SIGALRM, expired)
    faulthandler.dump_traceback_later(limit + EXIT_GRACE_S, exit=True,
                                      file=stderr)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "set-up"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _time_limit(item, "tear-down"):
        return (yield)
