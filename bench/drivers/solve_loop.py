"""Closed loop of one caller: a plan built once, then ``execute`` on the
traffic's distinct inputs in turn, each result waited for, until the window
closes.

Traffic parameters: ``methods``, ``impl``, ``mode_order`` (the
``TuckerConfig``), ``inputs`` (distinct inputs made from the seed),
``warm_rounds`` (untimed passes over them in set-up), ``sample`` (results
kept, drawn from the seed, for the comparison), ``trace_stretch_s`` (the
end of the window a ``--trace 1`` run profiles).
"""

from __future__ import annotations

import gc
import random
import time
from contextlib import nullcontext

from bench import count, devtrace, gen, reference
from bench.drivers import common


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> list:
    """The traffic's distinct inputs, from the seed."""
    return [gen.lowrank(cfg["shape"], cfg["ranks"],
                        gen.generator(device, seed, 0, k), noise=cfg["noise"])
            for k in range(traffic["inputs"])]


def judged_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(input, mode order) of every input a run of this seed judges."""
    order = reference.mode_order(cfg["shape"], cfg["ranks"],
                                 traffic["mode_order"])
    for x in make_inputs(cfg, traffic, seed, device):
        yield x, order


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device) -> dict:
    from repro_torch.core import TuckerConfig, clear_sweep_cache, plan
    marks = [time.perf_counter()]
    shape, ranks = tuple(cfg["shape"]), tuple(cfg["ranks"])
    inputs = make_inputs(cfg, traffic, seed, device)
    common.sync(device)
    marks.append(time.perf_counter())
    tcfg = TuckerConfig(ranks=ranks, methods=traffic["methods"],
                        impl=traffic["impl"], mode_order=traffic["mode_order"])
    p = plan(shape, cfg["dtype"], tcfg, device=device)
    marks.append(time.perf_counter())
    for _ in range(traffic["warm_rounds"]):
        for x in inputs:
            p.execute(x)
            common.sync(device)
    marks.append(time.perf_counter())
    if trace and common.is_cuda(device):
        devtrace.warm(device)
    marks.append(time.perf_counter())
    sample = common.Reservoir(traffic["sample"],
                              random.Random(gen.stream_seed(seed, 2)))
    setup_peak = common.peak(device, reset=True)

    n = failed = 0
    errors: list[str] = []
    stretch = min(traffic["trace_stretch_s"], seconds / 4) if trace else 0.0
    t0 = time.perf_counter()
    deadline, prof_from = t0 + seconds, t0 + seconds - stretch
    prof = cm = None
    n_pre, t_pre = 0, t0
    now = t0
    while now < deadline or n == 0:
        k = n % len(inputs)
        try:
            with devtrace.unit() if cm is not None else nullcontext():
                res = p.execute(inputs[k])
                common.sync(device)
        except Exception as e:  # noqa: BLE001 - a failed solve is counted
            failed += 1
            errors.append(repr(e)[:400])
            break
        sample.offer((k, res.tucker.core, res.tucker.factors))
        n += 1
        now = time.perf_counter()
        if trace and cm is None and now >= prof_from and now < deadline:
            cm = devtrace.profiled()
            prof = cm.__enter__()
            n_pre, t_pre = n, time.perf_counter()
    t_end = now
    if cm is not None:
        common.sync(device)
        t_end = time.perf_counter()     # before the profiler's own parsing
        cm.__exit__(None, None, None)
    window_s = now - t0
    window_peak = common.peak(device)
    held = sum(x.numel() * x.element_size() for x in inputs)

    bound_s, bound_by = count.solve_bound(shape, ranks)
    summary = None
    if prof is not None:
        summary = devtrace.summarize(prof.events(), t_end - t_pre)
    solve_ms = window_s / max(n, 1) * 1e3
    ctx = dict(kind="solve", bound_s=bound_s, bound_by=bound_by,
               solve_ms=(t_pre - t0) / n_pre * 1e3 if n_pre else solve_ms,
               trace=summary)
    setup = dict(zip(("inputs_s", "plan_s", "warm_s", "profiler_s"),
                     (b - a for a, b in zip(marks, marks[1:]))))

    # the program's state goes before the reference runs
    del p
    clear_sweep_cache()
    gc.collect()
    common.empty_cache(device)
    order = reference.mode_order(shape, ranks, traffic["mode_order"])
    refs = {}
    readings = {"subspace": 0.0, "recon": 0.0}
    for k, core, factors in sorted(sample.items, key=lambda s: s[0]):
        if k not in refs:
            refs = {k: reference.sthosvd(inputs[k], ranks, order)}
        g = reference.gaps(core, factors, *refs[k])
        for name in readings:
            readings[name] = max(readings[name], g[name])
    readings["failed"] = failed
    return dict(t_window=t0, attempted=n + failed, failed=failed,
                e2e=dict(solve_ms=solve_ms,
                         peak_gb=(window_peak - held) / 1e9),
                memory_peak_bytes=max(setup_peak, window_peak),
                ctx=ctx, readings=readings, errors=errors,
                info=dict(solves=n, window_s=window_s, held_bytes=held,
                          window_peak_bytes=window_peak, sampled=len(
                              sample.items), bound_ms=bound_s * 1e3,
                          bound_by=bound_by, setup=setup,
                          traced_solves=n - n_pre if prof is not None
                          else 0))
