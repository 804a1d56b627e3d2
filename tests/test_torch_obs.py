"""The port's observability layer (``repro_torch.obs``) held to the
reference's: the span bus, the exporters, the metrics registry, the drift
monitor and its CLI, and the spans the core emits.

These are the behaviours of ``tests/test_obs.py`` that need no serve
service, run against the port on ``device="cpu"`` (``MemoryWatch`` on the
CPU samples the bytes of live tensors).  The parity cases run one plan in
each package with its obs enabled, on the same numpy input made from a
seed, and require the same sequence of (event kind, span name) pairs.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as R_api
from repro import obs as R_obs
from repro_torch import obs
from repro_torch.core import TuckerConfig, api as A, plan as make_plan
from repro_torch.core.cost_model import CostModel
from repro_torch.obs import drift as drift_mod
from repro_torch.obs import export as export_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.obs.drift import DriftMonitor, MemoryWatch

SHAPE = (16, 18, 20)
RANKS = (4, 4, 4)


@pytest.fixture(autouse=True)
def _obs_disabled_after():
    """Tracing must never leak into other test modules."""
    yield
    obs.disable()
    R_obs.disable()


def _x(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# span bus
# ---------------------------------------------------------------------------

class TestTraceBus:
    def test_disabled_is_default_and_free(self):
        assert not obs.enabled()
        buf = obs.EventBuffer()
        obs.add_sink(buf)
        try:
            obs.event("cache", status="hit")
            with obs.span("execute", backend="matfree"):
                pass
            assert len(buf) == 0
        finally:
            obs.remove_sink(buf)

    def test_event_shape_and_span_nesting(self):
        with obs.capture() as buf:
            with obs.span("outer", a=1) as sp:
                obs.event("cache", status="miss")
                with obs.span("inner"):
                    pass
                sp.set(late=True)
        evs = buf.events()
        kinds = [(e["kind"], e.get("name")) for e in evs]
        # inner span exits first, point event lands before both
        assert kinds == [("cache", None), ("span", "inner"),
                         ("span", "outer")]
        cache, inner, outer = evs
        for e in evs:
            assert {"t", "kind", "pid", "tid"} <= e.keys()
        assert cache["parent"] == outer["span"]
        assert inner["parent"] == outer["span"]
        assert outer["parent"] is None
        assert outer["late"] is True and outer["a"] == 1
        assert outer["dur_s"] >= inner["dur_s"] >= 0.0

    def test_span_records_exception_and_unwinds(self):
        with obs.capture() as buf:
            with pytest.raises(RuntimeError):
                with obs.span("boom"):
                    raise RuntimeError("solver exploded")
            with obs.span("after"):
                pass
        boom, after = buf.events()
        assert "solver exploded" in boom["error"]
        assert after["parent"] is None  # contextvar fully unwound

    def test_capture_restores_enabled_state(self):
        assert not obs.enabled()
        with obs.capture():
            assert obs.enabled()
            with obs.capture():    # nested: inner exit must not disable
                pass
            assert obs.enabled()
        assert not obs.enabled()

    def test_broken_sink_warns_and_event_survives(self):
        def bad(evt):
            raise RuntimeError("sink down")
        with obs.capture() as buf:
            obs.add_sink(bad)
            try:
                with pytest.warns(RuntimeWarning, match="sink"):
                    obs.event("submit", rid=1)
            finally:
                obs.remove_sink(bad)
        assert [e["kind"] for e in buf.events()] == ["submit"]

    def test_event_buffer_is_a_ring(self):
        buf = obs.EventBuffer(maxlen=3)
        for i in range(5):
            buf({"kind": "e", "i": i})
        assert [e["i"] for e in buf.events()] == [2, 3, 4]
        buf.clear()
        assert len(buf) == 0


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

class TestExport:
    EVENTS = [
        {"t": 10.0, "kind": "span", "name": "solve", "dur_s": 0.5,
         "span": 1, "parent": None, "pid": 7, "tid": 9, "mode": 0,
         "solver": "eig"},
        {"t": 12.0, "kind": "wave", "wall_s": 2.0, "bucket": "16x16x16",
         "n": 4},
        {"t": 13.0, "kind": "submit", "rid": 3},
    ]

    def test_to_chrome_phases(self):
        doc = export_mod.to_chrome(self.EVENTS)
        assert doc["displayTimeUnit"] == "ms"
        sp, wave, sub = doc["traceEvents"]
        assert sp == {"name": "solve", "cat": "atucker", "ph": "X",
                      "ts": 10.0e6, "dur": 0.5e6, "pid": 7, "tid": 9,
                      "args": {"span": 1, "parent": None, "mode": 0,
                               "solver": "eig"}}
        # wave slices are rewound by wall_s so they sit where work ran
        assert wave["ph"] == "X" and wave["ts"] == 10.0e6 \
            and wave["dur"] == 2.0e6 and wave["name"] == "wave 16x16x16"
        assert sub["ph"] == "i" and sub["cat"] == "serve"

    def test_chrome_document_equals_the_reference(self):
        import repro.obs.export as R_export
        assert export_mod.to_chrome(self.EVENTS) == \
            R_export.to_chrome(self.EVENTS)

    def test_jsonl_round_trip_with_repr_fallback(self, tmp_path):
        events = [*self.EVENTS,
                  {"t": 14.0, "kind": "done", "shape": (16, 16)}]
        path = tmp_path / "ev.jsonl"
        assert export_mod.write_jsonl(events, path) == 4
        path.write_text(path.read_text() + "not json\n\n")
        back = export_mod.read_jsonl(path)
        assert len(back) == 4  # malformed + blank lines skipped
        assert back[0]["name"] == "solve"
        assert back[3]["shape"] == [16, 16] or \
            isinstance(back[3]["shape"], str)

    def test_chrome_args_jsonable(self):
        doc = export_mod.to_chrome(
            [{"t": 1.0, "kind": "span", "name": "s", "dur_s": 0.1,
              "weird": object()}])
        json.dumps(doc)  # must not raise


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_counter_gauge_histogram_render(self):
        reg = obs_metrics.MetricsRegistry()
        c = reg.counter("atucker_requests_total", "requests")
        c.inc(service="t")
        c.inc(2, service="t")
        with pytest.raises(ValueError):
            c.inc(-1, service="t")
        g = reg.gauge("atucker_queue_depth")
        g.set(5, bucket="a")
        g.inc(bucket="a")
        h = reg.histogram("atucker_latency_s", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v, arm="svc")
        text = reg.render()
        assert "# TYPE atucker_requests_total counter" in text
        assert 'atucker_requests_total{service="t"} 3' in text
        assert 'atucker_queue_depth{bucket="a"} 6' in text
        assert '# TYPE atucker_latency_s histogram' in text
        assert 'atucker_latency_s_bucket{arm="svc",le="0.1"} 1' in text
        assert 'atucker_latency_s_bucket{arm="svc",le="1"} 2' in text
        assert 'atucker_latency_s_bucket{arm="svc",le="+Inf"} 3' in text
        assert 'atucker_latency_s_count{arm="svc"} 3' in text

    def test_registry_idempotent_and_type_guarded(self):
        reg = obs_metrics.MetricsRegistry()
        assert reg.counter("a") is reg.counter("a")
        with pytest.raises(ValueError):
            reg.gauge("a")

    def test_quantile_from_histogram(self):
        reg = obs_metrics.MetricsRegistry()
        h = reg.histogram("lat", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 1.6, 3.0):
            h.observe(v)
        q = obs_metrics.quantile_from_histogram(h, 50.0)
        assert 1.0 <= q <= 2.0

    def test_absorb_service_stats_renders_as_the_reference(self):
        # a service's stats() snapshot in the reference's schema (the
        # port's service comes later): both registries render it alike
        from repro.obs import metrics as R_metrics
        lat = {"p50_ms": 1.0, "p95_ms": 2.0, "p99_ms": 3.0}
        stats = {"submitted": 1, "requests": 1, "rejected": 0, "failed": 0,
                 "batches": 1, "plans_built": 1, "pending": 0,
                 "throughput_rps": 5.0, "pad_waste": 0.25, "latency": lat,
                 "buckets": {"8x8x8": {
                     "completed": 1, "waves": 1, "queue_depth": 0,
                     "pad_waste": 0.25, "occupancy": 0.5,
                     "pipeline_occupancy": 0.5, "latency": lat,
                     "solvers": {"eig": 1}}}}
        reg, ref = obs_metrics.MetricsRegistry(), R_metrics.MetricsRegistry()
        obs_metrics.absorb_service_stats(stats, reg)
        R_metrics.absorb_service_stats(stats, ref)
        text = reg.render()
        assert text == ref.render()
        assert 'atucker_serve_submitted{service="tucker"} 1' in text
        assert "atucker_bucket_completed" in text


# ---------------------------------------------------------------------------
# drift monitor
# ---------------------------------------------------------------------------

class TestDrift:
    def test_centered_cell_is_not_stale(self):
        m = DriftMonitor(min_samples=5)
        rng = np.random.default_rng(0)
        for _ in range(50):
            actual = 0.01 * float(np.exp(rng.normal(0.0, 0.05)))
            m.observe(platform="cpu", backend="matfree", solver="eig",
                      predicted_s=0.01, actual_s=actual)
        rep = m.report()
        assert len(rep["cells"]) == 1
        assert not rep["cells"][0]["stale"]
        assert rep["recommendations"] == []

    def test_consistent_drift_is_stale_with_tune_recommendation(self):
        m = DriftMonitor(min_samples=5)
        rng = np.random.default_rng(1)
        for _ in range(20):   # ~3x slower than predicted, modest noise
            actual = 0.03 * float(np.exp(rng.normal(0.0, 0.1)))
            m.observe(platform="cuda", backend="hopper", solver="eig",
                      predicted_s=0.01, actual_s=actual)
        rep = m.report()
        (cell,) = rep["cells"]
        assert cell["stale"] and cell["ratio"] == pytest.approx(3.0, rel=0.3)
        cmds = [r["command"] for r in rep["recommendations"]]
        assert any(f"{drift_mod.TUNE_CLI} calibrate --platform cuda "
                   "--backend hopper" in c for c in cmds)
        assert any(f"{drift_mod.TUNE_CLI} train" in c for c in cmds)

    def test_small_consistent_bias_tolerated(self):
        # hugely significant z but inside the tolerance band: not stale
        m = DriftMonitor(min_samples=5, tolerance=1.5)
        rng = np.random.default_rng(2)
        for _ in range(100):
            actual = 0.012 * float(np.exp(rng.normal(0.0, 0.01)))
            m.observe(platform="cpu", backend="matfree", solver="eig",
                      predicted_s=0.01, actual_s=actual)
        (cell,) = m.report()["cells"]
        assert abs(cell["z"]) > m.z_threshold
        assert not cell["stale"]

    def test_nonpositive_pairs_ignored_and_z_clamped(self):
        m = DriftMonitor()
        m.observe(platform="cpu", backend="matfree", solver="eig",
                  predicted_s=0.0, actual_s=1.0)
        m.observe(platform="cpu", backend="matfree", solver="eig",
                  predicted_s=1.0, actual_s=0.0)
        assert m.report()["cells"] == []
        for _ in range(10):  # identical ratios: zero variance, clamped z
            m.observe(platform="cpu", backend="matfree", solver="eig",
                      predicted_s=0.01, actual_s=0.1)
        (cell,) = m.report()["cells"]
        assert cell["z"] == 99.0 and cell["stale"]

    def test_observe_traces_skips_cached_steps(self):
        class T:
            def __init__(self, s):
                self.method, self.predicted_s, self.seconds = "eig", 0.01, s
        m = DriftMonitor()
        n = m.observe_traces([T(0.02), T(0.0)], platform="cpu",
                             backend="matfree")
        assert n == 1

    def test_memory_drift_recommendation(self):
        m = DriftMonitor(tolerance=1.5)
        m.observe_memory(backend="matfree", modeled_bytes=100,
                         observed_bytes=400)
        rep = m.report()
        assert rep["memory"]["matfree"]["ratio"] == pytest.approx(4.0)
        assert any(r["cell"][0] == "memory"
                   for r in rep["recommendations"])

    def test_summary_shape(self):
        m = DriftMonitor()
        m.observe(platform="cpu", backend="matfree", solver="eig",
                  predicted_s=0.01, actual_s=0.02)
        s = m.summary()
        assert s["cells"] == 1 and s["observations"] == 1
        assert s["stale"] == []

    def test_memory_watch_sees_allocations(self):
        with MemoryWatch("cpu", interval_s=0.001) as mw:
            base = mw.high_water
            arrs = [torch.zeros((128, 128)) for _ in range(4)]
            time.sleep(0.05)
        assert mw.high_water >= base + 4 * 128 * 128 * 4
        del arrs

    def test_memory_watch_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is available here: the default device works")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MemoryWatch()


class TestMiscalibratedCostModel:
    def test_execute_flags_bogus_calibration(self):
        """An absurd calibrated CostModel (1 second per FLOP) stamps absurd
        predicted_s on the plan; a handful of recorded executes must flag
        the (cpu, matfree, eig) cell stale and recommend a recalibration."""
        class BogusSelector:
            cost_model = CostModel(eig_scale=1.0, source="calibrated")

        drift_mod.MONITOR.reset()
        try:
            cfg = TuckerConfig(ranks=RANKS, methods="eig")
            p = make_plan(SHAPE, "float32", cfg, selector=BogusSelector(),
                          device="cpu")
            assert p.total_predicted_s > 1e3   # absurd by construction
            x = _x()
            for _ in range(drift_mod.MONITOR.min_samples):
                p.execute(x, record=True)
            rep = drift_mod.MONITOR.report()
            stale = {(c["platform"], c["backend"], c["solver"])
                     for c in rep["stale"]}
            assert ("cpu", "matfree", "eig") in stale
            assert any("calibrate" in r["command"]
                       for r in rep["recommendations"])
            (cell,) = [c for c in rep["cells"] if c["solver"] == "eig"]
            assert cell["ratio"] < 1e-3   # wildly over-predicted
            assert cell["sources"].get("execute", 0) >= \
                drift_mod.MONITOR.min_samples
        finally:
            drift_mod.MONITOR.reset()


# ---------------------------------------------------------------------------
# core instrumentation
# ---------------------------------------------------------------------------

class TestCoreSpans:
    def test_plan_and_execute_spans(self):
        cfg = TuckerConfig(ranks=RANKS, methods="eig")
        x = _x()
        with obs.capture() as buf:
            A.clear_sweep_cache()
            p = make_plan(SHAPE, "float32", cfg, device="cpu")
            p.execute(x)
            p.execute(x)
        spans = {e["name"]: e for e in obs.iter_spans(buf.events())}
        assert {"plan", "compile", "execute"} <= spans.keys()
        assert spans["plan"]["n_steps"] == 3
        assert spans["plan"]["backend"] == "matfree"
        assert spans["execute"]["shape"] == list(SHAPE)
        assert spans["compile"]["captured"] is False   # the CPU's sweep
        cache = [e for e in buf.events() if e["kind"] == "cache"]
        assert [e["status"] for e in cache] == ["miss"]

    def test_recorded_execute_emits_solve_spans_with_attrs(self):
        cfg = TuckerConfig(ranks=RANKS, methods="eig")
        p = make_plan(SHAPE, "float32", cfg, device="cpu")
        with obs.capture() as buf:
            p.execute(_x(), record=True)
        solves = [e for e in obs.iter_spans(buf.events())
                  if e["name"] == "solve"]
        assert [e["mode"] for e in solves] == [0, 1, 2]
        for e in solves:
            assert e["solver"] == "eig" and e["backend"] == "matfree"
            assert e["rank"] == 4 and e["dur_s"] > 0.0
            assert e["platform"] == "cpu"

    def test_adaptive_execute_emits_sketch_spans(self):
        cfg = TuckerConfig(error_target=0.5)
        p = make_plan(SHAPE, "float32", cfg, device="cpu")
        with obs.capture() as buf:
            p.execute(_x())
        sketches = [e for e in obs.iter_spans(buf.events())
                    if e["name"] == "sketch"]
        assert len(sketches) == 3
        for e in sketches:
            assert e["solver"] == "rand" and e["rank"] >= 1
            assert 0.0 <= e["tail_err"] <= 1.0

    def test_opt_search_is_spanned(self):
        with obs.capture() as buf:
            make_plan(SHAPE, "float32",
                      TuckerConfig(ranks=RANKS, mode_order="opt"),
                      device="cpu")
        (dp,) = [e for e in obs.iter_spans(buf.events())
                 if e["name"] == "plan.dp_search"]
        assert sorted(dp["order"]) == [0, 1, 2] and dp["n_states"] > 0


def _names(events):
    return [(e["kind"], e.get("name")) for e in events]


#: (config, execute kwargs): a fixed-rank plan in the natural order, one
#: searched under mode_order="opt", a recorded execute, and an adaptive
#: plan whose refinement plans and executes again inside its execute
PARITY = [
    (dict(ranks=RANKS, methods="eig"), {}),
    (dict(ranks=RANKS, mode_order="opt"), {}),
    (dict(ranks=RANKS, methods="eig"), dict(record=True)),
    (dict(error_target=0.5), {}),
]


@pytest.mark.parametrize("cfg,kw", PARITY)
def test_span_and_event_names_equal_the_reference(cfg, kw):
    """The same plan → execute → execute in each package, obs enabled,
    fresh sweep caches: the same (kind, name) sequence, including the cache
    miss and the first run's compile span."""
    x = _x(seed=3)
    with R_obs.capture() as rbuf:
        R_api.clear_sweep_cache()
        rp = R_api.plan(SHAPE, jnp.float32, R_api.TuckerConfig(**cfg))
        rp.execute(jnp.asarray(x), **kw)
        rp.execute(jnp.asarray(x), **kw)
    with obs.capture() as buf:
        A.clear_sweep_cache()
        p = make_plan(SHAPE, "float32", TuckerConfig(**cfg), device="cpu")
        p.execute(x, **kw)
        p.execute(x, **kw)
    want = _names(rbuf.events())
    assert ("span", "plan") in want and ("span", "execute") in want
    assert _names(buf.events()) == want


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

class TestCli:
    def _events_file(self, tmp_path):
        events = [
            {"t": 1.0 + i, "kind": "span", "name": "solve", "dur_s": 0.03,
             "mode": i % 3, "solver": "eig", "backend": "matfree",
             "platform": "cpu", "predicted_s": 0.01}
            for i in range(6)
        ]
        events.append({"t": 9.0, "kind": "submit", "rid": 1})
        path = tmp_path / "events.jsonl"
        export_mod.write_jsonl(events, path)
        return path

    def test_report_from_events_json(self, tmp_path, capsys):
        path = self._events_file(tmp_path)
        assert obs_cli(["report", str(path), "--json"]) == 0
        out = capsys.readouterr().out
        rep = json.loads(out[out.index("{"):])
        (cell,) = rep["cells"]
        assert (cell["platform"], cell["backend"], cell["solver"]) == \
            ("cpu", "matfree", "eig")
        assert cell["n"] == 6 and cell["stale"]
        assert rep["recommendations"]

    def test_report_text_flags_stale(self, tmp_path, capsys):
        path = self._events_file(tmp_path)
        assert obs_cli(["report", str(path)]) == 0
        out = capsys.readouterr().out
        assert "STALE" in out and "tune calibrate" in out

    def test_export_to_chrome(self, tmp_path, capsys):
        path = self._events_file(tmp_path)
        to = tmp_path / "trace.json"
        assert obs_cli(["export", str(path), "--to", str(to)]) == 0
        doc = json.loads(to.read_text())
        assert len(doc["traceEvents"]) == 7
        assert {e["ph"] for e in doc["traceEvents"]} == {"X", "i"}

    def test_probe_report_on_the_cpu(self, capsys):
        drift_mod.MONITOR.reset()
        try:
            assert obs_cli(["report", "--device", "cpu", "--json"]) == 0
        finally:
            drift_mod.MONITOR.reset()
        out = capsys.readouterr().out
        rep = json.loads(out[out.index("{"):])
        assert rep["cells"] and all(c["platform"] == "cpu"
                                    for c in rep["cells"])
