"""The port's autotune subsystem (``repro_torch.tune``): measurement store,
harvesting, stratified training, calibration, the (platform, backend)
selector resolution order, the recording hooks of ``execute``, and the
shipped CUDA models — held against the reference's ``repro.tune`` on the
CPU.

Parity tolerances: stores, sampled dims/ranks/tensors, trees and harvested
rows are compared exactly (the same numpy streams and the same float64
arithmetic); fitted cost-model constants within 1e-6 relative (both solve
the same least-squares problems with numpy).
"""

import importlib
import json
import shlex
import sys
from dataclasses import asdict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.tune as RT
from repro.core import dtree as R_dtree
from repro_torch.core import api as A
from repro_torch.core import cost_model as cm_mod
from repro_torch.core import selector as sel_mod
from repro_torch.core import solvers as S
from repro_torch.core import (CACHE_STATS, TuckerConfig, clear_sweep_cache,
                              fallback_hops, plan, reset_fallback_hops)
from repro_torch.core.cost_model import CostModel
from repro_torch.core.selector import Selector, default_selector
from repro_torch.obs import drift as drift_mod
from repro_torch.tune import (
    Measurement,
    RecordStore,
    fit_cost_model,
    labeled_examples,
    recording,
    train_stratified,
)
from repro_torch.tune.records import COLLECT, HARVEST
from torch_parity import lowrank

#: the measurement modules (the package attribute ``collect`` is the
#: function, shadowing the submodule)
collect_mod = importlib.import_module("repro_torch.tune.collect")
ref_collect_mod = importlib.import_module("repro.tune.collect")

SHIPPED = Path(sel_mod.__file__).resolve().parent / "models"
CUDA_FILES = ("selector_cuda.json", "selector_cuda_hopper.json",
              "selector_cuda_matfree.json", "cost_cuda_hopper.json",
              "cost_cuda_matfree.json")


def M(i, r, j, method, seconds, *, backend="matfree", platform="cpu",
      device="box", source=COLLECT, dtype="float32", order=3):
    return Measurement(platform=platform, backend=backend, device=device,
                       i_n=i, r_n=r, j_n=j, method=method, seconds=seconds,
                       dtype=dtype, order=order, source=source)


@pytest.fixture
def model_env(tmp_path, monkeypatch):
    """Isolated model dir + empty selector cache (the port's)."""
    monkeypatch.setattr(sel_mod, "_DEFAULT_MODEL_DIR", tmp_path / "models")
    monkeypatch.setattr(sel_mod, "_DEFAULT_BY_PLATFORM", {})
    return tmp_path


def synthetic_records(*, backend="matfree", platform="cpu", als_faster_above=64,
                      n=40, seed=0, cls=Measurement):
    """Labeled-by-construction records: als wins iff i_n > threshold.
    Seconds are flop-proportional + overhead so calibration fits cleanly."""
    rng = np.random.default_rng(seed)
    out = []
    for i in np.unique(np.geomspace(4, 256, n).astype(int)):
        r = max(1, int(i) // 4)
        j = int(rng.integers(64, 1024))
        slow, fast = 2e-4, 1e-4
        te = slow if i > als_faster_above else fast
        ta = fast if i > als_faster_above else slow
        te += 1e-10 * cm_mod.eig_flops(i, r, j)
        ta += 1e-10 * cm_mod.als_flops(i, r, j)
        for method, t in (("eig", te), ("als", ta)):
            out.append(cls(platform=platform, backend=backend, device="box",
                           i_n=int(i), r_n=r, j_n=j, method=method,
                           seconds=t))
    return out


def x_np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class TestRecordStore:
    def test_roundtrip(self, tmp_path):
        store = RecordStore(tmp_path / "s.jsonl")
        ms = [M(10, 2, 50, "eig", 0.01), M(10, 2, 50, "als", 0.02)]
        assert store.append(ms) == 2
        got = store.load()
        assert got == ms          # frozen dataclass equality
        assert got[0].key() != got[1].key()
        assert got[0].problem_key() == got[1].problem_key()

    def test_dedup_keeps_fastest(self, tmp_path):
        store = RecordStore(tmp_path / "s.jsonl")
        store.append([M(10, 2, 50, "eig", 0.05),
                      M(10, 2, 50, "eig", 0.01),
                      M(10, 2, 50, "eig", 0.03)])
        best = store.dedup()
        assert len(best) == 1
        assert next(iter(best.values())).seconds == 0.01

    def test_digest_stable_under_order_and_duplicates(self, tmp_path):
        a = RecordStore(tmp_path / "a.jsonl")
        b = RecordStore(tmp_path / "b.jsonl")
        m1, m2 = M(10, 2, 50, "eig", 0.01), M(20, 4, 30, "als", 0.02)
        a.append([m1, m2])
        b.append([m2, m1, m1])    # reordered + an exact duplicate
        assert a.digest() == b.digest()
        b.append([M(9, 2, 9, "eig", 0.5)])
        assert a.digest() != b.digest()

    def test_filter_and_merge(self, tmp_path):
        a = RecordStore(tmp_path / "a.jsonl")
        b = RecordStore(tmp_path / "b.jsonl")
        a.append([M(10, 2, 50, "eig", 0.01, backend="matfree"),
                  M(10, 2, 50, "eig", 0.02, backend="explicit")])
        b.append([M(10, 2, 50, "eig", 0.005, backend="matfree"),   # faster
                  M(99, 9, 99, "als", 0.5, backend="matfree")])    # new
        assert len(a.filter(backend="explicit")) == 1
        assert a.merge_from(b) == 2
        assert a.dedup()[M(10, 2, 50, "eig", 0).key()].seconds == 0.005

    def test_partial_tail_line_skipped(self, tmp_path):
        store = RecordStore(tmp_path / "s.jsonl")
        store.append([M(10, 2, 50, "eig", 0.01)])
        with store.path.open("a") as f:
            f.write('{"platform": "cpu", "i_n": 5')   # interrupted append
        assert len(store.load()) == 1

    def test_compact(self, tmp_path):
        store = RecordStore(tmp_path / "s.jsonl")
        store.append([M(10, 2, 50, "eig", 0.05), M(10, 2, 50, "eig", 0.01)])
        digest = store.digest()
        assert store.compact() == 1
        assert len(store) == 1 and store.digest() == digest


class TestLabeling:
    def test_pairing_requires_both_methods(self):
        ms = [M(10, 2, 50, "eig", 0.02), M(10, 2, 50, "als", 0.01),
              M(77, 7, 70, "eig", 0.5)]         # one-sided → unlabeled
        feats, labels, times = labeled_examples(ms)
        assert len(labels) == 1
        assert labels[0] == 1                   # als was faster
        assert tuple(times[0]) == (0.02, 0.01)
        assert feats[0][0] == 10

    def test_best_of_duplicates_labels(self):
        ms = [M(10, 2, 50, "eig", 0.02), M(10, 2, 50, "eig", 0.005),
              M(10, 2, 50, "als", 0.01)]
        _, labels, times = labeled_examples(ms)
        assert labels[0] == 0                   # best eig (0.005) beats als
        assert tuple(times[0]) == (0.005, 0.01)


class TestTrainingAndResolution:
    def test_stratified_training_and_resolution_order(self, model_env):
        store = RecordStore(model_env / "s.jsonl")
        # two backends with INVERTED crossovers — one pooled tree can't
        # serve both, which is exactly why resolution is backend-first
        store.append(synthetic_records(backend="m1", als_faster_above=64))
        store.append(synthetic_records(backend="m2", als_faster_above=-1,
                                       seed=1))   # m2: als always wins
        written = train_stratified(store, platform="cpu")
        names = {p.split("/")[-1] for p in written}
        assert names == {"selector_cpu_m1.json", "selector_cpu_m2.json",
                         "selector_cpu.json"}
        for info in written.values():
            assert info["store_digest"] == store.digest()
            assert info["n_examples"] >= 12
            assert info["devices"] == ["box"]

        sel_mod._DEFAULT_BY_PLATFORM.clear()
        s1 = default_selector("cpu", "m1")
        s2 = default_selector("cpu", "m2")
        assert s1.backend == "m1" and s2.backend == "m2"
        assert s1(i_n=16, r_n=4, j_n=256) == "eig"   # below m1 crossover
        assert s2(i_n=16, r_n=4, j_n=256) == "als"   # m2: als everywhere
        # unknown backend → platform-pooled tree, not the cost model
        pooled = default_selector("cpu", "no_such_backend")
        assert pooled.tree is not None and pooled.backend is None
        # caching is per (platform, backend)
        assert default_selector("cpu", "m1") is s1
        assert s1 is not s2

    def test_resolution_falls_back_to_cost_model(self, model_env):
        sel = default_selector("cpu", "matfree")    # no files at all
        assert sel.tree is None
        assert sel(i_n=30648, r_n=10, j_n=2256) == "als"   # Eq.4/5 fallback
        # the same holds for cuda when its model dir holds no model
        assert default_selector("cuda", "hopper").tree is None

    def test_trained_model_prices_plans(self, model_env):
        """A trained+calibrated model makes plan schedules carry
        predicted_s, and traces expose predicted-vs-actual."""
        store = RecordStore(model_env / "s.jsonl")
        store.append(synthetic_records())
        train_stratified(store, platform="cpu")
        sel_mod._DEFAULT_BY_PLATFORM.clear()
        assert default_selector("cpu", "matfree").cost_model.calibrated
        p = plan((24, 16, 12), "float32", TuckerConfig(ranks=(4, 4, 4)),
                 device="cpu")
        assert all(s.predicted_s > 0 for s in p.schedule)
        res = p.execute(torch.zeros((24, 16, 12)))
        assert all(t.predicted_s > 0 for t in res.trace)

    def test_selector_save_without_tree_raises(self, tmp_path):
        with pytest.raises(ValueError, match="no trained tree"):
            Selector(platform="cpu").save(tmp_path / "x.json")

    def test_train_and_save_platform_agreement(self, model_env, monkeypatch):
        """The passed platform labels the model, names the file, and keys
        the cache — regardless of the box it trained on."""
        from repro_torch.tune import train as train_mod

        def fake_collect(**kw):
            rng = np.random.default_rng(0)
            feats = np.stack([sel_mod.extract_features(i, r, j)
                              for i, r, j in rng.integers(2, 500, (60, 3))])
            labels = (feats[:, 0] > 100).astype(int)
            return feats, labels, np.zeros((60, 2))

        monkeypatch.setattr(collect_mod, "collect_samples", fake_collect)
        info = train_mod.train_and_save(platform="gpu")
        assert info["n_train"] > 0
        path = sel_mod.model_path("gpu")
        assert path.exists()
        loaded = Selector.load(path)
        assert loaded.platform == "gpu"
        assert sel_mod._DEFAULT_BY_PLATFORM[("gpu", None)].platform == "gpu"
        # the selector module's shim reaches the same function
        assert sel_mod.train_and_save(platform="gpu2")["n_train"] > 0
        assert sel_mod.model_path("gpu2").exists()

    def test_v1_model_file_still_loads(self, tmp_path):
        from repro_torch.core.dtree import DecisionTree
        t = DecisionTree(max_depth=2).fit(
            np.array([[1.0], [2.0], [3.0], [4.0]] * 5),
            np.array([0, 0, 1, 1] * 5))
        (tmp_path / "old.json").write_text(json.dumps(
            {"platform": "cpu", "tree": t.to_dict(),
             "trained_range": [[1, 1, 1], [9, 9, 9]]}))
        s = Selector.load(tmp_path / "old.json")
        assert s.backend is None and s.tree is not None
        assert s.cost_model.source == "textbook"


class TestHarvest:
    def test_recording_harvests_executed_plans(self, tmp_path, model_env):
        store = RecordStore(tmp_path / "h.jsonl")
        x = x_np((16, 12, 10), 0)
        with recording(store) as sink:
            for methods in ("eig", "als"):
                p = plan(x.shape, "float32",
                         TuckerConfig(ranks=(4, 4, 4), methods=methods),
                         device="cpu")
                res = p.execute(x)          # recording context forces timing
                assert all(t.seconds > 0 for t in res.trace)
            assert len(sink.measurements) == 6
        got = store.load()
        assert len(got) == 6
        assert all(m.source == HARVEST and m.seconds > 0 for m in got)
        assert all(m.platform == "cpu" for m in got)
        # eig+als ran on identical problems → records pair into labeled
        # training examples: the full online flywheel roundtrip
        feats, labels, _ = labeled_examples(got)
        assert len(labels) == 3

    def test_execute_record_matches_unrecorded(self, model_env):
        x = x_np((12, 10, 8), 1)
        cfg = TuckerConfig(ranks=(3, 3, 3), methods="eig")
        p = plan(x.shape, "float32", cfg, device="cpu")
        plain = p.execute(x)
        rec = p.execute(x, record=True)
        assert all(t.seconds > 0 for t in rec.trace)
        assert all(t.seconds == 0 for t in plain.trace)
        np.testing.assert_allclose(np.abs(rec.tucker.core.numpy()),
                                   np.abs(plain.tucker.core.numpy()),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("variant", ["sthosvd", "thosvd", "hooi"])
    def test_record_covers_all_variants(self, variant, model_env):
        x = x_np((10, 9, 8), 2)
        cfg = TuckerConfig(ranks=(3, 3, 3), methods="eig", variant=variant,
                           hooi_iters=1)
        p = plan(x.shape, "float32", cfg, device="cpu")
        res = p.execute(x, record=True)
        plain = p.execute(x)
        assert len(res.trace) == len(p.schedule)
        assert all(t.seconds > 0 for t in res.trace)
        assert float(res.tucker.rel_error(torch.from_numpy(x))) < 1.0
        # the recorded runner computes what the cached sweep computes
        np.testing.assert_allclose(
            float(res.tucker.rel_error(torch.from_numpy(x))),
            float(plain.tucker.rel_error(torch.from_numpy(x))), atol=1e-5)


class TestCalibration:
    def test_fit_recovers_scales_and_constants(self):
        """Synthetic seconds generated FROM the model → fit recovers it."""
        rng = np.random.default_rng(3)
        truth = CostModel(c_eig=40.0, c_inv=2.0, c_qr=1.0,
                          eig_scale=2e-10, als_scale=1e-10,
                          eig_overhead_s=3e-4, als_overhead_s=8e-4,
                          source="calibrated")
        ms = []
        for _ in range(40):
            i = int(rng.integers(8, 300))
            r = max(1, i // 4)
            j = int(rng.integers(64, 4096))
            ms.append(M(i, r, j, "eig",
                        truth.predict_seconds("eig", i, r, j)))
            ms.append(M(i, r, j, "als",
                        truth.predict_seconds("als", i, r, j)))
        cm = fit_cost_model(ms)
        assert cm is not None and cm.calibrated
        assert cm.c_eig == pytest.approx(40.0, rel=0.05)
        assert cm.eig_scale == pytest.approx(2e-10, rel=0.05)
        assert cm.als_overhead_s == pytest.approx(8e-4, rel=0.1)

    def test_calibration_flips_predicted_best(self):
        """Measurements where EIG FLOPs are pathologically slow flip the
        analytic choice at a query the textbook model calls for EIG."""
        q = (6, 5, 30648 * 376)                     # textbook: eig wins big
        assert cm_mod.predicted_best(*q) == "eig"
        ms = []
        rng = np.random.default_rng(4)
        for _ in range(20):
            i = int(rng.integers(4, 64))
            r = max(1, i // 4)
            j = int(rng.integers(1024, 1 << 16))
            # eig FLOPs cost 1000× als FLOPs on this "hardware"
            ms.append(M(i, r, j, "eig", 1e-7 * cm_mod.eig_flops(i, r, j)))
            ms.append(M(i, r, j, "als", 1e-10 * cm_mod.als_flops(i, r, j)))
        cm = fit_cost_model(ms)
        assert cm is not None and cm.calibrated
        assert cm.predicted_best(*q) == "als"

    def test_fit_returns_none_when_starved(self):
        assert fit_cost_model([M(8, 2, 64, "eig", 0.1)]) is None

    def test_out_of_range_guardrail_uses_calibrated_model(self):
        """In-range queries hit the tree; out-of-range queries defer to the
        selector's EMBEDDED calibrated cost model, not the textbook one."""
        from repro_torch.core.dtree import DecisionTree
        feats = np.stack([sel_mod.extract_features(i, 4, 64)
                          for i in range(8, 64)])
        tree = DecisionTree(max_depth=1).fit(feats,
                                             np.zeros(len(feats), int))
        calibrated = CostModel(eig_scale=1e-3, als_scale=1e-12,
                               source="calibrated")   # als wins everywhere
        sel = Selector(tree=tree, platform="cpu", backend="matfree",
                       trained_range=((8, 4, 64), (63, 4, 64)),
                       cost_model=calibrated)
        assert sel(i_n=32, r_n=4, j_n=64) == "eig"          # tree, in range
        q = dict(i_n=6, r_n=5, j_n=30648 * 376)             # out of range
        assert Selector(tree=tree, platform="cpu",
                        trained_range=sel.trained_range)(**q) == "eig"
        assert sel(**q) == "als"                            # calibrated

    def test_calibrate_store_writes_per_backend_files(self, model_env):
        store = RecordStore(model_env / "s.jsonl")
        store.append(synthetic_records(backend="matfree"))
        store.append(synthetic_records(backend="explicit", seed=5))
        from repro_torch.tune import calibrate_store
        written = calibrate_store(store, platform="cpu")
        names = {p.split("/")[-1] for p in written}
        assert names == {"cost_cpu_matfree.json", "cost_cpu_explicit.json"}
        sel_mod._DEFAULT_BY_PLATFORM.clear()
        # no tree model on disk → fallback selector picks up the calibration
        sel = default_selector("cpu", "matfree")
        assert sel.tree is None and sel.cost_model.calibrated
        # --backend restricts the strata
        only = calibrate_store(store, platform="cpu", backends=["explicit"],
                               model_dir=model_env / "one")
        assert [p.split("/")[-1] for p in only] == ["cost_cpu_explicit.json"]


class TestCLI:
    def test_collect_train_report_roundtrip(self, tmp_path, model_env,
                                            capsys):
        from repro_torch.tune.cli import main
        store = str(tmp_path / "cli.jsonl")
        assert main(["collect", "--store", store, "--n-tensors", "4",
                     "--min-dim", "6", "--max-dim", "20", "--reps", "1",
                     "--quiet", "--device", "cpu"]) == 0
        assert main(["harvest", "--store", store, "--smoke",
                     "--device", "cpu"]) == 0
        mdir = str(tmp_path / "m")
        assert main(["train", "--store", store, "--model-dir", mdir,
                     "--min-examples", "6", "--device", "cpu"]) == 0
        sel = Selector.load(next(iter(
            Path(mdir).glob("selector_cpu.json"))))
        assert sel.tree is not None and sel.platform == "cpu"
        assert sel.meta["store_digest"] == RecordStore(store).digest()
        # calibration on timings this small may find no per-FLOP signal:
        # hold the command to a store whose fit is known to succeed
        syn = RecordStore(tmp_path / "syn.jsonl")
        syn.append(synthetic_records())
        assert main(["calibrate", "--store", str(syn.path), "--model-dir",
                     mdir, "--device", "cpu"]) == 0
        assert (Path(mdir) / "cost_cpu_matfree.json").exists()
        assert main(["report", "--store", store, "--model-dir", mdir,
                     "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "selector_cpu.json" in out
        assert "cost_cpu_matfree.json" in out

    @pytest.mark.parametrize("argv", [
        "collect --smoke", "harvest --smoke", "train", "calibrate",
        "report"])
    def test_without_device_cpu_needs_the_card(self, argv, tmp_path):
        """The default device is cuda:0: with no card each command raises
        rather than running on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        from repro_torch.tune.cli import main
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv.split() + ["--store", str(tmp_path / "s.jsonl")])
        assert not (tmp_path / "s.jsonl").exists()

    def test_drift_recommendations_parse(self):
        """Every repair command the drift monitor recommends is a command
        this CLI parses (a cuda cell and a cpu cell)."""
        from repro_torch.tune.cli import build_parser
        m = drift_mod.DriftMonitor(min_samples=5)
        rng = np.random.default_rng(1)
        for platform, backend in (("cuda", "hopper"), ("cpu", "matfree")):
            for _ in range(20):
                m.observe(platform=platform, backend=backend, solver="eig",
                          predicted_s=0.01,
                          actual_s=0.03 * float(np.exp(rng.normal(0, 0.1))))
        cmds = [r["command"] for r in m.report()["recommendations"]]
        assert len(cmds) == 4
        for c in cmds:
            assert c.startswith(drift_mod.TUNE_CLI + " ")
            args = build_parser().parse_args(
                shlex.split(c[len(drift_mod.TUNE_CLI):]))
            assert args.cmd in ("calibrate", "train")
            assert args.platform in ("cuda", "cpu")
            assert args.backend == {"cuda": "hopper",
                                    "cpu": "matfree"}[args.platform]
            assert args.device == ("cpu" if args.platform == "cpu" else None)


class TestParity:
    """The port's tune against the reference's, on the CPU."""

    def test_stores_read_across_packages(self, tmp_path):
        ms = synthetic_records(n=12) + [
            M(30, 3, 40, "rand", 0.002, source=HARVEST, order=4)]
        mine = RecordStore(tmp_path / "port.jsonl")
        mine.append(ms)
        theirs = RT.RecordStore(tmp_path / "ref.jsonl")
        theirs.append(synthetic_records(n=12, cls=RT.Measurement, seed=0) + [
            RT.Measurement(platform="cpu", backend="matfree", device="box",
                           i_n=30, r_n=3, j_n=40, method="rand",
                           seconds=0.002, order=4, source=HARVEST)])
        assert mine.path.read_text() == theirs.path.read_text()
        assert mine.digest() == theirs.digest()
        # each package reads the other's file
        assert RT.RecordStore(mine.path).digest() == mine.digest()
        assert RecordStore(theirs.path).digest() == theirs.digest()
        assert [m.to_dict() for m in RecordStore(theirs.path)] == \
            [asdict(m) | {"v": 1} for m in RT.RecordStore(theirs.path)]

    def test_collect_samples_the_reference_grid(self, monkeypatch):
        """Same seed → the same dims, ranks and tensors as the reference
        (solves stubbed: the timing is not what is compared)."""
        seen, ref_seen = [], []

        def stub(log, pair):
            def time_solver(y, mode, rank, method, **kw):
                if kw["reps"] == 2:   # not the reference's throwaway calls
                    log.append((np.asarray(y).copy(), mode, rank, method))
                return (1.0, None) if pair else 1.0
            return time_solver

        monkeypatch.setattr(collect_mod, "_time_solver", stub(seen, True))
        monkeypatch.setattr(ref_collect_mod, "_time_solver",
                            stub(ref_seen, False))
        kw = dict(n_tensors=6, dim_range=(6, 60), seed=3, orders=(3, 4),
                  max_elements=20000)
        got = collect_mod.collect(device="cpu", reps=2, **kw)
        want = ref_collect_mod.collect(**kw)
        key = lambda m: (m.i_n, m.r_n, m.j_n, m.order, m.method, m.backend)  # noqa: E731
        assert [key(m) for m in got] == [key(m) for m in want]
        assert len(seen) == len(ref_seen) > 0
        for (a, *rest), (b, *ref_rest) in zip(seen, ref_seen):
            np.testing.assert_array_equal(a, b)
            assert rest == ref_rest
        # the rank cap only clamps: the stream (and the dims) stay the same
        capped = collect_mod.collect(device="cpu", max_rank=3, **kw)
        assert [(m.i_n, m.j_n) for m in capped] == \
            [(m.i_n, m.j_n) for m in got]
        assert max(m.r_n for m in capped) <= 3 < max(m.r_n for m in got)

    def test_train_selector_same_tree(self):
        recs = synthetic_records(n=60, seed=7)
        ref_recs = synthetic_records(n=60, seed=7, cls=RT.Measurement)
        f, lab, t = labeled_examples(recs)
        rf, rlab, rt = RT.labeled_examples(ref_recs)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(lab, rlab)
        np.testing.assert_array_equal(t, rt)
        sel, info = sel_mod.train_selector(f, lab, platform="cpu")
        rsel, rinfo = RT.train_selector(rf, rlab, platform="cpu")
        assert sel.tree.to_dict() == rsel.tree.to_dict()
        assert isinstance(rsel.tree, R_dtree.DecisionTree)
        assert info["test_accuracy"] == rinfo["test_accuracy"]
        assert info["cv_accuracy"] == rinfo["cv_accuracy"]
        assert sel.trained_range == rsel.trained_range

    def test_fit_cost_model_same_constants(self):
        recs = synthetic_records(n=50, seed=8)
        ref = RT.fit_cost_model(synthetic_records(n=50, seed=8,
                                                  cls=RT.Measurement))
        got = fit_cost_model(recs)
        for k in ("c_eig", "c_qr", "c_inv", "eig_scale", "als_scale",
                  "eig_overhead_s", "als_overhead_s"):
            assert getattr(got, k) == pytest.approx(getattr(ref, k),
                                                    rel=1e-6, abs=1e-15), k
        assert got.source == ref.source == "calibrated"

    @pytest.mark.parametrize("variant,methods", [
        ("sthosvd", "auto"), ("sthosvd", "als"), ("thosvd", "eig"),
        ("hooi", "eig")])
    def test_harvested_rows_equal(self, variant, methods):
        shape, ranks = (14, 11, 9), (4, 3, 3)
        x = lowrank(shape, ranks, seed=5, noise=0.01)
        cfg = dict(ranks=ranks, variant=variant, methods=methods,
                   hooi_iters=1)
        res = plan(shape, "float32", TuckerConfig(**cfg),
                   device="cpu").execute(x, record=True)
        ref = R.plan(shape, jnp.float32, R.TuckerConfig(**cfg)).execute(
            jnp.asarray(x), record=True)
        drop = ("seconds", "device", "platform")
        got = [{k: v for k, v in m.to_dict().items() if k not in drop}
               for m in collect_mod.harvest_result(res)]
        want = [{k: v for k, v in m.to_dict().items() if k not in drop}
                for m in RT.harvest_result(ref)]
        assert got == want and len(got) == len(res.trace)
        assert all(m.platform == "cpu" for m in collect_mod.harvest_result(
            res))


class TestHooks:
    """``execute`` honours an active ``recording()`` sink."""

    @pytest.mark.parametrize("variant", ["sthosvd", "thosvd", "hooi"])
    def test_recording_takes_the_recorded_runner(self, variant):
        x = x_np((12, 10, 8), 6)
        p = plan(x.shape, "float32", TuckerConfig(
            ranks=(3, 3, 3), methods="als", variant=variant, hooi_iters=1),
            device="cpu")
        clear_sweep_cache()
        with recording() as sink:
            res = p.execute(x)
        assert CACHE_STATS["builds"] == 0     # no cached sweep was run
        assert all(t.seconds > 0 for t in res.trace)
        assert [(m.i_n, m.r_n, m.j_n, m.method, m.backend)
                for m in sink.measurements] == \
            [(s.i_n, s.r_n, s.j_n, s.method, s.backend) for s in p.schedule]
        assert all(m.source == HARVEST for m in sink.measurements)
        # outside the context the cached sweep runs again, untimed
        assert all(t.seconds == 0 for t in p.execute(x).trace)
        assert CACHE_STATS["builds"] == 1

    def test_adaptive_sketch_feeds_the_sink(self):
        x = lowrank((20, 16, 12), (4, 3, 3), seed=7, noise=0.01)
        p = plan(x.shape, "float32", TuckerConfig(
            error_target=0.05, methods="rand"), device="cpu")
        with recording() as sink:
            res = p.execute(x)
        assert [m.method for m in sink.measurements] == ["rand"] * 3
        assert [m.rel_err for m in sink.measurements] == \
            [t.tail_err for t in res.trace]
        assert [(m.i_n, m.r_n) for m in sink.measurements] == \
            [(t.i_n, t.r_n) for t in res.trace]

    def test_adaptive_refinement_records(self):
        x = lowrank((20, 16, 12), (4, 3, 3), seed=7, noise=0.01)
        p = plan(x.shape, "float32", TuckerConfig(
            error_target=0.05, methods="eig"), device="cpu")
        with recording() as sink:
            res = p.execute(x)
        # the refinement plan ran the recorded runner under the same sink
        assert [m.method for m in sink.measurements] == ["eig"] * 3
        assert [m.r_n for m in sink.measurements] == \
            [t.r_n for t in res.trace]
        assert all(t.seconds > 0 for t in res.trace)

    def test_fallback_hop_records_the_degraded_plan(self, monkeypatch):
        reset_fallback_hops()
        x = lowrank((12, 10, 8), (3, 3, 3), seed=1, noise=0.01)
        als = S.SOLVERS["als"]
        calls = []

        def failing(*a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise torch.linalg.LinAlgError("failed")
            return als(*a, **kw)

        monkeypatch.setitem(S.SOLVERS, "als", failing)
        p = plan(x.shape, "float32", TuckerConfig(ranks=(3, 3, 3),
                                                  methods="als"),
                 device="cpu")
        try:
            with recording() as sink:
                res = p.execute(x)
            assert fallback_hops() == {("als_to_eig", "matfree"): 1}
        finally:
            reset_fallback_hops()
        assert res.methods == ("eig",) * 3
        assert [m.method for m in sink.measurements] == ["eig"] * 3
        assert all(t.seconds > 0 for t in res.trace)

    def test_no_tune_import_no_cost(self, monkeypatch):
        """Plans that never import the tune subsystem never load it."""
        for name in [k for k in sys.modules
                     if k == "repro_torch.tune"
                     or k.startswith("repro_torch.tune.")]:
            monkeypatch.delitem(sys.modules, name)
        x = x_np((10, 9, 8), 8)
        p = plan(x.shape, "float32", TuckerConfig(ranks=(3, 3, 3)),
                 device="cpu")
        p.execute(x)
        p.execute(x, record=True)
        assert A._active_sink() is None
        assert "repro_torch.tune" not in sys.modules


class TestShippedModels:
    @pytest.mark.parametrize("name", CUDA_FILES)
    def test_cuda_file_loads_and_names_its_card(self, name):
        path = SHIPPED / name
        doc = json.loads(path.read_text())
        if name.startswith("selector"):
            sel = Selector.load(path)
            assert sel.platform == "cuda" and sel.tree is not None
            assert sel.backend == (None if name == "selector_cuda.json"
                                   else name[len("selector_cuda_"):-5])
            meta = sel.meta
        else:
            assert CostModel.from_dict(doc).calibrated
            meta = doc
        assert "H100" in meta["card"]         # nvidia-smi's name, power.limit
        assert meta["card"].endswith(" W")
        assert len(meta["store_digest"]) == 64
        assert all(d.startswith("cuda/") for d in meta["devices"])

    def test_cuda_auto_resolves_to_the_shipped_trees(self, monkeypatch):
        monkeypatch.setattr(sel_mod, "_DEFAULT_BY_PLATFORM", {})
        for backend in ("hopper", "matfree"):
            sel = default_selector("cuda", backend)
            assert sel.tree is not None and sel.backend == backend
            assert sel.cost_model.calibrated
            assert sel.meta["store_digest"] == json.loads(
                (SHIPPED / f"cost_cuda_{backend}.json").read_text()
            )["store_digest"]

    def test_cpu_auto_plans_unchanged(self, monkeypatch):
        """The CPU models still resolve: methods="auto" on the CPU picks
        what the reference picks, with the cuda files beside them."""
        monkeypatch.setattr(sel_mod, "_DEFAULT_BY_PLATFORM", {})
        assert default_selector("cpu", "matfree").meta["platform"] == "cpu"
        for shape, ranks in [((10, 12, 8), (3, 4, 2)),
                             ((300, 40, 30), (8, 6, 5)),
                             ((2000, 12, 10), (5, 4, 4)),
                             ((64, 64, 64, 8), (8, 8, 8, 4))]:
            for impl in ("matfree", "explicit"):
                cfg = dict(ranks=ranks, methods="auto", impl=impl)
                got = plan(shape, "float32", TuckerConfig(**cfg),
                           device="cpu")
                want = R.plan(shape, jnp.float32, R.TuckerConfig(**cfg))
                assert got.methods == want.methods
