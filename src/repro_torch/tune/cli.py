"""``python -m repro_torch.tune`` — the autotune flywheel CLI.

    collect    sample EIG-vs-ALS timings offline into the measurement store
    harvest    execute demo plans with record=True and harvest their traces
               (the online path, runnable standalone for smoke/CI)
    train      (platform, backend)-stratified trees → versioned model files
    calibrate  fit Eq. 4/5 constants per backend from the same store
    report     store statistics + model inventory with embedded metadata

Every command runs on ``--device`` (default ``cuda:0``, raising when CUDA
is not available; ``--device cpu`` runs on the CPU), and ``--platform``
defaults to that device's type.

Typical flywheel:  collect/harvest → train (+calibrate) → plans pick the
trained model up through ``default_selector`` automatically.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .records import RecordStore, default_store_path


def _store(args) -> RecordStore:
    return RecordStore(args.store)


def _backends(args) -> list[str] | None:
    return None if args.backend is None else [args.backend]


def cmd_collect(args) -> int:
    from .collect import SMOKE, collect_into
    kw = dict(SMOKE) if args.smoke else dict(
        n_tensors=args.n_tensors, dim_range=(args.min_dim, args.max_dim),
        backends=tuple(args.backends.split(",")),
        orders=tuple(int(o) for o in args.orders.split(",")),
        reps=args.reps)
    kw.update(seed=args.seed, verbose=not args.quiet, device=args.device)
    n = collect_into(_store(args), **kw)
    print(f"collected {n} records into {args.store}")
    return 0


def cmd_harvest(args) -> int:
    """Run a few planned decompositions with record=True on ``--device``
    and harvest the timed traces — exercises the online path end to end
    (and doubles as a cheap store seeder: both fixed-eig and fixed-als
    plans run, so the harvested records pair into labeled examples)."""
    import numpy as np

    from ..core.api import TuckerConfig, plan
    from .collect import recording

    rng = np.random.default_rng(args.seed)
    store = _store(args)
    shapes = [(24, 18, 12), (40, 10, 8)] if args.smoke else \
        [(48, 36, 24), (96, 16, 12), (20, 20, 20, 8)]
    with recording(store) as sink:
        for shape in shapes:
            ranks = tuple(max(2, s // 4) for s in shape)
            x = rng.standard_normal(shape).astype(np.float32)
            for methods in ("eig", "als"):
                p = plan(shape, "float32", TuckerConfig(ranks=ranks,
                                                        methods=methods),
                         device=args.device)
                p.execute(x, record=True)
        n = len(sink.measurements)
    print(f"harvested {n} records into {args.store}")
    return 0


def cmd_train(args) -> int:
    from .train import train_stratified
    written = train_stratified(
        _store(args), platform=args.platform, backends=_backends(args),
        model_dir=args.model_dir, min_examples=args.min_examples,
        seed=args.seed, calibrate=not args.no_calibrate)
    if not written:
        print("no stratum had enough labeled examples; collect more "
              f"records (need >= {args.min_examples} eig/als pairs)")
        return 1
    for path, info in written.items():
        print(f"wrote {path}: backend={info['backend']} "
              f"n={info['n_examples']} cv={info['cv_accuracy']:.3f} "
              f"test={info['test_accuracy']}")
    return 0


def cmd_calibrate(args) -> int:
    from .calibrate import calibrate_store
    written = calibrate_store(_store(args), platform=args.platform,
                              backends=_backends(args),
                              model_dir=args.model_dir)
    if not written:
        print("no stratum had enough records to calibrate")
        return 1
    for path, doc in written.items():
        print(f"wrote {path}: c_eig={doc['c_eig']:.2f} "
              f"c_qr={doc['c_qr']:.2f} c_inv={doc['c_inv']:.2f} "
              f"eig_scale={doc['eig_scale']:.3g} "
              f"als_scale={doc['als_scale']:.3g}")
    return 0


def cmd_report(args) -> int:
    from ..core.selector import model_dir as default_model_dir
    store = _store(args)
    print(json.dumps(store.stats(), indent=2))
    mdir = Path(args.model_dir) if args.model_dir else default_model_dir()
    models = sorted(mdir.glob("selector_*.json")) + \
        sorted(mdir.glob("cost_*.json")) if mdir.exists() else []
    if not models:
        print(f"no model files under {mdir}")
        return 0
    print(f"\nmodels under {mdir}:")
    for p in models:
        d = json.loads(p.read_text())
        meta = d.get("meta", d)
        brief = {k: meta[k] for k in ("platform", "backend", "n_examples",
                                      "cv_accuracy", "test_accuracy",
                                      "store_digest", "trained_at", "c_eig",
                                      "source", "card") if k in meta}
        if "store_digest" in brief:
            brief["store_digest"] = brief["store_digest"][:12]
        print(f"  {p.name}: {json.dumps(brief)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="a-Tucker autotune flywheel (measurement store → "
                    "selector training → calibrated cost model)")
    shared = argparse.ArgumentParser(add_help=False)
    shared.add_argument("--store", default=str(default_store_path()),
                        help="measurement store JSONL path (default: "
                             "$ATUCKER_TUNE_STORE or ./tune_store.jsonl)")
    shared.add_argument("--device", default=None,
                        help="device to measure and plan on (default "
                             "cuda:0, raising without CUDA; 'cpu' runs on "
                             "the CPU)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("collect", parents=[shared],
                       help="offline EIG-vs-ALS sampling")
    c.add_argument("--smoke", action="store_true",
                   help="tiny CI preset (8 tensors, matfree only)")
    c.add_argument("--n-tensors", type=int, default=120)
    c.add_argument("--min-dim", type=int, default=10)
    c.add_argument("--max-dim", type=int, default=192)
    c.add_argument("--backends", default="matfree",
                   help="comma-separated ops backends to sample through")
    c.add_argument("--orders", default="3",
                   help="comma-separated tensor orders to rotate through")
    c.add_argument("--reps", type=int, default=2)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--quiet", action="store_true")
    c.set_defaults(fn=cmd_collect)

    h = sub.add_parser("harvest", parents=[shared],
                       help="run demo plans with record=True → store")
    h.add_argument("--smoke", action="store_true", help="smaller shapes")
    h.add_argument("--seed", type=int, default=0)
    h.set_defaults(fn=cmd_harvest)

    t = sub.add_parser("train", parents=[shared],
                       help="stratified trees → model files")
    t.add_argument("--platform", default=None,
                   help="platform slice to train (default: the device's "
                        "type)")
    t.add_argument("--backend", default=None,
                   help="train this backend's tree only (and the pooled "
                        "one)")
    t.add_argument("--model-dir", default=None,
                   help="write models here instead of the default model dir")
    t.add_argument("--min-examples", type=int, default=12)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--no-calibrate", action="store_true",
                   help="skip embedding fitted cost-model constants")
    t.set_defaults(fn=cmd_train)

    k = sub.add_parser("calibrate", parents=[shared],
                       help="fit Eq.4/5 constants per backend")
    k.add_argument("--platform", default=None)
    k.add_argument("--backend", default=None,
                   help="calibrate this backend only")
    k.add_argument("--model-dir", default=None)
    k.set_defaults(fn=cmd_calibrate)

    r = sub.add_parser("report", parents=[shared],
                       help="store stats + model inventory")
    r.add_argument("--model-dir", default=None)
    r.set_defaults(fn=cmd_report)
    return ap


def main(argv=None) -> int:
    from ..core.api import resolve_device
    args = build_parser().parse_args(argv)
    # every command names its device up front: without CUDA the default
    # raises here instead of measuring, planning or training elsewhere
    args.device = resolve_device(args.device)
    if hasattr(args, "platform") and args.platform is None:
        args.platform = args.device.type
    return args.fn(args)
