"""The readings that a cell's limits are set from, in one process on the card.

    python3 bench/control.py --workload <name> --program-seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2 [--out readings.jsonl]

For each program seed: one run of the cell as ``bench/run.py`` makes it
(at the cell's own sizes and load, with a short window), and its compared
numbers: the lower readings.  For each control seed: the control, the
plain reference computed with TF32 products (the precision below the
float32 the configurations state), put in the program's place on every
input a run of that seed judges, and judged against the float64 reference
by the same comparison: the upper readings.  The benchmark's own runs
never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import reference  # noqa: E402
from bench.manifest import Manifest  # noqa: E402

#: the control's precision: float32 data, TF32 products
CONTROL = dict(dtype="float32", tf32=True)


def control_readings(m: Manifest, workload: str, seed: int, device="cuda",
                     *, config: dict | None = None,
                     traffic: dict | None = None) -> dict:
    """The largest ``subspace`` and ``recon`` gaps of the control over the
    inputs a run of ``seed`` judges."""
    import torch
    w = m.workload(workload)
    cfg = config if config is not None else m.config(w["config"])
    tr = traffic if traffic is not None else m.traffic(w["traffic"])
    drv = m.driver(tr["driver"])
    out = {"subspace": 0.0, "recon": 0.0}
    for x, order in drv.judged_inputs(cfg, tr, seed, device):
        truth = reference.sthosvd(x, cfg["ranks"], order)
        ctl = reference.sthosvd(x, cfg["ranks"], order, tf32=CONTROL["tf32"],
                                dtype=getattr(torch, CONTROL["dtype"]),
                                seed=1)
        g = reference.gaps(*ctl, *truth)
        for k in out:
            out[k] = max(out[k], g[k])
        del x, truth, ctl
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    from bench import run as harness
    m = Manifest(ROOT)
    sink = open(args.out, "a") if args.out else None
    try:
        def emit(row):
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()

        for s in [int(v) for v in args.program_seeds.split(",") if v]:
            t = time.perf_counter()
            r = harness.run_cell(m, args.workload, s, args.seconds, False,
                                 t0=t)
            emit(dict(workload=args.workload, side="program", seed=s,
                      correct=r["correct"], checks=r["checks"],
                      metrics=r["metrics"], info=r["info"],
                      seconds=time.perf_counter() - t))
        for s in [int(v) for v in args.control_seeds.split(",") if v]:
            t = time.perf_counter()
            emit(dict(workload=args.workload, side="control", seed=s,
                      readings=control_readings(m, args.workload, s),
                      seconds=time.perf_counter() - t))
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
