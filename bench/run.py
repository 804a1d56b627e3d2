"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in
``BENCHMARK.json`` (see ``bench/manifest.py``): its configuration's sizes,
its traffic's driver and parameters, its limits.  The run makes its inputs
on the card from the seed, builds and warms the program (set-up), runs the
driver's window for ``--seconds``, then compares the window's results with
the plain reference (``bench/reference.py``).  It prints each number
compared beside its limit as the last lines of standard error, and one
JSON object as the last line of standard output: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``.

It exits with 2, and prints no result, without enough CUDA devices for the
cell; with 3 if JAX or the JAX package was loaded; with 1 if the program
cannot be imported.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the benchmark's modules are ``bench.*``; its own folder leaves the path
# so that none of them shadows a module of the standard library
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# load from one process with few threads: the host's intra-op pools stay at
# one thread, so they never compete with the program's own threads
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench" / sub)

from bench import isolation  # noqa: E402
from bench.manifest import Manifest  # noqa: E402


#: seconds after which a run is taken to hang (a first run, which builds
#: the kernels, takes about two minutes)
WATCHDOG_S = 600


def _finite(v: float) -> float:
    """A number JSON carries: a value that is not finite reads 1e300, above
    every limit."""
    return float(v) if math.isfinite(v) else 1e300


def run_cell(m: Manifest, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", *, t0: float = T0,
             config: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of ``workload``; returns the result's JSON object.
    ``config`` and ``traffic`` stand in for the cell's own files (the tests
    run the harness at small sizes on the CPU)."""
    import torch
    w = m.workload(workload)
    cfg = config if config is not None else m.config(w["config"])
    tr = traffic if traffic is not None else m.traffic(w["traffic"])
    limits = m.cell(workload)["limits"]
    cuda = torch.device(device).type == "cuda"
    if cuda:    # the configurations state float32 with TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_driver = time.perf_counter()
    out = m.driver(tr["driver"]).run(cfg, tr, seed, seconds, trace, device)
    values = dict(setup_s=out["t_window"] - t0, **out["e2e"])
    metrics = {}
    if not trace:
        for e in m.end_to_end(workload):
            metrics[e["name"]] = dict(value=values[e["name"]], unit=e["unit"])
    else:
        for e in m.per_layer(workload):
            v = m.reader(e["name"])(out["ctx"])
            if v is not None:
                metrics[e["name"]] = dict(value=v, unit=e["unit"])
    checks = {name: dict(value=_finite(out["readings"].get(name, math.inf)),
                         limit=lim) for name, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=w["chips"], memory_peak_bytes=out["memory_peak_bytes"])
    result = dict(correct=correct, attempted=out["attempted"],
                  failed=out["failed"], metrics=metrics, device=dev)
    tr_sum = out["ctx"].get("trace")
    if trace and tr_sum:
        dev.update(busy_s=tr_sum["busy_s"], window_s=tr_sum["window_s"])
        result["breakdown"] = dict(device_ops=tr_sum["device_ops"],
                                   idle_gaps=tr_sum["idle_gaps"])
    result["info"] = dict(out["info"], before_driver_s=t_driver - t0,
                          errors=out["errors"][:5])
    result["checks"] = checks
    return result


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e!r})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run that hangs prints every thread's stack and exits with 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    m = Manifest(ROOT)
    w = m.workload(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401 - the program under test
    except ImportError as e:
        print(f"the program cannot be imported: {e!r}", file=sys.stderr)
        return 1
    result = run_cell(m, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    result["card"] = power_limit()
    result["checks"] = result.pop("checks")   # the last key of the line
    bad = isolation.forbidden()
    if bad:
        print(f"modules that a run must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
