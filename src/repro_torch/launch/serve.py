"""Serving entry point: batched requests through the slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        [--smoke] --requests 6 --max-new 16 [--slots 4] [--max-len 256] \
        [--device cpu]

``--arch`` is any architecture the port has (``repro_torch.configs.PORTED``:
falcon-mamba-7b, gemma2-9b, gemma3-1b, phi3-mini-3.8b, minitron-4b,
granite-moe-3b-a800m, mixtral-8x22b, zamba2-1.2b, internvl2-2b; text
prompts only, as the reference's engine serves them), at its full size
or, with ``--smoke``, its SMOKE preset.  Runs on ``cuda:0`` and
raises without CUDA unless ``--device cpu`` is given.
Weights are random, from ``torch.Generator(device).manual_seed(0)``, or,
with ``--ckpt <dir>``, the parameter tree of that directory's newest
checkpoint (one written by ``Checkpointer.save`` of a parameter tree, by
either package; a Tucker-tier leaf comes back reconstructed).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from .. import configs
from ..core.api import resolve_device
from ..checkpoint.checkpointer import Checkpointer
from ..models import build
from ..models.convert import load_tree, tree_from_params
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir to restore")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    device = resolve_device(args.device)
    bundle = build(cfg)
    params = bundle.init(0, device)
    if args.ckpt:
        if not Path(args.ckpt).is_dir():
            raise FileNotFoundError(f"--ckpt: no checkpoint directory "
                                    f"{args.ckpt!r}")
        restored = Checkpointer(args.ckpt).restore(tree_from_params(params,
                                                                    "cpu"))
        if restored:
            tree, step = restored
            load_tree(params, tree)
            print(f"restored params at step {step}")
    eng = ServeEngine(bundle, params, batch_slots=args.slots,
                      max_len=args.max_len)
    reqs = [Request(prompt=[1 + i, 2, 3, 4 + i], max_new_tokens=args.max_new,
                    rid=i) for i in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = sum(len(r.output) for r in outs)
    print(f"{tok} tokens in {dt:.2f}s ({tok/dt:.1f} tok/s across "
          f"{args.slots} slots on {device})")
    for r in outs:
        print(f"  req {r.rid}: {r.prompt} → {r.output}")
    return outs


if __name__ == "__main__":
    main()
