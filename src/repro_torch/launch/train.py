"""Training entry point: the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
        [--smoke | --tuned] [--shape train_4k] --steps 100 [--compress] \
        [--microbatch 2] [--lr 3e-4] [--ckpt-dir DIR] [--device cpu]

Runs on ``cuda:0`` and raises without CUDA unless ``--device cpu`` is
given.  ``--compress`` runs the Tucker-compressed step with no process
group on this one process (the reference's ``n_pods = 1`` on one device):
the shared factors, the error feedback and their refresh every 20 steps
run as they would across pods, without the all-reduce.  Checkpoints and
(seed, step)-pure data give an exact resume: a second run with the same
``--ckpt-dir`` continues from its newest checkpoint.
"""

from __future__ import annotations

import argparse

from .. import configs
from ..core.api import resolve_device
from ..data.pipeline import DataConfig, make_source
from ..models import build
from ..models.config import SHAPES, ShapeConfig
from ..optim.adamw import AdamW, cosine_schedule
from ..optim.grad_compress import CompressionConfig
from ..train.train_step import (init_state, make_compressed_train_step,
                                make_train_step)
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="assigned shape id (default: CPU-sized tiny shape)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--tuned", action="store_true",
                    help="use the tuned recipe where defined")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="build/repro_torch/launch_train")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' to run there)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = configs.get_smoke(args.arch)
    elif args.tuned:
        mod = configs._mod(args.arch)
        cfg = getattr(mod, "TUNED", mod.CONFIG)
    else:
        cfg = configs.get(args.arch)
    shape = SHAPES[args.shape] if args.shape else \
        ShapeConfig("cpu_tiny", 128, 8, "train")
    device = resolve_device(args.device)
    print(f"arch={cfg.name} params≈{cfg.param_count():,} "
          f"shape={shape.name} device={device}")

    bundle = build(cfg)
    src = make_source(DataConfig(seed=0), cfg, shape, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.steps // 10, args.steps))
    comp = CompressionConfig() if args.compress else None
    state = init_state(bundle, opt, 0, compression=comp, device=device)
    if comp is not None:
        step = make_compressed_train_step(bundle, opt, comp,
                                          n_micro=args.microbatch)
    else:
        step = make_train_step(bundle, opt, n_micro=args.microbatch)

    tc = TrainerConfig(total_steps=args.steps,
                       ckpt_every=max(20, args.steps // 4),
                       log_every=10, ckpt_dir=args.ckpt_dir,
                       refresh_every=comp.refresh_every if comp else 20)
    hist = Trainer(tc, step, state, src,
                   log_path=f"{args.ckpt_dir}/metrics.jsonl").run()
    print(f"done: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
