"""Multi-pod dry run: trace every (arch × shape) on the production meshes
with nothing allocated, and record its per-device counts and roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # full sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b \\
        --shape train_4k --mesh single --artifacts artifacts/dryrun

The port of ``repro/launch/dryrun.py``, on the CPU with no card.  Where
the reference lowers and compiles on 512 fake XLA devices, this runs each
step once in one process that stands for rank 0 of a fake world (the
``fake`` process-group backend: collectives return at once and move no
data): the parameters, optimizer state, batch and cache are ``meta``
DTensors placed by ``models.shardings``' rules on a ``DeviceMesh`` of the
reference's shape, the model code runs on them as written (DTensor
propagates the shardings and issues the collectives), and
``roofline.op_walk.OpWalk`` counts rank 0's local work.  Artifacts land in
``<artifacts>/<mesh>/<arch>__<shape>.json`` with the reference's keys;
the trace's seconds stand in for ``lower_s``/``compile_s``, and in place of
``memory_analysis`` a cell records the argument bytes a device and the
walker's peak live bytes.  Cells already present are skipped (a resumable
sweep); ``--force`` recomputes.

Everything is ``meta`` by request: the parameters come from
``bundle.abstract_params()`` and the inputs from ``input_specs``; nothing
reaches ``meta`` because CUDA is missing.  On ``meta`` the S6 scan takes
its plain form (its hand kernel needs CUDA).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
from torch import nn

from .. import configs
from ..models import build, input_specs
from ..models import shardings as shardings_mod
from ..models.config import SHAPES
from ..models.convert import leaves, param_tree
from ..models.shardings import (batch_specs, cache_specs_tree, param_specs,
                                to_placements)
from ..optim.adamw import AdamW
from ..roofline.analysis import Roofline, model_flops_for
from ..roofline.op_walk import COLLECTIVES, OpWalk
from .mesh import data_axes, make_production_mesh, placement_mesh

# grad-accumulation chunks per (shape kind); keeps live activations bounded
N_MICRO = {"train": 8, "prefill": 1, "decode": 1}


def fake_world(world_size: int) -> None:
    """Make the default process group a fake world of ``world_size`` ranks
    (this process is rank 0), replacing one made before."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:        # an internal module of torch's tests
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            "(the 'fake' process-group backend), which this torch "
            f"({torch.__version__}) lacks") from e
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _distribute(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, to_placements(spec, mesh))


def _place_params(params: nn.Module, specs: dict, mesh) -> int:
    """Replace every parameter of ``params`` (meta) by a meta DTensor
    placed by its leaf's spec; a per-layer tensor of a stacked leaf takes
    the spec without its layer axis (where the rules put an axis on it,
    that axis replicates the layer).  Returns the local bytes."""
    spec_of = {}
    flat = dict(leaves(specs))
    for path, leaf in leaves(param_tree(params)):
        spec = flat[path]
        for p in (leaf if isinstance(leaf, list) else [leaf]):
            spec_of[id(p)] = spec[1:] if isinstance(leaf, list) else spec
    local = 0
    for mod in params.modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            d = _distribute(p.detach(), mesh, spec_of[id(p)])
            local += d.to_local().numel() * d.element_size()
            mod._parameters[name] = nn.Parameter(d, requires_grad=False)
    return local


def _place_tree(tree: dict, specs, mesh) -> tuple[dict, int]:
    if isinstance(tree, torch.Tensor):
        d = _distribute(tree, mesh, specs)
        return d, d.to_local().numel() * d.element_size()
    out, n = {}, 0
    for k, v in tree.items():
        out[k], b = _place_tree(v, specs[k], mesh)
        n += b
    return out, n


def build_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
               shape_override=None, cfg_override=None):
    """Returns (step, abstract_args, cfg, shape) for one cell: ``step()``
    runs it on ``abstract_args``, meta DTensors on ``mesh`` placed by the
    rules (parameters by ``param_specs`` with ``fsdp_axes`` when
    ``cfg.fsdp`` and ``replicate_names`` when
    ``cfg.moe_capacity_sharding``; batch and cache by ``batch_specs`` and
    ``cache_specs_tree``).  ``abstract_args`` is a dict: ``params`` and,
    by kind, ``opt_state``, ``batch``, ``cache``, ``token``, ``pos``, and
    ``arg_bytes``, their local bytes.  ``smoke=True`` swaps in the reduced
    config (the dry-run-lite path); ``shape_override``/``cfg_override``
    shrink the cell further."""
    cfg = cfg_override or (configs.get_smoke(arch) if smoke
                           else configs.get(arch))
    shape = shape_override or SHAPES[shape_name]
    bundle = build(cfg)
    optimizer = AdamW(lr=1e-4)

    daxes = data_axes(mesh)
    fsdp = daxes if cfg.fsdp else None
    params = bundle.abstract_params()
    repl = (("w_gate", "w_up", "w_down") if cfg.moe_capacity_sharding
            else ())
    pspecs = param_specs(param_tree(params), mesh, fsdp_axes=fsdp,
                         replicate_names=repl)
    pmesh = placement_mesh(mesh)
    arg_bytes = _place_params(params, pspecs, pmesh)
    specs = input_specs(cfg, shape)
    args: dict = {"params": params}

    if shape.kind == "train":
        from ..train.train_step import TrainState, make_train_step
        n_micro = shape.microbatch or N_MICRO["train"]
        if shape.global_batch % n_micro:
            n_micro = 1
        batch, b = _place_tree(specs["batch"],
                               batch_specs(specs["batch"], mesh), pmesh)
        params.requires_grad_(True)
        # the moments mirror the parameters' sharding; the count replicates
        opt_state = optimizer.init(param_tree(params))
        m, bm = _place_tree(opt_state.m, pspecs, pmesh)
        v, bv = _place_tree(opt_state.v, pspecs, pmesh)
        opt_state = opt_state._replace(m=m, v=v)
        arg_bytes += b + bm + bv
        state = TrainState(params, opt_state, 0, None)
        train = make_train_step(bundle, optimizer, n_micro=n_micro)
        args.update(opt_state=opt_state, batch=batch)

        def step():
            return train(state, batch)
    elif shape.kind == "prefill":
        cache, c = _place_tree(specs["cache"],
                               cache_specs_tree(specs["cache"], mesh), pmesh)
        batch, b = _place_tree(specs["batch"],
                               batch_specs(specs["batch"], mesh), pmesh)
        arg_bytes += b + c
        args.update(batch=batch, cache=cache)

        def step():
            with torch.no_grad():
                return bundle.prefill(params, batch, cache)
    else:
        total = shape.seq_len
        cache, c = _place_tree(specs["cache"],
                               cache_specs_tree(specs["cache"], mesh), pmesh)
        token, b = _place_tree(specs["token"],
                               batch_specs(specs["token"], mesh), pmesh)
        pos = specs["pos"]
        arg_bytes += b + c
        args.update(token=token, cache=cache, pos=pos)

        def step():
            with torch.no_grad():
                return bundle.decode(params, token, cache, pos, total)
    args["arg_bytes"] = arg_bytes
    return step, args, cfg, shape


def walk_cell(step, arg_bytes: int = 0) -> tuple[dict, float]:
    """Run ``step()`` once under the walker on the activation mesh, plain
    tensors meeting DTensors taken as replicated; returns (the walker's
    counts, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    with implicit_replication(), OpWalk(track_live=True,
                                        live_base=arg_bytes) as w:
        step()
    return w.result(), time.time() - t0


def tree_param_count(cfg) -> int:
    """The parameter count of the tree ``init`` makes (the reference's
    ``param_count`` takes a gated-gelu MLP as two matrices)."""
    ab = build(cfg).abstract_params()
    return sum(p.numel() for p in ab.parameters())


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             art_dir: Path, *, force: bool = False, verbose: bool = True,
             **build_kw):
    out_path = Path(art_dir) / mesh_name / \
        f"{configs.canonical(arch)}__{shape_name}.json"
    if out_path.exists() and not force:
        if verbose:
            print(f"[dryrun] skip (cached): {arch} × {shape_name} × "
                  f"{mesh_name}")
        return json.loads(out_path.read_text())
    out_path.parent.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    shardings_mod.set_activation_mesh(mesh)
    try:
        step, args, cfg, shape = build_cell(arch, shape_name, mesh,
                                            **build_kw)
        t_build = time.time() - t0
        walked, t_trace = walk_cell(step, args["arg_bytes"])
    finally:
        shardings_mod.set_activation_mesh(None)

    coll = {k: walked[k] for k in COLLECTIVES}
    coll["count"] = walked["coll_count"]
    coll["total"] = walked["coll_total"]
    coll["nvlink"] = walked["coll_nvlink"]
    coll["network"] = walked["coll_network"]
    chips = mesh.size()
    mf = model_flops_for(cfg, shape)
    # the memory term uses ESSENTIAL traffic (what must cross HBM under
    # perfect fusion); the upper bound (every op's I/O) is recorded beside
    roof = Roofline.from_cell(
        arch=configs.canonical(arch), shape=shape_name, mesh_name=mesh_name,
        chips=chips,
        cost={"flops": walked["flops"],
              "bytes accessed": walked["traffic_ess"]},
        collectives=coll, model_flops=mf,
        peak_bytes=float(walked["peak_live"]))
    rec = {
        "arch": configs.canonical(arch), "shape": shape_name,
        "mesh": mesh_name, "chips": chips,
        "build_s": t_build, "trace_s": t_trace,
        "walked": {k: float(v) for k, v in walked.items()},
        "memory": {"argument_bytes": int(args["arg_bytes"]),
                   "peak_live_bytes": int(walked["peak_live"])},
        "collectives": coll,
        "model_flops": mf,
        "param_count": cfg.param_count(),
        "param_count_tree": tree_param_count(cfg),
        "roofline": {
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s, "bottleneck": roof.bottleneck,
            "useful_ratio": roof.useful_ratio,
        },
    }
    out_path.write_text(json.dumps(rec, indent=1))
    if verbose:
        m = rec["roofline"]
        print(f"[dryrun] OK {arch} × {shape_name} × {mesh_name}: "
              f"trace {t_trace:.1f}s, bottleneck={m['bottleneck']}, "
              f"compute={m['compute_s']:.3e}s mem={m['memory_s']:.3e}s "
              f"coll={m['collective_s']:.3e}s useful={m['useful_ratio']:.2f} "
              f"peak={rec['memory']['peak_live_bytes'] / 2**30:.2f}GiB/dev",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--artifacts", default="artifacts/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(configs.ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod16x16", False, 256))
    if args.mesh in ("multi", "both"):
        meshes.append(("pods2x16x16", True, 512))

    art_dir = Path(args.artifacts)
    failures = []
    for mesh_name, multi, world in meshes:
        fake_world(world)
        mesh = make_production_mesh(multi_pod=multi)
        for arch in archs:
            for shape_name in shapes:
                if not configs.supports_shape(arch, shape_name):
                    print(f"[dryrun] SKIP {arch} × {shape_name} "
                          f"(full-attention arch)")
                    continue
                try:
                    run_cell(arch, shape_name, mesh, mesh_name, art_dir,
                             force=args.force)
                except Exception:
                    failures.append((arch, shape_name, mesh_name))
                    print(f"[dryrun] FAIL {arch} × {shape_name} × "
                          f"{mesh_name}")
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells traced")


if __name__ == "__main__":
    main()
