"""Three-term roofline from the dry run's per-device counts.

The port of ``repro/roofline/analysis.py``, with the H100 figures of
``repro_torch.launch.mesh`` in place of the TPU v5e's:

  compute    = flops / 989 TFLOP/s (bf16 dense, SXM)
  memory     = essential bytes / 3.35 TB/s (HBM3, SXM)
  collective = Σ collective bytes / the slowest link each group crosses
               (NVLink 450 GB/s within an 8-GPU node, NDR 50 GB/s across)

The counts are one device's (``op_walk.OpWalk`` counts local shards), so
each term is one device's over one device's peak.  The reference parses
its collective bytes from HLO text (``collective_bytes_from_hlo``); here
the walker counts them as the program issues them, so that role is the
walker's ``collectives`` (with ``coll_nvlink``/``coll_network`` splitting
them by link).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from ..launch.mesh import HBM_BW, NETWORK_BW, NVLINK_BW, PEAK_FLOPS_BF16

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")


def collective_seconds(collectives: dict) -> float:
    """Seconds of one device's collective bytes at the links they cross:
    ``coll_nvlink`` at NVLink's rate, ``coll_network`` at the network's,
    and without that split ``total`` at the network's (the slowest)."""
    if "nvlink" in collectives or "network" in collectives:
        return (float(collectives.get("nvlink", 0)) / NVLINK_BW
                + float(collectives.get("network", 0)) / NETWORK_BW)
    return float(collectives.get("total", 0)) / NETWORK_BW


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    collective_bytes: float     # per device
    model_flops: float          # 6·N·D (global, useful)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float         # model_flops / (hlo_flops × chips)
    peak_bytes_per_device: float = 0.0

    @classmethod
    def from_cell(cls, *, arch, shape, mesh_name, chips, cost, collectives,
                  model_flops, peak_bytes=0.0):
        flops = float(cost.get("flops", 0.0))
        byts = float(cost.get("bytes accessed", 0.0))
        coll = float(collectives.get("total", 0))
        compute_s = flops / PEAK_FLOPS_BF16
        memory_s = byts / HBM_BW
        collective_s = collective_seconds(collectives)
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": collective_s}
        bott = max(terms, key=terms.get)
        useful = model_flops / max(1.0, flops * chips)
        return cls(arch, shape, mesh_name, chips, flops, byts, coll,
                   model_flops, compute_s, memory_s, collective_s, bott,
                   useful, peak_bytes)


def model_flops_for(cfg, shape_cfg) -> float:
    """6·N·D for train (N = active params, D = tokens); decode: 2·N_active
    per generated token + KV-cache read bytes are in the memory term.  N is
    ``cfg.param_count()``, the reference's arithmetic kept as it is (it
    counts a gated-gelu MLP as two matrices, where the tree has three)."""
    n = cfg.param_count()
    if cfg.n_experts:
        gated = 3 if cfg.act == "silu" else 2
        dense_moe = cfg.n_layers * cfg.n_experts * gated * cfg.d_model * cfg.d_ff
        active_moe = dense_moe * cfg.top_k / cfg.n_experts
        n = n - dense_moe + active_moe
    tokens = shape_cfg.global_batch * shape_cfg.seq_len
    if shape_cfg.kind == "train":
        return 6.0 * n * tokens
    if shape_cfg.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape_cfg.global_batch      # decode: one token per seq


def fmt_seconds(s: float) -> str:
    if s < 1e-3:
        return f"{s*1e6:.1f}µs"
    if s < 1:
        return f"{s*1e3:.2f}ms"
    return f"{s:.2f}s"


def load_artifacts(art_dir: str | Path) -> list[dict]:
    out = []
    for p in sorted(Path(art_dir).glob("**/*.json")):
        out.append(json.loads(p.read_text()))
    return out


def to_markdown_table(rows: list[Roofline]) -> str:
    hdr = ("| arch | shape | mesh | compute | memory | collective | "
           "bottleneck | useful |\n|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {fmt_seconds(r.compute_s)} "
            f"| {fmt_seconds(r.memory_s)} | {fmt_seconds(r.collective_s)} "
            f"| {r.bottleneck} | {r.useful_ratio:.2f} |")
    return hdr + "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    print("| arch | shape | mesh | compute | memory | collective | "
          "bottleneck | roofline-frac | useful | GiB/dev |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for d in load_artifacts(args.artifacts):
        if "roofline" not in d:
            continue
        r = d["roofline"]
        tot = max(r["compute_s"], r["memory_s"], r["collective_s"]) or 1.0
        print(f"| {d['arch']} | {d['shape']} | {d['mesh']} "
              f"| {fmt_seconds(r['compute_s'])} | {fmt_seconds(r['memory_s'])} "
              f"| {fmt_seconds(r['collective_s'])} | {r['bottleneck']} "
              f"| {r['compute_s']/tot:.3f} | {r['useful_ratio']:.2f} "
              f"| {d['memory'].get('peak_live_bytes', 0)/2**30:.2f} |")


if __name__ == "__main__":
    main()
