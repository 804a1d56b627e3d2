"""The reference's parameter tree in the port's modules, and back.

``repro.models.lm.init_params`` returns a nested dict whose per-layer
arrays are stacked on a leading layer axis (``params["layers"]["ssm"]
["in_proj"]`` is (L, d, 2·Di), ``params["layers"]["attn"]["wq"]`` (L, d,
Hq·D)).  :func:`params_from_jax` takes that tree
with numpy leaves (``np.asarray`` of each jax array; bf16 as ml_dtypes'
bfloat16) or tensors (the hybrid family's top-level ``shared`` tree and the
vlm family's ``vis_proj`` included) and builds the port's
:class:`~repro_torch.models.lm.LM`, splitting the stacked arrays into one
block per layer.  With it, both packages compute with the same weights.
:func:`tree_from_params` is its inverse: it stacks the layers' parameters
into that tree, and :func:`load_tree` copies such a tree into an existing
model.  Nothing here imports jax.

The optimizer, the gradient compressor and the checkpointer work on the
reference's tree.  :func:`param_tree` gives it without copying: the same
nested dict whose per-layer leaves are *lists* of the layers' tensors
(a "layered" leaf, standing for their stack), and :func:`leaves` /
:func:`map_leaves` walk it in the reference's leaf order (dict keys
sorted, as ``jax.tree_util`` flattens).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from ..core.api import _as_tensor, resolve_device
from .config import ModelConfig
from .layers import param
from .lm import LM, Block, require_ported

SSM_KEYS = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
            "a_log", "d_skip", "out_proj")
SSM2_KEYS = ("in_proj", "conv_w", "conv_b", "bc_proj", "dt_proj", "dt_bias",
             "a_log", "d_skip", "out_proj")
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _attn_keys(cfg: ModelConfig) -> dict[str, tuple[str, ...]]:
    norm = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    attn = ("wq", "wk", "wv", "wo") + (("q_norm", "k_norm") if cfg.qk_norm
                                       else ())
    mlp = ("wi", "wo") if cfg.act == "relu2" else ("wi_gate", "wi_up", "wo")
    return {"norm_attn": norm, "attn": attn, "norm_mlp": norm, "mlp": mlp}


def layer_keys(cfg: ModelConfig) -> dict[str, tuple[str, ...]]:
    """The reference's per-layer tree for ``cfg``: {part: its leaf keys}."""
    require_ported(cfg)
    norm = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    if cfg.family in ("ssm", "hybrid"):
        return {"norm_ssm": norm,
                "ssm": SSM_KEYS if cfg.ssm_version == 1 else SSM2_KEYS}
    out = _attn_keys(cfg)
    if cfg.n_experts:
        del out["mlp"]
        out["moe"] = MOE_KEYS
    if cfg.post_norm:
        out.update(post_attn=norm, post_mlp=norm)
    return out


def shared_keys(cfg: ModelConfig) -> dict[str, tuple[str, ...]] | None:
    """The hybrid family's top-level ``shared`` tree ({part: its leaf
    keys}), or None where the config has none."""
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        return _attn_keys(cfg)
    return None


def _pdict(tree: dict, keys, index=None, device=None) -> nn.ParameterDict:
    out = {}
    for k in keys:
        t = _as_tensor(tree[k])
        out[k] = param((t if index is None else t[index]).contiguous()
                       .to(device))
    return nn.ParameterDict(out)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """Build an :class:`LM` on ``device`` (default ``cuda:0``; raises
    without CUDA) from the reference's parameter tree for ``cfg`` (numpy
    leaves).  Raises on a missing or extra layer key and on a layer axis
    that is not ``cfg.n_layers`` long."""
    want = layer_keys(cfg)
    device = resolve_device(device)
    layers = tree["layers"]
    got = {part: tuple(sorted(v)) for part, v in layers.items()}
    if got != {part: tuple(sorted(v)) for part, v in want.items()}:
        raise ValueError(f"params_from_jax: layer keys {got} are not the "
                         f"{cfg.family} keys {want}")
    for part, keys in want.items():
        for k in keys:
            n = layers[part][k].shape[0]
            if n != cfg.n_layers:
                raise ValueError(f"params_from_jax: layers/{part}/{k} has "
                                 f"{n} layers, the config {cfg.n_layers}")
    blocks = [Block(**{part: _pdict(layers[part], keys, i, device)
                       for part, keys in want.items()})
              for i in range(cfg.n_layers)]
    skeys = shared_keys(cfg)
    got = {part: tuple(sorted(v)) for part, v in tree.get("shared", {}).items()}
    if got != {part: tuple(sorted(v)) for part, v in (skeys or {}).items()}:
        raise ValueError(f"params_from_jax: shared keys {got} are not the "
                         f"{cfg.family} keys {skeys}")
    shared = None if skeys is None else Block(**{
        part: _pdict(tree["shared"][part], keys, device=device)
        for part, keys in skeys.items()})
    want_vis = cfg.family == "vlm" and bool(cfg.n_patches)
    if want_vis != ("vis_proj" in tree):
        raise ValueError(f"params_from_jax: vis_proj is "
                         f"{'missing' if want_vis else 'not'} a key of the "
                         f"{cfg.family} tree")
    lm_head, vis = tree.get("lm_head"), tree.get("vis_proj")
    return LM(_as_tensor(tree["embed"]).to(device), blocks,
              _pdict(tree["final_norm"], tuple(tree["final_norm"]),
                     device=device),
              None if lm_head is None else _as_tensor(lm_head).to(device),
              shared=shared,
              vis_proj=None if vis is None else _as_tensor(vis).to(device))


# ---------------------------------------------------------------------------
# the reference's tree
# ---------------------------------------------------------------------------

def param_tree(lm: LM) -> dict:
    """The reference's parameter tree of ``lm`` without copies: top-level
    leaves are the parameters, per-layer leaves lists of the layers'
    parameters in layer order."""
    blocks = list(lm.layers)
    tree = {"embed": lm.embed,
            "final_norm": dict(lm.final_norm.items()),
            "layers": {part: {k: [getattr(b, part)[k] for b in blocks]
                              for k in getattr(blocks[0], part)}
                       for part in blocks[0].parts}}
    if lm.lm_head is not None:
        tree["lm_head"] = lm.lm_head
    if lm.shared is not None:
        tree["shared"] = {part: dict(getattr(lm.shared, part).items())
                          for part in lm.shared.parts}
    if lm.vis_proj is not None:
        tree["vis_proj"] = lm.vis_proj
    return tree


def leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) of a nested dict in the reference's order (keys
    sorted); a leaf is anything but a dict (a tensor, a layered list)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def map_leaves(fn: Callable, tree: dict, *rest: dict) -> dict:
    """A tree of the same keys with ``fn(leaf, *leaves_of_rest)`` at each
    leaf (``rest`` trees share ``tree``'s keys)."""
    return {k: (map_leaves(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def stacked_shape(leaf) -> tuple[int, ...]:
    """The shape a leaf has in the reference's tree (a layered leaf stacks
    its layers on a leading axis)."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def stack(leaf, device=None, dtype=None) -> torch.Tensor:
    """A new tensor holding ``leaf`` as the reference lays it out (a
    layered leaf stacked, detached), on ``device`` in ``dtype`` (default:
    the leaf's)."""
    first = leaf[0] if isinstance(leaf, list) else leaf
    out = torch.empty(stacked_shape(leaf), dtype=dtype or first.dtype,
                      device=first.device if device is None else device)
    if isinstance(leaf, list):
        for i, p in enumerate(leaf):
            out[i].copy_(p.detach())
    else:
        out.copy_(leaf.detach())
    return out


def tree_from_params(lm: LM, device=None) -> dict:
    """The reference's parameter tree of ``lm``: per-layer parameters
    stacked on a leading layer axis, every leaf a detached copy on
    ``device`` (default: the parameters')."""
    return map_leaves(lambda leaf: stack(leaf, device), param_tree(lm))


@torch.no_grad()
def load_tree(lm: LM, tree: dict) -> LM:
    """Copy the reference-layout ``tree`` (tensors or numpy arrays) into
    ``lm``'s parameters in place; raises on a missing key or a shape that
    differs."""
    ours = dict(leaves(param_tree(lm)))
    theirs = dict(leaves(tree))
    if set(ours) != set(theirs):
        raise ValueError(f"load_tree: keys {sorted(theirs)} are not the "
                         f"model's {sorted(ours)}")
    for path, leaf in ours.items():
        src = _as_tensor(theirs[path])
        if tuple(src.shape) != stacked_shape(leaf):
            raise ValueError(f"load_tree: {'/'.join(path)} has shape "
                             f"{tuple(src.shape)}, the model "
                             f"{stacked_shape(leaf)}")
        if isinstance(leaf, list):
            for i, p in enumerate(leaf):
                p.copy_(src[i])
        else:
            leaf.copy_(src)
    return lm
