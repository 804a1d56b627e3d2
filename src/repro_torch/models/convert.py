"""The reference's parameter tree in the port's modules.

``repro.models.lm.init_params`` returns a nested dict whose per-layer
arrays are stacked on a leading layer axis (``params["layers"]["ssm"]
["in_proj"]`` is (L, d, 2·Di)).  :func:`params_from_jax` takes that tree
with numpy leaves (``np.asarray`` of each jax array; bf16 as ml_dtypes'
bfloat16) and builds the port's :class:`~repro_torch.models.lm.LM`,
splitting the stacked arrays into one block per layer.  With it, both
packages compute with the same weights.  Nothing here imports jax.
"""

from __future__ import annotations

from torch import nn

from ..core.api import _as_tensor, resolve_device
from .config import ModelConfig
from .layers import param
from .lm import LM, Mamba1Block, require_mamba1

SSM_KEYS = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
            "a_log", "d_skip", "out_proj")


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
    require_mamba1(cfg)
    device = resolve_device(device)
    layers = tree["layers"]
    ssm = layers["ssm"]
    if set(ssm) != set(SSM_KEYS):
        raise ValueError(f"params_from_jax: layer keys {sorted(ssm)} are not "
                         f"the Mamba-1 keys {sorted(SSM_KEYS)}")
    norm_keys = tuple(layers["norm_ssm"])
    for k, v in (*ssm.items(), *layers["norm_ssm"].items()):
        if v.shape[0] != cfg.n_layers:
            raise ValueError(f"params_from_jax: layers/{k} has {v.shape[0]} "
                             f"layers, the config {cfg.n_layers}")
    blocks = [Mamba1Block(_pdict(layers["norm_ssm"], norm_keys, i, device),
                          _pdict(ssm, SSM_KEYS, i, device))
              for i in range(cfg.n_layers)]
    lm_head = tree.get("lm_head")
    return LM(_as_tensor(tree["embed"]).to(device), blocks,
              _pdict(tree["final_norm"], tuple(tree["final_norm"]),
                     device=device),
              None if lm_head is None else _as_tensor(lm_head).to(device))
