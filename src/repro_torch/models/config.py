"""Model configuration for the assigned architecture zoo.

The port's own copy of the reference's pure-Python ``ModelConfig`` and
``ShapeConfig`` (same fields, same derived properties, so a config means the
same model in both packages).  One frozen dataclass covers all 10 families;
per-arch files in ``repro_torch/configs/`` instantiate it with the exact
published numbers and a reduced smoke variant.  Layer heterogeneity (gemma
local:global, zamba2 shared-attention sites) is a per-layer kind pattern.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


ATTN_GLOBAL = 0
ATTN_LOCAL = 1   # sliding-window


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec | vlm

    # transformer backbone
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int | None = None    # default: d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"              # silu (SwiGLU) | gelu | relu2 (non-gated)
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    post_norm: bool = False        # gemma2/3-style extra post-block norms
    qk_norm: bool = False          # gemma3-style RMSNorm on q/k
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scale

    # attention pattern
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None   # gemma3: 1e6 on global layers
    sliding_window: int | None = None        # window for local layers
    local_global_pattern: tuple[int, int] = (0, 1)  # (n_local, n_global) per cycle
    attn_softcap: float | None = None        # gemma2: 50.0
    final_softcap: float | None = None       # gemma2: 30.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # perf: explicit shard_map expert-FFN with combine-BEFORE-psum — the
    # model-axis all-reduce then moves (T, d) tokens instead of (E, C, d)
    # capacity slots (~topk·cf× smaller).  Beyond-paper optimization, see
    # EXPERIMENTS.md §Perf.
    moe_combine_shardmap: bool = False
    # perf: shard the capacity dim over the model axis with REPLICATED expert
    # weights — expert GEMMs go fully local; remaining collectives are
    # token-sized (T·d) instead of slot-sized (E·C·d).  EXPERIMENTS.md §Perf.
    moe_capacity_sharding: bool = False
    # perf: expand GQA KV heads to the query-head count before attention so
    # the head dim shards cleanly (partial-score all-reduce otherwise when
    # kv_heads < model axis).  Applicable when n_heads % model_axis == 0.
    # EXPERIMENTS.md §Perf A3.
    gqa_expand_kv: bool = False
    # perf: context parallelism for prefill/train attention — shard the query
    # T dim over 'model' so attention is head-layout-independent and local
    # (the recipe for archs whose head counts don't divide the model axis).
    # EXPERIMENTS.md §Perf A4.
    seq_shard_attn: bool = False
    # perf: Megatron-style sequence parallelism for the residual stream —
    # h between blocks is T-sharded over 'model', so remat-saved layer inputs
    # shrink by the TP degree (AG before qkv / RS after wo replace the ARs at
    # equal wire volume).  EXPERIMENTS.md §Perf B7.
    seq_shard_residual: bool = False

    # SSM (mamba)
    ssm_version: int = 0           # 0 = none, 1 = mamba1/S6, 2 = mamba2/SSD
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # mamba2
    ssm_chunk: int = 64
    # hybrid (zamba2): shared attention block applied every N ssm layers
    shared_attn_every: int = 0

    # encoder-decoder
    enc_layers: int = 0

    # vlm
    n_patches: int = 0

    # numerics / distribution
    dtype: str = "float32"         # params/activations wire dtype
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False             # shard params over the data axes too

    # --- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded so the model axis always shards it
        (multiple of 256 covers any mesh axis ≤ 256 with MXU-aligned tiles).
        Logits over the padded tail are masked in the loss / sampler."""
        pad = 256
        return ((self.vocab + pad - 1) // pad) * pad

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def layer_kinds(self) -> tuple[int, ...]:
        """Per-layer attention kind (ATTN_GLOBAL/ATTN_LOCAL) for the decoder
        stack.  Pattern cycles (n_local, n_global); pure-global when no
        sliding window is configured."""
        if self.sliding_window is None:
            return tuple([ATTN_GLOBAL] * self.n_layers)
        n_local, n_global = self.local_global_pattern
        if n_global == 0:
            return tuple([ATTN_LOCAL] * self.n_layers)
        cycle = [ATTN_LOCAL] * n_local + [ATTN_GLOBAL] * n_global
        return tuple(cycle[i % len(cycle)] for i in range(self.n_layers))

    def shared_attn_sites(self) -> tuple[int, ...]:
        """zamba2: 1 at layers where the shared attention block fires."""
        if self.shared_attn_every <= 0:
            return tuple([0] * self.n_layers)
        return tuple(1 if (i + 1) % self.shared_attn_every == 0 else 0
                     for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        n_attn = self.n_heads * self.hd * d + 2 * self.n_kv_heads * self.hd * d + self.n_heads * self.hd * d
        gated = 3 if self.act == "silu" else 2
        n_mlp = gated * d * ff
        if self.n_experts:
            n_mlp = self.n_experts * gated * d * ff + d * self.n_experts
        n_ssm = 0
        if self.ssm_version:
            di, n = self.d_inner, self.ssm_state
            n_ssm = 2 * d * di + di * self.ssm_conv + di * d
            if self.ssm_version == 1:
                n_ssm += di * n * 2 + di * 2  # B,C proj via x_proj + dt
            else:
                n_ssm += d * 2 * n + self.ssm_heads * 2
        per_layer = n_ssm if self.family in ("ssm",) else n_attn + n_mlp
        if self.family == "hybrid":
            per_layer = n_ssm
        total = self.n_layers * per_layer + v * d
        if self.family == "hybrid" and self.shared_attn_every:
            total += n_attn + n_mlp
        if self.family == "encdec":
            total += self.enc_layers * (n_attn + n_mlp) + self.n_layers * (n_attn + n_mlp // 2)
        if not self.tie_embeddings:
            total += v * d
        return int(total)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    microbatch: int | None = None  # grad-accumulation chunks (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
