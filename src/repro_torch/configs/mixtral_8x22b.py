"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA.  [arXiv:2401.04088]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    n_experts=8, top_k=2,
    sliding_window=4096, local_global_pattern=(1, 0),   # pure SWA
    rope_theta=1e6, tie_embeddings=False,
    dtype="bfloat16", fsdp=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, n_experts=4, top_k=2, sliding_window=16,
    capacity_factor=8.0, dtype="float32", fsdp=False)

# §Perf-tuned recipe (EXPERIMENTS.md): tight MoE capacity; pair with
# microbatch=16 (launch-level) to fit 16 GB/chip.  seq-shard variants
# REGRESSED collectives for this arch (48 heads shard cleanly) — B2/B7.
TUNED = CONFIG.with_(capacity_factor=1.0)
