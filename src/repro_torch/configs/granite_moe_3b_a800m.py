"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512, vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    tie_embeddings=True, dtype="bfloat16",
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab=256, n_experts=8, top_k=2, capacity_factor=8.0, dtype="float32")

# §Perf-tuned recipe (EXPERIMENTS.md): context-parallel attention (head
# counts 24/8 don't divide model=16) + tight MoE capacity.
TUNED = CONFIG.with_(seq_shard_attn=True, capacity_factor=1.0)
