"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144, 5:1 local:global (window 512), qk-norm, 128k rope.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    sliding_window=512, local_global_pattern=(5, 1),
    rope_theta=10_000.0, rope_theta_global=1e6,
    qk_norm=True, post_norm=True, embed_scale=True,
    act="gelu", tie_embeddings=True, dtype="bfloat16",
)

SMOKE = CONFIG.with_(
    n_layers=6, d_model=48, n_heads=2, n_kv_heads=1, head_dim=24,
    d_ff=96, vocab=256, sliding_window=8, dtype="float32")
