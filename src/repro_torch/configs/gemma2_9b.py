"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, local(4096):global alternating, logit softcaps.
[arXiv:2408.00118]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    sliding_window=4096, local_global_pattern=(1, 1),
    attn_softcap=50.0, final_softcap=30.0,
    post_norm=True, embed_scale=True,
    act="gelu", tie_embeddings=True, dtype="bfloat16", fsdp=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, sliding_window=8, dtype="float32", fsdp=False)
