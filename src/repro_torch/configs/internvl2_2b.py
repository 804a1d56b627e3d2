"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT frontend stubbed (input_specs supplies patch
embeddings), InternLM2 backbone.  [arXiv:2404.16821]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553,
    n_patches=1024,
    tie_embeddings=True, dtype="bfloat16",
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, n_patches=16, dtype="float32")
