"""seamless-m4t-medium [audio]: 12L(enc)+12L(dec) d_model=1024 16H
d_ff=4096 vocab=256206 — enc-dec backbone; modality frontend stubbed
(input_specs supplies frame embeddings).  [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256206,
    norm="layernorm", act="gelu",
    tie_embeddings=True, dtype="bfloat16",
)

SMOKE = CONFIG.with_(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, dtype="float32")
