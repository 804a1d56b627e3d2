"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free, ssm_state=16
vocab=65024 — mamba1 architecture.  [arXiv:2410.05355]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    ssm_version=1, ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=False, dtype="bfloat16", fsdp=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, vocab=256, ssm_chunk=16,
    dtype="float32", fsdp=False)
