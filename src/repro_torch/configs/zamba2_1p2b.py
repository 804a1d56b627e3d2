"""zamba2-1.2b [hybrid]: 38L d_model=2048 Mamba2 backbone, shared attn
block (32H kv=32, d_ff=8192) every 6 layers, ssm_state=64, vocab=32000.
[arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm_version=2, ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=256,
    shared_attn_every=6,
    tie_embeddings=True, dtype="bfloat16",
)

SMOKE = CONFIG.with_(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
    shared_attn_every=2, dtype="float32")
