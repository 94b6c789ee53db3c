"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
d_inner = 2*d_model = 4096, head_dim 64 → 64 SSD heads.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=128,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_chunk=32,
        tie_embeddings=True,
    )
