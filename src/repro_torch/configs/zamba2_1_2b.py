"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242]. One shared attention+MLP block (single weight copy) is
applied every ``attn_every`` Mamba2 blocks, zamba2-style.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    attn_every=6,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_chunk=16,
        attn_every=2,
        tie_embeddings=True,
    )
