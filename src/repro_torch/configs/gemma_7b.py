"""gemma-7b [dense] — GeGLU, head_dim=256.

28L d_model=3072 16H (kv=16, MHA) d_ff=24576 vocab=256000 [arXiv:2403.08295].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    mlp_activation="geglu",
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        head_dim=32,
        mlp_activation="geglu",
        tie_embeddings=True,
    )
