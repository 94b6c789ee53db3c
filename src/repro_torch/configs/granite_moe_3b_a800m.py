"""granite-moe-3b-a800m [moe] — IBM Granite 3.0 MoE.

32L d_model=1536 24H (GQA kv=8) expert_d_ff=512 vocab=49155, 40 experts
top-8 [hf:ibm-granite/granite-3.0-*-base family]. ``expert_tp=2`` splits
each expert into two F-slices: 80 virtual experts with F_v = 256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    expert_d_ff=512,
    expert_tp=2,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        num_experts=8,
        experts_per_token=2,
        expert_d_ff=96,
        expert_tp=1,
        tie_embeddings=True,
    )
