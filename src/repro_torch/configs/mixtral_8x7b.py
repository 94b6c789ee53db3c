"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) expert_d_ff=14336 vocab=32000, SWA window
4096 [arXiv:2401.04088]. ``expert_tp=2`` splits each expert into two
F-slices: 16 virtual experts.

The engine serves the 4,096-token window (32 in the smoke reduction) on
the dense KV ring, as the JAX engine does: ``kv_mode="auto"`` pages only
attention families without a window.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    expert_d_ff=14336,
    expert_tp=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        num_experts=4,
        experts_per_token=2,
        expert_d_ff=128,
        expert_tp=1,
        sliding_window=32,
    )
