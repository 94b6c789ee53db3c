"""qwen2.5-14b [dense] — GQA, QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 [hf:Qwen/Qwen2.5].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        qkv_bias=True,
    )
