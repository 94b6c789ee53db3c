"""qwen1.5-4b [dense] — MHA with QKV bias.

40L d_model=2560 20H (kv=20, MHA) d_ff=6912 vocab=151936 [hf:Qwen/Qwen1.5].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        qkv_bias=True,
    )
