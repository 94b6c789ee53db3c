"""musicgen-medium [audio] — decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (MHA: kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec audio frontend is a stub: ``input_specs()`` provides precomputed
frame token ids (the backbone consumes the EnCodec codebook stream).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
    mlp_activation="swiglu",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        frontend="audio",
        mlp_activation="swiglu",
    )
