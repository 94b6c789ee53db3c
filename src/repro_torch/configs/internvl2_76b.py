"""internvl2-76b [vlm] — InternViT + InternLM2/Llama3-70B-class backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 [arXiv:2404.16821].
The InternViT vision frontend is a stub: ``input_specs()`` provides
precomputed patch embeddings (num_patches, d_model) prepended to the text
token sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    num_patches=256,
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        frontend="vision",
        num_patches=8,
    )
