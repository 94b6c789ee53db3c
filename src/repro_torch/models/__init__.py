"""Model layers, the MoE dispatch plane, the SSD blocks and model assembly
for every family."""
from .model import (
    decode_step,
    init_decode_cache,
    init_paged_decode_cache,
    init_params,
    prefill,
)
from .moe import apply_placement, identity_placement, moe_layer

__all__ = [
    "apply_placement",
    "decode_step",
    "identity_placement",
    "init_decode_cache",
    "init_paged_decode_cache",
    "init_params",
    "moe_layer",
    "prefill",
]
