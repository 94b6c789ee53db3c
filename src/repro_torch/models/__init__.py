"""Model layers, the MoE dispatch plane and model assembly (MoE family)."""
from .model import decode_step, init_paged_decode_cache, init_params, prefill
from .moe import apply_placement, identity_placement, moe_layer

__all__ = [
    "apply_placement",
    "decode_step",
    "identity_placement",
    "init_paged_decode_cache",
    "init_params",
    "moe_layer",
    "prefill",
]
