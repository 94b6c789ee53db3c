"""Model layers, the MoE dispatch plane, the SSD blocks and model assembly
for every family."""
from .model import (
    decode_step,
    forward_train,
    init_decode_cache,
    init_paged_decode_cache,
    init_params,
    loss_fn,
    prefill,
)
from .moe import (
    apply_layer_permutation,
    apply_placement,
    identity_placement,
    moe_layer,
)

__all__ = [
    "apply_layer_permutation",
    "apply_placement",
    "decode_step",
    "forward_train",
    "identity_placement",
    "init_decode_cache",
    "init_paged_decode_cache",
    "init_params",
    "loss_fn",
    "moe_layer",
    "prefill",
]
