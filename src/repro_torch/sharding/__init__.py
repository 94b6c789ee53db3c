"""Which dims of which tensors live on which rank of a mesh."""
from .policy import (
    ShardingPolicy,
    host_policy,
    is_expert_leaf,
    local_expert_slots,
    param_specs,
    spec_axes,
)

__all__ = [
    "ShardingPolicy", "host_policy", "is_expert_leaf", "local_expert_slots",
    "param_specs", "spec_axes",
]
