"""Which dims of which tensors live on which rank of a mesh."""
from .policy import (
    ShardingPolicy,
    host_policy,
    local_expert_slots,
    param_specs,
)

__all__ = [
    "ShardingPolicy", "host_policy", "local_expert_slots", "param_specs",
]
