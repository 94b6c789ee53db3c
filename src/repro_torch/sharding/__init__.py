"""Which dims of which tensors live on which rank of a mesh."""
from .policy import (
    ShardingPolicy,
    host_policy,
    is_expert_leaf,
    kv_shard,
    layout_policy,
    local_expert_slots,
    model_axis,
    param_specs,
    shard_range,
    spec_axes,
    take_shard,
)

__all__ = [
    "ShardingPolicy", "host_policy", "is_expert_leaf", "kv_shard",
    "layout_policy", "local_expert_slots", "model_axis", "param_specs",
    "shard_range", "spec_axes", "take_shard",
]
