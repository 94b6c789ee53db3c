"""Which dims of which tensors live on which rank of a mesh."""
from .policy import (
    ShardingPolicy,
    fsdp_dim,
    fsdp_gather_axis,
    host_policy,
    is_expert_leaf,
    kv_shard,
    local_expert_slots,
    model_axis,
    param_specs,
    shard_range,
    spec_axes,
    take_shard,
)

__all__ = [
    "ShardingPolicy", "fsdp_dim", "fsdp_gather_axis", "host_policy",
    "is_expert_leaf", "kv_shard", "local_expert_slots",
    "model_axis", "param_specs", "shard_range", "spec_axes", "take_shard",
]
