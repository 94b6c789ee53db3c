"""Serving plane: engine, paged KV pool, scheduler, arrivals, SLOs."""
from .arrivals import (
    ArrivalConfig,
    RequestSpec,
    TaskProfile,
    batch_arrivals,
    generate_arrivals,
)
from .engine import EngineConfig, ServingEngine
from .kv_cache import (
    PagedKVConfig,
    PagedKVPool,
    kv_pool_bytes,
    replica_slots_for_headroom,
)
from .sampling import sample
from .scheduler import Request, Scheduler
from .shed import ShedConfig, default_token_bytes
from .slo import slo_report

__all__ = [
    "ArrivalConfig",
    "EngineConfig",
    "PagedKVConfig",
    "PagedKVPool",
    "Request",
    "RequestSpec",
    "Scheduler",
    "ServingEngine",
    "ShedConfig",
    "TaskProfile",
    "batch_arrivals",
    "default_token_bytes",
    "generate_arrivals",
    "kv_pool_bytes",
    "replica_slots_for_headroom",
    "sample",
    "slo_report",
]
