"""Serving plane: engine, paged KV pool, scheduler, arrivals, SLOs."""
from .arrivals import (
    ArrivalConfig,
    RequestSpec,
    TaskProfile,
    batch_arrivals,
    generate_arrivals,
)
from .engine import EngineConfig, ServingEngine
from .kv_cache import PagedKVConfig, PagedKVPool
from .sampling import sample
from .scheduler import Request, Scheduler
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
    "TaskProfile",
    "batch_arrivals",
    "generate_arrivals",
    "sample",
    "slo_report",
]
