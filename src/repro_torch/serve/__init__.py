"""Serving of the port (counterpart of ``repro.serve``): static and
continuous batching over the model API, plus the multi-tenant
query-serving engine over the relational planner."""

from .engine import (
    ContinuousEngine,
    Request,
    ServeEngine,
    SlotAllocator,
    engine_record,
    generate_bucketed,
    grow_cache,
    make_mixed_workload,
    sample_token,
)
from .query_engine import (
    QueryRequest,
    QueryServeEngine,
    make_query_mix,
)

__all__ = [
    "ServeEngine",
    "ContinuousEngine",
    "SlotAllocator",
    "Request",
    "sample_token",
    "generate_bucketed",
    "grow_cache",
    "make_mixed_workload",
    "engine_record",
    "QueryRequest",
    "QueryServeEngine",
    "make_query_mix",
]
