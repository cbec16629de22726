"""Serving of the port (counterpart of ``repro.serve``): static and
continuous batching over the model API.  The query-serving engine comes
with a later slice (ROADMAP A.9)."""

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
]
