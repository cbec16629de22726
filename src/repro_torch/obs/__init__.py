"""Observability (port of ``repro.obs``): the telemetry spine (spans,
counters, query traces), Perfetto export, and the model-vs-measured check.

:mod:`repro_torch.obs.trace` imports nothing of the port (executors import
it freely), :mod:`repro_torch.obs.export` depends only on trace, and
:mod:`repro_torch.obs.model_check` imports the planner lazily.
"""

from .trace import (  # noqa: F401
    ExchangeEdge,
    QueryTrace,
    Span,
    Tracer,
    deposit,
    maybe_span,
    model_error,
)

__all__ = [
    "ExchangeEdge",
    "QueryTrace",
    "Span",
    "Tracer",
    "deposit",
    "maybe_span",
    "model_error",
]
