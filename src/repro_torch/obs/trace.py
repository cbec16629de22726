"""One telemetry spine: host-side spans plus per-query device counters
(port of ``repro.obs.trace``; the port keeps its own copy).

* :class:`Tracer` — nested host-side spans (plan → compile → pass → morsel
  → exchange → drain-round on the query side; admission round / request /
  prefill / decode step on the serve side) plus a thread-safe registry of
  counters, gauges and histograms.  Attach one through the frozen
  ``ExecutionContext.trace`` field: the field is ``compare=False``, so a
  traced and an untraced context hash equal — tracing never invalidates a
  plan-cache or executor-memo entry and never changes what runs on the
  card (the per-edge histograms are always computed; the tracer only
  decides whether anyone writes them down).

* :class:`QueryTrace` — the per-run record of what the card measured: one
  :class:`ExchangeEdge` per shuffle (destination histogram, measured vs
  modeled wire bytes, the autotuner's predicted makespan next to the
  measured wall time, the salted/plain decision) plus the streamed path's
  spill, drain and prefetch counters.  Returned per run by
  ``runner.collect(out)``; the deprecated ``runner.exchange_report`` is a
  warned view of the last finalized run.

Span timestamps are wall-clock epoch seconds (``time.time``) so traces
from different processes merge onto one timeline; durations come from
``time.perf_counter``.  Export to JSON and Chrome trace events lives in
:mod:`repro_torch.obs.export`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator, Mapping

__all__ = [
    "Span",
    "Tracer",
    "ExchangeEdge",
    "QueryTrace",
    "maybe_span",
    "model_error",
    "deposit",
]


def _process_index() -> int:
    """This process's track id: its ``torch.distributed`` rank when a
    process group is initialized, else 0.  Resolved lazily, so a Tracer can
    be built before the process group is."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def model_error(predicted: float | None, measured: float | None) -> float | None:
    """Symmetric model-error ratio: ``max(pred/meas, meas/pred)`` — always
    >= 1, lower is better, 1.0 = the model was exact.  ``None`` (or a
    non-positive side) means no comparison is possible."""
    if predicted is None or measured is None:
        return None
    if predicted <= 0.0 or measured <= 0.0:
        return None
    return max(predicted / measured, measured / predicted)


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """One timed region.  ``t0`` is epoch seconds; ``dur`` is None while
    the span is open.  ``pid``/``tid`` are the Chrome trace-event track
    ids (process index / thread ident)."""

    name: str
    cat: str
    t0: float
    dur: float | None
    pid: int
    tid: int
    args: dict
    children: list["Span"] = dataclasses.field(default_factory=list)

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


class Tracer:
    """Thread-safe span + metric registry.

    Spans nest per thread (a ``threading.local`` stack); finished root
    spans land in ``self.spans``.  Counters, gauges and histograms are
    plain dicts under one lock.  ``query_traces`` accumulates every
    :class:`QueryTrace` deposited by a traced run, in completion order.
    """

    def __init__(self, pid: int | None = None):
        self._pid = pid
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list[float]] = {}
        self.query_traces: list["QueryTrace"] = []

    @property
    def pid(self) -> int:
        if self._pid is None:
            self._pid = _process_index()
        return self._pid

    def _stack(self) -> list[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _attach(self, span: Span) -> None:
        stack = self._stack()
        if stack:
            stack[-1].children.append(span)
        else:
            with self._lock:
                self.spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args: Any):
        """Open a nested span around a ``with`` block."""
        s = Span(
            name=name, cat=cat, t0=time.time(), dur=None,
            pid=self.pid, tid=threading.get_ident(), args=dict(args),
        )
        self._attach(s)
        self._stack().append(s)
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.dur = time.perf_counter() - t0
            self._stack().pop()

    def add_span(
        self,
        name: str,
        cat: str = "host",
        t0: float | None = None,
        dur: float = 0.0,
        **args: Any,
    ) -> Span:
        """Record a span after the fact (e.g. per-edge exchange spans laid
        out inside an already-measured execute window).  Nests under the
        current thread's open span, if any."""
        s = Span(
            name=name, cat=cat, t0=time.time() if t0 is None else t0,
            dur=dur, pid=self.pid, tid=threading.get_ident(),
            args=dict(args),
        )
        self._attach(s)
        return s

    # -- metrics ------------------------------------------------------------

    def counter(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self.histograms.setdefault(name, []).append(float(value))

    # -- query traces ---------------------------------------------------------

    def add_query_trace(self, qt: "QueryTrace") -> None:
        with self._lock:
            self.query_traces.append(qt)


@contextlib.contextmanager
def maybe_span(tracer: Tracer | None, name: str, cat: str = "host", **args):
    """``tracer.span(...)`` when a tracer is attached, else a no-op — the
    one-liner every traced call site uses, so untraced runs pay nothing."""
    if tracer is None:
        yield None
        return
    with tracer.span(name, cat=cat, **args) as s:
        yield s


# ---------------------------------------------------------------------------
# The per-run device-counter record.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeEdge:
    """What one shuffle edge measured, next to what the model predicted.

    ``hist`` is the global per-destination arrival histogram (valid rows,
    the exact routing rule of the exchange).  ``measured_bytes`` prices the
    arrivals with the planner's own wire formula (rows x row_bytes x
    (n-1)/n — a row crosses the wire iff it leaves its shard), so the
    ratio against ``modeled_wire_bytes`` isolates the planner's ROW
    estimate.  ``predicted_s`` is the autotuner's makespan for this edge's
    stats under the plan's tuned knobs; ``measured_s`` the edge's share of
    the run's measured wall time (apportioned by predicted share).
    """

    key: str
    rows: int                    # estimated rows flowing per traversal
    row_bytes: int
    hist: tuple[int, ...]
    measured_bytes: int
    modeled_wire_bytes: int
    overload: float              # measured max/fair-share of the chosen route
    plain_overload: float        # measured overload of the plain-hash route
    salted: bool                 # did the runtime gate pick the salted route
    predicted_s: float | None = None
    measured_s: float | None = None
    # How many times this edge shipped its input during the traversal the
    # report covers: 1 for in-memory edges and streamed-side edges, the
    # morsel-step count for a resident-side edge inside a streamed pass
    # (the evaluator re-ships the unchanged table every step).
    # ``modeled_wire_bytes`` already includes the multiplier.
    traversals: int = 1

    @property
    def byte_model_err(self) -> float | None:
        """max(modeled/measured, measured/modeled) wire bytes, >= 1."""
        return model_error(
            float(self.modeled_wire_bytes), float(self.measured_bytes)
        )

    @property
    def time_model_err(self) -> float | None:
        return model_error(self.predicted_s, self.measured_s)

    def legacy_report(self) -> dict:
        """The old ``run.exchange_report`` entry shape for this edge."""
        import numpy as np

        return {
            "hist": np.asarray(self.hist, dtype=np.int64),
            "overload": float(self.overload),
            "plain_overload": float(self.plain_overload),
            "salted": bool(self.salted),
        }


@dataclasses.dataclass(frozen=True)
class QueryTrace:
    """One run's worth of device-side measurement, under one record.

    ``counters`` carries whatever the execution path counted on the host:
    the streamed runner's ``passes``/``morsels``/``spilled_rows``/
    ``drain_rounds``/``prefetch_*`` stats land here verbatim; the in-memory
    executor contributes nothing beyond the edges.
    """

    query: str
    num_shards: int
    num_pods: int
    edges: tuple[ExchangeEdge, ...] = ()
    counters: Mapping[str, float] = dataclasses.field(default_factory=dict)
    measured_s: float | None = None   # dispatch-to-fetched wall time

    def exchange_report(self) -> dict:
        """The legacy ``run.exchange_report`` dict view."""
        return {e.key: e.legacy_report() for e in self.edges}

    def model_errors(self) -> dict[str, dict]:
        """Per-edge model-error ratios (``obs.model_check`` gates these)."""
        return {
            e.key: {
                "byte_model_err": e.byte_model_err,
                "time_model_err": e.time_model_err,
            }
            for e in self.edges
        }


def deposit(tracer: Tracer | None, qt: QueryTrace) -> None:
    """Write one run's QueryTrace into a tracer: the record itself, one
    ``exchange:`` span per edge (laid out inside the measured window when
    one is known), and byte counters.  No-op without a tracer."""
    if tracer is None:
        return
    tracer.add_query_trace(qt)
    now = time.time()
    window = qt.measured_s
    t0 = now - window if window is not None else now
    shares = [e.predicted_s or 0.0 for e in qt.edges]
    total_share = sum(shares) or float(len(qt.edges) or 1)
    at = t0
    for e, share in zip(qt.edges, shares):
        dur = (
            (window or 0.0) * (share / total_share)
            if window is not None
            else (e.measured_s or 0.0)
        )
        tracer.add_span(
            f"exchange:{e.key}", cat="exchange", t0=at, dur=dur,
            query=qt.query, measured_bytes=e.measured_bytes,
            modeled_wire_bytes=e.modeled_wire_bytes,
            byte_model_err=e.byte_model_err,
            predicted_s=e.predicted_s, measured_s=e.measured_s,
            time_model_err=e.time_model_err,
            overload=e.overload, salted=e.salted,
        )
        at += dur
        tracer.counter("exchange.measured_bytes", e.measured_bytes)
        tracer.counter("exchange.modeled_wire_bytes", e.modeled_wire_bytes)
    tracer.counter(f"query.{qt.query}.runs", 1.0)
    for k, v in qt.counters.items():
        if isinstance(v, (int, float)):
            tracer.counter(f"query.{qt.query}.{k}", float(v))
