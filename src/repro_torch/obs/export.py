"""Trace export: JSON round trip + Chrome trace-event (Perfetto) timelines
(port of ``repro.obs.export``; the layout is the reference's).

Two serializations of one :class:`~repro_torch.obs.trace.Tracer`:

* **JSON** — the full record (spans, counters, gauges, histograms, query
  traces) in a schema that round-trips: ``query_trace_from_dict(
  query_trace_to_dict(qt)) == qt``, so a trace written by one run can be
  re-loaded and re-gated later.

* **Chrome trace-event** — the ``traceEvents`` array Perfetto and
  ``chrome://tracing`` load directly: matched ``B``/``E`` duration events
  (microsecond timestamps, sorted), one *process* track per cluster
  process (``pid`` = the ``torch.distributed`` rank) and one thread track
  per host thread.  :func:`write_trace_dir` writes ``trace-p<pid>.json``
  per process; :func:`merge_trace_dir` concatenates every per-process file
  into one timeline — span timestamps are wall-clock epoch, so processes
  on one host line up without clock translation.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any

from .trace import ExchangeEdge, QueryTrace, Span, Tracer

__all__ = [
    "query_trace_to_dict",
    "query_trace_from_dict",
    "query_trace_to_json",
    "query_trace_from_json",
    "chrome_trace_events",
    "tracer_to_dict",
    "write_trace",
    "write_trace_dir",
    "merge_trace_dir",
]


# ---------------------------------------------------------------------------
# QueryTrace JSON round-trip.
# ---------------------------------------------------------------------------


def query_trace_to_dict(qt: QueryTrace) -> dict:
    d = dataclasses.asdict(qt)
    d["counters"] = dict(qt.counters)
    d["edges"] = [dataclasses.asdict(e) for e in qt.edges]
    for e in d["edges"]:
        e["hist"] = list(e["hist"])
    return d


def query_trace_from_dict(d: dict) -> QueryTrace:
    edges = tuple(
        ExchangeEdge(**{**e, "hist": tuple(int(x) for x in e["hist"])})
        for e in d.get("edges", ())
    )
    return QueryTrace(
        query=d["query"],
        num_shards=int(d["num_shards"]),
        num_pods=int(d["num_pods"]),
        edges=edges,
        counters=dict(d.get("counters", {})),
        measured_s=d.get("measured_s"),
    )


def query_trace_to_json(qt: QueryTrace) -> str:
    return json.dumps(query_trace_to_dict(qt), sort_keys=True)


def query_trace_from_json(s: str) -> QueryTrace:
    return query_trace_from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Chrome trace-event export.
# ---------------------------------------------------------------------------


def _span_events(s: Span, out: list[dict]) -> None:
    ts = s.t0 * 1e6                       # trace-event timestamps are µs
    dur = (s.dur or 0.0) * 1e6
    args = {k: v for k, v in s.args.items() if _jsonable(v)}
    out.append(
        dict(name=s.name, cat=s.cat, ph="B", ts=ts, pid=s.pid, tid=s.tid,
             args=args)
    )
    for c in s.children:
        _span_events(c, out)
    out.append(
        dict(name=s.name, cat=s.cat, ph="E", ts=ts + dur, pid=s.pid,
             tid=s.tid)
    )


def _jsonable(v: Any) -> bool:
    return isinstance(v, (str, int, float, bool, type(None)))


def chrome_trace_events(tracer: Tracer, process_name: str | None = None) -> list[dict]:
    """The ``traceEvents`` array: metadata + sorted, matched B/E pairs.

    Events are emitted in (ts, B-before-E-at-equal-ts) order — Perfetto
    tolerates unsorted input but the validity tests (and humans diffing
    two traces) should not have to."""
    events: list[dict] = []
    for root in tracer.spans:
        _span_events(root, events)
    # Stable sort: ts ascending; at equal ts, B (opens) before E (closes)
    # of a *different* span, but an E already emitted before a B at the
    # same ts stays put — sorting on (ts, ph!="B") keeps pairs matched
    # because a child's B/E always nests strictly inside its parent's.
    events.sort(key=lambda e: (e["ts"], e["ph"] != "E"))
    meta: list[dict] = [
        dict(
            name="process_name", ph="M", pid=tracer.pid, tid=0,
            args={"name": process_name or f"process {tracer.pid}"},
        )
    ]
    return meta + events


def tracer_to_dict(tracer: Tracer, process_name: str | None = None) -> dict:
    """Everything: Perfetto loads ``traceEvents`` and ignores the rest;
    the JSON consumers read ``counters``/``queryTraces``."""
    return dict(
        traceEvents=chrome_trace_events(tracer, process_name),
        displayTimeUnit="ms",
        counters=dict(tracer.counters),
        gauges=dict(tracer.gauges),
        histograms={k: list(v) for k, v in tracer.histograms.items()},
        queryTraces=[query_trace_to_dict(qt) for qt in tracer.query_traces],
    )


def write_trace(tracer: Tracer, path: str, process_name: str | None = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(tracer_to_dict(tracer, process_name), f)
    os.replace(tmp, path)
    return path


def write_trace_dir(tracer: Tracer, trace_dir: str, basename: str = "trace") -> str:
    """Per-process trace file: ``<dir>/<basename>-p<pid>.json``.  Every
    process of a cluster writes its own file (atomic rename), then any one
    process merges with :func:`merge_trace_dir`."""
    return write_trace(
        tracer, os.path.join(trace_dir, f"{basename}-p{tracer.pid}.json")
    )


def merge_trace_dir(
    trace_dir: str, basename: str = "trace", out: str | None = None
) -> dict:
    """Merge every ``<basename>-p*.json`` in ``trace_dir`` into ONE
    Perfetto-loadable timeline (events re-sorted across processes; each
    process keeps its own pid track).  Writes ``out`` when given; returns
    the merged dict."""
    merged = dict(
        traceEvents=[], displayTimeUnit="ms", counters={}, gauges={},
        histograms={}, queryTraces=[],
    )
    paths = sorted(glob.glob(os.path.join(trace_dir, f"{basename}-p*.json")))
    if not paths:
        raise FileNotFoundError(
            f"no {basename}-p*.json trace files under {trace_dir!r}"
        )
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        merged["traceEvents"].extend(d.get("traceEvents", ()))
        for k, v in d.get("counters", {}).items():
            merged["counters"][k] = merged["counters"].get(k, 0.0) + v
        merged["gauges"].update(d.get("gauges", {}))
        for k, v in d.get("histograms", {}).items():
            merged["histograms"].setdefault(k, []).extend(v)
        merged["queryTraces"].extend(d.get("queryTraces", ()))
    merged["traceEvents"].sort(
        key=lambda e: (0 if e.get("ph") == "M" else 1, e.get("ts", 0.0))
    )
    if out is not None:
        tmp = f"{out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, out)
    return merged
