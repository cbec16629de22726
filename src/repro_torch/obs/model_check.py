"""Model-vs-measured: per-edge error ratios between the planner/autotuner
and what the card actually did (port of ``repro.obs.model_check``).

For every traced shuffle edge this module compares

* **bytes** — the planner's modeled wire bytes (the §3.1
  ``exchange_bytes`` formula over the rows the estimator expects to flow)
  against the MEASURED arrivals (the global destination histogram priced
  with the same (n-1)/n wire rule), as ``byte_model_err =
  max(modeled/measured, measured/modeled)``.  The ratio is deterministic
  for a given dataset and independent of the hardware, so the port's
  ratios equal the reference's edge for edge.  ``BYTE_MODEL_BOUND`` is the
  2x bar; the reference's own plans do not hold it on every edge (Q3's
  orders shuffle at TPC-H SF 0.1 on 8 shards reads 2.61x), so the bound
  gates only where the reference holds it.

* **time** — the autotuner's predicted makespan for the edge
  (:func:`repro_torch.core.autotune.exchange_makespan` under the plan's
  tuned knobs) against the run's measured wall time, apportioned over
  edges by predicted share.  The model prices the reference's TPU links
  (``topology.V5E``), so on the card this ratio is reported, never gated.

``python -m repro_torch.obs.model_check --query q17 --shards 8`` runs one
traced query on the card and prints the JSON report.
"""

from __future__ import annotations

from typing import Mapping

from .trace import ExchangeEdge, QueryTrace

__all__ = [
    "edge_models",
    "build_query_trace",
    "model_report",
    "assert_bytes_within",
    "BYTE_MODEL_BOUND",
]

# The bound on byte_model_err: the reference's 2x bar.
BYTE_MODEL_BOUND = 2.0


def edge_models(plan) -> dict[str, dict]:
    """Per-shuffle-edge model predictions, keyed like the runtime reports.

    Walks the plan's shuffle edges in ``_report_keys`` order (the stable
    ``shuffle[<col>]#<ordinal>`` keys the executor reports under) and
    prices each one: modeled wire bytes via the planner's own
    ``exchange_bytes`` and predicted makespan via ``exchange_makespan``
    with the plan's tuned knobs.  Tuned chunk counts that do not divide an
    edge's row count fall back to unchunked — the same fallback the
    exchange itself applies.
    """
    from ..core.autotune import exchange_makespan
    from ..relational.planner.executor import _report_keys
    from ..relational.planner.physical import PlannerConfig, exchange_bytes

    keys = _report_keys(plan.root)
    n_inner = plan.num_shards // max(plan.num_pods, 1)
    tuned = plan.tuned
    out: dict[str, dict] = {}

    def walk(n, seen):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            walk(c, seen)
        if n.kind != "exchange" or n.info["exkind"] != "shuffle":
            return
        st = n.info["stats"]
        # Bytes are priced on the rows the estimator expects to FLOW
        # (``est_rows``), not the buffer capacity; the makespan keeps the
        # capacity stats — that is what the autotuner priced.
        est_rows = n.info.get("est_rows") or st.rows * plan.num_shards
        modeled = exchange_bytes(
            "partition", int(round(est_rows)), 0, st.row_bytes,
            PlannerConfig(num_units=plan.num_shards),
        )
        try:
            predicted = exchange_makespan(
                st, n_inner, impl=tuned.impl, pack_impl=tuned.pack_impl,
                pipeline_chunks=tuned.pipeline_chunks,
                transport_chunks=tuned.transport_chunks,
                num_pods=plan.num_pods,
            )
        except AssertionError:  # chunk knobs don't divide this edge's rows
            predicted = exchange_makespan(
                st, n_inner, impl=tuned.impl, pack_impl=tuned.pack_impl,
                pipeline_chunks=1, transport_chunks=1,
                num_pods=plan.num_pods,
            )
        out[keys[id(n)]] = dict(
            rows=int(round(est_rows)),
            row_bytes=int(st.row_bytes),
            modeled_wire_bytes=int(modeled),
            predicted_s=float(predicted),
        )

    walk(plan.root, set())
    return out


def _wire_fraction(num_shards: int) -> float:
    """A hash-routed row crosses the wire iff it leaves its shard:
    probability (n-1)/n — the planner's own partition-bytes rule."""
    return (num_shards - 1) / num_shards if num_shards > 1 else 0.0


def build_query_trace(
    plan,
    reports: Mapping[str, Mapping],
    models: Mapping[str, Mapping] | None = None,
    counters: Mapping[str, float] | None = None,
    measured_s: float | None = None,
) -> QueryTrace:
    """Assemble one run's :class:`QueryTrace` from the fetched per-edge
    reports plus the plan's edge models.

    ``reports`` maps edge keys to the executor's per-shuffle report
    (``hist``/``overload``/``plain_overload``/``salted``, host values).
    Streamed runs key multi-pass traversals as ``<edge>@p<pass>`` — the
    base edge's model applies to each traversal.  ``measured_s``
    (dispatch-to-fetched wall) is apportioned over edges by predicted
    share.
    """
    import numpy as np

    models = edge_models(plan) if models is None else models
    frac = _wire_fraction(plan.num_shards)
    edges = []
    preds = []
    for key in reports:
        base = key.split("@p")[0]
        preds.append((models.get(base) or {}).get("predicted_s") or 0.0)
    total_pred = sum(preds) or float(len(reports) or 1)
    for (key, rep), pred in zip(reports.items(), preds):
        base = key.split("@p")[0]
        m = models.get(base) or {}
        hist = np.asarray(rep["hist"]).astype(np.int64)
        rows_arrived = int(hist.sum())
        row_bytes = int(m.get("row_bytes") or 0)
        traversals = int(rep.get("traversals", 1) or 1)
        share = (
            pred / total_pred if total_pred else 1.0 / max(len(reports), 1)
        )
        edges.append(
            ExchangeEdge(
                key=key,
                rows=int(m.get("rows") or 0),
                row_bytes=row_bytes,
                hist=tuple(int(x) for x in hist),
                measured_bytes=int(rows_arrived * row_bytes * frac),
                modeled_wire_bytes=(
                    int(m.get("modeled_wire_bytes") or 0) * traversals
                ),
                traversals=traversals,
                overload=float(rep["overload"]),
                plain_overload=float(rep["plain_overload"]),
                salted=bool(rep["salted"]),
                predicted_s=m.get("predicted_s"),
                measured_s=(
                    measured_s * share if measured_s is not None else None
                ),
            )
        )
    return QueryTrace(
        query=plan.name,
        num_shards=plan.num_shards,
        num_pods=plan.num_pods,
        edges=tuple(edges),
        counters=dict(counters or {}),
        measured_s=measured_s,
    )


def model_report(qt: QueryTrace) -> dict:
    """Flat model-error summary for one run: per-edge byte/time error
    ratios plus the worst byte ratio (lower is better, >= 1)."""
    per_edge = {
        e.key: dict(
            measured_bytes=e.measured_bytes,
            modeled_wire_bytes=e.modeled_wire_bytes,
            byte_model_err=e.byte_model_err,
            predicted_s=e.predicted_s,
            measured_s=e.measured_s,
            time_model_err=e.time_model_err,
        )
        for e in qt.edges
    }
    byte_errs = [e.byte_model_err for e in qt.edges if e.byte_model_err]
    return dict(
        query=qt.query,
        edges=per_edge,
        worst_byte_model_err=max(byte_errs) if byte_errs else None,
    )


def assert_bytes_within(qt: QueryTrace, bound: float = BYTE_MODEL_BOUND) -> None:
    """Raise if any edge's measured wire bytes disagree with the planner's
    model by more than ``bound``x (edges that shipped zero rows are
    vacuous)."""
    for e in qt.edges:
        err = e.byte_model_err
        if err is not None and err > bound:
            raise AssertionError(
                f"{qt.query} {e.key}: measured {e.measured_bytes}B vs "
                f"modeled {e.modeled_wire_bytes}B wire bytes — "
                f"{err:.2f}x exceeds the {bound}x model bound"
            )


# ---------------------------------------------------------------------------
# CLI: one traced query on the simulated mesh, report as JSON.
# ---------------------------------------------------------------------------


def _cli_run(args, device: str) -> dict:
    from ..relational import datagen
    from ..relational import stats as rstats
    from ..relational.context import ExecutionContext, StatsMode
    from ..relational.planner import tpch
    from . import export as obs_export
    from .trace import Tracer

    tabs = datagen.gen_all(args.sf, device=device)
    pq = tpch.ALL_QUERIES[args.query]()
    tables = {t: tabs[t] for t in pq.tables}
    morsel_rows = args.morsel_rows
    if args.streamed and not morsel_rows:
        morsel_rows = max(tabs["lineitem"].capacity // 4, 1)
    tracer = Tracer()
    # Plan from a data profile: the byte model prices the rows the
    # estimator expects to flow, which is only meaningful when the
    # estimator has seen the data (selectivities, key ndv).
    ctx = ExecutionContext(
        num_shards=args.shards, num_pods=args.pods,
        morsel_rows=morsel_rows or None, trace=tracer,
        stats_mode=StatsMode.PROFILE,
        stats_profile=rstats.collect_stats(tables),
        device=device,
    )
    result = tpch.run_query(pq, tables, ctx)
    qt = tracer.query_traces[-1] if tracer.query_traces else None
    rep = model_report(qt) if qt is not None else {"query": args.query}
    try:
        rep["result"] = float(result)
    except (TypeError, ValueError):
        rep["result"] = None
    rep["span_names"] = sorted(
        {s.name.split(":")[0] for root in tracer.spans for s in root.walk()}
    )
    if args.trace_dir:
        rep["trace_path"] = obs_export.write_trace_dir(
            tracer, args.trace_dir, basename=f"model_check-{args.query}"
        )
    if qt is not None and args.bound > 0:
        assert_bytes_within(qt, args.bound)
    return rep


def main(argv=None, device: str = "cuda") -> int:
    """The CLI; it runs on the card, ``device="cpu"`` from Python runs the
    plain versions on the CPU."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="run one traced TPC-H query and report model-vs-measured"
    )
    ap.add_argument("--query", default="q17")
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--streamed", action="store_true",
                    help="stream lineitem morsel by morsel (out of core)")
    ap.add_argument("--morsel-rows", type=int, default=0)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--bound", type=float, default=BYTE_MODEL_BOUND,
                    help="fail if byte_model_err exceeds this (0 disables)")
    args = ap.parse_args(argv)
    print(json.dumps(_cli_run(args, device), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
