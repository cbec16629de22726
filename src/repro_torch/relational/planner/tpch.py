"""The TPC-H workload as logical plans (port of ``repro.relational.planner.tpch``).

Every query — Q1, Q3, Q4, Q6, Q12, Q14, Q17, Q18, Q19 — is a logical
operator DAG and nothing else; the physical planner places the exchanges and
the executor runs the result over the multiplexer on the simulated fabric.
The plans are the reference's, node for node, so ``explain()`` matches it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from ...obs.trace import deposit, maybe_span
from .. import queries as Q
from ..context import ExecutionContext, StatsMode, require_context
from ..datagen import (
    LINESTATUS,
    ORDERPRIORITIES,
    RETURNFLAGS,
    SHIPMODES,
    date_to_days,
    table_capacity,
)
from ..source import MorselView, as_source
from . import logical as L
from .executor import compile_plan
from .logical import Aggregate, Filter, GroupBy, HashJoin, Project, Scan, TopK
from .logical import col, lit, where
from .physical import PhysicalPlan, PlannerConfig, plan_physical
from .stream import compile_plan_streamed


@dataclasses.dataclass(frozen=True)
class PlannedQuery:
    """A query as the planner sees it: name, base tables, logical root, and
    a host-side finalize applied to the fetched (numpy) result."""

    name: str
    tables: tuple[str, ...]
    logical: L.Node
    finalize: Callable | None = None

    def plan(
        self,
        catalog: L.Catalog,
        num_shards: int,
        num_pods: int = 1,
        cfg: PlannerConfig | None = None,
        cross_pod: str | None = None,
        stats: dict | None = None,
        morsel_rows: int | None = None,
    ) -> PhysicalPlan:
        return plan_physical(
            self.logical, catalog, num_shards, num_pods=num_pods, cfg=cfg,
            name=self.name, cross_pod=cross_pod, stats=stats,
            morsel_rows=morsel_rows,
        )


def plan_query(
    pq: PlannedQuery, tables: dict, ctx: ExecutionContext, morsel_rows: int | None = None,
) -> PhysicalPlan:
    """Plan ``pq`` against the actual table (or source) capacities under
    ``ctx``; ``morsel_rows`` prices streamed shuffles at one morsel.
    ``StatsMode.COLLECT`` samples the query's tables (in memory only: a
    chunked source is refused)."""
    srcs = {t: as_source(tables[t]) for t in pq.tables}
    if ctx.stats_mode is StatsMode.COLLECT:
        if any(s.is_chunked for s in srcs.values()):
            raise ValueError(
                "StatsMode.COLLECT samples in-memory tables; streamed "
                "sources plan with STATIC stats or a pre-collected PROFILE"
            )
        stats = ctx.planner_stats({t: s.materialize() for t, s in srcs.items()})
    else:
        stats = ctx.planner_stats()
    catalog = {t: srcs[t].capacity for t in pq.tables}
    return pq.plan(
        catalog, ctx.num_shards, num_pods=ctx.num_pods, cfg=ctx.cfg,
        cross_pod=ctx.cross_pod, stats=stats, morsel_rows=morsel_rows,
    )


def run_query(pq: PlannedQuery, tables: dict, ctx: ExecutionContext | None = None):
    """Plan against the actual source capacities, execute, finalize.

    ``tables`` maps base-table names to
    :class:`~repro_torch.relational.table.Table`\\ s or
    :class:`~repro_torch.relational.source.DataSource`\\ s.  ``ctx`` (None:
    one shard on the card) sets the mesh, the knobs and the device; without
    a CUDA device, anything but ``device="cpu"`` raises.  With
    ``ctx.trace`` set, the run records ``plan:``, ``compile:`` and
    ``execute:`` spans and deposits its
    :class:`~repro_torch.obs.trace.QueryTrace` (per-edge measured against
    modeled exchange bytes) into the tracer.

    Out-of-core: a chunked DataSource streams morsel by morsel through
    :func:`~repro_torch.relational.planner.stream.compile_plan_streamed`.
    With ``ctx.morsel_rows`` set and plain in-memory tables, the one table
    larger than ``morsel_rows`` is wrapped in a chunked
    :class:`~repro_torch.relational.source.MorselView`.  The planner prices
    streamed shuffles at one morsel (``morsel_rows`` reaches
    :func:`plan_physical`, and so the plan-cache key, which covers every
    argument of the planner).
    """
    ctx = require_context(ctx or ExecutionContext(), where="run_query")
    srcs = {t: as_source(tables[t]) for t in pq.tables}
    if ctx.morsel_rows is not None and not any(s.is_chunked for s in srcs.values()):
        big = [t for t in pq.tables if srcs[t].capacity > ctx.morsel_rows]
        if len(big) > 1:
            raise ValueError(
                f"morsel_rows={ctx.morsel_rows} would stream {big}, but "
                "streamed execution supports one chunked relation; chunk "
                "exactly one source (or raise morsel_rows)"
            )
        if big:
            srcs[big[0]] = MorselView(srcs[big[0]].materialize(), ctx.morsel_rows)
    chunked = [t for t in pq.tables if srcs[t].is_chunked]
    tracer = ctx.trace
    with maybe_span(tracer, f"plan:{pq.name}", "plan",
                    num_shards=ctx.num_shards, num_pods=ctx.num_pods,
                    streamed=bool(chunked)):
        phys = plan_query(pq, srcs, ctx, srcs[chunked[0]].chunk_rows if chunked else None)
    if chunked:
        with maybe_span(tracer, f"compile:{pq.name}", "compile", streamed=True):
            runner = compile_plan_streamed(phys, srcs, ctx)
        with maybe_span(tracer, f"execute:{pq.name}", "execute"):
            raw = runner()  # deposits its own QueryTrace + pass/morsel spans
    else:
        with maybe_span(tracer, f"compile:{pq.name}", "compile", streamed=False):
            runner = compile_plan(phys, srcs, ctx)
        t0 = time.perf_counter()
        with maybe_span(tracer, f"execute:{pq.name}", "execute"):
            raw, qt = runner.collect(runner.dispatch(), t_dispatch=t0)
        deposit(tracer, qt)
    return pq.finalize(raw) if pq.finalize else raw


def explain_query(pq: PlannedQuery, catalog: L.Catalog, ctx=None) -> str:
    """Render the physical plan the context would execute (planning only;
    no device is touched).  ``StatsMode.COLLECT`` is not explainable
    without the tables — collect a profile and pass it via
    ``StatsMode.PROFILE``."""
    ctx = require_context(ctx or ExecutionContext(), where="explain_query")
    return pq.plan(
        catalog, ctx.num_shards, num_pods=ctx.num_pods, cfg=ctx.cfg,
        cross_pod=ctx.cross_pod, stats=ctx.planner_stats(),
    ).explain()


def tpch_catalog(sf: float) -> dict[str, int]:
    """Base-table capacities at scale factor ``sf`` — straight from
    ``datagen.table_capacity`` (the shared definition the ``gen_*``
    functions size with), so plans built from this catalog are identical to
    plans built from generated tables (golden snapshots use this to plan
    without generating any data)."""
    return {
        t: table_capacity(t, sf)
        for t in ("part", "customer", "orders", "lineitem")
    }


# ----------------------------------------------------------------------------
# The money expression both revenue queries share: price * (100 - disc) / 100
# in f32 cents (identical op order to operators.money_times_pct).
# ----------------------------------------------------------------------------

def _disc_price() -> L.Expr:
    return col("l_extendedprice").f32() * (
        (lit(100) - col("l_discount")).f32() / lit(100.0)
    )


def _trim_topk(r: dict) -> dict:
    """Drop the top-k slots that never matched (the executor pads to k and
    marks real rows in ``_valid``)."""
    m = np.asarray(r["_valid"]).astype(bool)
    return {k: np.asarray(v)[m] for k, v in r.items() if k != "_valid"}


# ----------------------------------------------------------------------------
# Q1: pricing summary report — pure pre-aggregation, zero exchanges.
# ----------------------------------------------------------------------------

def q1(delta_days: int = 90) -> PlannedQuery:
    cutoff = date_to_days(1998, 12, 1) - delta_days
    li = Scan(
        "lineitem",
        ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
         "l_returnflag", "l_linestatus", "l_shipdate"),
    )
    f = Filter(li, col("l_shipdate") <= lit(cutoff))
    price = col("l_extendedprice").f32()
    disc = col("l_discount").f32() / lit(100.0)
    tax = col("l_tax").f32() / lit(100.0)
    disc_price = price * (lit(1.0) - disc)
    charge = disc_price * (lit(1.0) + tax)
    gid = col("l_returnflag") * lit(len(LINESTATUS)) + col("l_linestatus")
    g = GroupBy(
        f,
        aggs=(
            ("sum_qty", col("l_quantity"), "sum"),
            ("sum_base_price", price, "sum"),
            ("sum_disc_price", disc_price, "sum"),
            ("sum_charge", charge, "sum"),
            ("sum_disc", disc, "sum"),
            ("count_order", lit(1), "count"),
        ),
        key_expr=gid,
        num_groups=len(RETURNFLAGS) * len(LINESTATUS),
    )
    return PlannedQuery("q1", ("lineitem",), g, finalize=Q.q1_finalize)


# ----------------------------------------------------------------------------
# Q6: forecasting revenue change — filter + scalar aggregate, zero exchanges.
# ----------------------------------------------------------------------------

def q6(year: int = 1994) -> PlannedQuery:
    lo, hi = date_to_days(year, 1, 1), date_to_days(year + 1, 1, 1)
    li = Scan(
        "lineitem",
        ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate"),
    )
    d = col("l_discount")
    f = Filter(
        li,
        (col("l_shipdate") >= lit(lo)) & (col("l_shipdate") < lit(hi))
        & (d >= lit(5)) & (d <= lit(7)) & (col("l_quantity") < lit(24)),
    )
    revenue = col("l_extendedprice").f32() * (d.f32() / lit(100.0))
    agg = Aggregate(f, (("revenue", revenue, "sum"),))
    return PlannedQuery(
        "q6", ("lineitem",), agg, finalize=lambda r: r["revenue"]
    )


# ----------------------------------------------------------------------------
# Q17: small-quantity-order revenue — the paper's Fig 6 worked example.
# One broadcast (filtered part), ONE lineitem shuffle shared by the
# correlated-AVG group-by and the join back.
# ----------------------------------------------------------------------------

def q17(brand: int = 12, container: int = 2) -> PlannedQuery:
    li = Scan("lineitem", ("l_partkey", "l_quantity", "l_extendedprice"))
    pt = Scan("part", ("p_partkey", "p_brand", "p_container"))
    fpt = Filter(
        pt,
        col("p_brand").eq(lit(brand)) & col("p_container").eq(lit(container)),
    )
    semi = HashJoin(
        build=fpt, probe=li, build_key="p_partkey", probe_key="l_partkey"
    )
    g = GroupBy(
        semi,
        key="l_partkey",
        aggs=(
            ("sum_qty", col("l_quantity"), "sum"),
            ("cnt", lit(1), "count"),
        ),
    )
    avg = Project(
        g,
        keep=("l_partkey",),
        derived=(
            (
                "avg_qty",
                col("sum_qty")
                / where(col("cnt") < lit(1), lit(1.0), col("cnt").f32()),
            ),
        ),
    )
    back = HashJoin(
        build=avg, probe=semi, build_key="l_partkey", probe_key="l_partkey",
        payload=("avg_qty",),
    )
    small = Filter(back, col("l_quantity").f32() < lit(0.2) * col("avg_qty"))
    agg = Aggregate(small, (("revenue", col("l_extendedprice").f32(), "sum"),))
    return PlannedQuery(
        "q17", ("lineitem", "part"), agg,
        finalize=lambda r: r["revenue"] / 7.0,
    )


# ----------------------------------------------------------------------------
# Q3: shipping priority — 3-table join + distributed top-10.  The hybrid
# threshold broadcasts the customer side (10x smaller than orders).
# ----------------------------------------------------------------------------

def q3(segment: int = 1, cutoff: int | None = None) -> PlannedQuery:
    cutoff = date_to_days(1995, 3, 15) if cutoff is None else cutoff
    cu = Scan("customer", ("c_custkey", "c_mktsegment"))
    od = Scan("orders", ("o_orderkey", "o_custkey", "o_orderdate"))
    li = Scan(
        "lineitem",
        ("l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"),
    )
    fcu = Filter(cu, col("c_mktsegment").eq(lit(segment)))
    fod = Filter(od, col("o_orderdate") < lit(cutoff))
    j1 = HashJoin(
        build=fcu, probe=fod, build_key="c_custkey", probe_key="o_custkey"
    )
    keys = Project(j1, keep=("o_orderkey",))
    fli = Filter(li, col("l_shipdate") > lit(cutoff))
    j2 = HashJoin(
        build=keys, probe=fli, build_key="o_orderkey", probe_key="l_orderkey"
    )
    g = GroupBy(j2, key="l_orderkey", aggs=(("revenue", _disc_price(), "sum"),))
    named = Project(
        g, keep=("revenue",), derived=(("o_orderkey", col("l_orderkey")),)
    )
    top = TopK(named, key="revenue", k=10, payload=("o_orderkey", "revenue"))
    return PlannedQuery(
        "q3", ("customer", "orders", "lineitem"), top, finalize=_trim_topk
    )


# ----------------------------------------------------------------------------
# Q14: promotion effect — broadcast part, conditional revenue split.
# ----------------------------------------------------------------------------

def q14(year: int = 1995, month: int = 9, promo_brands: int = 5) -> PlannedQuery:
    lo = date_to_days(year, month, 1)
    hi = lo + 30
    li = Scan(
        "lineitem",
        ("l_partkey", "l_extendedprice", "l_discount", "l_shipdate"),
    )
    pt = Scan("part", ("p_partkey", "p_brand"))
    fli = Filter(
        li, (col("l_shipdate") >= lit(lo)) & (col("l_shipdate") < lit(hi))
    )
    j = HashJoin(
        build=pt, probe=fli, build_key="p_partkey", probe_key="l_partkey",
        payload=("p_brand",),
    )
    dp = _disc_price()
    agg = Aggregate(
        j,
        (
            ("promo", where(col("p_brand") < lit(promo_brands), dp, lit(0.0)),
             "sum"),
            ("total", dp, "sum"),
        ),
    )
    return PlannedQuery(
        "q14", ("lineitem", "part"), agg,
        finalize=lambda r: Q.q14_finalize(r["promo"], r["total"]),
    )


# ----------------------------------------------------------------------------
# Q19: discounted revenue — broadcast part, disjunction of range predicates.
# ----------------------------------------------------------------------------

def q19(terms=None) -> PlannedQuery:
    terms = terms or Q.Q19_TERMS
    li = Scan(
        "lineitem",
        ("l_partkey", "l_quantity", "l_extendedprice", "l_discount"),
    )
    pt = Scan("part", ("p_partkey", "p_brand", "p_container", "p_size"))
    j = HashJoin(
        build=pt, probe=li, build_key="p_partkey", probe_key="l_partkey",
        payload=("p_brand", "p_container", "p_size"),
    )
    keep = None
    for (b, c_lo, c_hi, q_lo, q_hi, s_hi) in terms:
        term = (
            col("p_brand").eq(lit(b))
            & (col("p_container") >= lit(c_lo))
            & (col("p_container") < lit(c_hi))
            & (col("l_quantity") >= lit(q_lo))
            & (col("l_quantity") <= lit(q_hi))
            & (col("p_size") >= lit(1))
            & (col("p_size") <= lit(s_hi))
        )
        keep = term if keep is None else keep | term
    f = Filter(j, keep)
    agg = Aggregate(f, (("revenue", _disc_price(), "sum"),))
    return PlannedQuery(
        "q19", ("lineitem", "part"), agg, finalize=lambda r: r["revenue"]
    )


# ----------------------------------------------------------------------------
# Q4: order priority checking — EXISTS as distinct-keys build side, dense
# priority group-by.  Plan-only (no hand-written counterpart ever existed).
# ----------------------------------------------------------------------------

def q4(year: int = 1993, month: int = 7) -> PlannedQuery:
    lo = date_to_days(year, month, 1)
    m2, y2 = (month + 3, year) if month + 3 <= 12 else (month - 9, year + 1)
    hi = date_to_days(y2, m2, 1)
    li = Scan("lineitem", ("l_orderkey", "l_commitdate", "l_receiptdate"))
    fli = Filter(li, col("l_commitdate") < col("l_receiptdate"))
    pli = Project(fli, keep=("l_orderkey",))
    distinct = GroupBy(
        pli, key="l_orderkey", aggs=(("n_late", lit(1), "count"),)
    )
    od = Scan("orders", ("o_orderkey", "o_orderdate", "o_orderpriority"))
    fod = Filter(
        od, (col("o_orderdate") >= lit(lo)) & (col("o_orderdate") < lit(hi))
    )
    pod = Project(fod, keep=("o_orderkey", "o_orderpriority"))
    j = HashJoin(
        build=distinct, probe=pod, build_key="l_orderkey",
        probe_key="o_orderkey",
    )
    g = GroupBy(
        j,
        key_expr=col("o_orderpriority"),
        num_groups=len(ORDERPRIORITIES),
        aggs=(("order_count", lit(1), "count"),),
    )
    return PlannedQuery("q4", ("lineitem", "orders"), g)


# ----------------------------------------------------------------------------
# Q12: shipmode priority split — co-partition orders x lineitem, dense
# shipmode group-by with conditional counts.  Plan-only.
# ----------------------------------------------------------------------------

def q12(year: int = 1994, modes: tuple[int, int] = (5, 3)) -> PlannedQuery:
    # default modes: MAIL (5) and SHIP (3) in datagen.SHIPMODES order
    lo, hi = date_to_days(year, 1, 1), date_to_days(year + 1, 1, 1)
    li = Scan(
        "lineitem",
        ("l_orderkey", "l_shipmode", "l_shipdate", "l_commitdate",
         "l_receiptdate"),
    )
    in_modes = None
    for m in modes:
        e = col("l_shipmode").eq(lit(m))
        in_modes = e if in_modes is None else in_modes | e
    fli = Filter(
        li,
        in_modes
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= lit(lo))
        & (col("l_receiptdate") < lit(hi)),
    )
    pli = Project(fli, keep=("l_orderkey", "l_shipmode"))
    od = Scan("orders", ("o_orderkey", "o_orderpriority"))
    j = HashJoin(
        build=od, probe=pli, build_key="o_orderkey", probe_key="l_orderkey",
        payload=("o_orderpriority",),
    )
    g = GroupBy(
        j,
        key_expr=col("l_shipmode"),
        num_groups=len(SHIPMODES),
        aggs=(
            ("high_line_count",
             where(col("o_orderpriority") < lit(2), lit(1), lit(0)), "sum"),
            ("low_line_count",
             where(col("o_orderpriority") >= lit(2), lit(1), lit(0)), "sum"),
        ),
    )
    return PlannedQuery("q12", ("lineitem", "orders"), g)


# ----------------------------------------------------------------------------
# Q18: large-volume customers — HAVING over a sorted group-by, two joins
# (partitioned orders, broadcast customer), top-100.  Plan-only.
# ----------------------------------------------------------------------------

def q18(threshold: int = 300, k: int = 100) -> PlannedQuery:
    # threshold 300 keeps the qualifying set well under k at the SFs the
    # tests/benchmarks run (28/38/92 orders at SF 0.005/0.01/0.02), so the
    # top-k boundary never has to tie-break between equal sums
    li = Scan("lineitem", ("l_orderkey", "l_quantity"))
    g = GroupBy(li, key="l_orderkey", aggs=(("sum_qty", col("l_quantity"), "sum"),))
    big = Filter(g, col("sum_qty") > lit(float(threshold)))
    od = Scan(
        "orders", ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice")
    )
    j1 = HashJoin(
        build=big, probe=od, build_key="l_orderkey", probe_key="o_orderkey",
        payload=("sum_qty",),
    )
    cu = Scan("customer", ("c_custkey", "c_mktsegment"))
    j2 = HashJoin(
        build=cu, probe=j1, build_key="c_custkey", probe_key="o_custkey",
        payload=("c_mktsegment",),
    )
    top = TopK(
        j2, key="o_totalprice", k=k,
        payload=("o_orderkey", "o_custkey", "c_mktsegment", "o_orderdate",
                 "o_totalprice", "sum_qty"),
    )
    return PlannedQuery(
        "q18", ("lineitem", "orders", "customer"), top, finalize=_trim_topk
    )


ALL_QUERIES: dict[str, Callable[..., PlannedQuery]] = {
    "q1": q1,
    "q3": q3,
    "q4": q4,
    "q6": q6,
    "q12": q12,
    "q14": q14,
    "q17": q17,
    "q18": q18,
    "q19": q19,
}


__all__ = [
    "PlannedQuery",
    "run_query",
    "explain_query",
    "tpch_catalog",
    "ALL_QUERIES",
    "q1",
    "q3",
    "q4",
    "q6",
    "q12",
    "q14",
    "q17",
    "q18",
    "q19",
]
