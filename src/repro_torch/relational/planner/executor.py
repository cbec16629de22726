"""Plan executor on the simulated fabric (port of ``repro.relational.planner.executor``).

The reference compiles a plan into one per-device body under ``shard_map``.
Here the body runs once, eagerly, on tables whose columns carry an explicit
leading shard dim ``[S, T]``: base tables are padded and dealt round-robin
onto ``S = num_shards`` shards, every ``Exchange`` edge is routed through ONE
per-query :class:`~repro_torch.core.multiplexer.CommMultiplexer` (knobs from
the plan-time tuner unless the context pins them), local operators come from
``relational/operators.py``, and the final combine is a sum over the shard
dim (dense group-bys, scalar aggregates) or a broadcast top-k merge;
replicated results are read from shard 0, as ``out_specs=P()`` would.
On a mesh that spans processes each process holds its own pods' shards
and every combine (histograms, sums, top-k) gathers all units' partials,
so every process computes the same global value in the same order.

Capacities are the static zero-drop bound; the drop count of every exchange
is summed and any overflow raises instead of silently losing rows.  Two-level
meshes (``num_pods > 1``) route shuffles through the coarse cross-pod + fine
in-pod exchange and obey the plan's ``cross_pod`` strategy.

Every shuffle measures its global destination histogram on the device;
``runner.collect(out)`` returns the result together with the run's
:class:`~repro_torch.obs.trace.QueryTrace` (per-edge measured against
modeled bytes), and mutates nothing on the runner.
"""

from __future__ import annotations

import math
import time
import warnings

import torch

from ...core.exchange import SHUFFLE_AXIS, Mesh, make_mesh, unit_sum
from ...core.multiplexer import CommMultiplexer, make_multiplexer
from ...kernels.ref import fibonacci_hash
from ...obs.model_check import build_query_trace, edge_models
from ...obs.trace import QueryTrace
from .. import operators as ops
from ..context import ExecutionContext, require_context
from ..source import DataSource
from ..table import Table, pad_to, resolve_device, shard_rows
from .physical import PhysicalPlan, PNode


def _prep(table: Table, mesh: Mesh, device) -> Table:
    """Pad and deal a flat table onto the mesh's units: row ``i`` goes to
    global shard ``i % S``; this process keeps its own units' shards."""
    S = mesh.num_units
    cap = math.ceil(table.capacity / S) * S
    keep = range(mesh.unit_offset, mesh.unit_offset + mesh.local_units)
    return shard_rows(pad_to(table.to(device), cap), S, keep=keep)


def _make_mux(
    mesh, plan: PhysicalPlan, impl: str, pack_impl: str | None,
    num_chunks: int | None,
) -> CommMultiplexer:
    """One multiplexer per query.

    ``impl="auto"`` applies the plan-time tuned knobs (so ``explain()``
    describes exactly what runs), with any explicitly passed knob pinned
    over the tuner's choice.  An explicit ``impl`` uses the caller's knobs,
    with the kernel pack and one pipeline chunk where they are unset: every
    shuffle of a pinned transport goes through the pack kernel (on CPU
    tensors the wrapper runs its plain version).
    """
    resolved = plan.tuned.cross_pod or "broadcast"
    if impl == "auto":
        t = plan.tuned
        return make_multiplexer(
            mesh,
            impl=t.impl,
            pack_impl=pack_impl or t.pack_impl,
            pipeline_chunks=num_chunks or t.pipeline_chunks,
            transport_chunks=t.transport_chunks,
            cross_pod=resolved,
        )
    return make_multiplexer(
        mesh, impl=impl, pack_impl=pack_impl or "cuda",
        pipeline_chunks=num_chunks or 1, cross_pod=resolved,
    )


def _exchange_by_key(
    mux: CommMultiplexer, tbl: Table, key_name: str, columns: list[str],
    route_keys: torch.Tensor | None = None,
) -> tuple[Table, torch.Tensor]:
    """Decoupled exchange: repartition rows by hash(key) over the mesh.

    Columns ship as one int32 row image ``[S, T, C]``; the capacity per
    (src, dst) message is the local capacity, the static zero-drop bound.
    ``route_keys`` overrides the ROUTING key only (the salted
    repartitioning).  Returns ``(table, dropped [S])``.
    """
    for c in columns:
        if tbl[c].dtype.is_floating_point:
            raise TypeError(
                f"exchange of non-integer column {c!r} ({tbl[c].dtype}): "
                "the packed row image is int32 — keep float aggregates "
                "local (group after the exchange, not before)"
            )
    cap = tbl.valid.shape[1]
    rows = torch.stack([tbl[c].to(torch.int32) for c in columns], dim=2)
    keys = tbl[key_name] if route_keys is None else route_keys
    out_rows, out_valid, dropped = mux.hash_shuffle_global(
        keys.to(torch.int32), rows, SHUFFLE_AXIS, capacity=cap, valid=tbl.valid,
    )
    cols = {c: out_rows[:, :, i] for i, c in enumerate(columns)}
    return Table(cols, out_valid), dropped


def _pair_counts(
    keys: torch.Tensor, valid: torch.Tensor, num_shards: int
) -> torch.Tensor:
    """Rows each shard sends each destination, ``[S, N]`` int32, under the
    exchange's routing rule (``hash % N`` over the global shard count)."""
    dest = fibonacci_hash(keys.to(torch.int32)) % num_shards
    local = torch.zeros((keys.shape[0], num_shards), dtype=torch.int32, device=keys.device)
    local.scatter_add_(1, dest, valid.to(torch.int32))
    return local


def _shuffle_histogram(
    keys: torch.Tensor, valid: torch.Tensor, mesh: Mesh
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global per-destination row histogram ``[N]`` of a (routing-key,
    valid) pair under the exchange's routing rule, plus
    ``max_load / fair_share``; the same on every process, so every process
    takes the same salting decision."""
    num_shards = mesh.num_units
    hist = unit_sum(_pair_counts(keys, valid, num_shards), mesh)
    total = hist.sum().clamp(min=1).to(torch.float32)
    overload = hist.max().to(torch.float32) * num_shards / total
    return hist, overload


def _route_and_report(
    tbl: Table, node: PNode, mesh: Mesh
) -> tuple[torch.Tensor | None, dict]:
    """Runtime re-optimization of one shuffle edge (paper §3.1).

    Every shuffle measures its destination histogram.  On an edge the
    planner marked salted, the MEASURED plain overload is compared to the
    plan's runtime threshold on the device: above it, heavy-key rows switch
    to the salted route (``key * num_salts + salt``, the salt hashed from
    the global row position); below it the exchange stays a plain hash.
    Returns the routing-key override (None = plain) and the report entry.
    """
    info = node.info
    keys = tbl[info["key"]].to(torch.int32)
    hist_plain, over_plain = _shuffle_histogram(keys, tbl.valid, mesh)
    if not info.get("salted"):
        return None, {
            "hist": hist_plain,
            "overload": over_plain,
            "plain_overload": over_plain,
            "salted": torch.tensor(False),
        }
    s = int(info["num_salts"])
    dev = keys.device
    heavy = torch.tensor(info["heavy_keys"], dtype=torch.int32, device=dev)
    do_salt = over_plain > info["runtime_threshold"]  # compared in f32
    # Per-row salt from the global row position (uint32 arithmetic).
    gidx = mesh.unit_offset + torch.arange(keys.shape[0], device=dev, dtype=torch.int64)[:, None]
    iota = torch.arange(keys.shape[1], device=dev, dtype=torch.int64)[None, :]
    rsalt = (fibonacci_hash((iota + gidx * 0x9E3779B9) & 0xFFFFFFFF) % s).to(torch.int32)
    salted_keys = keys * s + rsalt
    route = torch.where(
        do_salt & torch.isin(keys, heavy) & tbl.valid, salted_keys, keys
    )
    hist, overload = _shuffle_histogram(route, tbl.valid, mesh)
    return route, {
        "hist": hist,
        "overload": overload,
        "plain_overload": over_plain,
        "salted": do_salt,
    }


def _broadcast_table(
    mux: CommMultiplexer, tbl: Table, columns: list[str]
) -> tuple[Table, torch.Tensor]:
    """Deliver a join's (small) build side to where the probe rows are:
    in-pod ring all-gather, then (pod meshes) one coarse all-gather."""
    S = tbl.valid.shape[0]
    cols = {
        c: mux.broadcast_global(tbl[c], SHUFFLE_AXIS).reshape(S, -1) for c in columns
    }
    v = mux.broadcast_global(tbl.valid, SHUFFLE_AXIS).reshape(S, -1)
    return Table(cols, v), torch.zeros(S, dtype=torch.int32, device=v.device)


def _report_keys(root: PNode) -> dict[int, str]:
    """Stable per-edge report keys: the shuffle's first-visit ordinal plus
    its key column (``shuffle[l_partkey]#0``)."""
    seen: set[int] = set()
    order: list[PNode] = []

    def walk(n: PNode):
        if id(n) in seen:
            return
        seen.add(id(n))
        if n.kind == "exchange" and n.info["exkind"] == "shuffle":
            order.append(n)
        for c in n.children:
            walk(c)

    walk(root)
    return {
        id(n): f"shuffle[{n.info['key']}]#{j}" for j, n in enumerate(order)
    }


def _raise_on_dropped(query: str, dropped: torch.Tensor) -> None:
    """Capacity overflow is an error, not silent row loss."""
    d = int(dropped)
    if d:
        raise RuntimeError(
            f"{query}: exchange dropped {d} rows to capacity overflow — "
            "results would silently lose rows; raise the capacity bound"
        )


def _column(v, like: torch.Tensor) -> torch.Tensor:
    """An expression's value as a full column (a literal broadcasts)."""
    if isinstance(v, torch.Tensor) and v.shape == like.shape:
        return v
    return torch.as_tensor(v, device=like.device).expand(like.shape)


def _fetch(result: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in result.items()}


def _resolve_exec_ctx(plan: PhysicalPlan, ctx, where: str) -> ExecutionContext:
    """The context for this plan: the plan's own mesh on the card when
    omitted, else an :class:`ExecutionContext` whose mesh shape matches the
    plan's."""
    if ctx is None:
        ctx = ExecutionContext(plan.num_shards, num_pods=plan.num_pods)
    ctx = require_context(ctx, where=where)
    if (ctx.num_shards, ctx.num_pods) != (plan.num_shards, plan.num_pods):
        raise ValueError(
            f"{where}: context mesh {ctx.num_shards}x{ctx.num_pods} does "
            f"not match the plan's {plan.num_shards}x{plan.num_pods}"
        )
    return ctx


def _resident_table(name: str, obj) -> Table:
    """Coerce a Table-or-DataSource to an in-memory Table (the executor's
    unit of work); chunked sources belong to the streamed path."""
    if isinstance(obj, Table):
        return obj
    if isinstance(obj, DataSource):
        if obj.is_chunked:
            raise ValueError(
                f"table {name!r} is a chunked DataSource; in-memory "
                "execution cannot hold it — run through run_query (or "
                "stream.compile_plan_streamed) for out-of-core execution"
            )
        return obj.materialize()
    raise TypeError(f"table {name!r}: expected Table or DataSource, got {type(obj)!r}")


def _check_row_budget(plan: PhysicalPlan, tables: dict[str, Table], ctx) -> None:
    """``device_row_budget`` is a hard promise: in-memory execution refuses
    base tables whose per-shard slice exceeds it (chunk them instead)."""
    if ctx.device_row_budget is None:
        return
    for name in plan.scans:
        per_shard = math.ceil(tables[name].capacity / plan.num_shards)
        if per_shard > ctx.device_row_budget:
            raise ValueError(
                f"table {name!r} needs {per_shard} rows/device, over "
                f"device_row_budget={ctx.device_row_budget}; stream it as a "
                "chunked DataSource (run_query with morsel_rows) instead"
            )


def execute_plan(plan: PhysicalPlan, tables: dict, ctx: ExecutionContext | None = None) -> dict:
    """Run a physical plan over real data; returns the fetched result dict.

    ``tables`` maps base-table names to :class:`Table`\\ s or
    :class:`~repro_torch.relational.source.DataSource`\\ s whose capacities
    match the catalog the plan was built from.  A chunked source switches
    to morsel-streamed out-of-core execution
    (:func:`~repro_torch.relational.planner.stream.compile_plan_streamed`);
    everything resident runs the in-memory path.
    """
    ctx = _resolve_exec_ctx(plan, ctx, where="execute_plan")
    if any(isinstance(t, DataSource) and t.is_chunked for t in tables.values()):
        from .stream import compile_plan_streamed

        return compile_plan_streamed(plan, tables, ctx)()
    return compile_plan(plan, tables, ctx)()


def compile_plan(
    plan: PhysicalPlan,
    tables: dict,
    ctx: ExecutionContext | None = None,
    mux: CommMultiplexer | None = None,
):
    """Prepare a plan for execution: check the tables against the plan's
    catalog and ``ctx.device_row_budget``, move them to ``ctx.device``, pad
    and shard them, build the multiplexer.  Returns a
    :class:`CompiledRunner`.

    ``tables`` maps base-table names to :class:`Table`\\ s or single-chunk
    DataSources; a chunked source is refused (it streams through
    :func:`execute_plan` or ``stream.compile_plan_streamed``).  ``ctx``
    carries the device and the multiplexer knobs (its mesh shape must match
    the plan's); omitted, the plan's own mesh on the card with the tuned
    knobs applies.  ``mux`` injects a shared multiplexer (the query-serving
    engine tunes one knob set over every plan it serves and passes it here).

    The runner is callable (run to completion) or split-phase:
    ``dispatch()`` enqueues the plan's work on the device, ``collect(out)``
    fetches and checks it and returns ``(result, QueryTrace)`` without
    touching the runner, ``finalize(out)`` also records ``last_trace``.
    With ``ctx.trace`` set, the multiplexer's knobs are recorded as a
    ``mux:<query>`` span; the runner itself holds no tracer, since it may
    be memoized and shared with untraced contexts.
    """
    ctx = _resolve_exec_ctx(plan, ctx, where="compile_plan")
    tables = {name: _resident_table(name, tables[name]) for name in plan.scans}
    _check_row_budget(plan, tables, ctx)
    device = resolve_device(ctx.device)
    for name in plan.scans:
        if tables[name].capacity != plan.catalog[name]:
            raise ValueError(
                f"table {name!r} has capacity {tables[name].capacity} but the "
                f"plan was built for {plan.catalog[name]}; re-plan for the "
                "actual tables"
            )
    mesh = make_mesh(plan.num_shards, plan.num_pods)
    if mux is None:
        mux = _make_mux(mesh, plan, ctx.impl, ctx.pack_impl, ctx.num_chunks)
    if ctx.trace is not None:
        ctx.trace.add_span(f"mux:{plan.name}", cat="compile", **mux.describe())
    prepped = {name: _prep(tables[name], mesh, device) for name in plan.scans}
    return CompiledRunner(plan, mux, prepped, edge_models(plan))


class _NodeEval:
    """Memoized evaluator of a physical plan's nodes over sharded tables
    (called as ``ev(node)``).

    It evaluates the node kinds every executor shares (scan, filter,
    project, join) and hands exchanges to :meth:`exchange` and every other
    kind to :meth:`other`, which the in-memory and the streamed executors
    define.  An object rather than closures that call each other: such a
    pair is a reference cycle, which would keep a run's intermediates alive
    until the cycle collector ran.
    """

    def __init__(self, tabs: dict):
        self.tabs = tabs
        self.memo: dict[int, object] = {}

    def __call__(self, n: PNode):
        if id(n) not in self.memo:
            self.memo[id(n)] = self._eval(n)
        return self.memo[id(n)]

    def agg_dict(self, t: Table, aggs) -> dict:
        return {name: (_column(e.eval(t), t.valid), kind) for name, e, kind in aggs}

    def scan(self, n: PNode) -> Table:
        src = self.tabs[n.info["table"]]
        return Table({c: src[c] for c in n.schema}, src.valid)

    def exchange(self, n: PNode) -> Table:
        raise NotImplementedError

    def other(self, n: PNode):
        raise NotImplementedError

    def _eval(self, n: PNode):
        if n.kind == "scan":
            return self.scan(n)
        if n.kind == "filter":
            t = self(n.children[0])
            return t.with_mask(n.info["pred"].eval(t))
        if n.kind == "project":
            t = self(n.children[0])
            cols = {c: t[c] for c in n.info["keep"]}
            for name, e in n.info["derived"]:
                cols[name] = _column(e.eval(t), t.valid)
            return Table(cols, t.valid)
        if n.kind == "join":
            b, p = self(n.children[0]), self(n.children[1])
            bidx, match = ops.join_pk(
                b[n.info["build_key"]], b.valid,
                p[n.info["probe_key"]], p.valid,
            )
            cols = dict(p.columns)
            cols.update(ops.gather_payload(b, bidx, match, list(n.info["payload"])))
            return Table(cols, match)
        if n.kind == "exchange":
            return self.exchange(n)
        return self.other(n)


class _InMemoryEval(_NodeEval):
    """The in-memory executor's evaluator: whole tables, every exchange at
    its zero-drop bound, breakers combined over the shard dim."""

    def __init__(self, tabs: dict, mux: CommMultiplexer, report_keys: dict):
        super().__init__(tabs)
        self.mux, self.mesh, self.report_keys = mux, mux.mesh, report_keys
        self.num_shards = mux.mesh.num_units
        self.drops: list[torch.Tensor] = []
        self.reports: dict[str, dict] = {}

    def exchange(self, n: PNode) -> Table:
        t = self(n.children[0])
        if self.num_shards == 1:  # hash % 1 == 0: the exchange is the identity
            return t
        if n.info["exkind"] == "shuffle":
            route, rep = _route_and_report(t, n, self.mesh)
            out, d = _exchange_by_key(
                self.mux, t, n.info["key"], list(n.schema), route_keys=route,
            )
            self.reports[self.report_keys[id(n)]] = rep
        else:
            out, d = _broadcast_table(self.mux, t, list(n.schema))
        self.drops.append(d[0])
        return out

    def other(self, n: PNode):
        if n.kind == "groupby_sorted":
            t = self(n.children[0])
            gkeys, gvalid, out = ops.groupby_sorted(
                t[n.info["key"]], t.valid, self.agg_dict(t, n.info["aggs"])
            )
            return Table({n.info["key"]: gkeys, **out}, gvalid)
        if n.kind == "groupby_combine":
            # merge salted partials: every shard holds ALL partial groups
            # (they arrive by broadcast); re-grouping by the true key and
            # re-summing partial sums and counts gives the exact global
            # aggregate, replicated.
            t = self(n.children[0])
            aggs = {name: (t[name], "sum") for name, _e, _k in n.info["aggs"]}
            gkeys, gvalid, out = ops.groupby_sorted(t[n.info["key"]], t.valid, aggs)
            return Table({n.info["key"]: gkeys, **out}, gvalid)
        if n.kind == "groupby_dense":
            t = self(n.children[0])
            res = ops.groupby_dense(
                n.info["key_expr"].eval(t),
                n.info["num_groups"],
                self.agg_dict(t, n.info["aggs"]),
                t.valid,
            )
            return {k: unit_sum(v, self.mesh) for k, v in res.items()}
        if n.kind == "aggregate":
            t = self(n.children[0])
            out = {}
            for name, e, kind in n.info["aggs"]:
                local = (
                    ops.sum_where(_column(e.eval(t), t.valid), t.valid)
                    if kind == "sum"
                    else ops.count_where(t.valid)
                )
                out[name] = unit_sum(local, self.mesh)
            return out
        if n.kind == "topk":
            t = self(n.children[0])
            k = n.info["k"]
            vals, payload = ops.topk_rows(
                t[n.info["key"]], t.valid, k,
                {c: t[c] for c in n.info["payload"]},
            )
            if self.num_shards == 1:
                return {
                    **{c: col[0] for c, col in payload.items()},
                    "_valid": ~torch.isneginf(vals[0]),
                }
            S = vals.shape[0]
            # every shard gathers every candidate; shard 0's copy is the
            # replicated result
            mux = self.mux
            all_vals = mux.broadcast_global(vals, SHUFFLE_AXIS).reshape(S, -1)[0]
            gathered = {
                c: mux.broadcast_global(col, SHUFFLE_AXIS).reshape(S, -1)[0]
                for c, col in payload.items()
            }
            top_vals, idx = ops.topk_order(all_vals, k)
            out = {c: col[idx] for c, col in gathered.items()}
            out["_valid"] = ~torch.isneginf(top_vals)
            return out
        raise TypeError(f"unknown physical node kind {n.kind!r}")


class RunnerBase:
    """Shared surface of the in-memory and streamed runners.

    Per-run telemetry travels through ``collect``'s return value, not the
    runner: compiled runners are memoized and shared across concurrent
    callers, so a mutable report attribute would race.  ``last_trace`` and
    the deprecated ``exchange_report`` view show the LAST finalized run,
    for single-caller code.
    """

    _last_trace: QueryTrace | None = None

    @property
    def last_trace(self) -> QueryTrace | None:
        """The :class:`QueryTrace` of the most recent finalized run (None
        before the first)."""
        return self._last_trace

    @property
    def exchange_report(self) -> dict:
        """Deprecated last-run report view; racy under concurrency."""
        warnings.warn(
            "run.exchange_report is deprecated: it reflects only the LAST "
            "finalized run, which races under concurrent serving. Use "
            "result, trace = run.collect(run.dispatch()) and "
            "trace.exchange_report() (or trace.edges) instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        qt = self._last_trace
        return qt.exchange_report() if qt is not None else {}


def _fetch_reports(reports: dict) -> dict:
    """Per-edge reports on the host, in key order (the order the reference
    fetches them in: a JAX pytree sorts dict keys): the histogram as int64
    numpy, the overloads as floats, the salting decision as a bool."""
    return {
        key: {
            "hist": rep["hist"].cpu().numpy().astype("int64"),
            "overload": float(rep["overload"]),
            "plain_overload": float(rep["plain_overload"]),
            "salted": bool(rep["salted"]),
        }
        for key, rep in sorted(reports.items())
    }


class CompiledRunner(RunnerBase):
    """Zero-arg in-memory runner with split-phase dispatch/collect.

    ``dispatch()`` runs the plan and returns ``(result, dropped, reports)``
    on the device; ``collect`` raises on any dropped row, fetches the
    result to numpy and builds the run's trace; calling the runner does
    both and records ``last_trace``."""

    def __init__(self, plan: PhysicalPlan, mux: CommMultiplexer, tables: dict, models: dict):
        self.plan = plan
        self.mux = mux
        self._tables = tables
        self._models = models
        self._report_keys = _report_keys(plan.root)

    def dispatch(self):
        plan = self.plan
        ev = _InMemoryEval(self._tables, self.mux, self._report_keys)
        result = ev(plan.root)
        device = next(iter(self._tables.values())).device
        dropped = torch.stack(ev.drops).sum() if ev.drops else torch.zeros(
            (), dtype=torch.int32, device=device
        )
        return result, dropped, ev.reports

    def collect(self, out, t_dispatch: float | None = None):
        """Fetch and check a ``dispatch()`` result; returns ``(result,
        QueryTrace)`` without touching runner state (safe when one runner
        serves several requests).  ``t_dispatch`` (a ``time.perf_counter()``
        reading taken just before ``dispatch``) prices the trace's measured
        wall, which ends when the result has reached the host: the fetch
        waits for the device."""
        result, dropped, reports = out
        _raise_on_dropped(self.plan.name, dropped)
        fetched = _fetch(result)
        measured = time.perf_counter() - t_dispatch if t_dispatch is not None else None
        qt = build_query_trace(
            self.plan, _fetch_reports(reports), self._models, measured_s=measured
        )
        return fetched, qt

    def finalize(self, out, t_dispatch: float | None = None) -> dict:
        """``collect`` plus last-trace bookkeeping; returns the result."""
        result, qt = self.collect(out, t_dispatch)
        self._last_trace = qt
        return result

    def __call__(self) -> dict:
        t0 = time.perf_counter()
        return self.finalize(self.dispatch(), t_dispatch=t0)


__all__ = [
    "execute_plan",
    "compile_plan",
    "RunnerBase",
    "CompiledRunner",
]
