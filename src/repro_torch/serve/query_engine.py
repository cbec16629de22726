"""Multi-tenant query serving: continuous batching, applied to queries
(port of ``repro.serve.query_engine``).

A production engine faces a *stream* of concurrent queries from many
tenants, not one query at a time.  This module is the slot-map design of
:class:`~repro_torch.serve.engine.ContinuousEngine` one level up, with
queries as the unit of work and the shared mesh as the fixed resource:

* **admission queue + slot map** — a
  :class:`~repro_torch.serve.engine.SlotAllocator` over ``num_slots`` mesh
  compute slots (``free + live == num_slots`` at every round boundary).
  Between rounds, arrived requests are admitted under **fair-share/LPT**:
  the least-served tenant goes first (so a flooding tenant cannot starve a
  light one), and within a tenant the largest job (LPT over the scanned
  capacity) fills the slot.
* **plan + compile cache** — every request resolves its plan through a
  :class:`~repro_torch.relational.planner.plan_cache.PlanCache`, so a
  repeated template skips ``plan_physical`` entirely and reuses the
  memoized runner (its tables already padded and sharded on the device).
* **one shared multiplexer** — every plan's exchanges ride ONE multiplexer
  whose knobs are tuned over the union of every template's exchange shapes
  (:func:`repro_torch.core.autotune.tune_shared_config`).  The knobs freeze
  at first use: retuning would invalidate every memoized runner — so pass
  ``templates=`` at construction to tune over the full expected mix.
* **per-request TTFR + per-tenant SLOs** — each request records wall time
  from arrival to fetched result and how many scheduling rounds it queued;
  tenants accumulate SLO-violation counts against their declared ``slo_s``.

Execution inside one round is dispatch-then-collect, as in the reference:
every admitted query's work is enqueued on the device before any result
is fetched.  The engine runs on the card unless ``ctx.device`` is
``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np

from ..core.autotune import tune_shared_config
from ..core.exchange import make_mesh
from ..core.multiplexer import make_multiplexer
from ..core.topology import ChipSpec, V5E
from ..obs.trace import QueryTrace, deposit, maybe_span
from ..relational import stats as rstats
from ..relational.context import ExecutionContext, StatsMode, require_context
from ..relational.planner.physical import PhysicalPlan, plan_physical
from ..relational.planner.plan_cache import PlanCache, PlanKey, plan_key
from ..relational.planner.tpch import PlannedQuery
from ..relational.table import Table, resolve_device
from .engine import SlotAllocator


@dataclasses.dataclass
class QueryRequest:
    """One query in the stream: who wants it, what template, when it lands."""

    tenant: str
    query: PlannedQuery
    arrival_round: int = 0         # scheduling-round tick of arrival
    slo_s: float | None = None     # per-request latency SLO (None: no SLO)
    # --- filled in by the engine -------------------------------------------
    admitted_round: int | None = None
    finished_round: int | None = None
    queue_rounds: int = 0          # rounds spent arrived-but-unadmitted
    ttfr_s: float | None = None    # wall from arrival to fetched result
    plan_cache_hit: bool | None = None
    executor_cache_hit: bool | None = None
    result: Any = None
    #: This run's device-side measurement (per-edge exchange bytes,
    #: histograms, model predictions), collected per request: the runner is
    #: shared across requests, so the trace lives here, not on it.
    trace: QueryTrace | None = None
    _t_arrive: float | None = dataclasses.field(default=None, repr=False)


class QueryServeEngine:
    """Admit a stream of :class:`QueryRequest`\\ s onto one shared mesh.

    ``tables`` is the engine's resident data (the memoized runners hold
    padded copies of it — one engine, one table set).  ``ctx`` is the
    engine-wide :class:`~repro_torch.relational.context.ExecutionContext`:
    mesh shape, device and stats mode (``StatsMode.COLLECT`` profiles the
    tables once at construction so plans are skew-aware;
    ``StatsMode.PROFILE`` uses ``ctx.stats_profile``; STATIC keeps static
    plans).  ``ctx.trace`` attaches a tracer: every admission round and
    request becomes a span, and each request's :class:`QueryTrace` is
    deposited.  ``cache`` defaults to a fresh in-process :class:`PlanCache`;
    give one a ``cache_dir`` and plans persist across engine processes.
    Without a CUDA device, anything but ``ctx.device="cpu"`` raises here.
    """

    def __init__(
        self,
        tables: Mapping[str, Table],
        ctx: ExecutionContext | None = None,
        *,
        num_slots: int = 2,
        cache: PlanCache | None = None,
        chip: ChipSpec = V5E,
        topology: str = "ring",
        templates: Sequence[PlannedQuery] | None = None,
    ):
        if ctx is None:
            ctx = ExecutionContext()
        ctx = require_context(ctx, where="QueryServeEngine")
        resolve_device(ctx.device)
        self.ctx = ctx
        self.tables = dict(tables)
        self.num_shards = ctx.num_shards
        self.num_pods = ctx.num_pods
        self.alloc = SlotAllocator(num_slots)
        self.cache = cache if cache is not None else PlanCache()
        if ctx.stats_mode is StatsMode.COLLECT:
            self.stats = rstats.collect_stats(self.tables)
        elif ctx.stats_mode is StatsMode.PROFILE:
            self.stats = dict(ctx.stats_profile)
        else:
            self.stats = None
        self.chip = chip
        self.topology = topology
        self.rounds = 0
        self.served: list[QueryRequest] = []
        self.tenants: dict[str, dict] = {}
        self._service: dict[str, int] = {}  # fair-share counters
        self._plan_stats: dict[str, tuple] = {}  # digest -> shuffle_stats
        self._mux = None
        self._data_token = f"tables@{id(self):x}"
        for pq in templates or ():
            self._plan_for(pq)  # warm the plan cache + register exchange shapes

    # -- planning through the cache ----------------------------------------

    def _plan_for(self, pq: PlannedQuery) -> tuple[PhysicalPlan, PlanKey, bool]:
        catalog = {t: self.tables[t].capacity for t in pq.tables}
        stats = (
            {t: self.stats[t] for t in pq.tables if t in self.stats}
            if self.stats
            else None
        )
        key = plan_key(
            pq.logical, catalog, self.num_shards, num_pods=self.num_pods,
            chip=self.chip, topology=self.topology, stats=stats,
        )
        plan, hit = self.cache.get_plan(
            key,
            lambda: plan_physical(
                pq.logical, catalog, self.num_shards,
                num_pods=self.num_pods, chip=self.chip,
                topology=self.topology, name=pq.name, stats=stats,
            ),
        )
        self._plan_stats.setdefault(key.digest, tuple(plan.shuffle_stats))
        return plan, key, hit

    def _ensure_mux(self):
        """The one shared multiplexer, tuned over every registered plan's
        exchange shapes the first time a runner needs it."""
        if self._mux is None:
            tuned = tune_shared_config(
                self.num_shards,
                list(self._plan_stats.values()),
                num_pods=self.num_pods,
                chip=self.chip,
                topology=self.topology,
            )
            self.shared_tuned = tuned
            self._mux = make_multiplexer(
                make_mesh(self.num_shards, self.num_pods),
                impl=tuned.impl,
                pack_impl=tuned.pack_impl,
                pipeline_chunks=tuned.pipeline_chunks,
                transport_chunks=tuned.transport_chunks,
            )
            if self.ctx.trace is not None:
                self.ctx.trace.add_span(
                    "mux:shared", cat="serve", **self._mux.describe()
                )
        return self._mux

    def _runner(self, req: QueryRequest):
        plan, key, plan_hit = self._plan_for(req.query)
        runner, exec_hit = self.cache.executor(
            key, plan, self.tables,
            data_token=self._data_token, mux=self._ensure_mux(),
            ctx=self.ctx,
        )
        req.plan_cache_hit = plan_hit
        req.executor_cache_hit = exec_hit
        return runner

    # -- scheduling ---------------------------------------------------------

    def _job_size(self, pq: PlannedQuery) -> int:
        """LPT job-size estimate: total capacity the query scans (known
        before planning, deterministic)."""
        return sum(self.tables[t].capacity for t in pq.tables)

    def _pick(self, arrived: list[QueryRequest]) -> QueryRequest:
        """Fair-share across tenants, LPT within the chosen tenant.

        The least-served tenant (ties: name order) supplies the next job;
        among that tenant's arrived requests the largest scan wins (ties:
        arrival order, since ``max`` keeps the first maximum).
        """
        tenant = min(
            {r.tenant for r in arrived},
            key=lambda t: (self._service.get(t, 0), t),
        )
        mine = [r for r in arrived if r.tenant == tenant]
        return max(mine, key=lambda r: self._job_size(r.query))

    def serve(
        self, requests: Sequence[QueryRequest], max_rounds: int = 100_000
    ) -> list[QueryRequest]:
        """Run the stream to completion; returns requests in finish order.

        Queries complete within their round, so every round frees its
        slots: the scheduler can never deadlock, and the slot invariant is
        re-checked at each round boundary.
        """
        waiting = sorted(
            requests, key=lambda r: r.arrival_round
        )  # stable: preserves submission order within a tick
        done: list[QueryRequest] = []
        rnd = self.rounds
        while waiting:
            arrived = [r for r in waiting if r.arrival_round <= rnd]
            now = time.perf_counter()
            for r in arrived:
                if r._t_arrive is None:
                    r._t_arrive = now
            batch: list[tuple[int, QueryRequest]] = []
            while self.alloc.num_free and arrived:
                r = self._pick(arrived)
                arrived.remove(r)
                waiting.remove(r)
                slot = self.alloc.admit(r)
                r.admitted_round = rnd
                self._service[r.tenant] = self._service.get(r.tenant, 0) + 1
                batch.append((slot, r))
            for r in arrived:
                r.queue_rounds += 1
            # Dispatch every admitted query before collecting any; results
            # and traces come back per request from collect(), since a
            # runner is shared (memoized) across the batch.
            tracer = self.ctx.trace
            with maybe_span(tracer, f"admission-round:{rnd}", "serve",
                            admitted=len(batch), queued=len(arrived)):
                launched = []
                for slot, r in batch:
                    runner = self._runner(r)
                    t0 = time.perf_counter()
                    launched.append((slot, r, runner, runner.dispatch(), t0))
                for slot, r, runner, out, t0 in launched:
                    with maybe_span(tracer, f"request:{r.query.name}",
                                    "serve", tenant=r.tenant):
                        raw, qt = runner.collect(out, t_dispatch=t0)
                    r.trace = qt
                    deposit(tracer, qt)
                    r.result = (
                        r.query.finalize(raw) if r.query.finalize else raw
                    )
                    r.ttfr_s = time.perf_counter() - r._t_arrive
                    r.finished_round = rnd
                    self.alloc.release(slot)
                    self._account(r)
                    done.append(r)
            self.alloc.check()
            rnd += 1
            if rnd - self.rounds > max_rounds:
                raise RuntimeError(
                    f"serve exceeded {max_rounds} rounds with "
                    f"{len(waiting)} requests still queued"
                )
        self.rounds = rnd
        self.served.extend(done)
        return done

    # -- accounting ---------------------------------------------------------

    def _account(self, r: QueryRequest) -> None:
        rec = self.tenants.setdefault(
            r.tenant,
            {"ttfr_s": [], "slo_violations": 0, "max_queue_rounds": 0},
        )
        rec["ttfr_s"].append(r.ttfr_s)
        rec["max_queue_rounds"] = max(rec["max_queue_rounds"], r.queue_rounds)
        if r.slo_s is not None and r.ttfr_s > r.slo_s:
            rec["slo_violations"] += 1

    def tenant_report(self) -> dict[str, dict]:
        """Per-tenant SLO accounting: served count, TTFR mean/p50/p99,
        violations, worst queueing."""
        out = {}
        for tenant in sorted(self.tenants):
            rec = self.tenants[tenant]
            tt = np.asarray(rec["ttfr_s"], dtype=np.float64)
            out[tenant] = dict(
                served=int(tt.size),
                ttfr_mean_s=float(tt.mean()),
                ttfr_p50_s=float(np.percentile(tt, 50)),
                ttfr_p99_s=float(np.percentile(tt, 99)),
                slo_violations=int(rec["slo_violations"]),
                max_queue_rounds=int(rec["max_queue_rounds"]),
            )
        return out

    def record(self) -> dict:
        """Engine-level record (the launcher prints this)."""
        tt = np.asarray(
            [r.ttfr_s for r in self.served if r.ttfr_s is not None],
            dtype=np.float64,
        )
        out = dict(
            served=len(self.served),
            rounds=self.rounds,
            num_slots=self.alloc.num_slots,
            cache=self.cache.record(),
            tenants=self.tenant_report(),
        )
        if tt.size:
            out.update(
                ttfr_p50_s=float(np.percentile(tt, 50)),
                ttfr_p99_s=float(np.percentile(tt, 99)),
            )
        return out


def make_query_mix(
    templates: Sequence[PlannedQuery],
    tenants: Sequence[str],
    num_requests: int,
    seed: int = 0,
    max_arrival_round: int = 4,
    slo_s: float | None = None,
) -> list[QueryRequest]:
    """Seeded multi-tenant TPC-H-mix workload: uniform draws over
    templates and tenants, arrivals over the first ``max_arrival_round +
    1`` rounds (the reference's draws, in its order)."""
    rng = np.random.default_rng(seed)
    return [
        QueryRequest(
            tenant=str(rng.choice(list(tenants))),
            query=templates[int(rng.integers(len(templates)))],
            arrival_round=int(rng.integers(max_arrival_round + 1)),
            slo_s=slo_s,
        )
        for _ in range(num_requests)
    ]


__all__ = [
    "QueryRequest",
    "QueryServeEngine",
    "make_query_mix",
]
