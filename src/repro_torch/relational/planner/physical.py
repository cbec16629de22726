"""Cost-based physical planner (paper §3.1 / Fig 6); port of
``repro.relational.planner.physical``, pure Python like the reference.

Turns a logical DAG into a physical plan by deciding, per join/group
boundary, where an exchange goes and what kind it is:

* **broadcast vs partition** (Fig 6a/6b) — broadcast the small build side
  when it is at most ``broadcast_threshold`` times smaller than the probe;
  under hybrid parallelism the threshold is ``n - 1`` (vs ``n*t - 1``
  classic), so an 8-unit mesh already broadcasts at a 7x size difference
  (paper: 5x vs 239x on their 6-server cluster).
* **pre-aggregation** (Fig 6c) — dense group-bys reduce locally first and
  combine the tiny group table with a psum instead of shuffling raw rows.
* **co-partitioning reuse** — partitioning properties (round-robin /
  hash(key) / replicated) propagate through the plan, so a pipeline that is
  already partitioned on the join key gets NO new exchange (Q17's single
  lineitem shuffle feeds the correlated-AVG group-by *and* the join back).

Every exchange edge carries its own :class:`~repro_torch.core.autotune.TableStats`
(static per-shard rows x packed row bytes — the zero-drop shapes that
actually move), and the whole set is priced by the topology autotuner's
analytic core (:func:`repro_torch.core.autotune.tune_config`) to pick the
multiplexer knobs — at *plan* time, with no devices, which is what makes
``explain()`` deterministic and golden-snapshotable.

On two-level meshes (``num_pods > 1``) the planner emits the same plan; the
executor routes shuffles through ``hash_shuffle_global`` (coarse cross-pod
hop + fine in-pod — the DCI never carries fine-grained traffic, per
``HybridPlan``) and broadcast edges obey the tuned ``cross_pod`` strategy,
falling back to a hash reshard by the build key when the build side
outgrows the broadcast window.

The tuner prices with the reference's TPU constants (``topology.V5E``) so
that ``explain()`` equals the reference's; its ``modeled=`` seconds are a
TPU model, not an H100 prediction.  The port's pack knob is ``pack=torch``
(plain) or ``pack=cuda`` (the hand-written kernel), where the reference
prints ``xla`` / ``pallas``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from ...core import hybrid as H
from ...core.autotune import (
    TableStats,
    TunedConfig,
    exchange_makespan,
    pod_strategy_times,
    tune_config,
)
from ...core.topology import ChipSpec, V5E
from .. import stats as S
from . import logical as L

JoinStrategy = Literal["broadcast", "partition"]


# ----------------------------------------------------------------------------
# Paper §3.1 decision rules (absorbed from the old ``relational/plan.py`` —
# one formula, one home).
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    num_units: int  # parallel units on the exchange level (devices on axis)
    threads_per_unit: int = 1  # >1 only to *model* classic exchange
    hybrid: bool = True


def choose_join_strategy(
    small_rows: int, large_rows: int, cfg: PlannerConfig
) -> JoinStrategy:
    """Paper §3.1: broadcast iff  large/small >= units - 1.

    Broadcast cost per unit: (units-1) * small_rows sends.
    Partition cost per unit: ~ (units-1)/units * (small+large)/units sends.
    The crossover is large/small ~ units - 1 (paper's formula).
    """
    thr = H.broadcast_threshold(
        cfg.num_units, cfg.threads_per_unit, hybrid=cfg.hybrid
    )
    if small_rows == 0:
        return "broadcast"
    return "broadcast" if large_rows / small_rows >= thr else "partition"


def exchange_bytes(
    strategy: JoinStrategy,
    small_rows: int,
    large_rows: int,
    row_bytes: int,
    cfg: PlannerConfig,
) -> int:
    """Bytes crossing the network for the chosen strategy (cost model)."""
    n = cfg.num_units
    if strategy == "broadcast":
        return (n - 1) * small_rows * row_bytes
    # hash partition both sides: each row moves with prob (n-1)/n
    return int((small_rows + large_rows) * row_bytes * (n - 1) / n)


def use_preaggregation(num_groups: int, rows: int, threshold: float = 0.5) -> bool:
    """Pre-aggregate when the group table is much smaller than the input

    (paper Fig 6c: 'especially for aggregations with a small number of
    groups').
    """
    return num_groups <= rows * threshold


# ----------------------------------------------------------------------------
# Physical nodes.
# ----------------------------------------------------------------------------

# partitioning property: None (round-robin morsels), ("hash", key),
# ("salted", key) — hash on the salted sub-key space, rows of one heavy key
# span shards — or "replicated"
Partitioning = object

REPLICATED = "replicated"

# Estimated plain-hash overload (max/fair-share) above which the planner
# considers the salted repartitioning; also the runtime re-optimization
# threshold the executor compares its measured histogram against.
DEFAULT_SALT_THRESHOLD = 1.5


@dataclasses.dataclass
class PNode:
    """One physical operator. ``kind`` dispatches the executor; ``info``
    holds kind-specific fields (predicates, keys, strategies, stats)."""

    kind: str
    schema: tuple[str, ...]
    cap: int  # per-shard row capacity flowing OUT of this node
    part: Partitioning
    children: tuple["PNode", ...]
    info: dict
    # which schema columns are float (group-by sums, derived ratios): these
    # cannot go through the int32 row-image exchange
    float_cols: frozenset = frozenset()

    # display index, assigned at plan finalization (deterministic)
    idx: int = -1


@dataclasses.dataclass
class PhysicalPlan:
    """A planned query: the physical DAG + everything the executor needs."""

    name: str
    root: PNode
    scans: tuple[str, ...]  # distinct base tables, first-visit order
    shuffle_stats: tuple[TableStats, ...]
    broadcast_stats: tuple[TableStats, ...]
    tuned: TunedConfig
    num_shards: int
    num_pods: int
    cfg: PlannerConfig
    catalog: dict

    def exchange_summary(self) -> list[dict]:
        """One record per exchange edge (benchmarks report these)."""
        out = []

        def walk(n: PNode, seen: set[int]):
            if id(n) in seen:
                return
            seen.add(id(n))
            for c in n.children:
                walk(c, seen)
            if n.kind == "exchange":
                st: TableStats = n.info["stats"]
                out.append(
                    dict(
                        kind=n.info["exkind"],
                        key=n.info["key"],
                        columns=len(n.children[0].schema),
                        rows_per_shard=st.rows,
                        row_bytes=st.row_bytes,
                        wire_bytes=self._wire_bytes(n.info["exkind"], st),
                    )
                )

        walk(self.root, set())
        return out

    def _wire_bytes(self, exkind: str, st: TableStats) -> int:
        """Modeled bytes on the wire for one exchange edge:
        :func:`exchange_bytes` (the paper's §3.1 formulas — one home)
        applied to the edge's total capacity across all shards."""
        total_rows = st.rows * self.num_shards
        strategy = "broadcast" if exkind == "broadcast" else "partition"
        return exchange_bytes(
            strategy, total_rows, 0, st.row_bytes,
            PlannerConfig(num_units=self.num_shards),
        )

    def total_wire_bytes(self) -> int:
        return sum(e["wire_bytes"] for e in self.exchange_summary())

    def explain(self) -> str:
        return explain(self)


def _per_shard_cap(rows: int, num_shards: int) -> int:
    return math.ceil(rows / num_shards)


def plan_physical(
    root: L.Node,
    catalog: L.Catalog,
    num_shards: int,
    num_pods: int = 1,
    cfg: PlannerConfig | None = None,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    name: str = "query",
    cross_pod: str | None = None,
    stats: dict[str, S.TableProfile] | None = None,
    salt_threshold: float = DEFAULT_SALT_THRESHOLD,
    morsel_rows: int | None = None,
) -> PhysicalPlan:
    """Place exchanges, infer partitionings/capacities, tune the multiplexer.

    ``morsel_rows`` (out-of-core streaming) caps the rows the tuner prices
    per shuffle at one morsel's per-shard slice — streamed exchanges move one
    morsel at a time, so tuning them for the full-capacity message would
    mis-size the pipeline knobs.  Plan shape and node capacities are
    unaffected.

    Pure function of the logical DAG + catalog + mesh shape — no devices
    touched, so it runs at test/CI time and its ``explain()`` rendering is
    deterministic.

    ``stats`` (from :func:`repro_torch.relational.stats.collect_stats`) switches
    the planner from static pricing to adaptive: filter selectivities and
    NDVs refine the row estimates behind each exchange's pricing, and a
    shuffle key whose heavy-hitter profile predicts a plain-hash overload
    above ``salt_threshold`` is planned as a SALTED repartitioning (heavy
    keys split across salted sub-keys, ``core.skew.salt_keys``-style),
    priced against the plain hash and a broadcast of the same edge.  The
    capacity-based ``TableStats`` still size the zero-drop buffers and the
    tuner input, so with no skew in the stats the emitted plan is
    bit-identical to the stats-free one.

    On two-level meshes the cross-pod build-side strategy is itself a *plan*
    decision: a first pass places broadcast edges and prices them with
    :func:`~repro_torch.core.autotune.pod_strategy_times`; if ``"reshard"`` wins
    (or ``cross_pod="reshard"`` is pinned), the plan is rebuilt with those
    joins co-partitioned instead — resharding ONLY the build side would
    strand it away from an un-partitioned probe, so the reshard strategy
    must pull the probe onto the same hash partitioning.
    """
    # Counter hook: the plan cache's tests assert the warm path plans ZERO
    # times.
    plan_physical.calls += 1
    cfg = cfg or PlannerConfig(num_units=num_shards, hybrid=True)

    def build(reshard: bool) -> dict:
        return _plan_once(
            root, catalog, num_shards, cfg, reshard=reshard,
            num_pods=num_pods, chip=chip, topology=topology,
            stats=stats, salt_threshold=salt_threshold,
            morsel_rows=morsel_rows,
        )

    built = build(reshard=False)
    resolved_cross_pod = None

    def tune(b):
        bstats = max(
            b["broadcast_stats"], key=lambda s: s.rows * s.row_bytes,
            default=None,
        )
        return tune_config(
            num_shards // max(num_pods, 1), tuple(b["shuffle_stats"]),
            num_pods=num_pods, chip=chip, topology=topology,
            broadcast_stats=bstats,
        )

    tuned = tune(built)
    if num_pods > 1:
        resolved_cross_pod = cross_pod or tuned.cross_pod or "broadcast"
        if resolved_cross_pod == "reshard" and built["broadcast_stats"]:
            rebuilt = build(reshard=True)
            # joins whose schemas carry float columns keep their broadcast
            # edge (can_reshard=False); only re-tune if anything changed
            if rebuilt["broadcast_stats"] != built["broadcast_stats"]:
                built = rebuilt
                tuned = tune(built)
        tuned = dataclasses.replace(tuned, cross_pod=resolved_cross_pod)
    return PhysicalPlan(
        name=name,
        root=built["root"],
        scans=tuple(built["scans"]),
        shuffle_stats=tuple(built["shuffle_stats"]),
        broadcast_stats=tuple(built["broadcast_stats"]),
        tuned=tuned,
        num_shards=num_shards,
        num_pods=num_pods,
        cfg=cfg,
        catalog=dict(catalog),
    )


# How many times the planner has run in this process — the plan cache's
# zero-replan-on-warm-path checks read this.
plan_physical.calls = 0


def _plan_once(
    root: L.Node,
    catalog: L.Catalog,
    num_shards: int,
    cfg: PlannerConfig,
    reshard: bool,
    num_pods: int = 1,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    stats: dict[str, S.TableProfile] | None = None,
    salt_threshold: float = DEFAULT_SALT_THRESHOLD,
    morsel_rows: int | None = None,
) -> dict:
    """One planning pass; ``reshard=True`` turns broadcast-threshold joins
    into co-partitioned ones (the two-level reshard strategy)."""
    shuffle_stats: list[TableStats] = []
    broadcast_stats: list[TableStats] = []
    memo: dict[int, PNode] = {}
    exch_memo: dict[tuple[int, str, str | None], PNode] = {}
    scans: list[str] = []
    # column name -> ColumnStats; TPC-H column names are globally unique,
    # and the deterministic sorted-table iteration pins any tie.
    stats_by_col: dict[str, S.ColumnStats] = {}
    profiles: dict[str, S.TableProfile] = dict(stats) if stats else {}
    for _tname in sorted(profiles):
        for _cname, _cs in profiles[_tname].columns.items():
            stats_by_col.setdefault(_cname, _cs)
    # id(PNode) -> estimated total valid rows (refines capacity for the
    # per-edge pricing; capacities still size every buffer)
    est: dict[int, float] = {}

    def _est(p: PNode, default: float | None = None) -> float:
        if default is None:
            default = float(p.cap * num_shards)
        return est.get(id(p), default)

    def _selectivity(pred: L.Expr) -> float:
        cols = set(pred.columns())
        for tname in sorted(profiles):
            sample = profiles[tname].sample
            if cols <= set(sample):
                return L.predicate_selectivity(pred, sample)
        return 1.0

    def _salt_decision(child: PNode, key: str) -> dict | None:
        """Price plain vs salted vs broadcast for this shuffle edge; a dict
        of salted-exchange info when the salted repartitioning wins."""
        cs = stats_by_col.get(key)
        if cs is None or num_shards <= 1:
            return None
        heavy = S.salting_keys(cs, num_shards)
        num_salts = S.choose_num_salts(heavy, num_shards)
        if not heavy or not num_salts:
            return None
        over_plain = S.partition_overload(cs.heavy_hitters, num_shards)
        over_salted = S.partition_overload(
            cs.heavy_hitters, num_shards, num_salts=num_salts, salted=heavy
        )
        if over_plain < salt_threshold:
            return None
        # Price the three physical alternatives on the ESTIMATED rows (the
        # real TableStats), with the makespan charged to the max-loaded
        # shard via the skew factor.
        rows_ps = max(1, math.ceil(_est(child) / num_shards))
        pstats = TableStats(rows=rows_ps, row_bytes=4 * len(child.schema))
        n_inner = num_shards // max(num_pods, 1)
        priced = {
            "plain": exchange_makespan(
                pstats, n_inner, chip=chip, topology=topology,
                num_pods=num_pods, skew=over_plain,
            ),
            "salted": exchange_makespan(
                pstats, n_inner, chip=chip, topology=topology,
                num_pods=num_pods, skew=over_salted,
            ),
            "broadcast": pod_strategy_times(
                pstats, n_inner, num_pods, chip=chip, topology=topology
            )["broadcast"],
        }
        if priced["salted"] >= priced["plain"]:
            return None
        return {
            "salted": True,
            "num_salts": num_salts,
            "heavy_keys": tuple(int(k) for k in heavy),
            "overload_plain": over_plain,
            "overload_salted": over_salted,
            "priced_s": priced,
            "runtime_threshold": salt_threshold,
        }

    def exchange(child: PNode, exkind: str, key: str | None) -> PNode:
        mkey = (id(child), exkind, key)
        if mkey in exch_memo:
            return exch_memo[mkey]
        if exkind == "shuffle" and child.float_cols:
            raise ValueError(
                f"cannot hash-exchange a schema with float columns "
                f"{sorted(child.float_cols)}: the exchange ships an int32 "
                "row image — aggregate after the exchange, or project the "
                "float columns away first"
            )
        priced_rows = child.cap
        if morsel_rows is not None and exkind == "shuffle":
            # streamed exchanges move one morsel per step, not the full table
            priced_rows = min(priced_rows, math.ceil(morsel_rows / num_shards))
        stats_t = TableStats(rows=priced_rows, row_bytes=4 * len(child.schema))
        info = {"exkind": exkind, "key": key, "stats": stats_t}
        if exkind == "shuffle":
            shuffle_stats.append(stats_t)
            salt = _salt_decision(child, key)
            if salt:
                info.update(salt)
                part = ("salted", key)
            else:
                part = ("hash", key)
        else:
            broadcast_stats.append(stats_t)
            part = REPLICATED
        node = PNode(
            kind="exchange",
            schema=child.schema,
            # zero-drop bound: every sender may deliver its whole buffer
            cap=child.cap * num_shards,
            part=part,
            children=(child,),
            info=info,
            float_cols=child.float_cols,
        )
        est[id(node)] = _est(child)
        # expose the estimate for the model-vs-measured check: modeled wire
        # bytes price the rows the estimator expects to FLOW, while the
        # capacity-based ``stats`` above keep sizing every buffer
        info["est_rows"] = est[id(node)]
        exch_memo[mkey] = node
        return node

    def ensure_hash(p: PNode, key: str) -> PNode:
        # REPLICATED is acceptable for join sides: valid matches still land
        # exactly once globally (the other copies fail the key-owner test).
        # A salted partitioning on the same key is the adaptive equivalent
        # of hash(key); consumers that need co-location by the TRUE key
        # (sort-based GroupBy, join sides) handle it explicitly below.
        if p.part in (("hash", key), ("salted", key), REPLICATED):
            return p
        return exchange(p, "shuffle", key)

    def reject_replicated(p: PNode, op: str) -> PNode:
        # psum/top-k combines count every shard's contribution: a replicated
        # input would be counted num_shards times — reject at plan time
        # rather than silently multiply results
        if p.part == REPLICATED:
            raise ValueError(
                f"{op} over a replicated input would be combined "
                f"{num_shards}-fold by the cross-shard psum/top-k merge; "
                "restructure the plan so the aggregated side stays "
                "partitioned"
            )
        return p

    def plan(node: L.Node) -> PNode:
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node, L.Scan):
            if node.table not in scans:
                scans.append(node.table)
            p = PNode(
                kind="scan",
                schema=node.schema,
                cap=_per_shard_cap(node.est_rows(catalog), num_shards),
                part=None,
                children=(),
                info={"table": node.table},
            )
            prof = profiles.get(node.table)
            est[id(p)] = float(
                prof.rows if prof else node.est_rows(catalog)
            )
        elif isinstance(node, L.Filter):
            c = plan(node.child)
            p = PNode("filter", c.schema, c.cap, c.part, (c,),
                      {"pred": node.pred}, float_cols=c.float_cols)
            est[id(p)] = _est(c) * (_selectivity(node.pred) if profiles else 1.0)
        elif isinstance(node, L.Project):
            c = plan(node.child)
            fcols = frozenset(
                k for k in node.keep if k in c.float_cols
            ) | frozenset(
                name for name, e in node.derived if e.is_float(c.float_cols)
            )
            p = PNode("project", node.schema, c.cap, c.part, (c,),
                      {"keep": node.keep, "derived": node.derived},
                      float_cols=fcols)
            est[id(p)] = _est(c)
        elif isinstance(node, L.HashJoin):
            b, pr = plan(node.build), plan(node.probe)
            build_rows = node.build.est_rows(catalog)
            probe_rows = node.probe.est_rows(catalog)
            strategy = choose_join_strategy(build_rows, probe_rows, cfg)
            # Co-partitioning ships both sides through the int32 row-image
            # exchange, which cannot carry float columns (group-by sums,
            # derived ratios).  If a side that would need exchanging carries
            # floats, fall back to broadcasting the build (the replicate
            # route ships columns individually and handles any dtype) — a
            # always-valid plan, just not the cost winner.
            def needs_hash(side: PNode, key: str) -> bool:
                return side.part != ("hash", key) and side.part != REPLICATED

            forced = None
            if strategy == "partition" and (
                (needs_hash(b, node.build_key) and b.float_cols)
                or (needs_hash(pr, node.probe_key) and pr.float_cols)
            ):
                strategy = "broadcast"
                forced = "float columns cannot hash-exchange"
            # reshard = co-partition both sides; same float constraint —
            # keep the broadcast edge for such joins
            can_reshard = not b.float_cols and not pr.float_cols
            resharded = strategy == "broadcast" and reshard and can_reshard \
                and forced is None
            if strategy == "broadcast" and not resharded:
                if b.part != REPLICATED:
                    b = exchange(b, "broadcast", node.build_key)
                out_part = pr.part
            else:
                b = ensure_hash(b, node.build_key)
                pr = ensure_hash(pr, node.probe_key)
                out_part = ("hash", node.probe_key)
                # Under a salted repartitioning one heavy key's probe rows
                # span shards, so a co-partitioned build cannot meet them —
                # the build side must be replicated (the salted-join rule:
                # probe salts, build replicates across all salts).
                if pr.part == ("salted", node.probe_key):
                    out_part = pr.part
                    if b.part != REPLICATED:
                        b = exchange(b, "broadcast", node.build_key)
                        forced = "salted probe needs a replicated build"
                elif b.part == ("salted", node.build_key):
                    b = exchange(b, "broadcast", node.build_key)
                    forced = "salted build side must replicate"
            p = PNode(
                "join",
                node.schema,
                pr.cap,
                out_part,
                (b, pr),
                {
                    "build_key": node.build_key,
                    "probe_key": node.probe_key,
                    "payload": node.payload,
                    "strategy": strategy,
                    "forced": forced,
                    "resharded": resharded,
                    "build_rows": build_rows,
                    "probe_rows": probe_rows,
                    "threshold": H.broadcast_threshold(
                        cfg.num_units, cfg.threads_per_unit, cfg.hybrid
                    ),
                },
                float_cols=pr.float_cols | frozenset(
                    c for c in node.payload if c in b.float_cols
                ),
            )
            # Containment estimate: under referential integrity every probe
            # key is drawn from the build's key domain, so the probe rows
            # surviving the join are the fraction of build keys surviving
            # upstream filters — est(b) / ndv(build_key).  The build-key ndv
            # comes from the base-table profile (exact when the sample
            # covers the dimension table); the probe-key ndv is only a
            # fallback — its GEE estimate carries a sqrt(N/n) error that
            # would leak straight into the output cardinality.  Without
            # profiles, keep the pass-through estimate.
            est_out = _est(pr)
            if profiles:
                cs = stats_by_col.get(node.build_key) or stats_by_col.get(
                    node.probe_key
                )
                if cs is not None and cs.ndv > 0:
                    est_out = _est(pr) * min(1.0, _est(b) / float(cs.ndv))
            est[id(p)] = est_out
        elif isinstance(node, L.GroupBy) and node.num_groups is None:
            c = reject_replicated(plan(node.child), "sort-based GroupBy")
            c = ensure_hash(c, node.key)
            sum_cols = frozenset(
                name for name, _e, kind in node.aggs if kind == "sum"
            )
            if c.part == ("salted", node.key):
                # Salted shape (Fig 6c adapted to skew): aggregate per
                # salted sub-stream by the TRUE key, broadcast the small
                # partial-aggregate tables, and merge them everywhere by
                # summing partial sums AND partial counts — the replicated
                # result feeds join builds with no further exchange.
                partial = PNode(
                    "groupby_sorted", node.schema, c.cap, c.part, (c,),
                    {"key": node.key, "aggs": node.aggs, "partial": True},
                    float_cols=sum_cols,
                )
                est[id(partial)] = _est(c)
                bc = exchange(partial, "broadcast", node.key)
                p = PNode(
                    "groupby_combine", node.schema, bc.cap, REPLICATED, (bc,),
                    {"key": node.key, "aggs": node.aggs},
                    # every aggregate is re-summed in f32 by the combine
                    float_cols=frozenset(n for n, _e, _k in node.aggs),
                )
            else:
                p = PNode(
                    "groupby_sorted",
                    node.schema,
                    c.cap,
                    ("hash", node.key),
                    (c,),
                    {"key": node.key, "aggs": node.aggs},
                    float_cols=sum_cols,
                )
            cs = stats_by_col.get(node.key)
            est[id(p)] = min(_est(c), float(cs.ndv)) if cs else _est(c)
        elif isinstance(node, L.GroupBy):
            c = reject_replicated(plan(node.child), "dense GroupBy")
            assert use_preaggregation(node.num_groups, c.cap), (
                "dense GroupBy domain too large to pre-aggregate; use the "
                "sort-based GroupBy (key=...)"
            )
            p = PNode(
                "groupby_dense",
                node.schema,
                node.num_groups,
                REPLICATED,
                (c,),
                {"key_expr": node.key_expr, "num_groups": node.num_groups,
                 "aggs": node.aggs},
            )
        elif isinstance(node, L.Aggregate):
            c = reject_replicated(plan(node.child), "Aggregate")
            p = PNode("aggregate", node.schema, 1, REPLICATED, (c,),
                      {"aggs": node.aggs})
        elif isinstance(node, L.TopK):
            c = reject_replicated(plan(node.child), "TopK")
            p = PNode("topk", node.schema, node.k, REPLICATED, (c,),
                      {"key": node.key, "k": node.k, "payload": node.payload})
        else:
            raise TypeError(f"unknown logical node {type(node).__name__}")
        memo[id(node)] = p
        return p

    proot = plan(root)
    if proot.kind not in ("groupby_dense", "aggregate", "topk"):
        raise ValueError(
            f"plan root must be an aggregation/top-k (got {proot.kind}): "
            "distributed results are combined with psum/top-k, not gathered"
        )
    # deterministic display indices (first-visit preorder)
    counter = [0]
    seen: set[int] = set()

    def number(n: PNode):
        if id(n) in seen:
            return
        seen.add(id(n))
        n.idx = counter[0]
        counter[0] += 1
        for c in n.children:
            number(c)

    number(proot)
    return {
        "root": proot,
        "scans": scans,
        "shuffle_stats": shuffle_stats,
        "broadcast_stats": broadcast_stats,
    }


# ----------------------------------------------------------------------------
# explain(): the deterministic rendering golden snapshots assert on.
# ----------------------------------------------------------------------------

def _aggs_str(aggs) -> str:
    return ", ".join(f"{n}={k}({e.render()})" for n, e, k in aggs)


def _part_str(part) -> str:
    if part is None:
        return "round-robin"
    if part == REPLICATED:
        return "replicated"
    if part[0] == "salted":
        return f"salted-hash({part[1]})"
    return f"hash({part[1]})"


def _node_line(n: PNode) -> str:
    if n.kind == "scan":
        d = f"Scan[{n.info['table']}: {','.join(n.schema)}]"
    elif n.kind == "filter":
        d = f"Filter[{n.info['pred'].render()}]"
    elif n.kind == "project":
        derived = "".join(
            f" {name}:={e.render()}" for name, e in n.info["derived"]
        )
        d = f"Project[{','.join(n.info['keep'])}{derived}]"
    elif n.kind == "exchange":
        st: TableStats = n.info["stats"]
        if n.info.get("salted"):
            pr = n.info["priced_s"]
            d = (
                f"Exchange[shuffle by {n.info['key']}, "
                f"salted x{n.info['num_salts']} over "
                f"{len(n.info['heavy_keys'])} heavy] "
                f"rows/shard={st.rows} row_bytes={st.row_bytes} "
                f"overload {n.info['overload_plain']:.2f}->"
                f"{n.info['overload_salted']:.2f} "
                f"priced/s plain={pr['plain']:.2e} "
                f"salted={pr['salted']:.2e} "
                f"broadcast={pr['broadcast']:.2e}"
            )
        else:
            d = (
                f"Exchange[{n.info['exkind']} by {n.info['key']}] "
                f"rows/shard={st.rows} row_bytes={st.row_bytes}"
            )
    elif n.kind == "join":
        i = n.info
        ratio = (
            i["probe_rows"] / i["build_rows"] if i["build_rows"] else
            float("inf")
        )
        strategy = i["strategy"] + (
            "+cross_pod_reshard" if i.get("resharded") else ""
        ) + (f" (forced: {i['forced']})" if i.get("forced") else "")
        d = (
            f"HashJoin[{i['build_key']} = {i['probe_key']}] "
            f"strategy={strategy} "
            f"(probe/build = {i['probe_rows']}/{i['build_rows']} = "
            f"{ratio:.1f}, broadcast at >= {i['threshold']})"
        )
        if i["payload"]:
            d += f" payload={','.join(i['payload'])}"
    elif n.kind == "groupby_sorted":
        partial = " partial-per-salt" if n.info.get("partial") else ""
        d = (
            f"GroupBy[{n.info['key']}: {_aggs_str(n.info['aggs'])}] "
            f"sort-based{partial}"
        )
    elif n.kind == "groupby_combine":
        d = (
            f"GroupByCombine[{n.info['key']}: "
            f"{_aggs_str(n.info['aggs'])}] replicated merge of salted "
            "partials"
        )
    elif n.kind == "groupby_dense":
        d = (
            f"GroupBy[{n.info['key_expr'].render()} -> "
            f"{n.info['num_groups']} groups: {_aggs_str(n.info['aggs'])}] "
            "dense pre-aggregation + psum"
        )
    elif n.kind == "aggregate":
        d = f"Aggregate[{_aggs_str(n.info['aggs'])}] + psum"
    elif n.kind == "topk":
        d = (
            f"TopK[{n.info['key']} desc, k={n.info['k']}] "
            f"payload={','.join(n.info['payload'])} + broadcast combine"
        )
    else:  # pragma: no cover
        d = n.kind
    return f"#{n.idx} {d}  [cap/shard={n.cap}, {_part_str(n.part)}]"


def explain(plan: PhysicalPlan) -> str:
    """Render the physical plan: header, tuned multiplexer, operator tree.

    Shared subtrees (the DAG case) are printed once and referenced by
    ``#idx`` afterwards; everything here is a pure function of the plan, so
    a cost-model change that flips a broadcast/shuffle decision shows up as
    a reviewable golden-file diff.
    """
    t = plan.tuned
    lines = [
        f"plan {plan.name}: num_shards={plan.num_shards} "
        f"num_pods={plan.num_pods} units={plan.cfg.num_units} "
        f"broadcast_threshold={H.broadcast_threshold(plan.cfg.num_units, plan.cfg.threads_per_unit, plan.cfg.hybrid)}",
        f"multiplexer: impl={t.impl} pack={t.pack_impl} "
        f"pipeline_chunks={t.pipeline_chunks} "
        f"transport_chunks={t.transport_chunks} "
        f"modeled={t.modeled_s:.3e}s"
        + (f" cross_pod={t.cross_pod}" if t.cross_pod else ""),
        f"exchanges: {len(plan.shuffle_stats)} shuffle, "
        f"{len(plan.broadcast_stats)} broadcast, "
        f"wire_bytes~{plan.total_wire_bytes()}",
    ]
    printed: set[int] = set()

    def walk(n: PNode, depth: int):
        pad = "  " * depth
        if id(n) in printed:
            lines.append(f"{pad}#{n.idx} (shared, see above)")
            return
        printed.add(id(n))
        lines.append(pad + _node_line(n))
        for c in n.children:
            walk(c, depth + 1)

    walk(plan.root, 0)
    return "\n".join(lines) + "\n"


__all__ = [
    "JoinStrategy",
    "PlannerConfig",
    "choose_join_strategy",
    "exchange_bytes",
    "use_preaggregation",
    "PNode",
    "PhysicalPlan",
    "plan_physical",
    "explain",
    "REPLICATED",
    "DEFAULT_SALT_THRESHOLD",
]
