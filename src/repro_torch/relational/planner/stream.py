"""Out-of-core morsel-streamed plan execution (port of
``repro.relational.planner.stream``).

The in-memory executor (:mod:`.executor`) evaluates the whole plan over
full-capacity tables, so the scale factor is bounded by the card's memory.
This module executes the SAME physical plan chunk at a time: one base table
is a chunked :class:`~repro_torch.relational.source.DataSource` whose
fixed-capacity morsels stream through the pipeline, copied to the card from
pinned host memory on a side stream by a background thread
(:class:`~repro_torch.data.pipeline.Prefetcher`), while every pipeline
*breaker* (aggregates, group-bys, top-k) keeps a fixed-shape state with a
leading shard dim that each morsel merges into: the ``GroupByCombine``
semantics (re-group partials by the true key, re-sum sums AND counts)
applied incrementally.

Execution is decomposed into **passes**: breakers whose inputs contain no
other breaker run in pass 1, breakers over pass-1 outputs in pass 2, and so
on (Q17: pass 1 builds the per-part average over the stream, pass 2
re-scans the stream against it).  A pass whose breakers never touch the
streamed scan runs as one step over the resident inputs; the others loop
over the morsels.  Non-breaker work upstream of a breaker (filters,
projects, joins, the build-side broadcast) re-runs every morsel: compute is
traded for memory.  Each step evaluates the plan eagerly on ``[S, T]``
tensors, as :meth:`~.executor.CompiledRunner.dispatch` does, and ends in
one wait on the card, so the prefetch-overlap counters bill the step's
device time to the step.

Exchanges inside the streamed pipeline move one morsel at a time, sized for
structural zero drop unless ``ExecutionContext.exchange_rows`` bounds the
per-(src, dst) message.  Then with ``spill=True`` the overflow rows are
withheld on the sender (:func:`repro_torch.core.exchange.hash_shuffle_spill`),
parked in a host-memory overflow partition and re-offered in drain rounds
after the morsel loop; without it, overflow raises like the in-memory
executor's drop check.  An exchange of resident rows stays zero-drop, its
messages sized by the rows it really sends (one read of its per-pair
counts) rather than by the whole slice.  Drop counts and per-edge arrival
histograms stay on the card and are read once, at the end of the run; the
spilled rows and those per-pair maxima are the only other reads.

Not supported streamed (raises ``NotImplementedError``): salted plans
(``groupby_combine``), joins whose BUILD side streams, and non-group-by
breaker outputs consumed by later passes.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ...core.exchange import SHUFFLE_AXIS, make_mesh
from ...data.pipeline import Prefetcher
from ...obs.model_check import build_query_trace, edge_models
from ...obs.trace import deposit, maybe_span
from ...tree import tree_map
from .. import operators as ops
from ..source import DataSource, as_source
from ..table import Table, pad_to, resolve_device
from .executor import (
    _broadcast_table,
    _column,
    _make_mux,
    _NodeEval,
    _pair_counts,
    _prep,
    _raise_on_dropped,
    _report_keys,
    _resolve_exec_ctx,
    RunnerBase,
)
from .physical import PhysicalPlan, PNode

BREAKER_KINDS = frozenset(
    {"groupby_sorted", "groupby_combine", "groupby_dense", "aggregate", "topk"}
)

# Drain rounds make monotonic progress (every round delivers at least one
# row per backlogged destination), so this bound only trips on a logic bug.
MAX_DRAIN_ROUNDS = 1000

# Rows a sorted group-by merge re-groups at once (state plus partial, over
# a group of shards): bounds its int64 temporaries to ~128 MB each.
MERGE_ROWS = 1 << 24


def _walk_unique(root: PNode):
    seen: set[int] = set()

    def go(n: PNode):
        if id(n) in seen:
            return
        seen.add(id(n))
        yield n
        for c in n.children:
            yield from go(c)

    yield from go(root)


class _StreamedPlan:
    """Static analysis of one physical plan against one streamed scan:
    which nodes vary morsel to morsel, and which pass each breaker runs in."""

    def __init__(self, plan: PhysicalPlan, streamed_table: str):
        self.plan = plan
        self.streamed_table = streamed_table
        self._streamed: dict[int, bool] = {}
        for n in _walk_unique(plan.root):
            if n.kind == "groupby_combine":
                raise NotImplementedError(
                    "salted/adaptive plans cannot stream; plan with "
                    "StatsMode.STATIC for out-of-core execution"
                )
            if (
                n.kind == "exchange"
                and isinstance(n.part, tuple)
                and n.part[0] == "salted"
            ):
                raise NotImplementedError("salted exchanges cannot stream")
        if plan.root.kind not in BREAKER_KINDS:
            raise ValueError("plan root must be an aggregation/top-k to stream")
        self.breakers = [
            n for n in _walk_unique(plan.root) if n.kind in BREAKER_KINDS
        ]
        self.pass_of: dict[int, int] = {}
        for b in self.breakers:
            self._assign_pass(b)
        self.num_passes = max(self.pass_of.values(), default=1)

    def streamed(self, n: PNode) -> bool:
        """Does this node's output change morsel to morsel?"""
        if id(n) in self._streamed:
            return self._streamed[id(n)]
        if n.kind == "scan":
            r = n.info["table"] == self.streamed_table
        elif n.kind in BREAKER_KINDS:
            r = False  # breaker output is resident state
        elif n.kind == "join":
            build, probe = n.children
            if self.streamed(build):
                raise NotImplementedError(
                    "join build side streams: streamed execution requires "
                    "the chunked table on the probe side"
                )
            r = self.streamed(probe)
        else:
            r = any(self.streamed(c) for c in n.children)
        self._streamed[id(n)] = r
        return r

    def _upstream_breakers(self, n: PNode) -> list[PNode]:
        out: list[PNode] = []
        seen: set[int] = set()

        def go(m: PNode):
            for c in m.children:
                if id(c) in seen:
                    continue
                seen.add(id(c))
                if c.kind in BREAKER_KINDS:
                    out.append(c)
                else:
                    go(c)

        go(n)
        return out

    def _assign_pass(self, b: PNode) -> int:
        if id(b) in self.pass_of:
            return self.pass_of[id(b)]
        ups = self._upstream_breakers(b)
        p = 1 + max((self._assign_pass(u) for u in ups), default=0)
        self.pass_of[id(b)] = p
        return p

    def pass_breakers(self, p: int) -> list[PNode]:
        return [b for b in self.breakers if self.pass_of[id(b)] == p]

    def shuffles_feeding(self, b: PNode, streamed_only: bool) -> list[PNode]:
        """Shuffle exchanges on ``b``'s input side, not crossing breakers."""
        out: list[PNode] = []
        seen: set[int] = set()

        def go(m: PNode):
            if id(m) in seen or m.kind in BREAKER_KINDS:
                return
            seen.add(id(m))
            if m.kind == "exchange" and m.info["exkind"] == "shuffle":
                if not streamed_only or self.streamed(m):
                    out.append(m)
            for c in m.children:
                go(c)

        go(b.children[0])
        return out


def _bname(n: PNode) -> str:
    return f"b{n.idx}"


def compile_plan_streamed(
    plan: PhysicalPlan,
    sources: dict[str, DataSource | Table],
    ctx=None,
    mux=None,
):
    """Build a zero-arg runner that streams the plan over morsels.

    ``sources`` maps every base table of the plan to a Table or DataSource;
    exactly one must be chunked (``num_chunks > 1``): that relation streams,
    everything else stays resident on ``ctx.device``.  ``ctx`` is an
    :class:`~repro_torch.relational.context.ExecutionContext` (morsel and
    spill knobs plus the usual multiplexer knobs).  The runner returns the
    same result as the in-memory executor (integer outputs bit-identical;
    float aggregates differ only by f32 summation order) and exposes
    ``.stats`` (morsel, pass, spill and prefetch-overlap counters),
    ``.reports`` (per-edge arrival histograms) and ``.last_trace`` (the
    :class:`~repro_torch.obs.trace.QueryTrace` built from both) of its last
    run.  With ``ctx.trace`` set, every pass, morsel step and drain round
    is a span and each run's trace is deposited into that tracer.
    """
    ctx = _resolve_exec_ctx(plan, ctx, where="compile_plan_streamed")
    tracer = ctx.trace
    device = resolve_device(ctx.device)
    num_shards, num_pods = plan.num_shards, plan.num_pods
    srcs = {name: as_source(sources[name]) for name in plan.scans}
    for name in plan.scans:
        if srcs[name].capacity != plan.catalog[name]:
            raise ValueError(
                f"source {name!r} has capacity {srcs[name].capacity} but the "
                f"plan was built for {plan.catalog[name]}; re-plan for the "
                "actual sources"
            )
    chunked = [n for n in plan.scans if srcs[n].is_chunked]
    if len(chunked) != 1:
        raise ValueError(
            f"streamed execution needs exactly one chunked source, got "
            f"{chunked or 'none'}; use execute_plan for fully in-memory runs"
        )
    streamed_name = chunked[0]
    sp = _StreamedPlan(plan, streamed_name)
    src = srcs[streamed_name]

    mesh = make_mesh(num_shards, num_pods)
    report_keys = _report_keys(plan.root)
    if mux is None:
        mux = _make_mux(mesh, plan, ctx.impl, ctx.pack_impl, ctx.num_chunks)
    if ctx.spill and mux.plan.pod_axis is not None:
        raise NotImplementedError(
            "spill is single-level only; on pod meshes stream with "
            "zero-drop exchange capacity (exchange_rows=None)"
        )
    single = num_shards == 1 and num_pods == 1

    # Per-shard row capacity of one prepped morsel — every streamed
    # pipeline node keeps this capacity (filters/projects/joins preserve it).
    morsel_cap = math.ceil(src.chunk_rows / num_shards) * num_shards
    per_shard = morsel_cap // num_shards

    budget = ctx.device_row_budget
    if budget is not None:
        if per_shard > budget:
            raise ValueError(
                f"morsel slice of {per_shard} rows/device exceeds "
                f"device_row_budget={budget}; use smaller chunks"
            )
        for name in plan.scans:
            if name == streamed_name:
                continue
            resident_ps = math.ceil(srcs[name].capacity / num_shards)
            if resident_ps > budget:
                raise ValueError(
                    f"resident table {name!r} needs {resident_ps} rows/device,"
                    f" over device_row_budget={budget}; chunk it or raise the "
                    "budget"
                )

    # The pass schedule: streamed breakers join the morsel loop, resident
    # ones run a single step (their input never touches the morsel — one
    # step per pass, or they would multiply-count).
    pass_plan = []
    for p in range(1, sp.num_passes + 1):
        bs = sp.pass_breakers(p)
        streamed_bs = [b for b in bs if sp.streamed(b.children[0])]
        resident_bs = [b for b in bs if not sp.streamed(b.children[0])]
        spill_nodes: list[PNode] = []
        if ctx.spill:
            seen: set[int] = set()
            for b in streamed_bs:
                for x in sp.shuffles_feeding(b, streamed_only=True):
                    if id(x) not in seen:
                        seen.add(id(x))
                        spill_nodes.append(x)
            if len(spill_nodes) > 1:
                raise NotImplementedError(
                    "spill supports one streamed shuffle per pass"
                )
        # a drain round re-runs the breakers the spilling shuffle feeds
        spilling = {id(x) for x in spill_nodes}
        drain_bs = [
            b for b in streamed_bs
            if any(id(x) in spilling for x in sp.shuffles_feeding(b, streamed_only=True))
        ]
        pass_plan.append((p, streamed_bs, resident_bs, spill_nodes, drain_bs))

    def _shuffles(breakers: list[PNode]) -> int:
        """Shuffle exchanges one step over ``breakers`` runs (none on one
        shard, where an exchange is the identity)."""
        if single:
            return 0
        return len({id(x) for b in breakers
                    for x in sp.shuffles_feeding(b, streamed_only=False)})

    shuffles_per_step = [
        {"streamed": _shuffles(sbs), "resident": _shuffles(rbs), "drain": _shuffles(dbs)}
        for _p, sbs, rbs, _x, dbs in pass_plan
    ]

    # ---- breaker states ([num_shards, ...], on the card) -----------------
    def _group_cap(n: PNode) -> int:
        if ctx.group_state_rows is not None:
            return int(ctx.group_state_rows)
        cap = n.cap
        if budget is not None:
            cap = min(cap, budget)
        return max(int(cap), 1)

    if budget is not None:
        for b in sp.breakers:
            if b.kind == "groupby_sorted" and _group_cap(b) > budget:
                raise ValueError(
                    f"group state of {_group_cap(b)} rows/device exceeds "
                    f"device_row_budget={budget}; set group_state_rows"
                )

    def _zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def _init_state(n: PNode):
        N = num_shards
        if n.kind == "aggregate":
            return {
                name: _zeros((N,), torch.float32 if kind == "sum" else torch.int32)
                for name, _e, kind in n.info["aggs"]
            }
        if n.kind == "groupby_dense":
            G = n.info["num_groups"]
            return {
                name: _zeros((N, G), torch.float32 if kind == "sum" else torch.int32)
                for name, _e, kind in n.info["aggs"]
            }
        if n.kind == "groupby_sorted":
            C = _group_cap(n)
            return {
                "keys": _zeros((N, C), torch.int32),
                "valid": _zeros((N, C), torch.bool),
                "aggs": {
                    name: _zeros((N, C), torch.float32)
                    for name, _e, _k in n.info["aggs"]
                },
                "overflow": _zeros((N,), torch.int32),
            }
        if n.kind == "topk":
            child = n.children[0]
            k = n.info["k"]
            return {
                "vals": torch.full((N, k), float("-inf"), device=device),
                "payload": {
                    c: _zeros(
                        (N, k),
                        torch.float32 if c in child.float_cols else torch.int32,
                    )
                    for c in n.info["payload"]
                },
            }
        raise NotImplementedError(f"no streamed state for breaker {n.kind!r}")

    resident_names = [n for n in plan.scans if n != streamed_name]
    resident = {
        name: _prep(srcs[name].materialize(), num_shards, device)
        for name in resident_names
    }
    states = {_bname(b): _init_state(b) for b in sp.breakers}

    # ---- per-step evaluation ---------------------------------------------
    def _exchange_streamed(t: Table, n: PNode, spills, reports,
                           do_spill: bool, bounded: bool):
        """One step's rows through the decoupled exchange.

        ``bounded``: apply ``ctx.exchange_rows`` as the per-(src,dst)
        message capacity (streamed shuffles and drain re-offers only).  A
        resident exchange keeps zero drop at its real arrivals: its message
        capacity is the most rows one shard sends one destination (read back
        once), not the whole-slice bound, which on one card would hold every
        shard's copy of the table ``num_shards`` times over.  The global
        per-destination arrival histogram goes into ``reports`` always."""
        columns = list(n.schema)
        cap = t.valid.shape[1]
        rows = torch.stack([t[c].to(torch.int32) for c in columns], dim=2)
        keys = t[n.info["key"]].to(torch.int32)
        pairs = _pair_counts(keys, t.valid, num_shards)
        reports[report_keys[id(n)]] = pairs.sum(0, dtype=torch.int32)
        if not bounded:
            q = mux.pipeline_chunks * mux.transport_chunks  # chunks divide it
            msg_cap = -(-max(int(pairs.max()), 1) // q) * q
        elif ctx.exchange_rows is not None:
            msg_cap = min(cap, int(ctx.exchange_rows))
        else:
            msg_cap = cap
        if do_spill:
            out_rows, out_valid, spilled = mux.hash_shuffle_spill(
                keys, rows, SHUFFLE_AXIS, capacity=msg_cap, valid=t.valid
            )
            spills[id(n)] = (rows, spilled)
            dropped = _zeros((), torch.int32)
        else:
            out_rows, out_valid, dropped = mux.hash_shuffle_global(
                keys, rows, SHUFFLE_AXIS, capacity=msg_cap, valid=t.valid
            )
            dropped = dropped[0]
        cols = {c: out_rows[:, :, i] for i, c in enumerate(columns)}
        return Table(cols, out_valid), dropped

    class _StepEval(_NodeEval):
        """The evaluator of one step.

        ``tabs``: base-table name -> sharded Table (the streamed scan's
        entry is the current morsel, or None in drain and resident-only
        steps).  ``spill_ids``: exchange node ids that run the
        spill-capable path.  ``drain_for``: (exchange node id, drain table)
        — that exchange re-offers spilled rows instead of evaluating its
        child.  A breaker of an earlier pass is read from its state.
        """

        def __init__(self, tabs, local_states, drops, spills, spill_ids, reports,
                     drain_for=None):
            super().__init__(tabs)
            self.local_states = local_states
            self.drops, self.spills, self.reports = drops, spills, reports
            self.spill_ids, self.drain_for = spill_ids, drain_for

        def scan(self, n: PNode) -> Table:
            if self.tabs[n.info["table"]] is None:
                raise NotImplementedError(
                    "drain pass reached the streamed scan off the "
                    "spilling exchange's path"
                )
            return super().scan(n)

        def exchange(self, n: PNode) -> Table:
            draining = self.drain_for is not None and id(n) == self.drain_for[0]
            t = self.drain_for[1] if draining else self(n.children[0])
            if single:
                return t
            if n.info["exkind"] == "shuffle":
                out, d = _exchange_streamed(
                    t, n, self.spills, self.reports,
                    do_spill=id(n) in self.spill_ids,
                    bounded=sp.streamed(n) or draining,
                )
            else:
                out, d = _broadcast_table(mux, t, list(n.schema))
                d = d[0]
            self.drops.append(d)
            return out

        def other(self, n: PNode) -> Table:
            if n.kind not in BREAKER_KINDS:
                raise TypeError(f"unstreamable physical node kind {n.kind!r}")
            # consumed output of an earlier pass: rebuild from state
            if n.kind != "groupby_sorted":
                raise NotImplementedError(f"streamed consumption of {n.kind} output")
            st = self.local_states[_bname(n)]
            cols = {n.info["key"]: st["keys"]}
            for name, _e, _k in n.info["aggs"]:
                cols[name] = st["aggs"][name]
            return Table(cols, st["valid"])

    def _merge(b: PNode, st, ev):
        """Fold one step's partial of breaker ``b`` into its state."""
        t = ev(b.children[0])
        if b.kind == "aggregate":
            out = {}
            for name, e, kind in b.info["aggs"]:
                local = (
                    ops.sum_where(_column(e.eval(t), t.valid), t.valid)
                    if kind == "sum"
                    else ops.count_where(t.valid)
                )
                out[name] = st[name] + local.to(st[name].dtype)
            return out
        if b.kind == "groupby_dense":
            res = ops.groupby_dense(
                _column(b.info["key_expr"].eval(t), t.valid),
                b.info["num_groups"],
                ev.agg_dict(t, b.info["aggs"]),
                t.valid,
            )
            return {name: st[name] + res[name].to(st[name].dtype) for name in st}
        if b.kind == "groupby_sorted":
            key = b.info["key"]
            partial = ev.agg_dict(t, b.info["aggs"])
            new = tree_map(torch.empty_like, st)
            S, C = st["keys"].shape
            # A few shards at a time, MERGE_ROWS rows at most: re-grouping
            # C + T rows a shard takes several int64 temporaries of that
            # length, which over all shards at once would outgrow the state
            # itself (the shards are independent, so the result is the same).
            group = max(1, MERGE_ROWS // (C + t.valid.shape[1]))
            for s in range(0, S, group):
                sl = slice(s, min(s + group, S))
                G = sl.stop - sl.start
                gkeys, gvalid, out = ops.groupby_sorted(
                    t[key][sl], t.valid[sl],
                    {name: (col[sl], kind) for name, (col, kind) in partial.items()},
                )
                # the GroupByCombine path, incrementally: concat state with
                # the step's partial, re-group by true key, re-SUM every agg
                # (counts are small exact integers in f32)
                ck = torch.cat([st["keys"][sl], gkeys], dim=1)
                cv = torch.cat([st["valid"][sl], gvalid], dim=1)
                caggs = {
                    name: (torch.cat([st["aggs"][name][sl], out[name].to(torch.float32)],
                                     dim=1), "sum")
                    for name in st["aggs"]
                }
                mkeys, mvalid, mout = ops.groupby_sorted(ck, cv, caggs)
                # compact surviving groups into the fixed-capacity state;
                # rows not kept all write zeros to the dump slot C, so write
                # order cannot matter
                rank = mvalid.cumsum(1) - 1
                keep = mvalid & (rank < C)
                slot = torch.where(keep, rank, C)

                def compact(dst, vals):
                    full = _zeros((G, C + 1), dst.dtype)
                    full.scatter_(1, slot, torch.where(keep, vals, 0).to(dst.dtype))
                    dst[sl] = full[:, :C]

                compact(new["keys"], mkeys)
                compact(new["valid"], keep)
                for name in st["aggs"]:
                    compact(new["aggs"][name], mout[name])
                new["overflow"][sl] = st["overflow"][sl] + (mvalid & ~keep).sum(
                    1, dtype=torch.int32)
            return new
        if b.kind == "topk":
            k = b.info["k"]
            vals, payload = ops.topk_rows(
                t[b.info["key"]], t.valid, k,
                {c: t[c] for c in b.info["payload"]},
            )
            top_vals, idx = ops.topk_order(torch.cat([st["vals"], vals], dim=1), k)
            new_payload = {
                c: torch.cat(
                    [st["payload"][c], payload[c].to(st["payload"][c].dtype)], dim=1
                ).gather(1, idx)
                for c in st["payload"]
            }
            return {"vals": top_vals, "payload": new_payload}
        raise NotImplementedError(b.kind)

    def _step(st, breakers: list[PNode], morsel: Table | None, spill_nodes,
              drain_for=None):
        """Fold one step into the states of ``breakers``; returns ``(states,
        spill_out, dropped, reports)`` with everything on the card."""
        drops: list[torch.Tensor] = []
        spills: dict[int, tuple] = {}
        reports: dict[str, torch.Tensor] = {}
        spill_ids = {id(x) for x in spill_nodes}
        if drain_for is not None:
            spill_ids = {drain_for[0]}
        tabs = dict(resident)
        tabs[streamed_name] = morsel
        ev = _StepEval(tabs, st, drops, spills, spill_ids, reports, drain_for)
        new = dict(st)
        for b in breakers:
            new[_bname(b)] = _merge(b, st[_bname(b)], ev)
        dropped = torch.stack(drops).sum() if drops else _zeros((), torch.int32)
        spill_out = [spills[k] for k in sorted(spills)]
        # one wait a step: the device time queued here belongs to this step,
        # not to the next prefetch wait
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return new, spill_out, dropped, reports

    def _collect_spill(spill_out, width: int) -> torch.Tensor:
        """Spilled rows on the host, shard-major (the reference's global
        row order), ``[rows, width]`` int32."""
        got = [rows[mask].cpu() for rows, mask in spill_out]
        if not got:
            return torch.zeros((0, width), dtype=torch.int32)
        return torch.cat(got)

    def _drain(node: PNode, downstream, pending: torch.Tensor, st, drops_h, stats):
        """Re-offer spilled rows until the overflow partition drains dry."""
        schema = list(node.schema)
        rounds = 0
        while len(pending):
            if rounds >= MAX_DRAIN_ROUNDS:
                raise RuntimeError(
                    f"{plan.name}: spill drain did not converge after "
                    f"{rounds} rounds ({len(pending)} rows pending)"
                )
            rounds += 1
            take, pending = pending[:morsel_cap], pending[morsel_cap:]
            dt = Table(
                {c: take[:, i].contiguous() for i, c in enumerate(schema)},
                torch.ones(len(take), dtype=torch.bool),
            )
            dt = _prep(pad_to(dt, morsel_cap), num_shards, device)
            # drain-step reports are re-offers of already-counted rows, so
            # they stay out of the per-edge arrival histograms
            with maybe_span(tracer, f"drain-round:{rounds}", "stream",
                            pending_rows=int(len(take))):
                st, spill_out, dropped, _reports = _step(
                    st, downstream, None, [], drain_for=(id(node), dt)
                )
            drops_h.append(dropped)
            fresh = _collect_spill(spill_out, len(schema))
            if len(fresh):
                pending = torch.cat([pending, fresh]) if len(pending) else fresh
        stats["drain_rounds"] += rounds
        return st

    # ---- finalize ----------------------------------------------------------
    def _finalize_root(st):
        root = plan.root
        s = tree_map(lambda x: x.cpu().numpy(), st[_bname(root)])
        if root.kind in ("aggregate", "groupby_dense"):
            return {
                name: s[name].sum(axis=0) for name, _e, _k in root.info["aggs"]
            }
        if root.kind == "topk":
            k = root.info["k"]
            vals = s["vals"].reshape(-1)
            order = np.argsort(-vals, kind="stable")[:k]
            out = {c: s["payload"][c].reshape(-1)[order] for c in s["payload"]}
            out["_valid"] = ~np.isneginf(vals[order])
            return out
        raise NotImplementedError(f"streamed root {root.kind}")

    def _check_group_overflow(st):
        for b in sp.breakers:
            if b.kind != "groupby_sorted":
                continue
            over = int(st[_bname(b)]["overflow"].sum())
            if over:
                raise RuntimeError(
                    f"{plan.name}: group state overflowed by {over} groups on "
                    f"{_bname(b)}; raise group_state_rows (or the device "
                    "budget)"
                )

    # ---- per-edge arrival accumulation -------------------------------------
    # Shuffle edges whose input varies morsel to morsel: their per-step
    # histograms accumulate to ONE traversal of the stream per pass.  A
    # resident-side edge inside a streamed pass instead re-ships its whole
    # (unchanging) table every step — its traversal count is the step
    # count, and the byte model prices one shipment, so the report carries
    # the multiplier explicitly.
    streaming_edge_keys = {
        report_keys[id(n)]
        for n in _walk_unique(plan.root)
        if n.kind == "exchange" and n.info["exkind"] == "shuffle" and sp.streamed(n)
    }

    def _accumulate_reports(edge_hists, reports, p: int) -> None:
        """Fold one step's histograms into the per-(edge, pass) sums, on the
        card.  Keyed by pass: a shuffle shared across passes (Q17's lineitem
        shuffle feeds both) re-ships the stream per pass, so each traversal
        is reported separately."""
        for k, h in reports.items():
            hist, n_steps = edge_hists.get((k, p), (0, 0))
            edge_hists[(k, p)] = (h.to(torch.int64) + hist, n_steps + 1)

    def _final_reports(edge_hists) -> dict:
        """Executor-shaped report dict from the sums, read once.  Edges seen
        in one pass keep their base key; multi-pass edges split into
        ``<key>@p<pass>`` traversals.  Streamed plans never salt, so
        overload is the plain-route arrival skew of the whole stream."""
        passes_of: dict[str, list[int]] = {}
        for k, p in edge_hists:
            passes_of.setdefault(k, []).append(p)
        out: dict = {}
        for (k, p), (h, n_steps) in sorted(edge_hists.items()):
            h = h.cpu().numpy()
            key = f"{k}@p{p}" if len(passes_of[k]) > 1 else k
            total = max(int(h.sum()), 1)
            over = float(h.max()) * num_shards / total
            out[key] = {
                "hist": h,
                "traversals": 1 if k in streaming_edge_keys else n_steps,
                "overload": over,
                "plain_overload": over,
                "salted": False,
            }
        return out

    # ---- the runner --------------------------------------------------------
    def run():
        st = states
        drops_h: list[torch.Tensor] = []
        edge_hists: dict = {}
        peaks: list[int] = []
        stats = {
            "passes": sp.num_passes,
            "morsels": 0,
            "spilled_rows": 0,
            "drain_rounds": 0,
            "prefetch_wait_s": 0.0,
            "prefetch_total_s": 0.0,
        }
        for p, streamed_bs, resident_bs, spill_nodes, drain_bs in pass_plan:
            with maybe_span(tracer, f"pass:{p}", "stream",
                            streamed_breakers=len(streamed_bs),
                            resident_breakers=len(resident_bs)):
                if resident_bs:
                    st, _, dropped, reports = _step(st, resident_bs, None, [])
                    _accumulate_reports(edge_hists, reports, p)
                    drops_h.append(dropped)
                if streamed_bs:
                    st = _stream_pass(p, streamed_bs, spill_nodes, drain_bs, st, drops_h,
                                      edge_hists, stats)
            if device.type == "cuda":
                peaks.append(torch.cuda.max_memory_allocated(device))
        if drops_h:
            _raise_on_dropped(plan.name, torch.stack(drops_h).sum())
        _check_group_overflow(st)
        total = stats["prefetch_total_s"]
        stats["prefetch_overlap_fraction"] = (
            1.0 - stats["prefetch_wait_s"] / total if total > 0 else 0.0
        )
        return _finalize_root(st), stats, _final_reports(edge_hists), peaks

    def _stream_pass(p, streamed_bs, spill_nodes, drain_bs, st, drops_h, edge_hists, stats):
        """One pass's morsel loop, then its drain rounds."""
        pending = torch.zeros((0, 0), dtype=torch.int32)
        it = Prefetcher(
            (_prep(chunk, num_shards, chunk.device) for chunk in src.chunks()),
            depth=ctx.prefetch_depth, device=device,
        )
        t0 = time.perf_counter()
        wait = 0.0
        while True:
            w0 = time.perf_counter()
            try:
                m = next(it)
            except StopIteration:
                wait += time.perf_counter() - w0
                break
            wait += time.perf_counter() - w0
            stats["morsels"] += 1
            with maybe_span(tracer, f"morsel:{stats['morsels']}", "stream", pass_idx=p):
                st, spill_out, dropped, reports = _step(st, streamed_bs, m, spill_nodes)
            _accumulate_reports(edge_hists, reports, p)
            drops_h.append(dropped)
            if spill_nodes:
                fresh = _collect_spill(spill_out, len(spill_nodes[0].schema))
                stats["spilled_rows"] += int(len(fresh))
                pending = torch.cat([pending, fresh]) if len(pending) else fresh
        stats["prefetch_wait_s"] += wait
        stats["prefetch_total_s"] += time.perf_counter() - t0
        if spill_nodes and len(pending):
            st = _drain(spill_nodes[0], drain_bs, pending, st, drops_h, stats)
        return st

    return _StreamedRunner(plan, mux, run, shuffles_per_step, edge_models(plan), tracer)


class _StreamedRunner(RunnerBase):
    """Zero-arg streamed runner.

    Unlike the in-memory :class:`~.executor.CompiledRunner`, a streamed
    runner has no split-phase dispatch: a run ends with its answer on the
    host.  It is built per call chain (never memoized), so it may hold the
    compile-time tracer and deposit each run's trace into it.  ``.stats``
    holds the last run's morsel, pass, spill and prefetch counters (the
    reference's keys), ``.reports`` its per-edge arrival reports (``hist``,
    ``traversals``, ``overload``, ...; multi-pass edges keyed
    ``<edge>@p<pass>``) and ``.last_trace`` the
    :class:`~repro_torch.obs.trace.QueryTrace` built from both.  On the
    card, ``.pass_peak_bytes`` holds ``torch.cuda.max_memory_allocated()``
    read at the end of each pass (the running peak since the caller last
    reset it), so a caller can tell the streamed pass's peak from a later
    resident pass's.  ``.shuffles_per_step`` says, for each pass, how many
    shuffle exchanges one of its morsel steps, its resident step and one
    of its drain rounds run (each packs its rows once a pipeline chunk).
    """

    def __init__(self, plan: PhysicalPlan, mux, run_fn, shuffles_per_step: list[dict],
                 models: dict, tracer):
        self.plan = plan
        self.mux = mux
        self._run_fn = run_fn
        self.shuffles_per_step = shuffles_per_step
        self._models = models
        self._tracer = tracer
        self.stats: dict = {}
        self.reports: dict = {}
        self.pass_peak_bytes: list[int] = []

    def __call__(self):
        t0 = time.perf_counter()
        result, self.stats, self.reports, self.pass_peak_bytes = self._run_fn()
        measured = time.perf_counter() - t0
        qt = build_query_trace(
            self.plan, self.reports, self._models,
            counters={k: float(v) for k, v in self.stats.items()},
            measured_s=measured,
        )
        self._last_trace = qt
        deposit(self._tracer, qt)
        return result


__all__ = ["compile_plan_streamed", "BREAKER_KINDS", "MAX_DRAIN_ROUNDS"]
