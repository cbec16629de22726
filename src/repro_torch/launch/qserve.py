"""Multi-tenant query-serving launcher over the TPC-H mix (port of
``repro.launch.qserve``; the flags are the reference's).

  PYTHONPATH=src python -m repro_torch.launch.qserve --sf 0.01 --slots 4 \\
      --requests 16 --tenants 3

Builds the tables, prewarms the plan cache from the template mix, serves a
seeded multi-tenant stream, and prints per-tenant TTFR/SLO accounting plus
the cache counters as JSON.  With ``--cache-dir`` the plan artifacts
persist: run the same command twice and the second process reports
``plan_disk_hits`` and zero ``plan_physical`` calls for the prewarmed
templates.  It runs on the card; :func:`main` takes ``device="cpu"`` from
Python.
"""

from __future__ import annotations

import argparse
import json
import time

from ..obs.trace import Tracer
from ..relational import datagen
from ..relational.context import ExecutionContext, StatsMode
from ..relational.planner import tpch
from ..relational.planner.physical import plan_physical
from ..relational.planner.plan_cache import PlanCache
from ..serve import QueryServeEngine, make_query_mix

DEFAULT_MIX = ("q1", "q3", "q6", "q14", "q17")


def main(argv=None, device: str = "cuda") -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sf", type=float, default=0.01)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--num-pods", type=int, default=1)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--tenants", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mix", default=",".join(DEFAULT_MIX),
                   help="comma-separated TPC-H template names")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="per-request TTFR SLO (milliseconds)")
    p.add_argument("--cache-dir", default=None,
                   help="persist plan artifacts here (cross-process cache)")
    p.add_argument("--stats", action="store_true",
                   help="profile tables so plans are skew-aware")
    p.add_argument("--trace-dir", default=None,
                   help="write a Perfetto-loadable trace JSON per process")
    args = p.parse_args(argv)

    ctx = ExecutionContext(
        num_shards=args.num_shards,
        num_pods=args.num_pods,
        stats_mode=StatsMode.COLLECT if args.stats else StatsMode.STATIC,
        trace=Tracer() if args.trace_dir else None,
        device=device,
    )
    tabs = datagen.gen_all(args.sf, device=device)
    templates = [tpch.ALL_QUERIES[name]() for name in args.mix.split(",")]
    names = sorted({t for pq in templates for t in pq.tables})
    tables = {name: tabs[name] for name in names}

    calls_before = plan_physical.calls
    engine = QueryServeEngine(
        tables,
        ctx,
        num_slots=args.slots,
        cache=PlanCache(cache_dir=args.cache_dir),
        templates=templates,
    )
    reqs = make_query_mix(
        templates,
        [f"tenant{i}" for i in range(args.tenants)],
        args.requests,
        seed=args.seed,
        slo_s=args.slo_ms / 1e3 if args.slo_ms is not None else None,
    )
    t0 = time.perf_counter()
    engine.serve(reqs)
    elapsed = time.perf_counter() - t0

    rec = engine.record()
    rec["qps"] = args.requests / elapsed
    rec["plan_physical_calls"] = plan_physical.calls - calls_before
    if ctx.trace is not None:
        from ..obs.export import write_trace_dir

        rec["trace_path"] = write_trace_dir(
            ctx.trace, args.trace_dir, basename="qserve"
        )
    print(json.dumps(rec, indent=2, sort_keys=True))
    return rec


if __name__ == "__main__":
    main()
