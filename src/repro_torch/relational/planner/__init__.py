"""Declarative query-plan subsystem (port of ``repro.relational.planner``).

* :mod:`.logical` — the relational operator DAG and its expression language;
* :mod:`.physical` — the cost-based physical planner and ``explain()``;
* :mod:`.executor` — runs a physical plan on the simulated fabric;
* :mod:`.stream` — runs the same plan out of core, one morsel of a chunked
  source at a time;
* :mod:`.tpch` — the nine TPC-H queries as logical plans;
* :mod:`.plan_cache` — the persistent plan + compile cache the
  query-serving engine plans through.
"""

from .logical import (
    Aggregate,
    Expr,
    Filter,
    GroupBy,
    HashJoin,
    Project,
    Scan,
    TopK,
    col,
    lit,
    where,
)
from .physical import (
    PhysicalPlan,
    PlannerConfig,
    choose_join_strategy,
    exchange_bytes,
    plan_physical,
    use_preaggregation,
)
from .executor import compile_plan, execute_plan
from .plan_cache import (
    PlanCache,
    PlanKey,
    canonical_render,
    plan_key,
    stats_bucket,
)
from .stream import compile_plan_streamed

__all__ = [
    "Aggregate",
    "Expr",
    "Filter",
    "GroupBy",
    "HashJoin",
    "Project",
    "Scan",
    "TopK",
    "col",
    "lit",
    "where",
    "PhysicalPlan",
    "PlannerConfig",
    "choose_join_strategy",
    "exchange_bytes",
    "plan_physical",
    "use_preaggregation",
    "execute_plan",
    "compile_plan",
    "compile_plan_streamed",
    "PlanCache",
    "PlanKey",
    "canonical_render",
    "plan_key",
    "stats_bucket",
]
