"""Distributed TPC-H entry points — thin wrappers over the query planner
(port of ``repro.relational.distributed``).

Every query is a logical plan (``planner/tpch.py``); the cost-based physical
planner places the exchanges and the executor runs them over the simulated
fabric through one per-query multiplexer.  Execution is parameterized by ONE
:class:`~repro_torch.relational.context.ExecutionContext` (mesh shape,
multiplexer knobs, planner config, stats mode, device).  Capacities are the
static zero-drop bound and any exchange overflow raises.
"""

from __future__ import annotations

from .planner import tpch
from .planner.tpch import run_query as _run


def q1_distributed(lineitem, ctx=None, delta_days: int = 90):
    return _run(tpch.q1(delta_days), {"lineitem": lineitem}, ctx)


def q6_distributed(lineitem, ctx=None, year: int = 1994):
    return _run(tpch.q6(year), {"lineitem": lineitem}, ctx)


def q17_distributed(lineitem, part, ctx=None, brand: int = 12,
                    container: int = 2):
    return _run(
        tpch.q17(brand, container), {"lineitem": lineitem, "part": part}, ctx
    )


def q3_distributed(customer, orders, lineitem, ctx=None, segment: int = 1):
    return _run(
        tpch.q3(segment),
        {"customer": customer, "orders": orders, "lineitem": lineitem},
        ctx,
    )


def q14_distributed(
    lineitem, part, ctx=None, year: int = 1995, month: int = 9,
    promo_brands: int = 5,
):
    return _run(
        tpch.q14(year, month, promo_brands),
        {"lineitem": lineitem, "part": part}, ctx,
    )


def q19_distributed(lineitem, part, ctx=None, terms=None):
    return _run(tpch.q19(terms), {"lineitem": lineitem, "part": part}, ctx)


def q4_distributed(lineitem, orders, ctx=None, year: int = 1993,
                   month: int = 7):
    return _run(
        tpch.q4(year, month), {"lineitem": lineitem, "orders": orders}, ctx
    )


def q12_distributed(
    lineitem, orders, ctx=None, year: int = 1994,
    modes: tuple[int, int] = (5, 3),
):
    return _run(
        tpch.q12(year, modes), {"lineitem": lineitem, "orders": orders}, ctx
    )


def q18_distributed(
    lineitem, orders, customer, ctx=None, threshold: int = 300, k: int = 100,
):
    return _run(
        tpch.q18(threshold, k),
        {"lineitem": lineitem, "orders": orders, "customer": customer},
        ctx,
    )


__all__ = [
    "q1_distributed",
    "q3_distributed",
    "q4_distributed",
    "q6_distributed",
    "q12_distributed",
    "q14_distributed",
    "q17_distributed",
    "q18_distributed",
    "q19_distributed",
]
