"""TPC-H queries written by hand (port of ``repro.relational.queries``).

The per-shard pipelines of Q1, Q6, Q17, Q3, Q14 and Q19, the hand-written
baseline that the planner's plans (:mod:`.planner.tpch`) are held to, and
the helpers the plans take from the reference: the finalizers and Q19's
terms.  Q17 is the paper's own worked example (its Figure 6); Q1 and Q6 are
the no-network queries of its Fig 11; Q3 joins three tables.

Tables carry a leading shard dim ``[S, T]`` (the convention of
:mod:`.operators`), and each function computes every shard as the
reference's per-device function computes its device: shard ``s`` of the
result is the reference's on shard ``s`` of the tables, and a one-shard
table (``shard_rows(t, 1)``) is the reference's single-device run.  The
cross-shard combine (a sum over the shard dim) is the caller's.  The
finalizers take what the caller reduced over the shards and fetched, as
numpy; their f32 arithmetic mirrors the reference's.

All money is int32 cents, aggregated in f32 (see ``operators.sum_where``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import operators as ops
from .datagen import LINESTATUS, RETURNFLAGS, date_to_days
from .table import Table


# ----------------------------------------------------------------------------
# Q1: pricing summary report (pure aggregation, 6 groups).
# ----------------------------------------------------------------------------

def q1_local(lineitem: Table, delta_days: int = 90) -> dict[str, torch.Tensor]:
    """Per-shard partial aggregates ``[S, 6]``; sum over shards, then
    :func:`q1_finalize`."""
    cutoff = date_to_days(1998, 12, 1) - delta_days
    mask = lineitem.valid & (lineitem["l_shipdate"] <= cutoff)
    gid = lineitem["l_returnflag"] * len(LINESTATUS) + lineitem["l_linestatus"]
    price = lineitem["l_extendedprice"].to(torch.float32)
    disc = lineitem["l_discount"].to(torch.float32) / 100.0
    tax = lineitem["l_tax"].to(torch.float32) / 100.0
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    num_groups = len(RETURNFLAGS) * len(LINESTATUS)
    return ops.groupby_dense(
        gid,
        num_groups,
        {
            "sum_qty": (lineitem["l_quantity"], "sum"),
            "sum_base_price": (price, "sum"),
            "sum_disc_price": (disc_price, "sum"),
            "sum_charge": (charge, "sum"),
            "sum_disc": (disc, "sum"),
            "count_order": (gid, "count"),
        },
        mask,
    )


def q1_finalize(partials: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    cnt = np.maximum(partials["count_order"].astype(np.float32), np.float32(1.0))
    return {
        **partials,
        "avg_qty": partials["sum_qty"] / cnt,
        "avg_price": partials["sum_base_price"] / cnt,
        "avg_disc": partials["sum_disc"] / cnt,
    }


# ----------------------------------------------------------------------------
# Q6: forecasting revenue change (filter + scalar aggregate).
# ----------------------------------------------------------------------------

def q6_local(lineitem: Table, year: int = 1994) -> torch.Tensor:
    """Per-shard revenue ``[S]`` (f32)."""
    lo = date_to_days(year, 1, 1)
    hi = date_to_days(year + 1, 1, 1)
    d = lineitem["l_discount"]
    mask = (
        lineitem.valid
        & (lineitem["l_shipdate"] >= lo)
        & (lineitem["l_shipdate"] < hi)
        & (d >= 5)
        & (d <= 7)
        & (lineitem["l_quantity"] < 24)
    )
    revenue = ops.money_times_pct(lineitem["l_extendedprice"], d)
    return ops.sum_where(revenue, mask)


# ----------------------------------------------------------------------------
# Q17: small-quantity-order revenue, the paper's Figure 6 example.
#   SELECT sum(l_extendedprice)/7 FROM lineitem, part
#   WHERE p_partkey = l_partkey AND p_brand = X AND p_container = Y
#     AND l_quantity < 0.2 * (SELECT avg(l_quantity) FROM lineitem
#                             WHERE l_partkey = p_partkey)
# ----------------------------------------------------------------------------

def q17_part_filter(part: Table, brand: int, container: int) -> Table:
    return part.with_mask((part["p_brand"] == brand) & (part["p_container"] == container))


def q17_local(lineitem: Table, part: Table, brand: int = 12, container: int = 2) -> torch.Tensor:
    """Per-shard Q17 ``[S]``: semi-join, correlated AVG, anti-filter, sum."""
    fpart = q17_part_filter(part, brand, container)
    _, match = ops.join_pk(fpart["p_partkey"], fpart.valid, lineitem["l_partkey"], lineitem.valid)
    # the correlated subquery: avg(l_quantity) per partkey over the shard's
    # lineitems (matching parts only: others cannot pass the join)
    gkeys, gvalid, aggs = ops.groupby_sorted(
        lineitem["l_partkey"],
        lineitem.valid & match,
        {"sum_qty": (lineitem["l_quantity"], "sum"), "cnt": (lineitem["l_quantity"], "count")},
    )
    avg_qty = aggs["sum_qty"] / torch.clamp(aggs["cnt"].to(torch.float32), min=1.0)
    # the per-partkey average joined back to each lineitem row
    aidx, amatch = ops.join_pk(gkeys, gvalid, lineitem["l_partkey"], match)
    row_avg = avg_qty.gather(1, aidx)
    keep = amatch & (lineitem["l_quantity"].to(torch.float32) < 0.2 * row_avg)
    return ops.sum_where(lineitem["l_extendedprice"], keep) / 7.0


# ----------------------------------------------------------------------------
# Q3: shipping priority (customer x orders x lineitem, top-10 by revenue).
# ----------------------------------------------------------------------------

def q3_local(
    customer: Table,
    orders: Table,
    lineitem: Table,
    segment: int = 1,  # BUILDING
    cutoff: int | None = None,
) -> dict[str, torch.Tensor]:
    """Per-shard top 10 ``{"o_orderkey", "revenue"}``, each ``[S, 10]``."""
    cutoff = date_to_days(1995, 3, 15) if cutoff is None else cutoff
    fcust = customer.with_mask(customer["c_mktsegment"] == segment)
    ford = orders.with_mask(orders["o_orderdate"] < cutoff)
    # orders x customer on custkey (customer is the PK side)
    _, cmatch = ops.join_pk(fcust["c_custkey"], fcust.valid, ford["o_custkey"], ford.valid)
    # lineitem x orders on orderkey (orders is the PK side)
    flin = lineitem.with_mask(lineitem.valid & (lineitem["l_shipdate"] > cutoff))
    _, omatch = ops.join_pk(ford["o_orderkey"], cmatch, flin["l_orderkey"], flin.valid)
    revenue = ops.money_times_pct(flin["l_extendedprice"], 100 - flin["l_discount"])
    gkeys, gvalid, aggs = ops.groupby_sorted(
        flin["l_orderkey"], omatch, {"revenue": (revenue, "sum")}
    )
    _, payload = ops.topk_rows(
        aggs["revenue"], gvalid, 10, {"o_orderkey": gkeys, "revenue": aggs["revenue"]}
    )
    return payload


# ----------------------------------------------------------------------------
# Q14: promotion effect (lineitem x part, one month, conditional revenue).
# "PROMO" parts are brand ids < promo_brands (datagen has no p_type column).
# ----------------------------------------------------------------------------

def q14_local(lineitem: Table, part: Table, year: int = 1995, month: int = 9,
              promo_brands: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard ``(promo revenue, total revenue)``, each ``[S]``."""
    lo = date_to_days(year, month, 1)
    hi = lo + 30
    mask = lineitem.valid & (lineitem["l_shipdate"] >= lo) & (lineitem["l_shipdate"] < hi)
    pidx, match = ops.join_pk(part["p_partkey"], part.valid, lineitem["l_partkey"], mask)
    disc_price = ops.money_times_pct(lineitem["l_extendedprice"], 100 - lineitem["l_discount"])
    promo = match & (part["p_brand"].gather(1, pidx) < promo_brands)
    return ops.sum_where(disc_price, promo), ops.sum_where(disc_price, match)


def q14_finalize(promo_rev, total_rev):
    return np.float32(100.0) * promo_rev / np.maximum(total_rev, np.float32(1e-9))


# ----------------------------------------------------------------------------
# Q19: discounted revenue, a disjunction of (brand, container range, qty, size).
# ----------------------------------------------------------------------------

Q19_TERMS = (
    # (brand, container_lo, container_hi, qty_lo, qty_hi, size_hi)
    (12, 0, 10, 1, 11, 5),
    (14, 10, 25, 10, 20, 10),
    (15, 25, 40, 20, 30, 15),
)


def q19_local(lineitem: Table, part: Table, terms=Q19_TERMS) -> torch.Tensor:
    """Per-shard revenue ``[S]`` (f32)."""
    pidx, match = ops.join_pk(part["p_partkey"], part.valid, lineitem["l_partkey"],
                              lineitem.valid)
    brand = part["p_brand"].gather(1, pidx)
    container = part["p_container"].gather(1, pidx)
    size = part["p_size"].gather(1, pidx)
    qty = lineitem["l_quantity"]
    keep = torch.zeros_like(match)
    for (b, c_lo, c_hi, q_lo, q_hi, s_hi) in terms:
        keep = keep | (
            (brand == b)
            & (container >= c_lo) & (container < c_hi)
            & (qty >= q_lo) & (qty <= q_hi)
            & (size >= 1) & (size <= s_hi)
        )
    keep = keep & match
    disc_price = ops.money_times_pct(lineitem["l_extendedprice"], 100 - lineitem["l_discount"])
    return ops.sum_where(disc_price, keep)


__all__ = [
    "q1_local",
    "q1_finalize",
    "q6_local",
    "q17_part_filter",
    "q17_local",
    "q3_local",
    "q14_local",
    "q14_finalize",
    "q19_local",
    "Q19_TERMS",
]
