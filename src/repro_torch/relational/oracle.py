"""Pure-numpy float64 reference implementations of the TPC-H queries.

A copy of ``repro.relational.oracle`` (:func:`_np` fetches torch columns
to the host, and :func:`q18_oracle` works on whole arrays so it can check
TPC-H SF 30), so ``chip_smoke.py`` can check answers without the JAX
package.  The engine must agree with these to ~1e-4 relative (f32
accumulation vs f64).  Deliberately written in the dumbest possible style —
dictionaries and boolean masks — so bugs here are unlikely to correlate with
bugs in the engine.
"""

from __future__ import annotations

import numpy as np

from .datagen import LINESTATUS, RETURNFLAGS, date_to_days
from .table import Table


def _np(table: Table) -> dict[str, np.ndarray]:
    cols = {k: v.cpu().numpy() for k, v in table.columns.items()}
    cols["_valid"] = table.valid.cpu().numpy()
    return cols


def q1_oracle(lineitem: Table, delta_days: int = 90):
    t = _np(lineitem)
    cutoff = date_to_days(1998, 12, 1) - delta_days
    m = t["_valid"] & (t["l_shipdate"] <= cutoff)
    gid = t["l_returnflag"] * len(LINESTATUS) + t["l_linestatus"]
    price = t["l_extendedprice"].astype(np.float64)
    disc = t["l_discount"].astype(np.float64) / 100.0
    tax = t["l_tax"].astype(np.float64) / 100.0
    ngroups = len(RETURNFLAGS) * len(LINESTATUS)
    out = {
        k: np.zeros(ngroups)
        for k in (
            "sum_qty",
            "sum_base_price",
            "sum_disc_price",
            "sum_charge",
            "sum_disc",
            "count_order",
        )
    }
    for g in range(ngroups):
        mm = m & (gid == g)
        out["sum_qty"][g] = t["l_quantity"][mm].sum()
        out["sum_base_price"][g] = price[mm].sum()
        out["sum_disc_price"][g] = (price * (1 - disc))[mm].sum()
        out["sum_charge"][g] = (price * (1 - disc) * (1 + tax))[mm].sum()
        out["sum_disc"][g] = disc[mm].sum()
        out["count_order"][g] = mm.sum()
    return out


def q6_oracle(lineitem: Table, year: int = 1994) -> float:
    t = _np(lineitem)
    lo, hi = date_to_days(year, 1, 1), date_to_days(year + 1, 1, 1)
    m = (
        t["_valid"]
        & (t["l_shipdate"] >= lo)
        & (t["l_shipdate"] < hi)
        & (t["l_discount"] >= 5)
        & (t["l_discount"] <= 7)
        & (t["l_quantity"] < 24)
    )
    rev = t["l_extendedprice"].astype(np.float64) * t["l_discount"] / 100.0
    return float(rev[m].sum())


def q17_oracle(
    lineitem: Table, part: Table, brand: int = 12, container: int = 2
) -> float:
    lt, pt = _np(lineitem), _np(part)
    sel_parts = set(
        pt["p_partkey"][
            pt["_valid"] & (pt["p_brand"] == brand) & (pt["p_container"] == container)
        ].tolist()
    )
    by_part: dict[int, list[int]] = {}
    for i in range(lt["l_partkey"].shape[0]):
        if lt["_valid"][i] and int(lt["l_partkey"][i]) in sel_parts:
            by_part.setdefault(int(lt["l_partkey"][i]), []).append(i)
    total = 0.0
    for pk, idxs in by_part.items():
        avg = np.mean([lt["l_quantity"][i] for i in idxs])
        for i in idxs:
            if lt["l_quantity"][i] < 0.2 * avg:
                total += float(lt["l_extendedprice"][i])
    return total / 7.0


def q3_oracle(
    customer: Table,
    orders: Table,
    lineitem: Table,
    segment: int = 1,
    cutoff: int | None = None,
):
    ct, ot, lt = _np(customer), _np(orders), _np(lineitem)
    cutoff = date_to_days(1995, 3, 15) if cutoff is None else cutoff
    good_cust = set(
        ct["c_custkey"][ct["_valid"] & (ct["c_mktsegment"] == segment)].tolist()
    )
    good_orders = {}
    for i in range(ot["o_orderkey"].shape[0]):
        if (
            ot["_valid"][i]
            and ot["o_orderdate"][i] < cutoff
            and int(ot["o_custkey"][i]) in good_cust
        ):
            good_orders[int(ot["o_orderkey"][i])] = i
    revenue: dict[int, float] = {}
    for i in range(lt["l_orderkey"].shape[0]):
        ok = int(lt["l_orderkey"][i])
        if lt["_valid"][i] and lt["l_shipdate"][i] > cutoff and ok in good_orders:
            r = float(lt["l_extendedprice"][i]) * (100 - int(lt["l_discount"][i])) / 100.0
            revenue[ok] = revenue.get(ok, 0.0) + r
    top = sorted(revenue.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    return {
        "o_orderkey": np.array([k for k, _ in top], np.int32),
        "revenue": np.array([v for _, v in top]),
    }


def q14_oracle(lineitem: Table, part: Table, year: int = 1995, month: int = 9,
               promo_brands: int = 5) -> float:
    lt, pt = _np(lineitem), _np(part)
    lo = date_to_days(year, month, 1)
    hi = lo + 30
    brand_of = {int(k): int(b) for k, b in zip(pt["p_partkey"], pt["p_brand"])}
    promo = total = 0.0
    for i in range(lt["l_orderkey"].shape[0]):
        if not lt["_valid"][i]:
            continue
        if not (lo <= lt["l_shipdate"][i] < hi):
            continue
        pk = int(lt["l_partkey"][i])
        if pk not in brand_of:
            continue
        rev = float(lt["l_extendedprice"][i]) * (100 - int(lt["l_discount"][i])) / 100.0
        total += rev
        if brand_of[pk] < promo_brands:
            promo += rev
    return 100.0 * promo / max(total, 1e-9)


def q4_oracle(
    lineitem: Table, orders: Table, year: int = 1993, month: int = 7
) -> np.ndarray:
    """Order-priority counts over orders with >= 1 late lineitem (EXISTS)."""
    from .datagen import ORDERPRIORITIES

    lt, ot = _np(lineitem), _np(orders)
    lo = date_to_days(year, month, 1)
    m2, y2 = (month + 3, year) if month + 3 <= 12 else (month - 9, year + 1)
    hi = date_to_days(y2, m2, 1)
    late = set()
    for i in range(lt["l_orderkey"].shape[0]):
        if lt["_valid"][i] and lt["l_commitdate"][i] < lt["l_receiptdate"][i]:
            late.add(int(lt["l_orderkey"][i]))
    counts = np.zeros(len(ORDERPRIORITIES))
    for i in range(ot["o_orderkey"].shape[0]):
        if (
            ot["_valid"][i]
            and lo <= ot["o_orderdate"][i] < hi
            and int(ot["o_orderkey"][i]) in late
        ):
            counts[int(ot["o_orderpriority"][i])] += 1
    return counts


def q12_oracle(
    lineitem: Table, orders: Table, year: int = 1994,
    modes: tuple[int, ...] = (5, 3),
) -> dict:
    """Per-shipmode high/low priority line counts (all modes; only the
    selected ones can be nonzero)."""
    from .datagen import SHIPMODES

    lt, ot = _np(lineitem), _np(orders)
    lo, hi = date_to_days(year, 1, 1), date_to_days(year + 1, 1, 1)
    prio_of = {
        int(k): int(p)
        for k, p, v in zip(ot["o_orderkey"], ot["o_orderpriority"],
                           ot["_valid"])
        if v
    }
    high = np.zeros(len(SHIPMODES))
    low = np.zeros(len(SHIPMODES))
    for i in range(lt["l_orderkey"].shape[0]):
        if not lt["_valid"][i]:
            continue
        if int(lt["l_shipmode"][i]) not in modes:
            continue
        if not (lt["l_commitdate"][i] < lt["l_receiptdate"][i]):
            continue
        if not (lt["l_shipdate"][i] < lt["l_commitdate"][i]):
            continue
        if not (lo <= lt["l_receiptdate"][i] < hi):
            continue
        ok = int(lt["l_orderkey"][i])
        if ok not in prio_of:
            continue
        m = int(lt["l_shipmode"][i])
        if prio_of[ok] < 2:
            high[m] += 1
        else:
            low[m] += 1
    return {"high_line_count": high, "low_line_count": low}


def q18_oracle(
    lineitem: Table, orders: Table, customer: Table,
    threshold: int = 300, k: int = 100,
) -> dict:
    """Large-volume customers: orders whose lineitems sum past ``threshold``
    quantity, top-``k`` by o_totalprice descending (ties by order key).

    Written with whole-array numpy (a per-order ``bincount`` and a sort)
    rather than the reference's row loop, so it checks the out-of-core runs
    at TPC-H SF 30 (180 M lineitem rows) in seconds; the sums are of integer
    quantities in float64, so exact.  A test holds it to the reference's
    loop.
    """
    lt, ot, ct = _np(lineitem), _np(orders), _np(customer)
    lv = lt["_valid"]
    sums = np.bincount(
        lt["l_orderkey"][lv].astype(np.int64),
        weights=lt["l_quantity"][lv].astype(np.float64),
    )
    seg = np.full(int(ct["c_custkey"].max(initial=0)) + 1, -1, np.int64)
    seg[ct["c_custkey"][ct["_valid"]]] = ct["c_mktsegment"][ct["_valid"]]
    ok = ot["o_orderkey"].astype(np.int64)
    ck = ot["o_custkey"].astype(np.int64)
    osum = np.where((ok >= 0) & (ok < len(sums)), sums[np.clip(ok, 0, len(sums) - 1)], 0.0)
    oseg = np.where((ck >= 0) & (ck < len(seg)), seg[np.clip(ck, 0, len(seg) - 1)], -1)
    keep = np.flatnonzero(ot["_valid"] & (osum > threshold) & (oseg >= 0))
    price = ot["o_totalprice"][keep].astype(np.int64)
    top = keep[np.lexsort((ok[keep], -price))[:k]]
    return {
        "o_orderkey": ok[top],
        "o_custkey": ck[top],
        "c_mktsegment": oseg[top],
        "o_orderdate": ot["o_orderdate"][top].astype(np.int64),
        "o_totalprice": ot["o_totalprice"][top].astype(np.int64),
        "sum_qty": osum[top],
    }


def q19_oracle(lineitem: Table, part: Table, terms=None) -> float:
    from .queries import Q19_TERMS

    terms = terms or Q19_TERMS
    lt, pt = _np(lineitem), _np(part)
    pmap = {
        int(k): (int(b), int(c), int(s))
        for k, b, c, s in zip(
            pt["p_partkey"], pt["p_brand"], pt["p_container"], pt["p_size"]
        )
        if True
    }
    total = 0.0
    for i in range(lt["l_orderkey"].shape[0]):
        if not lt["_valid"][i]:
            continue
        pk = int(lt["l_partkey"][i])
        if pk not in pmap:
            continue
        b, c, s = pmap[pk]
        q = int(lt["l_quantity"][i])
        ok = any(
            b == tb and tc_lo <= c < tc_hi and tq_lo <= q <= tq_hi and 1 <= s <= ts_hi
            for (tb, tc_lo, tc_hi, tq_lo, tq_hi, ts_hi) in terms
        )
        if ok:
            total += float(lt["l_extendedprice"][i]) * (100 - int(lt["l_discount"][i])) / 100.0
    return total


__all__ = ["q1_oracle", "q6_oracle", "q17_oracle", "q3_oracle",
           "q14_oracle", "q19_oracle", "q4_oracle", "q12_oracle",
           "q18_oracle"]
