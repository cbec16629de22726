"""TPC-H-like data generator (port of ``repro.relational.datagen``).

The columns are drawn with numpy in exactly the reference's rng order, so
every column is ``np.array_equal`` to the reference's; only the last step
differs: the arrays become torch tensors on the caller's device (the card
unless ``device="cpu"``).  TPC-H cardinality ratios per scale factor
(SF 1 = 6M lineitem rows); strings are dictionary-encoded, money is int32
cents, dates are int32 days since 1992-01-01.  ``zipf_partkey`` /
``zipf_orderkey`` switch those keys from uniform to Zipf(z), the skew
experiment of paper §3.1.  :func:`gen_lineitem_chunked` generates lineitem
chunk by chunk on the host, for out-of-core streaming.
"""

from __future__ import annotations

import numpy as np

from .table import Table, resolve_device, table_from_numpy

# TPC-H cardinalities per scale factor.
CARD = {
    "customer": 150_000,
    "orders": 1_500_000,
    "lineitem": 6_000_000,  # ~4 per order
    "part": 200_000,
    "partsupp": 800_000,
}

RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
MKTSEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
ORDERPRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
CONTAINERS = [
    f"{s} {t}"
    for s in ["SM", "LG", "MED", "JUMBO", "WRAP"]
    for t in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
]

DATE_MIN_DAYS = 0  # 1992-01-01
DATE_MAX_DAYS = 2526  # ~1998-12-01

# Minimum row counts at tiny scale factors (keeps every table shardable).
FLOORS = {
    "part": 64,
    "customer": 64,
    "orders": 256,
    "lineitem": 1024,
}


def table_capacity(name: str, sf: float) -> int:
    """Row count of table ``name`` at scale factor ``sf`` — the one
    definition both the generators and ``tpch.tpch_catalog`` use."""
    return max(int(CARD[name] * sf), FLOORS[name])


def date_to_days(y: int, m: int, d: int) -> int:
    """Days since 1992-01-01 (proleptic, numpy datetime arithmetic)."""
    return int(
        (np.datetime64(f"{y:04d}-{m:02d}-{d:02d}") - np.datetime64("1992-01-01"))
        / np.timedelta64(1, "D")
    )


def _zipf_ranks(rng, n: int, domain: int, z: float) -> np.ndarray:
    """n samples from a Zipf(z) over [0, domain) via inverse-CDF on the pmf."""
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    pmf = ranks**-z
    pmf /= pmf.sum()
    return rng.choice(domain, size=n, p=pmf)


def _table(cols: dict[str, np.ndarray], device, dictionaries=None) -> Table:
    n = len(next(iter(cols.values())))
    return table_from_numpy(cols, np.ones(n, bool), resolve_device(device), dictionaries)


def part_columns(sf: float, seed: int = 1) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = table_capacity("part", sf)
    return {
        "p_partkey": np.arange(n, dtype=np.int32),
        "p_brand": rng.integers(0, len(BRANDS), n).astype(np.int32),
        "p_container": rng.integers(0, len(CONTAINERS), n).astype(np.int32),
        "p_retailprice": (
            90000 + (np.arange(n) % 20001) * 10  # cents, dbgen-like ramp
        ).astype(np.int32),
        "p_size": rng.integers(1, 51, n).astype(np.int32),
    }


def customer_columns(sf: float, seed: int = 2) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = table_capacity("customer", sf)
    return {
        "c_custkey": np.arange(n, dtype=np.int32),
        "c_mktsegment": rng.integers(0, len(MKTSEGMENTS), n).astype(np.int32),
    }


def orders_columns(sf: float, seed: int = 3) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = table_capacity("orders", sf)
    ncust = table_capacity("customer", sf)
    # draw order matters: it is the reference's, column for column
    custkey = rng.integers(0, ncust, n).astype(np.int32)
    orderdate = rng.integers(DATE_MIN_DAYS, DATE_MAX_DAYS - 151, n).astype(
        np.int32
    )
    priority = rng.integers(0, len(ORDERPRIORITIES), n).astype(np.int32)
    # capped below 2**23 so Q18's f32 top-k key stays integer-exact
    totalprice = rng.integers(90_000, 55_000_00, n).astype(np.int32)
    return {
        "o_orderkey": np.arange(n, dtype=np.int32),
        "o_custkey": custkey,
        "o_orderdate": orderdate,
        "o_shippriority": np.zeros(n, np.int32),
        "o_orderpriority": priority,
        "o_totalprice": totalprice,
    }


def _lineitem_columns(
    rng,
    n: int,
    npart: int,
    norder: int,
    zipf_partkey: float | None,
    zipf_orderkey: float | None,
) -> dict[str, np.ndarray]:
    if zipf_partkey:
        partkey = _zipf_ranks(rng, n, npart, zipf_partkey).astype(np.int32)
    else:
        partkey = rng.integers(0, npart, n).astype(np.int32)
    qty = rng.integers(1, 51, n).astype(np.int32)
    # extendedprice = qty * part retail-ish price (cents); fits int32
    price = (qty.astype(np.int32) * (90000 + (partkey.astype(np.int32) % 2000) * 100))
    orderdate = rng.integers(DATE_MIN_DAYS, DATE_MAX_DAYS - 151, n)
    shipdate = (orderdate + rng.integers(1, 122, n)).astype(np.int32)
    if zipf_orderkey:
        orderkey = _zipf_ranks(rng, n, norder, zipf_orderkey).astype(np.int32)
    else:
        orderkey = rng.integers(0, norder, n).astype(np.int32)
    discount = rng.integers(0, 11, n).astype(np.int32)  # percent
    tax = rng.integers(0, 9, n).astype(np.int32)  # percent
    returnflag = rng.integers(0, len(RETURNFLAGS), n).astype(np.int32)
    linestatus = rng.integers(0, len(LINESTATUS), n).astype(np.int32)
    commitdate = (orderdate + rng.integers(30, 91, n)).astype(np.int32)
    receiptdate = (shipdate + rng.integers(1, 31, n)).astype(np.int32)
    shipmode = rng.integers(0, len(SHIPMODES), n).astype(np.int32)
    return {
        "l_orderkey": orderkey,
        "l_partkey": partkey,
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
        "l_shipmode": shipmode,
    }


def lineitem_columns(
    sf: float,
    seed: int = 4,
    zipf_partkey: float | None = None,
    zipf_orderkey: float | None = None,
) -> dict[str, np.ndarray]:
    return _lineitem_columns(
        np.random.default_rng(seed),
        table_capacity("lineitem", sf),
        table_capacity("part", sf),
        table_capacity("orders", sf),
        zipf_partkey,
        zipf_orderkey,
    )


LINEITEM_DICTIONARIES = {
    "l_returnflag": RETURNFLAGS,
    "l_linestatus": LINESTATUS,
    "l_shipmode": SHIPMODES,
}


def gen_part(sf: float, seed: int = 1, device="cuda") -> Table:
    return _table(part_columns(sf, seed), device,
                  {"p_brand": BRANDS, "p_container": CONTAINERS})


def gen_customer(sf: float, seed: int = 2, device="cuda") -> Table:
    return _table(customer_columns(sf, seed), device,
                  {"c_mktsegment": MKTSEGMENTS})


def gen_orders(sf: float, seed: int = 3, device="cuda") -> Table:
    return _table(orders_columns(sf, seed), device,
                  {"o_orderpriority": ORDERPRIORITIES})


def gen_lineitem(
    sf: float,
    seed: int = 4,
    zipf_partkey: float | None = None,
    zipf_orderkey: float | None = None,
    device="cuda",
) -> Table:
    return _table(
        lineitem_columns(sf, seed, zipf_partkey, zipf_orderkey), device,
        LINEITEM_DICTIONARIES,
    )


def gen_lineitem_chunked(
    sf: float,
    num_chunks: int,
    seed: int = 4,
    zipf_partkey: float | None = None,
    zipf_orderkey: float | None = None,
):
    """Lineitem as a chunked :class:`~repro_torch.relational.source.GeneratorSource`.

    Each chunk is generated lazily, on the host (CPU tensors), from its own
    seed ``(seed, chunk_index)``, so only one chunk of rows is resident at a
    time; its columns equal the reference's chunk byte for byte.  Key
    domains (part and order capacities) are those of the full scale factor,
    so joins against ``gen_part`` / ``gen_orders`` at the same ``sf`` behave
    like one big table.  The stream is its own dataset, not a re-chunking of
    ``gen_lineitem(sf, seed)``; its oracle is ``source.materialize()``.
    """
    from .source import GeneratorSource

    if num_chunks < 1:
        raise ValueError("num_chunks must be >= 1")
    total = table_capacity("lineitem", sf)
    chunk_rows = -(-total // num_chunks)  # ceil: capacity rounds up to fit
    npart = table_capacity("part", sf)
    norder = table_capacity("orders", sf)

    def make_chunk(i: int) -> Table:
        rng = np.random.default_rng((seed, i))
        cols = _lineitem_columns(rng, chunk_rows, npart, norder, zipf_partkey, zipf_orderkey)
        return _table(cols, "cpu", LINEITEM_DICTIONARIES)

    return GeneratorSource(make_chunk, num_chunks, chunk_rows)


def gen_all(
    sf: float,
    seed: int = 0,
    zipf_partkey: float | None = None,
    zipf_orderkey: float | None = None,
    device="cuda",
) -> dict[str, Table]:
    return {
        "part": gen_part(sf, seed + 1, device),
        "customer": gen_customer(sf, seed + 2, device),
        "orders": gen_orders(sf, seed + 3, device),
        "lineitem": gen_lineitem(sf, seed + 4, zipf_partkey, zipf_orderkey, device),
    }


__all__ = [
    "CARD",
    "FLOORS",
    "table_capacity",
    "RETURNFLAGS",
    "LINESTATUS",
    "MKTSEGMENTS",
    "ORDERPRIORITIES",
    "SHIPMODES",
    "BRANDS",
    "CONTAINERS",
    "date_to_days",
    "part_columns",
    "customer_columns",
    "orders_columns",
    "lineitem_columns",
    "gen_part",
    "gen_customer",
    "gen_orders",
    "gen_lineitem",
    "gen_lineitem_chunked",
    "gen_all",
]
