"""The hand-written TPC-H queries of the port against the JAX package.

The reference's SF 0.01 tables (uniform, and with ``zipf_partkey=0.84``)
are handed to the port with ``table_from_numpy`` and dealt onto one shard
with ``shard_rows(t, 1)``, the reference's single-device run.  For Q1, Q6,
Q17 (at three (brand, container) pairs and on the skewed tables), Q3, Q14
and Q19 the port's ``q*_local`` must equal the reference's: integers bit
for bit (Q1's ``count_order``, Q3's set of order keys), f32 sums within the
tolerances of ``tests/test_relational.py`` (rtol 1e-4 for Q1, Q6, Q14 and
Q19, 1e-3 for Q17, 1e-5 for Q3's revenues: the two frameworks sum in
different orders).  Each is also held to ``repro.relational.oracle`` at
those tolerances.  On four shards, shard ``s`` of Q17's and Q3's results
(the joins and the per-shard gathers) must equal the reference's function
on shard ``s``'s rows.
"""

import numpy as np
import pytest
import torch

from repro.relational import datagen as ref_datagen
from repro.relational import operators as ref_ops
from repro.relational import oracle
from repro.relational import queries as ref_q
from repro.relational.table import Table as RefTable
from repro.relational.table import shard_rows as ref_shard_rows
from repro_torch.relational import operators as ops
from repro_torch.relational import queries as Q
from repro_torch.relational.table import shard_rows, table_from_numpy

# name -> (tables, query, params); the tolerances of tests/test_relational.py
CASES = {
    "q1": ("uniform", "q1", {}),
    "q6": ("uniform", "q6", {}),
    "q17-12-2": ("uniform", "q17", {"brand": 12, "container": 2}),
    "q17-1-0": ("uniform", "q17", {"brand": 1, "container": 0}),
    "q17-3-5": ("uniform", "q17", {"brand": 3, "container": 5}),
    "q17-skewed": ("skewed", "q17", {}),
    "q3": ("uniform", "q3", {}),
    "q14": ("uniform", "q14", {}),
    "q19": ("uniform", "q19", {}),
}
RTOL = {"q1": 1e-4, "q6": 1e-4, "q17": 1e-3, "q3": 1e-5, "q14": 1e-4, "q19": 1e-4}


def _port_tables(ref_tables, shards):
    return {
        name: shard_rows(table_from_numpy(
            {c: np.asarray(v) for c, v in t.columns.items()}, np.asarray(t.valid), "cpu",
            t.dictionaries), shards)
        for name, t in ref_tables.items()
    }


@pytest.fixture(scope="module")
def tables():
    """Both packages' tables, uniform and skewed: ``{kind: (ref, port)}``,
    the port's on one shard."""
    out = {}
    for kind, zipf in (("uniform", None), ("skewed", 0.84)):
        ref = ref_datagen.gen_all(0.01, zipf_partkey=zipf)
        out[kind] = (ref, _port_tables(ref, 1))
    return out


def _run_ref(q, t, params):
    """The reference's function composed as its own tests compose it."""
    li, pt = t["lineitem"], t["part"]
    if q == "q1":
        return {k: np.asarray(v) for k, v in ref_q.q1_finalize(ref_q.q1_local(li)).items()}
    if q == "q6":
        return float(ref_q.q6_local(li))
    if q == "q17":
        return float(ref_q.q17_local(li, pt, **params))
    if q == "q3":
        got = ref_q.q3_local(t["customer"], t["orders"], li)
        return {k: np.asarray(v) for k, v in got.items()}
    if q == "q14":
        return float(ref_q.q14_finalize(*ref_q.q14_local(li, pt)))
    return float(ref_q.q19_local(li, pt))


def _run_port(q, t, params):
    """The port's function; the caller's sum over shards, then a fetch."""
    li, pt = t["lineitem"], t["part"]
    if q == "q1":
        parts = {k: v.sum(0).numpy() for k, v in Q.q1_local(li).items()}
        return Q.q1_finalize(parts)
    if q == "q6":
        return float(Q.q6_local(li).sum(0))
    if q == "q17":
        return float(Q.q17_local(li, pt, **params).sum(0))
    if q == "q3":
        got = Q.q3_local(t["customer"], t["orders"], li)
        return {k: v[0].numpy() for k, v in got.items()}
    if q == "q14":
        pr, tr = Q.q14_local(li, pt)
        return float(Q.q14_finalize(pr.sum(0).numpy(), tr.sum(0).numpy()))
    return float(Q.q19_local(li, pt).sum(0))


def _oracle(q, t, params):
    li, pt = t["lineitem"], t["part"]
    return {
        "q1": lambda: oracle.q1_oracle(li),
        "q6": lambda: oracle.q6_oracle(li),
        "q17": lambda: oracle.q17_oracle(li, pt, **params),
        "q3": lambda: oracle.q3_oracle(t["customer"], t["orders"], li),
        "q14": lambda: oracle.q14_oracle(li, pt),
        "q19": lambda: oracle.q19_oracle(li, pt),
    }[q]()


def _assert_equal(q, got, want):
    rtol = RTOL[q]
    if q == "q1":
        assert np.array_equal(np.asarray(got["count_order"], np.int64),
                              np.asarray(want["count_order"]).astype(np.int64))
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=rtol, err_msg=k)
    elif q == "q3":
        got_map = dict(zip(np.asarray(got["o_orderkey"]).tolist(),
                           np.asarray(got["revenue"]).tolist()))
        want_map = dict(zip(np.asarray(want["o_orderkey"]).tolist(),
                            np.asarray(want["revenue"]).tolist()))
        assert set(got_map) == set(want_map) and len(got_map) == 10
        for k, v in want_map.items():
            np.testing.assert_allclose(got_map[k], v, rtol=rtol, err_msg=str(k))
    else:
        np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("case", CASES)
def test_one_shard_matches_the_reference(tables, case):
    kind, q, params = CASES[case]
    ref, port = tables[kind]
    _assert_equal(q, _run_port(q, port, params), _run_ref(q, ref, params))


@pytest.mark.parametrize("case", CASES)
def test_one_shard_matches_the_oracle(tables, case):
    kind, q, params = CASES[case]
    ref, port = tables[kind]
    want = _oracle(q, ref, params)
    if q in ("q6", "q17", "q14", "q19") and kind == "uniform":
        assert want != 0.0  # (the skewed Q17 at the defaults selects no row, in both packages)
    _assert_equal(q, _run_port(q, port, params), want)


@pytest.mark.parametrize("q", ["q17", "q3"])
def test_every_shard_is_the_reference_on_its_rows(tables, q):
    """Four shards: shard ``s`` of the port's result is the reference's
    per-device function on shard ``s`` of the reference's ``shard_rows``."""
    S = 4
    ref, _ = tables["uniform"]
    port = _port_tables(ref, S)
    dealt = {n: ref_shard_rows(t, S) for n, t in ref.items()}

    def shard(s):
        out = {}
        for n, t in dealt.items():
            per = t.capacity // S
            cut = slice(s * per, (s + 1) * per)
            out[n] = RefTable({c: v[cut] for c, v in t.columns.items()}, t.valid[cut],
                              t.dictionaries)
        return out

    li, pt = port["lineitem"], port["part"]
    if q == "q17":
        got = Q.q17_local(li, pt, brand=3, container=5)
    else:
        got = Q.q3_local(port["customer"], port["orders"], li)
    for s in range(S):
        t = shard(s)
        if q == "q17":
            want = ref_q.q17_local(t["lineitem"], t["part"], brand=3, container=5)
            np.testing.assert_allclose(float(got[s]), float(want), rtol=1e-3)
        else:
            want = ref_q.q3_local(t["customer"], t["orders"], t["lineitem"])
            _assert_equal("q3", {k: v[s].numpy() for k, v in got.items()}, want)


def test_money_times_pct_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    money = rng.integers(0, 10_000_000, (2, 4096), dtype=np.int32)
    pct = rng.integers(0, 101, (2, 4096), dtype=np.int32)
    got = ops.money_times_pct(torch.from_numpy(money), torch.from_numpy(pct))
    want = np.asarray(ref_ops.money_times_pct(money, pct))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_q17_part_filter_masks_the_reference_rows(tables):
    ref, port = tables["uniform"]
    want = np.asarray(ref_q.q17_part_filter(ref["part"], 12, 2).valid)
    got = Q.q17_part_filter(port["part"], 12, 2)
    assert want.sum() > 0 and np.array_equal(got.valid[0].numpy(), want)
