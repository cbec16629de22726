"""All nine TPC-H queries through the port, on the CPU, against the JAX package.

Both packages compute on identical data: the reference's SF 0.01 tables are
handed to the port with ``table_from_numpy``.

* One shard: the port's ``run_query`` equals the reference's — integer
  outputs exactly, f32 sums within rtol 1e-5 (the two frameworks sum in
  different orders).
* 8 shards and 2 pods x 4: the port equals ``repro.relational.oracle`` at
  the reference tests' tolerances (``tests/test_planner.py``).
* The CUDA pack knob and the scheduled transports give bit-identical
  answers to the plain pack; the pod mesh equals the flat mesh exactly.
* An entry point called without a device on a machine without CUDA raises.
"""

import numpy as np
import pytest
import torch

from repro.relational import datagen as ref_datagen
from repro.relational import oracle
from repro.relational.context import ExecutionContext as RefContext
from repro.relational.planner import tpch as ref_tpch
from repro_torch.relational import datagen
from repro_torch.relational.context import ExecutionContext
from repro_torch.relational.distributed import q3_distributed, q17_distributed
from repro_torch.relational.planner import tpch
from repro_torch.relational.table import table_from_numpy

QUERIES = sorted(tpch.ALL_QUERIES)


@pytest.fixture(scope="module")
def ref_tables():
    return ref_datagen.gen_all(0.01)


@pytest.fixture(scope="module")
def tables(ref_tables):
    return {
        name: table_from_numpy(
            {c: np.asarray(v) for c, v in t.columns.items()}, np.asarray(t.valid),
            "cpu", t.dictionaries,
        )
        for name, t in ref_tables.items()
    }


def _cpu(**kw) -> ExecutionContext:
    return ExecutionContext(device="cpu", **kw)


def _oracle(q, t):
    li, pt, od, cu = t["lineitem"], t["part"], t["orders"], t["customer"]
    return {
        "q1": lambda: oracle.q1_oracle(li),
        "q3": lambda: oracle.q3_oracle(cu, od, li),
        "q4": lambda: oracle.q4_oracle(li, od),
        "q6": lambda: oracle.q6_oracle(li),
        "q12": lambda: oracle.q12_oracle(li, od),
        "q14": lambda: oracle.q14_oracle(li, pt),
        "q17": lambda: oracle.q17_oracle(li, pt),
        "q18": lambda: oracle.q18_oracle(li, od, cu),
        "q19": lambda: oracle.q19_oracle(li, pt),
    }[q]()


def _assert_matches_oracle(q, got, want):
    """The tolerances of the reference's own oracle tests."""
    if q == "q1":
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=1e-4, err_msg=k)
    elif q in ("q6", "q19"):
        np.testing.assert_allclose(float(got), want, rtol=1e-4)
    elif q in ("q14", "q17"):
        np.testing.assert_allclose(float(got), want, rtol=1e-3)
    elif q == "q3":
        assert [int(k) for k in got["o_orderkey"]] == [int(k) for k in want["o_orderkey"]]
        np.testing.assert_allclose(np.asarray(got["revenue"], np.float64), want["revenue"],
                                   rtol=1e-5)
    elif q == "q4":
        np.testing.assert_array_equal(np.asarray(got["order_count"]), want)
        assert want.sum() > 0
    elif q == "q12":
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    elif q == "q18":
        def as_map(r):
            return {int(k): (int(tp), float(sq)) for k, tp, sq in
                    zip(r["o_orderkey"], r["o_totalprice"], r["sum_qty"])}
        assert len(want["o_orderkey"]) > 0 and as_map(got) == as_map(want)


def _assert_same_result(got, want, rtol):
    if not isinstance(want, dict):
        np.testing.assert_allclose(float(got), float(want), rtol=rtol)
        return
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("q", QUERIES)
def test_single_shard_equals_reference_run_query(q, ref_tables, tables):
    want = ref_tpch.run_query(ref_tpch.ALL_QUERIES[q](), ref_tables, RefContext(num_shards=1))
    got = tpch.run_query(tpch.ALL_QUERIES[q](), tables, _cpu(num_shards=1))
    _assert_same_result(got, want, rtol=1e-5)


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("q", QUERIES)
def test_eight_shards_match_oracle(q, pods, ref_tables, tables):
    got = tpch.run_query(tpch.ALL_QUERIES[q](), tables, _cpu(num_shards=8, num_pods=pods))
    _assert_matches_oracle(q, got, _oracle(q, ref_tables))


@pytest.mark.parametrize("q", ["q17", "q3"])
def test_kernel_pack_and_scheduled_transport_are_bit_exact(q, tables):
    base = tpch.run_query(tpch.ALL_QUERIES[q](), tables,
                          _cpu(num_shards=8, impl="xla", pack_impl="torch"))
    for impl in ("round_robin", "one_factorization"):
        got = tpch.run_query(tpch.ALL_QUERIES[q](), tables,
                             _cpu(num_shards=8, impl=impl, pack_impl="cuda", num_chunks=2))
        _assert_same_result(got, base, rtol=0)


@pytest.mark.parametrize("q", ["q3", "q18"])
def test_pod_mesh_equals_flat_mesh(q, tables):
    flat = tpch.run_query(tpch.ALL_QUERIES[q](), tables, _cpu(num_shards=8))
    pod = tpch.run_query(tpch.ALL_QUERIES[q](), tables, _cpu(num_shards=8, num_pods=2))
    _assert_same_result(pod, flat, rtol=0)


@pytest.mark.parametrize("cross_pod", ["broadcast", "reshard"])
def test_q17_on_pods_under_both_cross_pod_strategies(cross_pod, ref_tables, tables):
    got = q17_distributed(tables["lineitem"], tables["part"],
                          _cpu(num_shards=8, num_pods=2, cross_pod=cross_pod,
                               impl="round_robin"))
    np.testing.assert_allclose(float(got), _oracle("q17", ref_tables), rtol=1e-3)


def test_overflow_raises_instead_of_losing_rows(tables):
    from repro_torch.relational.planner import executor

    pq = tpch.q3()
    ctx = _cpu(num_shards=8)
    run = executor.compile_plan(tpch.plan_query(pq, tables, ctx), tables, ctx)
    result, dropped, reports = run.dispatch()
    assert int(dropped) == 0 and len(reports) == 2
    with pytest.raises(RuntimeError, match="dropped 5 rows"):
        run.finalize((result, dropped + 5, reports))


@pytest.mark.parametrize("impl", ["xla", "round_robin", "one_factorization"])
def test_pinned_transport_packs_through_the_kernel(impl, tables):
    from repro_torch.relational.planner import executor

    pq = tpch.q3()
    ctx = _cpu(num_shards=8, impl=impl)
    run = executor.compile_plan(tpch.plan_query(pq, tables, ctx), tables, ctx)
    assert (run.mux.impl, run.mux.pack_impl) == (impl, "cuda")


def test_entry_points_need_a_device_without_cuda(monkeypatch, tables):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q3_distributed(tables["customer"], tables["orders"], tables["lineitem"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpch.run_query(tpch.q6(), tables, ExecutionContext(num_shards=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        datagen.gen_all(0.01)
