"""The port's pod axis across REAL processes (2 x 4 units over Gloo on the
CPU): the port's counterpart of ``tests/test_multiprocess.py``.

ONE port cluster (``repro_torch.launch.cluster``) runs all ten scenarios of
``tests/_torch_multiproc_driver.py`` and dumps each process's integers and
answers; each scenario is one case here.  The integers are held bit for bit
to the port's in-process 2 x 4 fabric (which the other port tests hold to
the reference), the f32 answers within the reference's rtol 1e-3, the
plans' ``explain()`` to the reference planner's.  ONE reference cluster
(``repro.launch.cluster`` over ``tests/_torch_multiproc_ref_dump.py``)
holds the two-level shuffle and the hierarchical psum bit for bit.  The
``gpu`` cases run the same cluster on the card: Gloo with both processes
on one card, and NCCL with a card a rank (skipped on fewer than two).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import exchange
from repro_torch.core.exchange import POD_AXIS, SHUFFLE_AXIS, make_mesh
from repro_torch.launch.cluster import run_local_cluster

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
REF_DUMP = os.path.join(HERE, "_torch_multiproc_ref_dump.py")
PODS, UNITS = 2, 4
N = PODS * UNITS
SF = 0.01
MORSEL_ROWS = 4096

SCENARIOS = [
    "hierarchical_psum",
    "exchange_over_dci_raises",
    "two_level_shuffle",
    "production_mesh",
    "tuner_dci_aware",
    "tpch_pod_mesh",
    "ep_dispatch_two_level",
    "salted_pod_shuffle",
    "oocore_pod_stream",
    "trace_merge",
]

# the port's pack knob values -> the reference's names in explain()
PACK_NAMES = {"pack=torch": "pack=xla", "pack=cuda": "pack=pallas"}


def _as_reference(text: str) -> str:
    for port, reference in PACK_NAMES.items():
        text = text.replace(port, reference)
    return text


def _cluster(tmp, backend: str, device: str, processes: int = PODS, units: int = UNITS):
    outs = run_local_cluster(
        [DRIVER, "all", "--sf", str(SF), "--morsel-rows", str(MORSEL_ROWS), "--dump", str(tmp)],
        num_processes=processes, local_units=units, timeout_s=300, echo=False,
        backend=backend, device=device, env={"OMP_NUM_THREADS": "2"},
    )
    dumps = []
    for pid in range(processes):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            dumps.append(json.load(f))
    return outs, dumps


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    return _cluster(tmp_path_factory.mktemp("cluster"), "gloo", "cpu")


@pytest.fixture(scope="module")
def tabs():
    from repro_torch.relational import datagen

    return datagen.gen_all(SF, device="cpu")


def _in_process_inputs():
    keys = torch.from_numpy(
        np.random.default_rng(3).integers(0, 10_000, (N, 64)).astype(np.int32))
    return keys, torch.stack([keys, keys * 2 + 1], dim=2)


def _ctx(**kw):
    from repro_torch.relational.context import ExecutionContext

    return ExecutionContext(num_shards=N, num_pods=PODS, device="cpu", **kw)


def _edges(qt) -> dict:
    return {e.key: {"hist": [int(h) for h in e.hist], "overload": float(e.overload),
                    "plain_overload": float(e.plain_overload), "salted": bool(e.salted)}
            for e in qt.edges}


def _run_in_process(pq, plan, tabs):
    from repro_torch.relational.planner.executor import compile_plan

    run = compile_plan(plan, tabs, _ctx())
    out = run.dispatch()
    dropped = int(out[1])
    raw, qt = run.collect(out)
    return (pq.finalize(raw) if pq.finalize else raw), qt, dropped


def _check(scenario, cluster):
    outs, dumps = cluster
    assert all(f"PASS {scenario}" in o for o in outs), outs
    # every process returns the same integers and answers
    for d in dumps[1:]:
        assert d["results"].get(scenario) == dumps[0]["results"].get(scenario), scenario
    return dumps[0]["results"].get(scenario)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_multiprocess(scenario, cluster, tabs):
    got = _check(scenario, cluster)
    if scenario == "hierarchical_psum":
        for name, dtype, hi in (("int32", torch.int32, 1 << 20), ("float32", torch.float32, 1 << 12)):
            g = torch.from_numpy(np.random.default_rng(0).integers(0, hi, (N, 4, 3))).to(dtype)
            want = exchange.hierarchical_psum_tree(
                {"g": g}, make_mesh(N, PODS), SHUFFLE_AXIS, POD_AXIS)["g"]
            assert np.array_equal(np.asarray(got[name]), want.numpy()), name
    elif scenario == "two_level_shuffle":
        keys, rows = _in_process_inputs()
        r, v, d = exchange.hash_shuffle_two_level(
            keys, rows, make_mesh(N, PODS), SHUFFLE_AXIS, POD_AXIS, capacity=64)
        assert got == {"rows": r.tolist(), "valid": v.to(torch.int64).tolist(),
                       "dropped": d.tolist()}
    elif scenario == "tuner_dci_aware":
        from repro_torch.core.autotune import TableStats, tune_multiplexer

        mesh = make_mesh(N, PODS)
        stats = TableStats(rows=4096, row_bytes=16)
        cfg = tune_multiplexer(mesh, stats, broadcast_stats=TableStats(rows=128, row_bytes=12))
        big = tune_multiplexer(mesh, stats, broadcast_stats=TableStats(rows=1 << 20, row_bytes=64))
        assert got == {"cross_pod": cfg.cross_pod, "cross_pod_big": big.cross_pod,
                       "impl": cfg.impl, "pack_impl": cfg.pack_impl}
    elif scenario == "tpch_pod_mesh":
        from repro.relational.context import ExecutionContext as RefContext
        from repro.relational.planner import tpch as ref_tpch
        from repro_torch.relational import oracle
        from repro_torch.relational.planner import tpch

        for q in ("q17", "q3"):
            pq = tpch.ALL_QUERIES[q]()
            plan = tpch.plan_query(pq, tabs, _ctx())
            want, qt, dropped = _run_in_process(pq, plan, tabs)
            rec = got[q]
            assert rec["explain"] == plan.explain()
            catalog = {t: tabs[t].capacity for t in pq.tables}
            assert _as_reference(rec["explain"]) == ref_tpch.explain_query(
                ref_tpch.ALL_QUERIES[q](), catalog, RefContext(num_shards=N, num_pods=PODS))
            assert rec["edges"] == _edges(qt) and rec["dropped"] == dropped == 0
            if q == "q17":
                np.testing.assert_allclose(rec["answer"], float(want), rtol=1e-3)
                np.testing.assert_allclose(
                    rec["answer"], oracle.q17_oracle(tabs["lineitem"], tabs["part"]), rtol=1e-3)
            else:
                assert rec["orderkeys"] == [int(k) for k in want["o_orderkey"]]
                np.testing.assert_allclose(rec["revenue"], np.asarray(want["revenue"], np.float64),
                                           rtol=1e-3)
    elif scenario == "ep_dispatch_two_level":
        from repro_torch.configs.base import ModelConfig
        from repro_torch.distributed.sharding import MeshContext, mesh_context
        from repro_torch.models import moe

        cfg = ModelConfig(
            name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
            num_kv_heads=2, d_ff=32, vocab_size=64, num_experts=8, top_k=2,
            moe_d_ff=32, moe_impl="ep_shardmap", capacity_factor=8.0,
            dtype="float32", param_dtype="float32",
        )
        params = moe.init_moe_layer(torch.Generator().manual_seed(0), cfg)
        x = torch.randn((16, cfg.d_model), generator=torch.Generator().manual_seed(1))
        with mesh_context(MeshContext(make_mesh(N, PODS))):
            want = moe.moe_ep(params, cfg, x)
        assert got["tokens"] == want.to(torch.float64).tolist()
    elif scenario == "salted_pod_shuffle":
        from repro.relational import datagen as ref_datagen
        from repro.relational import stats as ref_stats
        from repro.relational.planner import tpch as ref_tpch
        from repro_torch.relational import datagen
        from repro_torch.relational import stats as rstats
        from repro_torch.relational.planner import tpch

        ztabs = datagen.gen_all(SF, zipf_partkey=1.2, device="cpu")
        pq = tpch.q17(brand=11, container=25)
        catalog = {t: ztabs[t].capacity for t in pq.tables}
        plan = pq.plan(catalog, N, num_pods=PODS,
                       stats=rstats.collect_stats({t: ztabs[t] for t in pq.tables}))
        want, qt, _ = _run_in_process(pq, plan, ztabs)
        plan0 = pq.plan(catalog, N, num_pods=PODS)
        want0, qt0, _ = _run_in_process(pq, plan0, ztabs)
        assert got["brand_container"] == [11, 25]  # the heaviest part's: the reference's literals
        assert got["explain"] == plan.explain()
        rtabs = ref_datagen.gen_all(SF, zipf_partkey=1.2)
        rpq = ref_tpch.q17(brand=11, container=25)
        rplan = rpq.plan(catalog, N, num_pods=PODS,
                         stats=ref_stats.collect_stats({t: rtabs[t] for t in rpq.tables}))
        assert _as_reference(got["explain"]) == rplan.explain()
        assert got["edges"] == _edges(qt) and got["edges_unsalted"] == _edges(qt0)
        assert got["dropped"] == [0, 0]
        np.testing.assert_allclose(got["answer"], float(want), rtol=1e-3)
        np.testing.assert_allclose(got["answer_unsalted"], float(want0), rtol=1e-3)
    elif scenario == "oocore_pod_stream":
        from repro_torch.relational.planner import tpch
        from repro_torch.relational.planner.stream import compile_plan_streamed
        from repro_torch.relational.source import MorselView, as_source

        pq = tpch.q17()
        sources = {"lineitem": MorselView(tabs["lineitem"], morsel_rows=MORSEL_ROWS),
                   "part": as_source(tabs["part"])}
        plan = pq.plan({t: sources[t].capacity for t in pq.tables}, N, num_pods=PODS)
        run = compile_plan_streamed(plan, sources, _ctx(num_chunks=1))
        want = float(pq.finalize(run()))
        assert got["reports"] == {k: v["hist"].tolist() for k, v in sorted(run.reports.items())}
        assert got["morsels"] == run.stats["morsels"]
        np.testing.assert_allclose(got["answer"], want, rtol=1e-3)


def test_reference_cluster_holds_the_fabric_bit_for_bit(cluster, tmp_path):
    """The reference's own 2-process JAX cluster: its two-level shuffle and
    hierarchical psum equal the port cluster's, bit for bit."""
    from repro.launch.cluster import run_local_cluster as run_reference_cluster

    out = str(tmp_path / "ref.npz")
    outs = run_reference_cluster([REF_DUMP, out], num_processes=PODS, local_devices=UNITS,
                                 timeout_s=300, echo=False)
    assert all("PASS ref_dump" in o for o in outs), outs
    ref = np.load(out)
    got = cluster[1][0]["results"]
    for k in ("rows", "valid", "dropped"):
        np.testing.assert_array_equal(np.asarray(got["two_level_shuffle"][k]),
                                      ref[f"shuffle_{k}"].astype(np.int64), err_msg=k)
    for name in ("int32", "float32"):
        np.testing.assert_array_equal(np.asarray(got["hierarchical_psum"][name]),
                                      ref[f"psum_{name}"], err_msg=name)


def _card_matches_cpu(card, cpu) -> None:
    """A card cluster's integers and answers against the CPU cluster's."""
    _outs, c_dumps = card
    _outs_cpu, p_dumps = cpu
    got, want = c_dumps[0]["results"], p_dumps[0]["results"]
    for s in ("two_level_shuffle", "tuner_dci_aware"):
        assert got[s] == want[s], s
    assert np.array_equal(np.asarray(got["hierarchical_psum"]["int32"]),
                          np.asarray(want["hierarchical_psum"]["int32"]))
    for q in ("q17", "q3"):
        g, w = got["tpch_pod_mesh"][q], want["tpch_pod_mesh"][q]
        assert g["explain"] == w["explain"]
        assert {k: e["hist"] for k, e in g["edges"].items()} == \
            {k: e["hist"] for k, e in w["edges"].items()}
        assert g["dropped"] == w["dropped"] == 0
    assert got["tpch_pod_mesh"]["q3"]["orderkeys"] == want["tpch_pod_mesh"]["q3"]["orderkeys"]
    assert got["oocore_pod_stream"]["reports"] == want["oocore_pod_stream"]["reports"]


@pytest.mark.gpu
def test_cluster_on_one_card_over_gloo(cluster, tmp_path):
    """Both processes on the one card, Gloo staging every pod-hop message
    through host memory; the packs run on the card in each process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = _cluster(tmp_path, "gloo", "cuda")
    _card_matches_cpu(card, cluster)
    launched = card[1][0]["results"]["tpch_pod_mesh"]["q3"]["launches"]
    assert launched["partition_pack"] > 0 and launched["hash_partition_pack"] > 0


@pytest.mark.gpu
def test_cluster_over_nccl_a_card_a_rank(cluster, tmp_path):
    """NCCL with one rank a card: the reference's 2 x 4 layout."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _card_matches_cpu(_cluster(tmp_path, "nccl", "cuda"), cluster)
