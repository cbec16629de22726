"""Pod-axis scenarios of the PyTorch port run as a REAL multi-process
cluster (2 processes x 4 units each, by default): the port's counterpart of
``tests/_multiproc_driver.py``.

Invoked via the port's launcher::

    python -m repro_torch.launch.cluster --processes 2 --local-units 4 \\
        --backend gloo --device cpu tests/_torch_multiproc_driver.py all

Every process runs the same scenarios; every operation over the ``pod``
axis crosses the process boundary through ``torch.distributed`` (Gloo on
the CPU or on one shared card, NCCL with a card a rank).  Each scenario
prints "PASS <name>" from every process; any exception fails the run.
``--dump DIR`` writes each process's integers, answers, plans, pack-kernel
launches and timings to ``DIR/p<pid>.json`` for the caller to hold against
the in-process fabric; ``--sf`` and ``--morsel-rows`` size the TPC-H
scenarios; ``--time-hop`` times the two-level shuffle's coarse hop alone
for each Q3 and Q17 edge.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.cluster import init_cluster, sync_processes  # noqa: E402

INFO = init_cluster()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import exchange  # noqa: E402
from repro_torch.core.exchange import POD_AXIS, SHUFFLE_AXIS, gather_units  # noqa: E402
from repro_torch.kernels import hash_partition as hp  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_context,
    make_pod_mesh,
    make_production_mesh,
    make_test_mesh,
)
from repro_torch.relational.context import ExecutionContext  # noqa: E402

DEV = "cpu" if INFO.device == "cpu" else "cuda"
ARGS = argparse.Namespace(sf=0.01, morsel_rows=4096, time_hop=False,
                          dp_archs=["train100m", "mamba2-1.3b"], dp_full=False, dp_shape=(8, 32),
                          moe_full=False, moe_layers=0, moe_shape=(8, 32), moe_fabric_check=False,
                          moe_ckpt="", moe_deep_steps=0, profile="",
                          serve_cells="qwen2.5-3b", serve_full=False,
                          serve_dtype="float32", serve_param_dtype="float32", serve_ref="whole",
                          serve_tol=1e-5, serve_repeat=1, serve_replicated="",
                          serve_continuous="", serve_prompts=[8, 16], serve_rate=2.0,
                          serve_uniform="", serve_temperature="",
                          tp_cells="deepseek-67b", tp_full=False, tp_dtype="float32",
                          tp_param_dtype="float32", tp_ref="whole", tp_repeat=1,
                          tp_temperature=0.0, tp_profile=False, tp_capacity_factor=0.0,
                          tp_mixed=(), tp_states=False, tp_split=0, tp_frames=0,
                          tp_routes=False)
RESULTS: dict = {}
PACKS = ("hash_partition_pack", "partition_pack", "moe_dispatch")


def _counts() -> dict:
    launched = {**hp.LAUNCHES, **md.LAUNCHES}
    return {k: launched[k] for k in PACKS}


def _ints(t: torch.Tensor) -> list:
    return t.cpu().to(torch.int64).tolist()


def _floats(t: torch.Tensor) -> list:
    return t.cpu().to(torch.float64).tolist()


def _pod_mesh(axes=(POD_AXIS, SHUFFLE_AXIS)):
    mesh = make_pod_mesh(axes=axes)
    assert mesh.axis_names == (POD_AXIS, SHUFFLE_AXIS), mesh.axis_names
    assert mesh.num_processes == INFO.num_processes, mesh
    return mesh


def _mine(x: torch.Tensor, mesh) -> torch.Tensor:
    """This process's units' rows of a global ``[N, ...]`` tensor."""
    return x[mesh.unit_offset:mesh.unit_offset + mesh.local_units]


def _packs_per_dispatch(plan, mux) -> dict:
    """Pack launches one in-memory run of ``plan`` implies on the card:
    ``hash_partition_pack`` once a pipeline chunk of each shuffle edge (a
    chunk count that does not divide the edge's rows runs it unchunked),
    ``partition_pack`` once an edge for the pod hop; none off the card or
    on the plain pack."""
    if DEV != "cuda" or mux.pack_impl != "cuda":
        return {"hash_partition_pack": 0, "partition_pack": 0}
    C = mux.pipeline_chunks
    P = plan.num_pods
    return {
        "hash_partition_pack": sum(C if (st.rows * P) % C == 0 else 1 for st in plan.shuffle_stats),
        "partition_pack": len(plan.shuffle_stats) if P > 1 else 0,
    }


def _check_packs(tag: str, before: dict, want: dict) -> dict:
    got = {k: _counts()[k] - before[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag}: pack launches {got}, the plan implies {want}")
    return got


def _edges(qt) -> dict:
    return {e.key: {"hist": [int(h) for h in e.hist], "overload": float(e.overload),
                    "plain_overload": float(e.plain_overload), "salted": bool(e.salted)}
            for e in qt.edges}


def scenario_hierarchical_psum():
    """RS-in-pod -> AR-cross-pod -> AG-in-pod equals a flat psum bit-exactly
    across the process boundary (int32 and exactly-representable float32),
    as functions and through the multiplexer's ``psum_tree``."""
    from repro_torch.core.multiplexer import make_multiplexer

    mesh = make_pod_mesh(axes=(POD_AXIS, "data"))
    n = mesh.num_units
    mux = make_multiplexer(mesh)
    data_axes = make_context(mesh=mesh).data_axes
    assert data_axes == (POD_AXIS, SHUFFLE_AXIS), data_axes
    out = {}
    for name, dtype, hi in (("int32", torch.int32, 1 << 20), ("float32", torch.float32, 1 << 12)):
        g = torch.from_numpy(np.random.default_rng(0).integers(0, hi, (n, 4, 3))).to(dtype)
        x = _mine(g.to(DEV), mesh)
        a = exchange.hierarchical_psum_tree({"g": x}, mesh, SHUFFLE_AXIS, POD_AXIS)["g"]
        b = exchange.flat_psum_tree({"g": x}, mesh, (POD_AXIS, SHUFFLE_AXIS))["g"]
        c = mux.psum_tree({"g": x}, data_axes)["g"]
        assert torch.equal(a, b) and torch.equal(a, c), name
        assert torch.equal(a[0].cpu(), g.sum(0, dtype=dtype)), name
        out[name] = _ints(gather_units(a, mesh)) if name == "int32" else _floats(gather_units(a, mesh))
    RESULTS["hierarchical_psum"] = out
    print("PASS hierarchical_psum")


def scenario_exchange_over_dci_raises():
    """The hybrid plan rejects any fine-grained shuffle routed over the pod
    axis, before a byte crosses the slow network."""
    from repro_torch.core.multiplexer import make_multiplexer

    mesh = _pod_mesh()
    mux = make_multiplexer(mesh)
    assert mux.plan.large_axes == (POD_AXIS,), mux.plan
    x = torch.zeros((mesh.local_units, mesh.num_pods, 4), dtype=torch.int32, device=DEV)
    for attempt in (
        lambda: mux.all_to_all(x, POD_AXIS),
        lambda: mux.hash_shuffle(x[:, :, 0], x, POD_AXIS, capacity=2),
        lambda: mux.shuffle_consume(x, POD_AXIS, lambda acc, c, s: acc, 0),
    ):
        try:
            attempt()
        except ValueError as e:
            assert "large-network axis" in str(e), e
        else:
            raise AssertionError("exchange over the DCI axis did not raise")
    print("PASS exchange_over_dci_raises")


def scenario_two_level_shuffle():
    """The two-level exchange (coarse cross-process hop + fine in-pod
    shuffle) loses no rows and lands every row on the unit owning its
    global hash, for both transports and both packs."""
    mesh = _pod_mesh()
    P, n = mesh.num_pods, mesh.n
    N, T = P * n, 64
    keys = torch.from_numpy(
        np.random.default_rng(3).integers(0, 10_000, (N, T)).astype(np.int32))
    rows = torch.stack([keys, keys * 2 + 1], dim=2)
    k, r = _mine(keys.to(DEV), mesh), _mine(rows.to(DEV), mesh)
    me = exchange.axis_index(mesh, POD_AXIS, DEV) * n + exchange.axis_index(mesh, SHUFFLE_AXIS, DEV)
    out = {}
    for impl in ("round_robin", "xla"):
        for pack in ("torch", "cuda"):
            before = _counts()
            out_rows, out_valid, dropped = exchange.hash_shuffle_two_level(
                k, r, mesh, SHUFFLE_AXIS, POD_AXIS, capacity=T, impl=impl, pack_impl=pack)
            want = {"hash_partition_pack": 1, "partition_pack": 1} \
                if (pack, DEV) == ("cuda", "cuda") else {"hash_partition_pack": 0, "partition_pack": 0}
            _check_packs(f"two_level_shuffle {impl}/{pack}", before, want)
            h = exchange.fibonacci_hash(out_rows[..., 0]) % N
            assert bool(torch.where(out_valid, h == me[:, None], True).all())
            assert int(dropped[0]) == 0 and bool((dropped == dropped[0]).all())
            assert int(exchange.unit_sum(out_valid.sum(1), mesh)) == N * T
            got = {"rows": _ints(gather_units(out_rows, mesh)),
                   "valid": _ints(gather_units(out_valid, mesh)),
                   "dropped": _ints(gather_units(dropped, mesh))}
            if out:
                assert got == next(iter(out.values())), f"{impl}/{pack} disagrees"
            out[f"{impl}/{pack}"] = got
    RESULTS["two_level_shuffle"] = out["round_robin/torch"]

    # every pod-axis transport across the processes against the same mesh
    # held whole by this process
    whole = exchange.Mesh(P, n)
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 100, (N, P, 6, 2))).to(DEV)
    for impl, chunks in (("round_robin", 1), ("round_robin", 3), ("xla", 1)):
        assert torch.equal(exchange.all_to_all(_mine(x, mesh), mesh, POD_AXIS, impl, chunks),
                           _mine(exchange.all_to_all(x, whole, POD_AXIS, impl, chunks), mesh))
    for impl in ("ring", "xla"):
        assert torch.equal(exchange.broadcast_exchange(_mine(x, mesh), mesh, POD_AXIS, impl),
                           _mine(exchange.broadcast_exchange(x, whole, POD_AXIS, impl), mesh))
    assert torch.equal(exchange.psum(_mine(x, mesh), mesh, POD_AXIS),
                       _mine(exchange.psum(x, whole, POD_AXIS), mesh))

    def fold(acc, c, src):
        return acc * 3 + c * (src[:, None, None] + 1)

    init = torch.zeros((N, 6, 2), dtype=x.dtype, device=DEV)
    assert torch.equal(
        exchange.scheduled_all_to_all_consume(_mine(x, mesh), mesh, POD_AXIS, fold,
                                              _mine(init, mesh)),
        _mine(exchange.scheduled_all_to_all_consume(x, whole, POD_AXIS, fold, init), mesh))
    print("PASS two_level_shuffle")


def scenario_production_mesh():
    """make_production_mesh derives the pod axis from the live process
    topology; the reference's in-pod names map onto the port's ``q``."""
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.axis_names == (POD_AXIS, SHUFFLE_AXIS), mesh.axis_names
    assert mesh.num_pods == INFO.num_processes, mesh
    assert mesh.num_units == INFO.num_processes * INFO.local_units, mesh
    assert mesh.num_processes == INFO.num_processes and mesh.local_units == INFO.local_units
    ctx = make_context(multi_pod=True)
    assert ctx.pod_axis == POD_AXIS and ctx.exchange_size == INFO.local_units, ctx
    assert ctx.data_axes == (POD_AXIS, SHUFFLE_AXIS)
    assert make_test_mesh() == mesh
    flat = make_production_mesh()
    assert flat.num_pods == 1 and flat.num_processes == 1 and flat.num_units == mesh.num_units
    print("PASS production_mesh")


def scenario_tuner_dci_aware():
    """tune_multiplexer on the live two-level mesh prices the DCI hop and
    picks a cross-pod strategy for the build side; refine=True there warns
    and stays analytical."""
    import warnings

    from repro_torch.core.autotune import TableStats, exchange_makespan, tune_multiplexer

    mesh = _pod_mesh()
    pods, n = mesh.num_pods, mesh.n
    stats = TableStats(rows=4096, row_bytes=16)
    cfg = tune_multiplexer(mesh, stats, broadcast_stats=TableStats(rows=128, row_bytes=12))
    assert cfg.impl in ("xla", "round_robin", "one_factorization")
    assert cfg.cross_pod in ("broadcast", "reshard"), cfg
    one = exchange_makespan(stats, n)
    two = exchange_makespan(stats, n, num_pods=pods)
    assert two > one, (one, two)
    cfg_big = tune_multiplexer(mesh, stats, broadcast_stats=TableStats(rows=1 << 20, row_bytes=64))
    assert cfg_big.cross_pod == "reshard", cfg_big
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        refined = tune_multiplexer(mesh, stats, refine=True, device=DEV)
    assert any("two-level" in str(x.message) for x in w), [str(x.message) for x in w]
    assert refined.measured_s is None
    RESULTS["tuner_dci_aware"] = {"cross_pod": cfg.cross_pod, "cross_pod_big": cfg_big.cross_pod,
                                  "impl": cfg.impl, "pack_impl": cfg.pack_impl}
    print("PASS tuner_dci_aware")


def _run(pq, plan, tabs, ctx):
    from repro_torch.relational.planner.executor import compile_plan

    run = compile_plan(plan, tabs, ctx)
    before = _counts()
    out = run.dispatch()
    dropped = int(out[1])
    raw, qt = run.collect(out)
    launches = _check_packs(plan.name, before, _packs_per_dispatch(plan, run.mux))
    got = pq.finalize(raw) if pq.finalize else raw
    return got, qt, dropped, launches, run


def _time_coarse_hop(plan, mesh, mux, tag: str, repeats: int = 5) -> list:
    """The two-level shuffle's coarse hop alone for each shuffle edge of
    ``plan``: the hop-1 message buffers (``[units, pods, rows, columns +
    key]`` int32, capacity one shard's rows a peer pod) and their counts
    through the pod-axis transport the run used; the least wall of
    ``repeats`` runs, each started together by a barrier and ended by the
    card's queue draining."""
    from repro_torch.core.exchange import _hop1_impl

    hop = _hop1_impl(mux.impl)
    out = []
    for i, st in enumerate(plan.shuffle_stats):
        T, width = st.rows, st.row_bytes // 4 + 1
        gen = torch.Generator(DEV).manual_seed(i)
        bufs = torch.randint(0, 1 << 20, (mesh.local_units, mesh.num_pods, T, width),
                             dtype=torch.int32, device=DEV, generator=gen)
        counts = torch.full((mesh.local_units, mesh.num_pods, 1), T, dtype=torch.int32,
                            device=DEV)
        walls = []
        for r in range(repeats + 2):  # two warm-up runs
            sync_processes()
            if DEV == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            exchange.all_to_all(bufs, mesh, POD_AXIS, impl=hop)
            exchange.all_to_all(counts, mesh, POD_AXIS, impl=hop)
            if DEV == "cuda":
                torch.cuda.synchronize()
            if r >= 2:
                walls.append(time.perf_counter() - t0)
        out.append({"edge": i, "rows": st.rows, "row_bytes": st.row_bytes, "transport": hop,
                    "message_bytes": T * width * 4, "wall_s": min(walls), "walls_s": walls})
        print(f"[hop] {tag} edge {i}: {T} rows x {width * 4} B a message, {hop}: coarse hop "
              f"{min(walls) * 1e3:.4f} ms (least of {repeats})")
    return out


def scenario_tpch_pod_mesh():
    """TPC-H Q3 and Q17 on the two-level mesh across processes match the
    numpy oracle: the pod-aware planner, the two-level exchanges and the
    cross-pod combines."""
    from repro_torch.relational import datagen, oracle
    from repro_torch.relational.planner import tpch

    mesh = _pod_mesh()
    pods, n = mesh.num_pods, mesh.n
    tabs = datagen.gen_all(ARGS.sf, device=DEV)
    ctx = ExecutionContext(num_shards=pods * n, num_pods=pods, device=DEV)
    out = {}
    for q in ("q17", "q3"):
        pq = tpch.ALL_QUERIES[q]()
        plan = tpch.plan_query(pq, tabs, ctx)
        got, qt, dropped, launches, run = _run(pq, plan, tabs, ctx)
        assert dropped == 0, dropped
        rec = {"explain": plan.explain(), "edges": _edges(qt), "dropped": dropped,
               "launches": launches}
        if q == "q17":
            want = oracle.q17_oracle(tabs["lineitem"], tabs["part"])
            np.testing.assert_allclose(float(got), want, rtol=1e-3)
            rec["answer"] = float(got)
        else:
            want = oracle.q3_oracle(tabs["customer"], tabs["orders"], tabs["lineitem"])
            assert [int(k) for k in got["o_orderkey"]] == [int(k) for k in want["o_orderkey"]]
            np.testing.assert_allclose(np.asarray(got["revenue"], np.float64),
                                       np.asarray(want["revenue"], np.float64), rtol=1e-3)
            rec["orderkeys"] = [int(k) for k in got["o_orderkey"]]
            rec["revenue"] = [float(v) for v in got["revenue"]]
        if ARGS.time_hop:
            rec["coarse_hop"] = _time_coarse_hop(plan, mesh, run.mux, q)
        out[q] = rec
    RESULTS["tpch_pod_mesh"] = out
    print("PASS tpch_pod_mesh")


def scenario_ep_dispatch_two_level():
    """MoE expert dispatch through the two-level fabric across the process
    boundary is token-for-token identical to the flat route (each process
    holding the whole one-pod mesh); a single-level multiplexer on the pod
    mesh is rejected; under a two-level multiplexer with the kernel pack
    the tokens are the same again."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.multiplexer import make_multiplexer, use_multiplexer
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import moe

    cfg = ModelConfig(
        name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
        num_kv_heads=2, d_ff=32, vocab_size=64, num_experts=8, top_k=2,
        moe_d_ff=32, moe_impl="ep_shardmap", capacity_factor=8.0,
        dtype="float32", param_dtype="float32",
    )
    # identical on every process (same seed): the cluster-wide replicas
    params = {k: v.to(DEV) for k, v in
              moe.init_moe_layer(torch.Generator().manual_seed(0), cfg).items()}
    x = torch.randn((16, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(DEV)

    pod_mesh = make_pod_mesh(axes=(POD_AXIS, "model"))
    N = pod_mesh.num_units
    assert cfg.num_experts % N == 0 and x.shape[0] % N == 0, (cfg, N)
    flat_mesh = exchange.make_mesh(N)
    assert flat_mesh.num_processes == 1
    ctx_flat, ctx_pod = MeshContext(flat_mesh), MeshContext(pod_mesh)

    with mesh_context(ctx_flat):
        want = moe.moe_ep(params, cfg, x)
    with mesh_context(ctx_pod):
        got = moe.moe_ep(params, cfg, x)
    assert torch.equal(want, got), (want - got).abs().max()

    try:
        with mesh_context(ctx_pod), use_multiplexer(make_multiplexer(flat_mesh)):
            moe.moe_ep(params, cfg, x)
    except ValueError as e:
        assert "single-level multiplexer" in str(e), e
    else:
        raise AssertionError("flat mux on the pod mesh did not raise")

    before = _counts()
    with mesh_context(ctx_pod), use_multiplexer(make_multiplexer(pod_mesh, pack_impl="cuda")):
        got_k = moe.moe_ep(params, cfg, x)
    launches = _check_packs("ep_dispatch_two_level", before,
                            {"moe_dispatch": 1 if DEV == "cuda" else 0})
    assert torch.equal(want, got_k), (want - got_k).abs().max()
    RESULTS["ep_dispatch_two_level"] = {"tokens": _floats(got), "launches": launches}
    print("PASS ep_dispatch_two_level")


def scenario_salted_pod_shuffle():
    """Salting works ACROSS the pod axis: Zipf(1.2) ``l_partkey`` Q17 on
    the two-level mesh (the heavy key's sub-keys spread over every global
    shard, crossing the process boundary), measured max/fair-share below
    the unsalted run's, result equal to the numpy oracle."""
    from repro_torch.relational import datagen, oracle
    from repro_torch.relational import stats as rstats
    from repro_torch.relational.planner import tpch

    mesh = _pod_mesh()
    pods, n = mesh.num_pods, mesh.n
    tabs = datagen.gen_all(ARGS.sf, zipf_partkey=1.2, device=DEV)
    # select the heaviest part: its brand and container (11 and 25 at SF 0.01,
    # the reference's literals)
    li, pt = tabs["lineitem"], tabs["part"]
    heavy = int(torch.bincount(li["l_partkey"][li.valid].long()).argmax())
    row = int(torch.nonzero(pt["p_partkey"] == heavy)[0, 0])
    brand, container = int(pt["p_brand"][row]), int(pt["p_container"][row])
    pq = tpch.q17(brand=brand, container=container)
    want = oracle.q17_oracle(li, pt, brand, container)
    assert want > 0
    catalog = {t: tabs[t].capacity for t in pq.tables}
    stats = rstats.collect_stats({t: tabs[t] for t in pq.tables})
    ctx = ExecutionContext(num_shards=pods * n, num_pods=pods, device=DEV)

    plan = pq.plan(catalog, pods * n, num_pods=pods, stats=stats)
    assert "salted x" in plan.explain()
    got, qt, dropped, launches, _ = _run(pq, plan, tabs, ctx)
    np.testing.assert_allclose(float(got), want, rtol=1e-3)
    # the salted edge: lineitem's l_partkey shuffle (at larger scale factors
    # part ships over a shuffle edge of its own too)
    (edge,) = [e for e in qt.edges if e.salted]
    assert edge.key.startswith("shuffle[l_partkey]"), edge.key
    salted_over, plain_over = float(edge.overload), float(edge.plain_overload)
    assert plain_over > 2.0, plain_over
    assert salted_over < 1.3, salted_over

    plan0 = pq.plan(catalog, pods * n, num_pods=pods)
    got0, qt0, dropped0, launches0, _ = _run(pq, plan0, tabs, ctx)
    np.testing.assert_allclose(float(got0), want, rtol=1e-3)
    (edge0,) = [e for e in qt0.edges if e.key.startswith("shuffle[l_partkey]")]
    assert not any(e.salted for e in qt0.edges)
    if sum(edge0.hist) == sum(edge.hist):
        # both plans shuffle the same rows (at SF 0.01 they do; at SF 1 the
        # static plan joins part first and ships only the matches)
        assert float(edge0.overload) == plain_over
    assert salted_over < float(edge0.overload)
    RESULTS["salted_pod_shuffle"] = {
        "brand_container": [brand, container], "explain": plan.explain(), "edges": _edges(qt), "edges_unsalted": _edges(qt0),
        "overload": [salted_over, float(edge0.overload)],
        "answer": float(got), "answer_unsalted": float(got0), "dropped": [dropped, dropped0],
        "launches": {k: launches[k] + launches0[k] for k in launches},
    }
    print("PASS salted_pod_shuffle")


def scenario_oocore_pod_stream():
    """Morsel-streamed Q17 ACROSS the process boundary: the chunked lineitem
    stream feeds the two-level exchange one morsel at a time, result equal
    to the in-memory pod-mesh run; spill is refused at compile time.  One
    pipeline chunk a shuffle, so the pack launches follow from the
    runner's counters."""
    from repro_torch.relational import datagen
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.executor import execute_plan
    from repro_torch.relational.planner.stream import compile_plan_streamed
    from repro_torch.relational.source import MorselView, as_source

    mesh = _pod_mesh()
    pods, n = mesh.num_pods, mesh.n
    tabs = datagen.gen_all(ARGS.sf, device=DEV)
    pq = tpch.q17()
    sources = {"lineitem": MorselView(tabs["lineitem"], morsel_rows=ARGS.morsel_rows),
               "part": as_source(tabs["part"])}
    mat = {t: sources[t].materialize() for t in pq.tables}
    catalog = {t: sources[t].capacity for t in pq.tables}
    plan = pq.plan(catalog, pods * n, num_pods=pods)
    ctx = ExecutionContext(num_shards=pods * n, num_pods=pods, device=DEV, num_chunks=1)
    want = float(pq.finalize(execute_plan(plan, mat, ctx)))

    run = compile_plan_streamed(plan, sources, ctx)
    before = _counts()
    got = float(pq.finalize(run()))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert run.stats["passes"] == 2, run.stats
    steps = run.stats["morsels"] // run.stats["passes"]
    packs = sum(steps * s["streamed"] + s["resident"] for s in run.shuffles_per_step)
    on_card = DEV == "cuda" and run.mux.pack_impl == "cuda"
    launches = _check_packs("oocore_pod_stream", before, {
        "hash_partition_pack": packs if on_card else 0,
        "partition_pack": packs if on_card else 0})

    try:
        compile_plan_streamed(plan, sources, ctx.with_(spill=True))
    except NotImplementedError:
        pass
    else:
        raise AssertionError("spill on the pod mesh did not raise")
    RESULTS["oocore_pod_stream"] = {
        "answer": got, "answer_in_memory": want, "morsels": run.stats["morsels"],
        "reports": {k: [int(h) for h in v["hist"]] for k, v in sorted(run.reports.items())},
        "launches": launches,
    }
    print("PASS oocore_pod_stream")


def scenario_trace_merge():
    """One timeline for the whole cluster: each process traces its own Q17
    run and writes ``<dir>/q17-p<pid>.json``; after a barrier, process 0
    merges them into one Perfetto timeline whose events carry every
    process's track."""
    import shutil
    import tempfile

    from repro_torch.obs.export import merge_trace_dir, write_trace_dir
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational import datagen
    from repro_torch.relational.planner import tpch

    # the processes of a cluster share a host: key the directory on the
    # rendezvous address so concurrent clusters never collide
    tag = (INFO.coordinator or "solo").replace(":", "-").replace("/", "-")
    trace_dir = os.path.join(tempfile.gettempdir(), f"repro-torch-trace-{tag}")
    if INFO.process_id == 0:
        shutil.rmtree(trace_dir, ignore_errors=True)
        os.makedirs(trace_dir, exist_ok=True)
    sync_processes()

    mesh = _pod_mesh()
    pods, n = mesh.num_pods, mesh.n
    tabs = datagen.gen_all(0.01, device=DEV)
    pq = tpch.q17()
    tracer = Tracer()  # pid resolves to the torch.distributed rank
    assert tracer.pid == INFO.process_id
    tpch.run_query(
        pq, {t: tabs[t] for t in pq.tables},
        ExecutionContext(num_shards=pods * n, num_pods=pods, trace=tracer, device=DEV),
    )
    path = write_trace_dir(tracer, trace_dir, basename="q17")
    assert path.endswith(f"q17-p{INFO.process_id}.json")
    sync_processes()

    if INFO.process_id == 0:
        merged = merge_trace_dir(trace_dir, basename="q17",
                                 out=os.path.join(trace_dir, "merged.json"))
        pids = {e["pid"] for e in merged["traceEvents"]}
        assert pids == set(range(INFO.num_processes)), pids
        for pid in pids:
            names = {e["name"] for e in merged["traceEvents"]
                     if e["pid"] == pid and e["ph"] == "B"}
            assert any(nm.startswith("exchange:") for nm in names), (pid, names)
        assert merged["counters"]["exchange.measured_bytes"] > 0
        with open(os.path.join(trace_dir, "merged.json")) as f:
            json.load(f)  # Perfetto-loadable JSON on disk
    sync_processes()
    if INFO.process_id == 0:
        shutil.rmtree(trace_dir, ignore_errors=True)
    print("PASS trace_merge")


def _synced(fn):
    """``(fn(), seconds)``, the card drained on both sides."""
    if DEV == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if DEV == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profiled_step(step, state, rows, tag: str) -> dict:
    """``--profile``: from ``state``, one more step counted op by op
    (``launch.op_cost``: flops, bytes, collective bytes by kind, the peak of
    live bytes beside the allocator's), then one under ``torch.profiler``
    (CPU and CUDA), timed, its chrome trace written to ``--profile`` and read
    by ``roofline.trace_overlap``.  Both new states are dropped."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import op_cost, roofline

    out = {}
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["allocated_before"] = torch.cuda.memory_allocated()
    exchange.reset_pod_hop()
    counter = op_cost.OpCounter()
    with counter.counting():
        new, _ = step(state, rows)
        del new
    r = counter.result()
    out.update(flops=r["flops"], bytes=r["bytes"], collective_bytes=r["collective_bytes"],
               peak_live_bytes=r["peak_live_bytes"], kernels=r["kernels"],
               pod_hop_bytes=exchange.POD_HOP["bytes"],
               pod_hop_kinds=exchange.pod_hop_kinds(), max_memory_allocated=_peak())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEV == "cuda" else [])
    with profile(activities=activities) as prof:
        (new, _), out["step_s"] = _synced(lambda: step(state, rows))
        del new
    path = os.path.join(ARGS.profile, f"{tag}_p{INFO.process_id}.json")
    prof.export_chrome_trace(path)
    out["trace"] = path
    out["overlap"] = roofline.trace_overlap(path)
    return out


def _digest(tree) -> str:
    """sha256 of every leaf's bytes, in order."""
    import hashlib

    from repro_torch.tree import leaves

    h = hashlib.sha256()
    for t in leaves(tree):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _worst_leaf(got, want) -> float:
    """The largest ``max |a - b| / max |b|`` over the leaves."""
    from repro_torch.tree import leaves

    return max(float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                1e-30)
               for a, b in zip(leaves(got), leaves(want)))


def _dp_kernel(cfg) -> tuple[dict, str, int]:
    """The launch counter and name of the kernel each forward pass of
    ``cfg`` launches once a layer (twice under remat: the recompute), and
    that count a pass (none off the card)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    counter = sk.LAUNCHES if cfg.family == "ssm" else fa.LAUNCHES
    key = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    per_pass = cfg.num_layers * (1 if cfg.remat == "none" else 2) if DEV == "cuda" else 0
    return counter, key, per_pass


def scenario_dp_train():
    """Data-parallel training across the processes (``train/step.py``):
    every process holds the same params from one seed and takes its
    contiguous rows of one global batch (``local_rows``).  Process 0 first
    runs the one-process step on the whole batch (no mesh: no
    ``torch.distributed``).  Then, under ``grad_sync="auto"`` (each
    process's gradient, one all-reduce a leaf over the processes) and
    ``"hierarchical"`` (a gradient a unit, the two-level psum tree), the
    gradient half and 3 steps from the same state: the first gradient's loss
    (rel 1e-5) and every leaf (``1e-4 * max |b|``) and the first step's loss
    and grad norm (rel 1e-5, 1e-4) equal process 0's one-process run, the
    params after 3 steps are bit-identical on every process, the attention
    (or scan) kernel launches once a layer a forward pass, twice under
    remat, on one pass a step (``"auto"``) or one a unit, and the pod hop
    carries each leaf's bytes once (``"auto"``) or its blocks padded to the
    unit count (``"hierarchical"``), never a stack of the process's units.
    A batch the processes, or a process's rows the units, do not split
    raises.  ``--dp-archs``, ``--dp-full`` and ``--dp-shape`` set the
    models and the global batch."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.step import local_rows, make_grad_fn, process_mean, unit_mean
    from repro_torch.tree import leaves, tree_map

    mesh = _pod_mesh()
    ctx = MeshContext(mesh)
    rank, R, units = INFO.process_id, mesh.num_processes, mesh.local_units
    B, S = ARGS.dp_shape
    opt = AdamWConfig()
    out = RESULTS.setdefault("dp_train", {})
    for arch in ARGS.dp_archs:
        cfg = (get_config if ARGS.dp_full else get_smoke_config)(arch)
        if cfg.family != "ssm":
            cfg = cfg.scaled(attn_impl="flash")
        api = registry.build(cfg)
        state = TrainState.create(api, 0, device=DEV)
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(DEV),
                 "labels": torch.from_numpy(toks[:, 1:]).to(DEV)}
        sizes = [t.numel() for t in leaves(state.params)]
        counter, kernel, per_pass = _dp_kernel(cfg)
        rec = {"params": sum(sizes), "leaves": len(sizes),
               "leaf_bytes": 4 * (sum(sizes) + 1),
               "padded_bytes": 4 * sum(-(-m // mesh.n) * mesh.n for m in sizes + [1]),
               "kernel": kernel, "modes": {}}
        if rank == 0:  # the one-process step on the whole global batch
            (ref_loss, ref_grads), rec["one_process_grad_s"] = _synced(
                lambda: make_grad_fn(api)(state.params, batch))
            one_step = make_train_step(api, opt)
            ref, ref_m = state, []
            for _ in range(3):
                ref, m = one_step(ref, batch)
                ref_m.append({k: float(v) for k, v in m.items()})
            rec["one_process"] = ref_m
        sync_processes()  # so no process's timings hold the wait for process 0
        rows = local_rows(batch, mesh)
        try:
            local_rows({k: v[:B - 1] for k, v in batch.items()}, mesh)
            raise AssertionError("a batch the processes do not split was taken")
        except ValueError:
            pass
        for mode in ("auto", "hierarchical"):
            mapi = registry.build(cfg.scaled(grad_sync=mode))
            grad_fn, step = make_grad_fn(mapi), make_train_step(mapi, opt)
            passes = 1 if mode == "auto" else units
            m_rec = {}
            with mesh_context(ctx):
                if mode == "hierarchical":
                    try:
                        grad_fn(state.params, {k: v[:units // 2] for k, v in rows.items()})
                        raise AssertionError("rows the units do not split were taken")
                    except ValueError:
                        pass
                exchange.reset_pod_hop()
                k0 = counter[kernel]
                (loss, grads), m_rec["grad_s"] = _synced(lambda: grad_fn(state.params, rows))
                m_rec["grad_hop"] = dict(exchange.POD_HOP)
                m_rec["grad_launches"] = counter[kernel] - k0
                s, metrics, walls, hops, launched = state, [], [], [], []
                for _ in range(3):
                    exchange.reset_pod_hop()
                    k0 = counter[kernel]
                    (s, m), wall = _synced(lambda: step(s, rows))
                    hops.append(exchange.POD_HOP["bytes"])
                    launched.append(counter[kernel] - k0)
                    walls.append(wall)
                    metrics.append({k: float(v) for k, v in m.items()})
                # the sync alone, on tensors of the gradient's shapes
                if mode == "auto":
                    tree = {"loss": loss, "grads": grads}
                    sync = lambda: process_mean(tree, mesh)  # noqa: E731
                else:
                    tree = {"loss": loss.expand(units).contiguous(),
                            "grads": tree_map(lambda g: g.expand((units,) + g.shape).contiguous(),
                                              grads)}
                    sync = lambda: unit_mean(tree, mesh)  # noqa: E731
                exchange.reset_pod_hop()
                _, m_rec["sync_s"] = _synced(sync)
                m_rec["sync_hop"] = dict(exchange.POD_HOP)
                del tree
                if ARGS.profile and mode == "auto":
                    m_rec["profile"] = _profiled_step(step, s, rows, f"dp_{arch}")
            m_rec.update(step_s=walls, step_hop_bytes=hops, launches=launched, metrics=metrics,
                         per_step=passes * per_pass)
            if any(n != passes * per_pass for n in launched + [m_rec["grad_launches"]]):
                raise AssertionError(f"dp_train {arch} {mode}: {kernel} launched "
                                     f"{[m_rec['grad_launches']] + launched} a call, the plan "
                                     f"implies {passes} passes x {per_pass}")
            want_bytes = rec["leaf_bytes"] if mode == "auto" else rec["padded_bytes"]
            if set(hops + [m_rec["grad_hop"]["bytes"], m_rec["sync_hop"]["bytes"]]) != {want_bytes}:
                raise AssertionError(f"dp_train {arch} {mode}: the pod hop carried {hops} B a "
                                     f"step, {want_bytes} B expected")
            digests = [None] * R
            dist.all_gather_object(digests, _digest(s.params))
            m_rec["ranks_identical"] = len(set(digests)) == 1
            if not m_rec["ranks_identical"]:
                raise AssertionError(f"dp_train {arch} {mode}: the params differ between ranks "
                                     "after 3 steps")
            if rank == 0:
                m_rec["loss_rel"] = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
                m_rec["leaf_rel"] = _worst_leaf(grads, ref_grads)
                m_rec["step_loss_rel"] = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                          for a, b in zip(metrics, ref_m)]
                m_rec["step_norm_rel"] = [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                                          for a, b in zip(metrics, ref_m)]
                m_rec["params_abs"] = max(float((a - b).abs().max())
                                          for a, b in zip(leaves(s.params), leaves(ref.params)))
                if (m_rec["loss_rel"] > 1e-5 or m_rec["leaf_rel"] > 1e-4
                        or m_rec["step_loss_rel"][0] > 1e-5 or m_rec["step_norm_rel"][0] > 1e-4):
                    raise AssertionError(f"dp_train {arch} {mode} against the one-process step: "
                                         f"{m_rec}")
            rec["modes"][mode] = m_rec
            print(f"[dp] {arch} {mode}: steps {' '.join(f'{w * 1e3:.1f}' for w in walls)} ms; "
                  f"sync alone {m_rec['sync_s'] * 1e3:.1f} ms, {m_rec['sync_hop']['bytes']} B in "
                  f"{m_rec['sync_hop']['messages']} messages; {kernel} {launched} a step")
            del grads, s
        out[arch] = rec
        del state, batch, rows
        if rank == 0:
            del ref, ref_grads
    print("PASS dp_train")


def _expert_leaf(path) -> bool:
    return path[-1] in ("w_gate", "w_up", "w_down") and "ffn" in path and "shared" not in path


def _whole_experts(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every process's rows of an expert leaf, in expert order, on every
    process (``gather_units`` of its ``[local_units, E_loc, ...]`` view)."""
    U = mesh.local_units
    return gather_units(t.reshape((U, t.shape[0] // U) + tuple(t.shape[1:])), mesh).reshape(
        (mesh.num_units * (t.shape[0] // U),) + tuple(t.shape[1:]))


def _process_rows(ref: dict | None, like: dict, mesh) -> dict:
    """Process 0's whole host leaves ``ref`` cut, for each process, to the
    rows of the leaves ``like`` that it holds, and sent to it over the
    process fabric (one process's rows at a time); on every process, its
    own rows on ``DEV``."""
    import torch.distributed as dist

    out = {}
    for p, t in like.items():
        n = t.shape[0]
        if mesh.process_index == 0:
            wire = "cpu" if dist.get_backend(mesh.group) == "gloo" else DEV
            exchange._p2p(mesh, [(r, 0, ref[p][r * n:(r + 1) * n].to(wire))
                                 for r in range(1, mesh.num_processes)], [])
            out[p] = ref[p][:n].to(DEV)
        else:
            out[p] = torch.empty_like(t)
            exchange._p2p(mesh, [], [(0, 0, out[p])])
    return out


def _moe_cfg(layers: int, dtype: str):
    from repro_torch.configs import get_config, get_smoke_config

    base = (get_config if ARGS.moe_full else get_smoke_config)("olmoe-1b-7b")
    return base.scaled(num_layers=layers or base.num_layers, moe_impl="ep_shardmap",
                       remat="block", attn_impl="flash", dtype=dtype, param_dtype="float32")


def _moe_batch(cfg, shape):
    B, S = shape
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(DEV),
            "labels": torch.from_numpy(toks[:, 1:]).to(DEV)}


def _moe_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa

    return {"moe_dispatch": md.LAUNCHES["moe_dispatch"], "flash_attention": fa.LAUNCHES[
        "flash_attention"]}


def _moe_steps(api, step, held: list, rows, steps: int) -> tuple:
    """``steps`` train steps from the state in the one-item list ``held``,
    which they take out of it, so that no caller keeps a state a step
    replaces (a full-depth state is a third of a card); per step its wall,
    metrics, pod-hop bytes and kernel launches."""
    state = held.pop()
    walls, metrics, hops, launched = [], [], [], []
    for _ in range(steps):
        exchange.reset_pod_hop()
        k0 = _moe_launches()
        (state, m), wall = _synced(lambda: step(state, rows))
        walls.append(wall)
        metrics.append({k: float(v) for k, v in m.items()})
        hops.append(exchange.POD_HOP["bytes"])
        launched.append({k: v - k0[k] for k, v in _moe_launches().items()})
    return state, {"step_s": walls, "metrics": metrics, "step_hop_bytes": hops,
                   "launches": launched}


def _peak() -> int | None:
    return torch.cuda.max_memory_allocated() if DEV == "cuda" else None


def _reset_peak() -> None:
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _hop_gradients(mesh) -> dict:
    """The pod-axis all-to-all's backward is the same hop on the gradient:
    for ``y = all_to_all(x)`` and a loss ``<y, w>``, ``dx = all_to_all(w)``,
    bit for bit, for the monolithic and the scheduled transport."""
    U, P = mesh.local_units, mesh.num_pods
    out = {}
    for impl in ("xla", "round_robin"):
        gen = torch.Generator().manual_seed(7 + INFO.process_id)
        x = torch.randn((U, P, 6, 3), generator=gen).to(DEV).requires_grad_()
        w = torch.randn((U, P, 6, 3), generator=gen).to(DEV)
        y = exchange.all_to_all(x, mesh, POD_AXIS, impl=impl)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        out[impl] = bool(torch.equal(g, exchange.all_to_all(w, mesh, POD_AXIS, impl=impl)))
        if not out[impl]:
            raise AssertionError(f"moe_train: the {impl} pod hop's backward is not the hop")
    return out


def _moe_warm_up(mesh, pack_impl: str) -> None:
    """One gradient of the smoke config over this process's own whole
    mesh: a process's first training pass loads its kernels and libraries,
    which would otherwise happen inside the first sharded gradient, with
    the other processes waiting on it at the pod hop."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.multiplexer import make_multiplexer, use_multiplexer
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import registry
    from repro_torch.train import TrainState
    from repro_torch.train.step import make_grad_fn

    cfg = get_smoke_config("olmoe-1b-7b").scaled(
        moe_impl="ep_shardmap", remat="block", attn_impl="flash", dtype="float32")
    api = registry.build(cfg)
    one = exchange.Mesh(mesh.num_pods, mesh.n)
    with mesh_context(MeshContext(one)), use_multiplexer(make_multiplexer(
            one, pack_impl=pack_impl)):
        make_grad_fn(api)(TrainState.create(api, 1, device=DEV).params, _moe_batch(cfg, (8, 32)))
    torch.cuda.synchronize()


def _moe_hop_bytes(cfg, params, shape, mesh) -> dict:
    """What the pod hop should carry a step: the replicated leaves' f32
    gradient, the loss and the norm's scalar; and 6 trips a layer of a
    unit's capacity rows to every unit of the other processes, in the
    compute dtype."""
    from repro_torch.core.autotune import ep_capacity
    from repro_torch.tree import leaves_with_paths

    U, N, E = mesh.local_units, mesh.num_units, cfg.num_experts
    C = ep_capacity(shape[0] * shape[1] // N, cfg.top_k, E, cfg.capacity_factor)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return {"replicated_bytes": 4 * (sum(t.numel() for p, t in leaves_with_paths(params)
                                         if not _expert_leaf(p)) + 2),
            "capacity": C, "trip_bytes": U * (N - U) * (E // N) * C * cfg.d_model * item}


def _moe_check(mesh, ctx, mux) -> dict:
    """Process 0's one-process step over the same units against the
    sharded step across the processes (the gates of ``scenario_moe_train``)."""
    import torch.distributed as dist

    from repro_torch.core.multiplexer import make_multiplexer, use_multiplexer
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import moe, registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.step import local_rows, make_grad_fn, state_shardings
    from repro_torch.tree import leaves, leaves_with_paths

    rank, R, U = INFO.process_id, mesh.num_processes, mesh.local_units
    cfg = _moe_cfg(ARGS.moe_layers, "float32")
    api, opt = registry.build(cfg), AdamWConfig()
    batch = _moe_batch(cfg, ARGS.moe_shape)
    E = cfg.num_experts
    rec = {"layers": cfg.num_layers, "shape": list(ARGS.moe_shape), "experts": E}
    parts, t0 = {}, time.perf_counter()

    def part(name):  # the seconds since the last mark, under ``name``
        nonlocal t0
        now = time.perf_counter()
        parts[name], t0 = now - t0, now

    if rank == 0:  # the one-process step: every unit of the same mesh here
        one = exchange.Mesh(mesh.num_pods, mesh.n)
        state = TrainState.create(api, 0, device=DEV)
        one_ctx = MeshContext(one)
        _reset_peak()
        with mesh_context(one_ctx), use_multiplexer(make_multiplexer(
                one, pack_impl=mux.pack_impl)), moe.record_drops() as drops:
            (ref_loss, ref_grads), rec["one_process_grad_s"] = _synced(
                lambda: make_grad_fn(api)(state.params, batch))
            ref_state, ref_run = _moe_steps(api, make_train_step(api, opt), [state], batch, 3)
        rec["one_process"] = ref_run
        rec["one_process_peak"] = _peak()
        ref_drops = torch.stack(drops[:2 * cfg.num_layers]).cpu()  # the first gradient's calls
        ref_grads = {p: t.cpu() for p, t in leaves_with_paths(ref_grads)}
        ref_final = {p: t.cpu() for p, t in leaves_with_paths(ref_state.params)}
        del state, ref_state
        if DEV == "cuda":
            torch.cuda.empty_cache()
    else:
        ref_grads = ref_final = None
    part("one_process")
    sync_processes()
    part("wait")

    shardings = state_shardings(api, ctx)
    _reset_peak()
    state = TrainState.create(api, 0, device=DEV, shardings=shardings)
    rec["state_bytes"] = sum(t.numel() * t.element_size() for t in leaves(state))
    held_experts = [(p, t.shape[0]) for p, t in leaves_with_paths(state) if _expert_leaf(p)]
    for p, n in held_experts:  # params, m and v hold this process's experts alone
        if n != U * E // mesh.num_units:
            raise AssertionError(f"moe_train: {p} holds {n} experts")
    rec["expert_leaves"] = len(held_experts)
    mine = slice(rank * U * E // mesh.num_units, (rank + 1) * U * E // mesh.num_units)
    whole = api.init(0, device=DEV)  # the whole init, drawn again, sliced here
    init_equal = all(torch.equal(t, w[mine] if _expert_leaf(p) else w)
                     for (p, t), w in zip(leaves_with_paths(state.params), leaves(whole)))
    del whole
    rows = local_rows(batch, mesh)
    rec.update(_moe_hop_bytes(cfg, state.params, ARGS.moe_shape, mesh))
    part("sharded_init")
    grad_fn, step = make_grad_fn(api), make_train_step(api, opt)
    with mesh_context(ctx), use_multiplexer(mux):
        exchange.reset_pod_hop()
        k0 = _moe_launches()
        with moe.record_drops() as drops:
            (loss, grads), rec["grad_s"] = _synced(lambda: grad_fn(state.params, rows))
        rec["grad_hop"] = dict(exchange.POD_HOP)
        rec["grad_launches"] = {k: v - k0[k] for k, v in _moe_launches().items()}
        my_drops = torch.stack(drops)
        if ARGS.moe_fabric_check:  # the same gradient through the fabric, no multiplexer
            with use_multiplexer(None):
                loss_f, grads_f = grad_fn(state.params, rows)
            rec["fabric_loss_rel"] = abs(float(loss_f) - float(loss)) / abs(float(loss))
            rec["fabric_leaf_rel"] = _worst_leaf(grads_f, grads)
            del grads_f
        held = [state]
        del state
        new_state, run = _moe_steps(api, step, held, rows, 3)
        rec.update(run)
        rec["peak"] = _peak()
        if ARGS.profile:
            rec["profile"] = _profiled_step(step, new_state, rows, "moe")
    part("sharded_steps")
    rec["hop_grad"] = _hop_gradients(mesh)
    all_drops = gather_units(my_drops.T.contiguous(), mesh).cpu()  # [N, calls]
    replicated = [t for p, t in leaves_with_paths(new_state.params) if not _expert_leaf(p)]
    digests = [None] * R
    dist.all_gather_object(digests, _digest(replicated))
    rec["ranks_identical"] = len(set(digests)) == 1
    if not rec["ranks_identical"]:
        raise AssertionError("moe_train: the replicated params differ between processes")
    # each process's expert rows against the same rows of process 0's run,
    # which process 0 sends it: no process gathers the experts whole
    got_grads = dict(leaves_with_paths(grads))
    got_final = dict(leaves_with_paths(new_state.params))
    experts = [p for p in got_grads if _expert_leaf(p)]
    want_grads = _process_rows(ref_grads, {p: got_grads[p] for p in experts}, mesh)
    want_final = _process_rows(ref_final, {p: got_final[p] for p in experts}, mesh)
    part("gathers")
    slice_rel = _worst_leaf([got_grads[p] for p in experts], [want_grads[p] for p in experts])
    final_abs = max(float((got_final[p] - want_final[p]).abs().max()) for p in experts)
    del want_grads, want_final
    if ARGS.moe_ckpt:
        from repro_torch.checkpoint import save_checkpoint

        from repro_torch.tree import unflatten

        save_checkpoint(ARGS.moe_ckpt + "/sharded", 3, new_state, shardings, mesh)
        gathered = unflatten(new_state, [_whole_experts(t, mesh) if _expert_leaf(p) else t
                                         for p, t in leaves_with_paths(new_state)])
        if rank == 0:
            save_checkpoint(ARGS.moe_ckpt + "/whole", 3, gathered)
        part("checkpoint")
    per_process = [None] * R
    dist.all_gather_object(per_process, (init_equal, slice_rel, final_abs))
    if rank == 0:
        rec["init_equal"] = all(eq for eq, _, _ in per_process)
        rec["loss_rel"] = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        rep = [p for p in ref_grads if not _expert_leaf(p)]
        rec["replicated_rel"] = _worst_leaf([got_grads[p] for p in rep],
                                            [ref_grads[p].to(DEV) for p in rep])
        rec["expert_slice_rel"] = {r: rel for r, (_, rel, _) in enumerate(per_process)}
        rec["leaf_rel"] = max(rec["replicated_rel"], *rec["expert_slice_rel"].values())
        rec["drops_equal"] = bool(torch.equal(all_drops, ref_drops.T))
        rec["drops"] = _ints(all_drops.sum(0))
        m0, r0 = rec["metrics"], rec["one_process"]["metrics"]
        rec["step_loss_rel"] = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(m0, r0)]
        rec["step_norm_rel"] = [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                                for a, b in zip(m0, r0)]
        rec["params_abs"] = max(
            max(a for _, _, a in per_process),
            max(float((got_final[p] - ref_final[p].to(DEV)).abs().max()) for p in rep))
        fails = [k for k, bad in (
            ("init", not rec["init_equal"]), ("loss", rec["loss_rel"] > 1e-5),
            ("leaves", rec["leaf_rel"] > 1e-4), ("grad norm", rec["step_norm_rel"][0] > 1e-4),
            ("step loss", rec["step_loss_rel"][0] > 1e-5), ("drops", not rec["drops_equal"]),
        ) if bad]
        if fails:
            raise AssertionError(f"moe_train against the one-process step: {fails}: {rec}")
    part("compare")
    rec["parts_s"] = parts
    per_step = 2 * cfg.num_layers if DEV == "cuda" else 0
    for got in rec["launches"] + [rec["grad_launches"]]:
        if got != {"moe_dispatch": per_step, "flash_attention": per_step}:
            raise AssertionError(f"moe_train: launches {got} a step, {per_step} of each implied")
    return rec


def _moe_deep(mesh, ctx, mux) -> dict:
    """``--moe-deep-steps`` steps of the full-depth model (bf16 compute over
    f32 params, a global batch of 8 x 2,048) on the sharded state: losses
    finite, the replicated params bit-identical on every process, the
    peak."""
    import math

    import torch.distributed as dist

    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.core.multiplexer import use_multiplexer
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.step import local_rows, state_shardings
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = _moe_cfg(0, "bfloat16")
    api = registry.build(cfg)
    shape = (8, 2048)
    rows = local_rows(_moe_batch(cfg, shape), mesh)
    _reset_peak()
    held, init_s = _synced(lambda: [TrainState.create(
        api, 0, device=DEV, shardings=state_shardings(api, ctx))])
    rec = {"layers": cfg.num_layers, "shape": list(shape), "dtype": cfg.dtype,
           "init_s": init_s, "init_peak": _peak(),
           "state_bytes": sum(t.numel() * t.element_size() for t in leaves(held[0]))}
    rec.update(_moe_hop_bytes(cfg, held[0].params, shape, mesh))
    step = make_train_step(api, AdamWConfig())
    with mesh_context(ctx), use_multiplexer(mux):
        state, run = _moe_steps(api, step, held, rows, ARGS.moe_deep_steps)
        rec.update(run)
        rec["peak"] = _peak()
        if ARGS.profile:
            rec["profile"] = _profiled_step(step, state, rows, "moe_deep")
    if not all(math.isfinite(m["loss"]) for m in run["metrics"]):
        raise AssertionError(f"moe_train deep: a loss is not finite: {run['metrics']}")
    digests = [None] * mesh.num_processes
    dist.all_gather_object(digests, _digest(
        [t for p, t in leaves_with_paths(state.params) if not _expert_leaf(p)]))
    rec["ranks_identical"] = len(set(digests)) == 1
    if not rec["ranks_identical"]:
        raise AssertionError("moe_train deep: the replicated params differ between processes")
    return rec


def scenario_moe_train():
    """OLMoE training with its experts sharded across the processes
    (``train/step.py``'s sharded state under ``grad_sync="auto"``), f32,
    ``remat="block"``, flash attention, under an ambient two-level
    multiplexer (the ``moe_dispatch`` kernel pack on the card).  Process 0
    first runs the one-process step over the same 8 units (a whole state)
    and frees it; then each process creates the sharded state (only its
    experts, drawn layer by layer: the whole init, drawn again, sliced, bit
    for bit) and takes the gradient and 3 steps on its rows.  Each process
    holds its expert rows against the same rows of process 0's run, which
    process 0 sends it (no process gathers the experts whole).  Gates: the
    loss within rel 1e-5, every gradient leaf within ``1e-4 * max |b|``
    (each process's expert slice and the replicated leaves), the first
    step's grad norm
    within rel 1e-4, the per-unit drop counts bit-exact, the replicated
    params after 3 steps bit-identical on every process, the pod hop's
    backward equal to the hop, and ``moe_dispatch`` and ``flash_attention``
    launching twice a layer a step (forward and recompute) on the card.
    ``--moe-full`` / ``--moe-layers`` / ``--moe-shape`` size it,
    ``--moe-fabric-check`` also takes the gradient with no multiplexer,
    ``--moe-ckpt DIR`` saves the sharded state there (and process 0 the
    gathered whole one), and ``--moe-deep-steps`` adds that many steps of the
    full-depth model in bf16 at 8 x 2,048."""
    from repro_torch.core.multiplexer import make_multiplexer
    from repro_torch.distributed.sharding import MeshContext

    started_at = time.time()
    mesh = _pod_mesh()
    ctx = MeshContext(mesh)
    mux = make_multiplexer(mesh, pack_impl="cuda" if DEV == "cuda" else "torch")
    t0 = time.perf_counter()
    if DEV == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _moe_warm_up(mesh, mux.pack_impl)
    warm_up = time.perf_counter() - t0
    out = {"check": _moe_check(mesh, ctx, mux)}
    out["check"]["parts_s"] = {"warm_up": warm_up, **out["check"]["parts_s"]}
    out["check"]["started_at"] = started_at
    c = out["check"]
    print(f"[moe] check: {c['layers']} layers, steps "
          f"{' '.join(f'{w * 1e3:.1f}' for w in c['step_s'])} ms, "
          f"{c['step_hop_bytes']} B a step on the pod hop, peak {c['peak']}")
    if ARGS.moe_deep_steps:
        out["deep"] = _moe_deep(mesh, ctx, mux)
        d = out["deep"]
        print(f"[moe] deep: {d['layers']} layers {d['dtype']}, steps "
              f"{' '.join(f'{w * 1e3:.1f}' for w in d['step_s'])} ms, peak {d['peak']}")
    RESULTS["moe_train"] = out
    print("PASS moe_train")


def _serve_cells() -> list[tuple[str, int, tuple]]:
    """``--serve-cells``: ``arch[:layers[:BxSxNEW]]`` items, comma-separated
    (layers 0: the config's; the shape by default 4 x 16 + 4 new)."""
    out = []
    for item in filter(None, ARGS.serve_cells.split(",")):
        arch, layers, shape = (item.split(":") + ["0", "4x16x4"][item.count(":"):])[:3]
        out.append((arch, int(layers), tuple(int(v) for v in shape.split("x"))))
    return out


def _serve_cfg(arch: str, layers: int):
    """The served config: smoke or full (``--serve-full``), cut to ``layers``,
    ``--serve-dtype`` compute over ``--serve-param-dtype`` params, a MoE
    config expert-parallel."""
    from repro_torch.configs import get_config, get_smoke_config

    base = (get_config if ARGS.serve_full else get_smoke_config)(arch)
    over = dict(dtype=ARGS.serve_dtype, param_dtype=ARGS.serve_param_dtype)
    if layers:
        over["num_layers"] = layers
    if base.num_experts:
        over["moe_impl"] = "ep_shardmap"
    return base.scaled(**over)


def _serve_inputs(cfg, B: int, S: int, new: int):
    """``B`` prompts of ``S`` tokens and the side inputs, drawn from seed 0
    as the serving launcher draws them (an encoder-decoder's frames ``[B, S,
    d]``, a VLM's ``min(1024, S // 2)`` patch rows), and the capacity."""
    from repro_torch.models.registry import VLM_PATCHES

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    extra, side = None, 0
    if cfg.family == "encdec":
        extra = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    elif cfg.family == "vlm":
        side = min(VLM_PATCHES, S // 2)
        extra = {"patches": rng.standard_normal((B, side, cfg.d_model)).astype(np.float32)}
    return prompts, extra, S + new + 1 + side


def _routes_scope():
    """``--tp-routes``: every MoE call's routes recorded (``moe.record_routes``);
    else nothing (the block's list is ``None``)."""
    import contextlib

    from repro_torch.models import moe

    return moe.record_routes() if ARGS.tp_routes else contextlib.nullcontext()


def _route_flips(got: list, want: list) -> dict:
    """``--tp-routes``: each MoE call's top-k sets of a run against the
    one-process run's, call for call (the same calls in the same order):
    the tokens routed, the tokens whose set differs (a flipped route) and
    where, the one-process run's router margin (its k-th minus its
    (k+1)-th logit) at each flipped token, its smallest margin over every
    token, and how many tokens sit within 1e-4 and 1e-5 of another route."""
    flips, margins, tokens = [], [], 0
    low = {"1e-4": 0, "1e-5": 0}
    for call, ((ids, _), (want_ids, margin)) in enumerate(zip(got, want)):
        tokens += int(margin.numel())
        margins.append(float(margin.min()))
        low["1e-4"] += int((margin < 1e-4).sum())
        low["1e-5"] += int((margin < 1e-5).sum())
        for t in (ids != want_ids).any(dim=-1).nonzero()[:, 0].tolist():
            flips.append({"call": call, "token": t, "margin": float(margin[t])})
    return {"calls": len(want), "calls_equal": len(got) == len(want), "tokens": tokens,
            "flipped": len(flips), "flips": flips[:32],
            "min_margin": min(margins) if margins else None, "tokens_within": low}


class _Recorded:
    """A model-API call with each call's logits kept on the host and its
    wall, the card drained on both sides; with ``states``, also each call's
    SSM states (the cache's ``ssm`` leaves by path) on the host."""

    def __init__(self, fn, states: bool = False):
        self.fn, self.logits, self.seconds = fn, [], []
        self.states = [] if states else None

    def __call__(self, *args, **kw):
        out, wall = _synced(lambda: self.fn(*args, **kw))
        self.seconds.append(wall)
        self.logits.append(out[0].float().cpu())
        if self.states is not None:
            self.states.append(_ssm_states(out[1]))
        return out


def _ssm_states(cache) -> dict:
    """A copy of a cache's ``ssm`` leaves on the host, by their path joined
    with ``/``."""
    from repro_torch.tree import leaves_with_paths

    return {"/".join(map(str, p)): t.to("cpu", copy=True) for p, t in leaves_with_paths(cache)
            if p[-1] == "ssm"}  # a copy: decode writes the cache in place


def _serve_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    return {"moe_dispatch": md.LAUNCHES["moe_dispatch"], "ssd_scan": sk.LAUNCHES["ssd_scan"],
            "flash_attention": fa.LAUNCHES["flash_attention"]}


def _serve_run(api, params, inputs: tuple, B: int, new: int, ctx, mux,
               temperature: float = 0.0, states: bool = False) -> dict:
    """One static batch through ``ServeEngine`` under ``ctx`` and ``mux``
    (at ``temperature``, seed 0):
    tokens, each call's logits (this process's rows), the drops of every
    expert-parallel call (this process's units), the path of every MoE
    call, the stats, the pod hop's bytes, the kernels' launches, the walls
    and the peak; with ``states``, the prefill's SSM states."""
    import dataclasses

    from repro_torch.core.multiplexer import use_multiplexer
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.models import moe
    from repro_torch.serve import Request, ServeEngine

    prompts, extra, cap = inputs
    rec = dataclasses.replace(api, prefill=_Recorded(api.prefill, states),
                              decode_step=_Recorded(api.decode_step))
    reqs = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts[:B]]
    engine = ServeEngine(rec, batch_size=B, capacity=cap, temperature=temperature, device=DEV)
    side = None if extra is None else {k: v[:B] for k, v in extra.items()}
    exchange.reset_pod_hop()
    k0 = _serve_launches()
    _reset_peak()
    with mesh_context(ctx), use_multiplexer(mux), moe.record_drops() as drops, \
            moe.record_paths() as paths, _routes_scope() as routes:
        _, wall = _synced(lambda: engine.generate(params, reqs, side))
    return {"tokens": [r.out_tokens for r in reqs], "routes": routes,
            "logits": rec.prefill.logits + rec.decode_step.logits,
            "drops": [d.cpu() for d in drops], "paths": list(paths), "stats": dict(engine.stats),
            "hop_bytes": exchange.POD_HOP["bytes"], "hop_kinds": exchange.pod_hop_kinds(),
            "launches": {k: v - k0[k] for k, v in _serve_launches().items()},
            "prefill_s": rec.prefill.seconds, "decode_s": rec.decode_step.seconds,
            "wall_s": wall, "peak": _peak(),
            **({"states": rec.prefill.states[0]} if states else {})}


def _expert_trips(cfg, params, mesh, impl: str = "round_robin"):
    """``(layers, trips)``: the expert-parallel MoE layers, and what one
    such layer's call over ``tokens`` of this process's tokens puts on the
    pod hop: the dispatch and the combine trips, each this process's ``U``
    units' capacity buffers for the ``N - U`` units of the other processes,
    ``2 * U * (N - U) * (E / N) * C * d * itemsize`` with ``C =
    ep_capacity(tokens / U, k, E, capacity_factor)``; under the ``"xla"``
    transport (one ``all_to_all_single``, whose buffer holds the process's
    own share too) all ``N`` units' buffers, ``2 * U * E * C * d *
    itemsize``; 0 for a call the ``N`` units do not divide (``tokens * R``
    tokens in all), which takes the dense path."""
    from repro_torch.tree import leaves_with_paths

    moe_layers = sum(1 for p, _ in leaves_with_paths(params) if p[-1] == "router")
    U, N, R = mesh.local_units, mesh.num_units, mesh.num_processes

    def trips(tokens: int) -> int:
        if cfg.moe_impl != "ep_shardmap" or (tokens * R) % N or cfg.num_experts % N:
            return 0  # the dense path: no hop
        return _ep_trip_bytes(cfg, mesh, tokens // U, impl)

    return moe_layers, trips


def _ep_trip_bytes(cfg, mesh, tokens_a_unit: int, impl: str) -> int:
    """One expert-parallel MoE call's dispatch and combine trips over the
    pod hop, a process: its ``U`` units' capacity buffers for the other
    processes' ``N - U`` units (all ``N`` under the ``"xla"`` transport,
    one ``all_to_all_single`` whose buffer holds the process's own share
    too), ``2 U (N - U) (E / N) C d`` items, ``C = ep_capacity(tokens a
    unit, k, E, capacity_factor)``."""
    from repro_torch.core.autotune import ep_capacity

    U, N, E = mesh.local_units, mesh.num_units, cfg.num_experts
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    C = ep_capacity(tokens_a_unit, cfg.top_k, E, cfg.capacity_factor)
    return 2 * U * (N if impl == "xla" else N - U) * (E // N) * C * cfg.d_model * item


def _serve_hop_bytes(cfg, params, rows: int, S: int, steps: int, mesh) -> dict:
    """What the pod hop carries in one split run, a process: the sampled
    int32 tokens of its ``rows`` gathered once a call (the prefill and
    ``steps`` decode steps), and each MoE layer call's expert trips
    (:func:`_expert_trips`; one decode token a row)."""
    gathers = (1 + steps) * rows * 4
    moe_layers, trips = _expert_trips(cfg, params, mesh)
    ep = moe_layers * (trips(rows * S) + steps * trips(rows))
    return {"gathers": gathers, "expert_trips": ep, "total": gathers + ep}


def _check_launches(tag: str, cfg, run: dict) -> None:
    """The launches a run implies on the card: ``moe_dispatch`` once an
    expert-parallel call (the multiplexer's kernel pack), ``ssd_scan`` once
    an SSM layer a prefill; none off the card."""
    on = DEV == "cuda"
    scan = cfg.num_layers * len(run["prefill_s"]) if cfg.family == "ssm" else 0
    want = {"moe_dispatch": len(run["drops"]) if on else 0, "ssd_scan": scan if on else 0}
    got = {k: run["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"serve {tag}: launches {got}, the run implies {want}")


def _worst_rows(got: list, want: list, lo: int) -> list:
    """Per call, ``max |a - b| / max |b|`` of this process's logit rows
    against rows ``lo ..`` of the whole batch's."""
    return [float((a - b[lo:lo + a.shape[0]]).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(got, want)]


def _serve_arch(arch: str, layers: int, shape: tuple, mesh, ctx, mux_for) -> dict:
    import torch.distributed as dist

    from repro_torch.distributed.sharding import MeshContext
    from repro_torch.models import registry

    rank, R = INFO.process_id, mesh.num_processes
    B, S, new = shape
    cfg = _serve_cfg(arch, layers)
    api = registry.build(cfg)
    params = api.init(0, device=DEV)
    inputs = _serve_inputs(cfg, B, S, new)
    rows = B // R
    rec = {"layers": cfg.num_layers, "shape": list(shape), "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "family": cfg.family}
    ref = None
    if ARGS.serve_ref == "whole" and rank == 0:  # every unit of the same mesh in this process
        one = exchange.Mesh(mesh.num_pods, mesh.n)
        ref = _serve_run(api, params, inputs, B, new, MeshContext(one), mux_for(one))
        _check_launches(f"{arch} one process", cfg, ref)
        if ref["hop_bytes"]:
            raise AssertionError(f"serve {arch}: the one-process run used the pod hop")
        rec["one_process"] = {k: ref[k] for k in ("stats", "prefill_s", "decode_s", "wall_s",
                                                  "peak", "launches")}
    elif ARGS.serve_ref == "rows":  # this process's rows alone, no mesh
        lo, hi = rank * rows, (rank + 1) * rows
        mine = (inputs[0][lo:hi],
                None if inputs[1] is None else {k: v[lo:hi] for k, v in inputs[1].items()},
                inputs[2])
        ref = _serve_run(api, params, mine, rows, new, None, None)
        rec["one_process"] = {k: ref[k] for k in ("stats", "prefill_s", "decode_s", "wall_s",
                                                  "peak", "launches")}
    sync_processes()
    runs = []
    for _ in range(ARGS.serve_repeat):
        runs.append(_serve_run(api, params, inputs, B, new, ctx, mux_for(mesh)))
    run = runs[-1]
    _check_launches(arch, cfg, run)
    mode = run["stats"]["rows"]
    if mode != "split":
        raise AssertionError(f"serve {arch}: a batch of {B} over {R} processes ran {mode}")
    want_hop = _serve_hop_bytes(cfg, params, rows, S, run["stats"]["decode_steps"], mesh)
    rec.update(rows=mode, tokens=run["tokens"], stats=run["stats"], hop_bytes=run["hop_bytes"],
               hop_kinds=run["hop_kinds"], want_hop=want_hop, launches=run["launches"],
               prefill_s=[r["prefill_s"] for r in runs], decode_s=[r["decode_s"] for r in runs],
               wall_s=[r["wall_s"] for r in runs], peak=run["peak"],
               tokens_repeat_equal=all(r["tokens"] == run["tokens"] for r in runs),
               expert_calls=len(run["drops"]))
    if run["hop_bytes"] != want_hop["total"]:
        raise AssertionError(f"serve {arch}: {run['hop_bytes']} B on the pod hop, derived "
                             f"{want_hop}")
    every = [None] * R
    whole = ARGS.serve_ref == "whole"  # process 0 holds every process's rows to its run
    dist.all_gather_object(every, (run["tokens"], run["logits"] if whole else None,
                                   [d.tolist() for d in run["drops"]]))
    rec["tokens_equal_on_every_process"] = all(t == run["tokens"] for t, _, _ in every)
    if not rec["tokens_equal_on_every_process"]:
        raise AssertionError(f"serve {arch}: the processes' tokens differ")
    if ref is not None:
        if ARGS.serve_ref == "rows":
            rec["tokens_equal"] = run["tokens"][rank * rows:(rank + 1) * rows] == ref["tokens"]
            rec["logit_rel"] = _worst_rows(run["logits"], ref["logits"], 0)
            rec["logits_bit_equal"] = all(torch.equal(a, b) for a, b in
                                          zip(run["logits"], ref["logits"]))
        else:
            rec["tokens_equal"] = run["tokens"] == ref["tokens"]
            rec["logit_rel"] = [max(v) for v in zip(*(
                _worst_rows(lg, ref["logits"], r * rows) for r, (_, lg, _) in enumerate(every)))]
            split_drops = [sum((d[c] for _, _, d in every), []) for c in range(len(run["drops"]))]
            rec["drops_equal"] = split_drops == [d.tolist() for d in ref["drops"]]
            rec["drops"] = [sum(d) for d in split_drops]
        fails = [k for k, bad in (
            ("tokens", not rec["tokens_equal"]),
            ("logits", max(rec["logit_rel"]) > ARGS.serve_tol),
            ("drops", not rec.get("drops_equal", True)),
        ) if bad]
        if fails:
            raise AssertionError(f"serve {arch} against the one-process engine: {fails}: "
                                 f"{ {k: rec.get(k) for k in ('logit_rel', 'drops')} }")
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return rec


def _serve_replicated(arch: str, B: int, shape: tuple, ctx, mux) -> dict:
    """A batch of ``B`` rows that the processes do not divide: every process
    runs it whole (``stats["rows"] == "replicated"``), nothing crosses the
    pod hop but what the MoE layer's gather would, and the tokens equal on
    every process; through the static engine and through the continuous one
    (``2 B`` mixed requests into ``B`` slots)."""
    import torch.distributed as dist

    from repro_torch.models import registry

    cfg = _serve_cfg(arch, 0)
    api = registry.build(cfg)
    params = api.init(0, device=DEV)
    run = _serve_run(api, params, _serve_inputs(cfg, *shape), B, shape[2], ctx, mux)
    work = _continuous_workload(cfg, B, 2 * B, shape[2])
    cont = _continuous_run(api, params, work, B, ctx)
    every = [None] * INFO.num_processes
    dist.all_gather_object(every, (run["tokens"], cont["tokens"]))
    return {"arch": arch, "batch": B, "rows": run["stats"]["rows"], "tokens": run["tokens"],
            "hop_bytes": run["hop_bytes"],
            "tokens_equal_on_every_process": all(t == run["tokens"] for t, _ in every),
            "continuous": {"rows": cont["stats"]["rows"], "hop_bytes": cont["hop_bytes"],
                           "done": cont["done"], "cache_bytes": cont["cache_bytes"],
                           "whole_cache_bytes": _cache_bytes(api, B, work[2]),
                           "tokens_equal_on_every_process": all(
                               c == cont["tokens"] for _, c in every)}}


def _continuous_cells() -> list[tuple[str, int, tuple]]:
    """``--serve-continuous``: ``arch[:layers[:BxREQxNEW]]`` items,
    comma-separated (layers 0: the config's; by default 8 slots, 12
    requests, 1-6 new tokens)."""
    out = []
    for item in filter(None, ARGS.serve_continuous.split(",")):
        arch, layers, shape = (item.split(":") + ["0", "8x12x6"][item.count(":"):])[:3]
        out.append((arch, int(layers), tuple(int(v) for v in shape.split("x"))))
    return out


def _continuous_workload(cfg, B: int, n_req: int, new: int):
    """``n_req`` mixed requests from seed 0 (``make_mixed_workload``:
    prompts cycling through ``--serve-prompts``, 1 to ``new`` new tokens,
    ``--serve-rate`` arrivals a step), a VLM's ``min(1024, shortest // 2)``
    patch rows ``[B, P, d]`` drawn next, and the capacity."""
    from repro_torch.models.registry import VLM_PATCHES
    from repro_torch.serve import make_mixed_workload

    rng = np.random.default_rng(0)
    plens = ARGS.serve_prompts
    reqs = make_mixed_workload(cfg.vocab_size, n_req, plens, new, rng,
                               arrival_rate=ARGS.serve_rate)
    extra, side = None, 0
    if cfg.family == "vlm":
        side = min(VLM_PATCHES, min(plens) // 2)
        extra = {"patches": rng.standard_normal((B, side, cfg.d_model)).astype(np.float32)}
    return reqs, extra, max(plens) + side + new + 1


def _fresh(reqs: list) -> list:
    from repro_torch.serve import Request

    return [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                    arrival_step=r.arrival_step) for r in reqs]


def _spans(tracer) -> list:
    """Every span's name, category, arguments and children's names, in order."""
    return [[s.name, s.cat, dict(s.args), [c.name for c in s.children]]
            for root in tracer.spans for s in root.walk()]


def _cache_bytes(api, rows: int, capacity: int) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size()
               for t in leaves(api.init_cache(rows, capacity, device="meta")))


def _continuous_schedule(api, B: int, work: tuple) -> dict:
    """The one-process engine's schedule of a workload, which the requests
    alone decide (no request stops early: ``eos_id`` is -1): each prefill
    group's prompt length, context length and slots (recorded by wrapping
    the engine's ``_scatter_prefill``), the decode steps and the spans.
    Taken from ``ContinuousEngine`` in this process with no mesh over a
    stand-in model (zero logits, a one-number-a-position cache), so it
    costs nothing and needs no reference run."""
    import dataclasses

    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve import ContinuousEngine

    reqs, extra, cap = work
    side = 0 if extra is None else extra["patches"].shape[1]

    def cache(rows, length):
        return {"seg0": {"k": torch.zeros((1, rows, length, 1))}}

    stub = dataclasses.replace(
        api,
        prefill=lambda _p, b: (torch.zeros((b["tokens"].shape[0], 1)),
                               cache(b["tokens"].shape[0], b["tokens"].shape[1] + side)),
        decode_step_slots=lambda _p, t, c, _pos: (torch.zeros((t.shape[0], 1)), c),
        init_cache=lambda rows, capacity, device="cpu": cache(rows, capacity),
    )
    groups = []
    tracer = Tracer(pid=0)
    with mesh_context(None):
        engine = ContinuousEngine(stub, batch_size=B, capacity=cap, tracer=tracer, device="cpu")
        scatter = engine._scatter_prefill

        def recorded(c, pref, slots, rows=None):
            ctx_len = int(pref["seg0"]["k"].shape[2])
            groups.append({"plen": ctx_len - side, "ctx_len": ctx_len, "slots": slots.tolist()})
            scatter(c, pref, slots, rows)

        engine._scatter_prefill = recorded
        engine.serve(None, _fresh(reqs), extra)
    return {"groups": groups, "decode_steps": engine.stats["decode_steps"],
            "spans": _spans(tracer)}


def _continuous_mux(cfg, B: int, mesh) -> dict | None:
    """The multiplexer the continuous engine should tune on ``mesh`` (the
    model's decode-step traffic, no timing), as ``describe()`` gives it."""
    from repro_torch.core.autotune import decode_table_stats
    from repro_torch.core.multiplexer import make_multiplexer

    if cfg.moe_impl != "ep_shardmap":
        return None
    stats = decode_table_stats(cfg, B, mesh.num_units)
    return make_multiplexer(mesh, auto=True, table_stats=[stats]).describe()


def _continuous_hop_bytes(cfg, params, api, sched: dict, B: int, mesh, mux) -> dict:
    """What the pod hop carries in one split continuous run, a process, from
    the schedule: the int32 tokens of its ``B / R`` slots gathered once a
    prefill group and once a decode step; each MoE layer call's expert
    trips (:func:`_expert_trips`) over its ``B / R`` rows of every group's
    context (a VLM's patch rows and the prompt) and of every decode step's
    tokens, under the transport of the tuned multiplexer ``mux``; and every
    prefilled row it sends to the process that owns its slot (admitted row ``j`` prefilled on process ``j // (B / R)``, slot
    ``s`` owned by ``s // (B / R)``), at one row's bytes over the cache
    leaves at the group's context length.  Also the expert-parallel calls
    and every process's moved rows."""
    R, me = mesh.num_processes, mesh.process_index
    n = B // R
    groups, steps = sched["groups"], sched["decode_steps"]
    moe_layers, trips = _expert_trips(cfg, params, mesh, mux["impl"] if mux else "round_robin")
    gathers = 4 * n * (len(groups) + steps)
    ep = moe_layers * (sum(trips(n * g["ctx_len"]) for g in groups) + steps * trips(n))
    ep_calls = moe_layers * (sum(trips(n * g["ctx_len"]) > 0 for g in groups)
                             + steps * (trips(n) > 0))
    sent = [sum(j // n == me and s // n != me for j, s in enumerate(g["slots"])) for g in groups]
    rows = sum(k * _cache_bytes(api, 1, g["ctx_len"]) for k, g in zip(sent, groups))
    moved = sum(j // n != s // n for g in groups for j, s in enumerate(g["slots"]))
    return {"gathers": gathers, "expert_trips": ep, "moved_row_bytes": rows,
            "sent_rows": sum(sent), "moved_rows": moved, "expert_calls": ep_calls,
            "total": gathers + ep + rows}


#: The stats that must equal the one-process engine's (``rows`` and
#: ``moved_rows`` say how the batch lay; ``wall`` is the clock's).
_COUNTERS = ("prefill_tokens", "prefill_calls", "decode_steps", "slot_steps",
             "live_slot_steps", "idle_steps", "admitted", "finished")


def _continuous_run(api, params, work: tuple, B: int, ctx, temperature: float = 0.0) -> dict:
    """One mixed workload through ``ContinuousEngine`` under ``ctx`` (the
    engine tunes its own multiplexer): tokens, admission and finish steps,
    each call's logits (this process's rows), the drops of every
    expert-parallel call, the path of every MoE call, the stats, the spans,
    the slots of each prefill group (whole runs), each decode step's live
    slots, the bytes of the cache it
    built, whether every slot came back free, the pod hop's bytes, the
    kernels' launches, the walls, ``engine_record`` and the peak."""
    import dataclasses

    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.models import moe
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve import ContinuousEngine, engine_record
    from repro_torch.tree import leaves

    reqs, extra, cap = work
    built = []

    def init_cache(rows, capacity, device="cuda"):
        cache = api.init_cache(rows, capacity, device=device)
        built.append(sum(t.numel() * t.element_size() for t in leaves(cache)))
        return cache

    rec = dataclasses.replace(api, prefill=_Recorded(api.prefill),
                              decode_step_slots=_Recorded(api.decode_step_slots),
                              init_cache=init_cache)
    reqs = _fresh(reqs)
    tracer = Tracer(pid=0)
    slots = []
    with mesh_context(ctx):
        engine = ContinuousEngine(rec, batch_size=B, capacity=cap, temperature=temperature,
                                  tracer=tracer, device=DEV)
    scatter = engine._scatter_prefill

    def recorded(cache, pref, s, rows=None):
        slots.append(s.tolist())
        scatter(cache, pref, s, rows)

    engine._scatter_prefill = recorded
    live = []  # each decode step's live slots
    decode = rec.decode_step_slots

    def decode_live(*args):
        live.append(sorted(engine.alloc.live))
        return decode(*args)

    engine.api = dataclasses.replace(rec, decode_step_slots=decode_live)
    exchange.reset_pod_hop()
    k0 = _serve_launches()
    _reset_peak()
    with mesh_context(ctx), moe.record_drops() as drops, moe.record_paths() as paths, \
            _routes_scope() as routes:
        _, wall = _synced(lambda: engine.serve(params, reqs, extra))
    engine.alloc.check()
    return {"tokens": [r.out_tokens for r in reqs], "routes": routes,
            "admitted": [r.admitted_step for r in reqs],
            "finished": [r.finished_step for r in reqs],
            "done": all(r.done for r in reqs),
            "leak_free": engine.alloc.num_free == B and not engine.alloc.live,
            "logits": rec.prefill.logits + rec.decode_step_slots.logits,
            "drops": [d.cpu() for d in drops], "paths": list(paths), "stats": dict(engine.stats),
            "spans": _spans(tracer), "slots": slots, "live": live, "cache_bytes": built[0],
            "mux": None if engine.mux is None else engine.mux.describe(),
            "hop_bytes": exchange.POD_HOP["bytes"], "hop_kinds": exchange.pod_hop_kinds(),
            "launches": {k: v - k0[k] for k, v in _serve_launches().items()},
            "prefill_s": rec.prefill.seconds, "decode_s": rec.decode_step_slots.seconds,
            "wall_s": wall, "record": engine_record(reqs, engine.stats, wall), "peak": _peak()}


def _continuous_arch(arch: str, layers: int, shape: tuple, mesh, ctx) -> dict:
    """One ``--serve-continuous`` cell: the continuous engine's slots split
    over the processes, held to process 0's one-process engine over the same
    units (``--serve-ref whole``) and to the schedule's derived counts."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import MeshContext
    from repro_torch.models import registry

    rank, R = INFO.process_id, mesh.num_processes
    B, n_req, new = shape
    cfg = _serve_cfg(arch, layers)
    api = registry.build(cfg)
    params = api.init(0, device=DEV)
    work = _continuous_workload(cfg, B, n_req, new)
    sched = _continuous_schedule(api, B, work)
    whole_cache = _cache_bytes(api, B, work[2])
    rec = {"layers": cfg.num_layers, "shape": list(shape), "prompts": ARGS.serve_prompts,
           "rate": ARGS.serve_rate, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "family": cfg.family, "whole_cache_bytes": whole_cache}
    ref = None
    if ARGS.serve_ref == "whole" and rank == 0:  # every unit of the same mesh in this process
        ref = _continuous_run(api, params, work, B, MeshContext(exchange.Mesh(mesh.num_pods,
                                                                              mesh.n)))
        _check_launches(f"{arch} continuous one process", cfg, ref)
        bad = [k for k, b in (("pod hop", ref["hop_bytes"]),
                              ("slots", ref["slots"] != [g["slots"] for g in sched["groups"]]),
                              ("spans", ref["spans"] != sched["spans"]),
                              ("cache", ref["cache_bytes"] != whole_cache)) if b]
        if bad:
            raise AssertionError(f"serve continuous {arch}: the one-process run's {bad}")
        rec["one_process"] = {k: ref[k] for k in ("stats", "prefill_s", "decode_s", "wall_s",
                                                  "peak", "launches", "record", "cache_bytes")}
    sync_processes()
    run = _continuous_run(api, params, work, B, ctx)
    _check_launches(f"{arch} continuous", cfg, run)
    mux = _continuous_mux(cfg, B, mesh)
    want = _continuous_hop_bytes(cfg, params, api, sched, B, mesh, mux)
    rec.update(rows=run["stats"]["rows"], tokens=run["tokens"], stats=run["stats"],
               hop_bytes=run["hop_bytes"], hop_kinds=run["hop_kinds"], want_hop=want,
               launches=run["launches"], prefill_s=run["prefill_s"], decode_s=run["decode_s"],
               wall_s=run["wall_s"], record=run["record"], peak=run["peak"],
               cache_bytes=run["cache_bytes"], expert_calls=len(run["drops"]), mux=run["mux"],
               groups=len(sched["groups"]))
    fails = [k for k, bad in (
        ("rows", run["stats"]["rows"] != "split"),
        ("done", not run["done"]),
        ("cache", run["cache_bytes"] * R != whole_cache),
        ("pod hop", run["hop_bytes"] != want["total"]),
        ("moved rows", run["stats"]["moved_rows"] != want["moved_rows"]),
        ("expert calls", len(run["drops"]) != want["expert_calls"]),
        ("spans", run["spans"] != sched["spans"]),
        ("multiplexer", run["mux"] != mux),
    ) if bad]
    if fails:
        raise AssertionError(f"serve continuous {arch} process {rank}: {fails}: "
                             f"{ {k: rec[k] for k in ('hop_bytes', 'want_hop', 'cache_bytes')} }")
    every = [None] * R
    whole = ARGS.serve_ref == "whole"  # process 0 holds every process's rows to its run
    dist.all_gather_object(every, (run["tokens"], run["spans"], run["mux"],
                                   run["logits"] if whole else None,
                                   [d.tolist() for d in run["drops"]]))
    rec["equal_on_every_process"] = {
        k: all(e[i] == every[0][i] for e in every)
        for i, k in enumerate(("tokens", "spans", "mux"))}
    if not all(rec["equal_on_every_process"].values()):
        raise AssertionError(f"serve continuous {arch}: {rec['equal_on_every_process']}")
    if ref is not None:
        n = B // R
        rec["tokens_equal"] = run["tokens"] == ref["tokens"]
        rec["steps_equal"] = (run["admitted"], run["finished"]) == (ref["admitted"],
                                                                    ref["finished"])
        rec["stats_equal"] = all(run["stats"][k] == ref["stats"][k] for k in _COUNTERS)
        rec["spans_equal"] = run["spans"] == ref["spans"]
        rec["logit_rel"] = [max(v) for v in zip(*(
            _worst_rows(e[3], ref["logits"], r * n) for r, e in enumerate(every)))]
        split_drops = [sum((e[4][c] for e in every), []) for c in range(len(run["drops"]))]
        rec["drops_equal"] = split_drops == [d.tolist() for d in ref["drops"]]
        rec["drops"] = [sum(d) for d in split_drops]
        fails = [k for k, bad in (
            ("tokens", not rec["tokens_equal"]), ("steps", not rec["steps_equal"]),
            ("stats", not rec["stats_equal"]), ("spans", not rec["spans_equal"]),
            ("logits", max(rec["logit_rel"]) > ARGS.serve_tol),
            ("drops", not rec["drops_equal"]),
        ) if bad]
        if fails:
            raise AssertionError(f"serve continuous {arch} against the one-process engine: "
                                 f"{fails}: { {k: rec.get(k) for k in ('logit_rel', 'drops')} }")
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return rec


def _continuous_uniform(arch: str, shape: tuple, ctx, mux) -> dict:
    """``B`` prompts of ``S`` tokens, ``NEW`` new each, all arriving at once,
    through the split continuous engine and the split static engine: one
    prefill group into slots ``0 .. B - 1``, so no row moves, and the same
    greedy tokens."""
    from repro_torch.models import registry
    from repro_torch.serve import Request

    B, S, new = shape
    cfg = _serve_cfg(arch, 0)
    api = registry.build(cfg)
    params = api.init(0, device=DEV)
    inputs = _serve_inputs(cfg, B, S, new)
    static = _serve_run(api, params, inputs, B, new, ctx, mux)
    reqs = [Request(prompt=p.copy(), max_new_tokens=new) for p in inputs[0]]
    run = _continuous_run(api, params, (reqs, inputs[1], inputs[2]), B, ctx)
    return {"arch": arch, "shape": list(shape), "rows": run["stats"]["rows"],
            "moved_rows": run["stats"]["moved_rows"], "tokens": run["tokens"],
            "tokens_equal_static": run["tokens"] == static["tokens"],
            "static_rows": static["stats"]["rows"]}


def _continuous_sampled(arch: str, temperature: float, ctx) -> dict:
    """The first continuous cell's workload, split, with a temperature:
    each process draws its slots' tokens from its own generator; the
    gathered tokens, and so the slot map and the spans, are the same on
    every process."""
    import torch.distributed as dist

    from repro_torch.models import registry

    _, layers, (B, n_req, new) = next(c for c in _continuous_cells() if c[0] == arch)
    cfg = _serve_cfg(arch, layers)
    api = registry.build(cfg)
    params = api.init(0, device=DEV)
    run = _continuous_run(api, params, _continuous_workload(cfg, B, n_req, new), B, ctx,
                          temperature=temperature)
    every = [None] * INFO.num_processes
    dist.all_gather_object(every, (run["tokens"], run["spans"]))
    return {"arch": arch, "temperature": temperature, "rows": run["stats"]["rows"],
            "done": run["done"], "admitted": run["stats"]["admitted"],
            "finished": run["stats"]["finished"], "requests": n_req, "tokens": run["tokens"],
            "equal_on_every_process": all(e == every[0] for e in every)}


def scenario_serve():
    """The static serving engine with its batch split over the processes
    (``serve/engine.py``): each process prefills, caches and decodes its
    ``B / R`` rows (and side inputs) under ``moe_tokens="local"``, the
    expert-parallel MoE layer crossing the pod hop under an ambient
    two-level multiplexer (the ``moe_dispatch`` kernel pack on the card),
    and every step's tokens are gathered.  ``--serve-ref whole``: process 0
    first runs the one-process engine on the whole batch over the same 8
    units; the split run's greedy tokens must equal it, each call's logits
    (each process's rows) within ``--serve-tol`` of their max, the per-unit
    drops bit-exact.  ``--serve-ref rows``: each process first runs the
    one-process engine on its own rows with no mesh (families with no
    expert-parallel layer), which the split run must equal.  Every run:
    tokens equal on every process, the pod hop's bytes equal to the derived
    count (``_serve_hop_bytes``), ``moe_dispatch`` once an expert-parallel
    call and ``ssd_scan`` once an SSM layer a prefill on the card.  Also a
    ``ContinuousEngine`` under the mesh must raise, and with
    ``--serve-replicated arch:B`` a batch the processes do not divide runs
    whole.  ``--serve-cells``, ``--serve-full``,
    ``--serve-dtype``, ``--serve-param-dtype`` and ``--serve-repeat`` size
    it."""
    from repro_torch.core.multiplexer import make_multiplexer
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine

    started_at = time.time()
    mesh = _pod_mesh()
    ctx = MeshContext(mesh)
    pack = "cuda" if DEV == "cuda" else "torch"

    def mux_for(m):
        return make_multiplexer(m, pack_impl=pack)

    if DEV == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"started_at": started_at, "archs": {}, "continuous": {},
           "threads": torch.get_num_threads()}
    cells = _serve_cells()
    for arch, layers, shape in cells:
        t0 = time.perf_counter()
        out["archs"][arch] = _serve_arch(arch, layers, shape, mesh, ctx, mux_for)
        out["archs"][arch]["seconds"] = time.perf_counter() - t0
        r = out["archs"][arch]
        print(f"[serve] {arch}: {r['layers']} layers {r['dtype']}, {r['shape']}, rows {r['rows']}, "
              f"prefill {[round(s * 1e3, 1) for s in r['prefill_s'][-1]]} ms, decode "
              f"{sum(r['decode_s'][-1]) * 1e3:.1f} ms over {len(r['decode_s'][-1])} steps, "
              f"pod hop {r['hop_bytes']} B, peak {r['peak']}")
    for arch, layers, shape in _continuous_cells():
        t0 = time.perf_counter()
        r = out["continuous"][arch] = _continuous_arch(arch, layers, shape, mesh, ctx)
        r["seconds"] = time.perf_counter() - t0
        print(f"[serve] {arch} continuous: {r['layers']} layers {r['dtype']}, {r['shape']}, "
              f"rows {r['rows']}, {r['groups']} prefill groups "
              f"{[round(v * 1e3, 1) for v in r['prefill_s']]} ms, decode "
              f"{sum(r['decode_s']) * 1e3:.1f} ms over {len(r['decode_s'])} steps, moved rows "
              f"{r['stats']['moved_rows']}, pod hop {r['hop_bytes']} B, cache "
              f"{r['cache_bytes']} B, peak {r['peak']}")
    if ARGS.serve_uniform:
        arch, shape = ARGS.serve_uniform.split(":")
        u = out["uniform"] = _continuous_uniform(
            arch, tuple(int(v) for v in shape.split("x")), ctx, mux_for(mesh))
        if not (u["tokens_equal_static"] and u["moved_rows"] == 0
                and u["rows"] == u["static_rows"] == "split"):
            raise AssertionError(f"serve: the uniform continuous run {u}")
    if ARGS.serve_temperature:
        arch, temp = ARGS.serve_temperature.split(":")
        t = out["sampled"] = _continuous_sampled(arch, float(temp), ctx)
        if not (t["equal_on_every_process"] and t["done"] and t["rows"] == "split"
                and t["admitted"] == t["finished"] == t["requests"]):
            raise AssertionError(f"serve: the sampled continuous run {t}")
    # the families with no per-slot decode still refuse continuous batching
    api = registry.build(_serve_cfg("mamba2-1.3b", 0))
    try:
        with mesh_context(ctx):
            ContinuousEngine(api, batch_size=2 * mesh.num_processes, capacity=8, device=DEV)
        out["continuous_raises"] = None
    except NotImplementedError as e:
        out["continuous_raises"] = str(e)
    if out["continuous_raises"] is None:
        raise AssertionError("serve: ContinuousEngine took a family with no decode_step_slots")
    if ARGS.serve_replicated:
        arch, B = ARGS.serve_replicated.split(":")
        shape = next(s for a, _, s in cells if a == arch) if any(
            a == arch for a, _, _ in cells) else cells[0][2]
        out["replicated"] = _serve_replicated(arch, int(B), shape, ctx, mux_for(mesh))
        rep = out["replicated"]
        if not (rep["rows"] == rep["continuous"]["rows"] == "replicated"
                and rep["tokens_equal_on_every_process"]
                and rep["continuous"]["tokens_equal_on_every_process"]):
            raise AssertionError(f"serve: batch {B} over {mesh.num_processes} processes: "
                                 f"{out['replicated']}")
    RESULTS["serve"] = out
    print("PASS serve")


def _tp_cells() -> list[tuple[str, str, int, tuple, int, str]]:
    """``--tp-cells``: ``arch[:layers[:BxSxNEW[:vocab[:impl]]]]`` items,
    comma-separated (layers 0: the config's; the shape by default 4 x 16 +
    4 new; vocab 0: the config's; impl ``dense`` or ``ep`` for an MoE
    config's ``moe_impl="dense"`` or ``"ep_shardmap"``, ``sdpa`` for
    ``attn_impl="sdpa"``, empty: the config's MoE and ``"flash"``), as
    ``(key, arch, layers, shape, vocab, impl)`` with the key ``arch``, then
    ``:v<vocab>`` and ``:<impl>`` where given."""
    out = []
    for item in filter(None, ARGS.tp_cells.split(",")):
        arch, layers, shape, vocab, moe = (item.split(":")
                                           + ["0", "4x16x4", "0", ""][item.count(":"):])[:5]
        key = ":".join([arch] + [f"v{vocab}"] * (vocab != "0") + [moe] * bool(moe))
        out.append((key, arch, int(layers), tuple(int(v) for v in shape.split("x")),
                    int(vocab), moe))
    return out


#: ``tensor_serve``'s logits against the reference's, ``allclose`` at rtol =
#: atol = this: the reference's ``decode_sharded_equiv`` tolerance
TP_TOL = 2e-4


def _tp_cfg(arch: str, layers: int, vocab: int = 0, moe: str = ""):
    """The served config: smoke or full (``--tp-full``), cut to ``layers``
    (and to a ``vocab`` of another size), ``--tp-dtype`` compute over
    ``--tp-param-dtype`` params, ``attn_impl="flash"`` (the prefill's
    kernel) unless ``moe`` is ``sdpa``; an MoE config at ``moe_impl``
    ``moe`` and, where ``--tp-capacity-factor`` is given, that capacity
    factor."""
    from repro_torch.configs import get_config, get_smoke_config

    base = (get_config if ARGS.tp_full else get_smoke_config)(arch)
    over = dict(dtype=ARGS.tp_dtype, param_dtype=ARGS.tp_param_dtype,
                attn_impl="sdpa" if moe == "sdpa" else "flash")
    if layers:
        over["num_layers"] = layers
    if vocab:
        over["vocab_size"] = vocab
    if moe in ("dense", "ep"):
        over["moe_impl"] = {"dense": "dense", "ep": "ep_shardmap"}[moe]
    if base.num_experts and ARGS.tp_capacity_factor:
        over["capacity_factor"] = ARGS.tp_capacity_factor
    return base.scaled(**over)


def _tp_moe_layers(cfg) -> int:
    return cfg.num_layers - cfg.first_dense_layers if cfg.num_experts else 0


def _tp_blocks(cfg) -> int:
    """The attention + MLP blocks a call runs: every layer of a
    transformer, none of an SSM, the shared block once a group of a
    hybrid (an encoder-decoder's: :func:`_tp_call_bytes`)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def _tp_flash(cfg) -> int:
    """``flash_attention`` launches a prefill under ``attn_impl="flash"``:
    one a GQA attention block; one an encoder layer of an encoder-decoder
    (its decoder's prefill runs ``sdpa``, as the reference's); none under
    MLA (plain products, as in the reference)."""
    if cfg.attn_impl != "flash" or cfg.attn_kind == "mla":
        return 0
    return cfg.encoder_layers if cfg.family == "encdec" else _tp_blocks(cfg)


def _tp_side(extra) -> int:
    """The rows a VLM's patches put before every prompt (0 without them)."""
    return int(extra["patches"].shape[1]) if extra and "patches" in extra else 0


def _tp_frames(extra) -> int:
    """An encoder-decoder's frame rows a request (0 without them)."""
    return int(extra["frames"].shape[1]) if extra and "frames" in extra else 0


def _tp_ssm_layers(cfg) -> int:
    """The Mamba2 layers a call runs (every layer of an SSM or a hybrid)."""
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


def _tp_moe_path(cfg, tokens: int, ctx) -> str:
    """The path an MoE call over ``tokens`` tokens takes under the tensor
    table, in ``moe.record_paths``' names: expert-parallel where the units
    divide the tokens and the experts, else the dense path on the process's
    experts (``"dense-tensor"``) or, where they stay whole, on all."""
    from repro_torch.distributed.sharding import tensor_split

    N = ctx.mesh.num_units
    if cfg.moe_impl == "ep_shardmap" and tokens % N == 0 and cfg.num_experts % N == 0:
        return "ep"
    return "dense-tensor" if tensor_split(cfg.num_experts, "experts", ctx) > 1 else "dense"


def _tp_call_bytes(cfg, rows: int, length: int, side: int, ctx, impl: str,
                   frames: int = 0) -> dict:
    """What one model call over ``rows`` rows of ``length`` positions (the
    first ``side`` a VLM's patch rows, which skip the embedding) puts on the
    pod hop under the tensor table, a process, from the shapes, in the
    compute dtype: ``[rows, length - side, d]`` all-reduced once for the
    embedding (the vocab split); ``[rows, length, d]`` once for each
    attention block's output (the heads split; MLA's ``wo`` too), each dense
    MLP (``d_ff`` split), each MoE layer's shared MLP (its width split),
    each MoE layer's dense path on the process's experts and each Mamba2
    layer's ``out_proj`` (the SSM heads split), with the Mamba2 layer's
    ``gate_norm`` sum of squares, ``[rows, length, 1]`` in f32; each
    expert-parallel MoE call's trips under the transport ``impl``
    (:func:`_ep_trip_bytes`) and the all-gather of its units' ``T / R``
    outputs; and the ``[rows, V / R]`` logits all-gathered (the vocab
    split).  An encoder-decoder's decoder layer reduces its self- and its
    cross-attention and its MLP over ``[rows, length, d]``, and a prefill's
    encoder (``frames`` rows a request) each encoder layer's attention and
    MLP over ``[rows, frames, d]``.  ``reduces``: the call's all-reduces."""
    from repro_torch.distributed.sharding import tensor_split

    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    R, N = ctx.mesh.num_processes, ctx.mesh.num_units
    d, T = cfg.d_model, rows * length

    def split(dim: int, name: str) -> int:
        return int(bool(dim) and tensor_split(dim, name, ctx) > 1)

    from repro_torch.models import mamba2

    moe_layers = _tp_moe_layers(cfg)
    blocks = _tp_blocks(cfg)
    ssm = _tp_ssm_layers(cfg) * (mamba2.tensor_heads(cfg, ctx)[0] > 1)
    attn = 2 if cfg.family == "encdec" else 1  # self- and cross-attention
    reduces = (blocks * attn * split(cfg.num_heads, "heads")
               + (blocks - moe_layers) * split(cfg.d_ff, "d_ff") + ssm)
    enc = (cfg.encoder_layers * (split(cfg.num_heads, "heads") + split(cfg.d_ff, "d_ff"))
           if frames else 0)
    trips = moe_gather = 0
    if moe_layers:
        reduces += moe_layers * split((cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts,
                                      "d_ff")
        path = _tp_moe_path(cfg, T, ctx)
        if path == "dense-tensor":
            reduces += moe_layers
        elif path == "ep":
            trips = moe_layers * _ep_trip_bytes(cfg, ctx.mesh, T // N, impl)
            moe_gather = moe_layers * (T // R) * d * item
    vocab = split(cfg.vocab_size, "vocab")
    return {"all-reduce": (reduces * T + enc * rows * frames + vocab * rows * (length - side))
            * d * item + ssm * T * 4,
            "all-gather": moe_gather + vocab * rows * (cfg.vocab_size // R) * item,
            "trips": trips, "reduces": reduces + enc + ssm + vocab}


def _tp_hop_bytes(cfg, calls: list, ctx, impl: str) -> dict:
    """:func:`_tp_call_bytes` summed over ``calls`` (``(rows, length,
    side)`` each, and an encoder-decoder prefill's frame rows a request
    fourth; the first a prefill), with their ``total`` and the first call's
    all-reduces (``reduces_a_call``)."""
    out = {"all-reduce": 0, "all-gather": 0, "trips": 0}
    for call in calls:
        got = _tp_call_bytes(cfg, *call[:3], ctx, impl, *call[3:])
        for k in out:
            out[k] += got[k]
    out["reduces_a_call"] = _tp_call_bytes(cfg, *calls[0][:3], ctx, impl,
                                           *calls[0][3:])["reduces"]
    out["total"] = out["all-reduce"] + out["all-gather"] + out["trips"]
    return out


def _tp_paths(cfg, calls: list, ctx) -> list:
    """Every MoE call's path over ``calls``, in call order."""
    return [_tp_moe_path(cfg, rows * length, ctx) for rows, length, *_ in calls
            for _ in range(_tp_moe_layers(cfg))]


def _tp_hop_bad(run: dict, want: dict) -> bool:
    return ({k: run["hop_kinds"].get(k, 0) for k in ("all-reduce", "all-gather")}
            != {k: want[k] for k in ("all-reduce", "all-gather")}
            or run["hop_bytes"] != want["total"])


def _tp_decode_profile(api, params, cache, tokens, pos: int, ctx) -> dict:
    """One more decode step under ``torch.profiler`` on the card: its wall,
    and the device time of the collectives' kernels (NCCL's) and of every
    kernel, by the profiler's own sums."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed.sharding import mesh_context

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with mesh_context(ctx):
            _, wall = _synced(lambda: api.decode_step(params, tokens, cache, pos))
    out = {"step_ms": wall * 1e3, "device_ms": 0.0, "all_reduce_ms": 0.0,
           "all_gather_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        out["device_ms"] += ms
        name = e.key.lower()
        if "allreduce" in name or "all_reduce" in name:
            out["all_reduce_ms"] += ms
        elif "allgather" in name or "all_gather" in name:
            out["all_gather_ms"] += ms
    return out


def _tp_reference(key: str):
    """``--tp-ref DIR``: the reference's params (numpy, the JAX package's
    tree) and its one-device greedy runs (the prompts, each call's logits,
    the tokens; with ``continuous``, its continuous engine's requests,
    capacity, logits and tokens) from ``DIR/<key>.pkl`` (``:`` in the key
    as ``_``)."""
    import pickle

    with open(os.path.join(ARGS.tp_ref, key.replace(":", "_") + ".pkl"), "rb") as f:
        return pickle.load(f)


def _tp_ref_workload(cont: dict) -> tuple:
    """The reference's continuous workload as the port's requests."""
    from repro_torch.serve import Request

    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=int(m), arrival_step=int(a))
            for p, m, a in cont["requests"]]
    return reqs, None, int(cont["capacity"])


def _logits_close(got: list, want: list, rows: list | None = None) -> tuple[list, bool]:
    """Each call's max |error| and whether every call is ``allclose`` at
    rtol = atol = ``TP_TOL``; with ``rows``, over each call's listed rows
    only."""
    want = [torch.as_tensor(np.asarray(w)).float() for w in want]
    got = [g.float() for g in got]
    if rows is not None:
        got, want = ([t[r] for t, r in zip(ts, rows)] for ts in (got, want))
    err = [float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, want)]
    close = len(got) == len(want) and all(
        torch.allclose(a, b, rtol=TP_TOL, atol=TP_TOL) for a, b in zip(got, want))
    return err, close


def _tp_arch(key: str, arch: str, layers: int, shape: tuple, vocab: int, moe: str,
             ctx) -> dict:
    """One cell of ``tensor_serve``: the params (from the seed through
    ``tensor_place``, or the reference's cut by ``convert.tensor_params``),
    the one-process references (the static engine and, with ``--tp-mixed``,
    the continuous one), the tensor-parallel static run, its checks, then
    the continuous engine (:func:`_tp_continuous`).  A family
    without ``decode_step_slots`` (the encoder-decoder, the SSMs) runs no
    continuous workload: the continuous engine must refuse it under the
    tensor table, as the reference's refuses it."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import (
        MeshContext,
        mesh_context,
        tensor_place,
        tensor_slice,
    )
    from repro_torch.models import convert, registry
    from repro_torch.serve.engine import grow_cache
    from repro_torch.tree import leaves, leaves_with_paths

    rank, R = INFO.process_id, INFO.num_processes
    B, S, new = shape
    cfg = _tp_cfg(arch, layers, vocab, moe)
    api = registry.build(cfg)
    place = tensor_place(api.param_specs, ctx, api.tensor_index)
    mixed, refused = ARGS.tp_mixed, None
    if mixed and api.decode_step_slots is None:
        mixed, refused = (), _tp_refuses_continuous(api, ctx)
    states = ARGS.tp_states and cfg.family in ("ssm", "hybrid")
    rec = {"layers": cfg.num_layers, "shape": list(shape), "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "attn_impl": cfg.attn_impl, "tol": TP_TOL,
           "moe_impl": cfg.moe_impl if cfg.num_experts else None,
           "capacity_factor": cfg.capacity_factor}
    meta = api.init(0, device="meta", place=place)
    rec["param_bytes_counted"] = sum(t.numel() * t.element_size() for t in leaves(meta))
    # every unit of the same mesh in this process: the one-process engines' context
    one_ctx = MeshContext(exchange.Mesh(ctx.mesh.num_pods, ctx.mesh.n))
    ref = whole = work = None
    cont_refs: dict = {}
    if ARGS.tp_ref not in ("whole", "none"):
        ref = _tp_reference(key.removesuffix(f":{moe}") if moe else key)
        prompts, extra = ref["prompts"], ref.get("extra")
        converted = convert.from_reference(ref["params"], device=DEV)
        params = convert.tensor_params(converted, cfg, ctx)
        if mixed:
            cont_refs["reference"] = ref["continuous"]
            work = _tp_ref_workload(ref["continuous"])
            if rank == 0:  # and the port's one-process engine on the whole tree
                cont_refs["one_process"] = _continuous_run(api, converted, work,
                                                           mixed[0], one_ctx)
        del converted
    else:
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        extra = None
        if cfg.family == "vlm":
            side = min(1024, S // 2)
            extra = {"patches": rng.standard_normal((B, side, cfg.d_model)).astype(np.float32)}
        elif cfg.family == "encdec":  # the frames as the serving launcher draws them
            frames = ARGS.tp_frames or S
            extra = {"frames": rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32)}
        if mixed:
            work = _continuous_workload(cfg, *mixed)
        if ARGS.tp_ref == "whole" and rank == 0:
            _reset_peak()
            whole = api.init(0, device=DEV)
            ref = _serve_run(api, whole, (prompts, extra, _tp_capacity(S, extra, new)), B,
                             new, one_ctx, None, states=states)
            rec["one_process"] = {k: ref[k] for k in ("stats", "prefill_s", "decode_s",
                                                      "wall_s", "peak", "launches", "paths")}
            if work is not None:
                one = cont_refs["one_process"] = _continuous_run(api, whole, work, mixed[0],
                                                                 one_ctx)
                rec["one_process_continuous"] = {
                    k: one[k] for k in ("stats", "prefill_s", "decode_s", "wall_s", "peak",
                                        "launches", "record", "paths", "mux")}
            if DEV == "cuda":  # the one-process runs' freed blocks, before the placed draw
                torch.cuda.empty_cache()
        params = api.init(0, device=DEV, place=place)
    if whole is not None:  # the placed draw is the whole draw's slices
        rec["params_equal_slices"] = all(  # a slice at a time: the whole tree is large
            torch.equal(a, tensor_slice(b, spec, ctx, api.tensor_index)) for a, b, spec in zip(
                leaves(params), leaves(whole), leaves(api.param_specs)))
        if not rec["params_equal_slices"]:
            raise AssertionError(f"tensor_serve {key}: the placed params are not the whole "
                                 "tree's slices")
        whole = None
        if DEV == "cuda":
            torch.cuda.empty_cache()
    rec["leaf_shapes"] = {"/".join(map(str, p)): list(t.shape)
                          for p, t in leaves_with_paths(params)}
    if refused is not None:
        rec["continuous_refused"] = refused
    side = _tp_side(extra)
    cap = _tp_capacity(S, extra, new)
    with mesh_context(ctx):
        rec["cache_bytes_counted"] = _cache_bytes(api, B, cap)
    sync_processes()
    runs = [_serve_run(api, params, (prompts, extra, cap), B, new, ctx, None, states=states)
            for _ in range(ARGS.tp_repeat)]
    run = runs[-1]
    if run["stats"]["rows"] != "tensor":
        raise AssertionError(f"tensor_serve {key}: ran {run['stats']['rows']}")
    calls = [(B, S + side, side, _tp_frames(extra))] + [(B, 1, 0)] * run["stats"]["decode_steps"]
    want_hop = _tp_hop_bytes(cfg, calls, ctx, cfg.exchange_impl)
    want_paths = _tp_paths(cfg, calls, ctx)
    want_flash = _tp_flash(cfg) if DEV == "cuda" else 0
    want_ssd = _tp_ssm_layers(cfg) if DEV == "cuda" else 0
    rec.update(rows=run["stats"]["rows"], tokens=run["tokens"], stats=run["stats"],
               hop_bytes=run["hop_bytes"], hop_kinds=run["hop_kinds"], want_hop=want_hop,
               want_flash=want_flash,
               launches=run["launches"], prefill_s=[r["prefill_s"] for r in runs],
               decode_s=[r["decode_s"] for r in runs], wall_s=[r["wall_s"] for r in runs],
               peak=run["peak"], tokens_repeat_equal=all(r["tokens"] == run["tokens"]
                                                        for r in runs),
               paths={p: run["paths"].count(p) for p in sorted(set(run["paths"]))})
    bad = []
    if _tp_hop_bad(run, want_hop):
        bad.append(f"pod hop {run['hop_kinds']} against {want_hop}")
    if any(r["paths"] != want_paths for r in runs):
        bad.append(f"MoE paths {rec['paths']} against {want_paths}")
    if any(r["launches"]["flash_attention"] != want_flash for r in runs):
        bad.append(f"flash_attention launched {[r['launches']['flash_attention'] for r in runs]}"
                   f" times a run, {want_flash} a prefill")
    if any(r["launches"]["ssd_scan"] != want_ssd for r in runs):
        bad.append(f"ssd_scan launched {[r['launches']['ssd_scan'] for r in runs]} times a run, "
                   f"{want_ssd} a prefill")
    if states:
        whole_states = ref.get("states") if ref is not None else None
        if ARGS.tp_ref == "whole":  # process 0's one-process run, to every process
            box = [whole_states]
            dist.broadcast_object_list(box, src=0)
            whole_states = box[0]
        rec["state_abs"], rec["states_close"] = _states_close(run["states"], whole_states, ctx)
        if not rec["states_close"]:
            bad.append(f"prefill states {rec['state_abs']} against the one-device run's "
                       f"(tolerance {TP_TOL})")
    every = [None] * R
    dist.all_gather_object(every, run["tokens"])
    rec["tokens_equal_on_every_process"] = all(t == run["tokens"] for t in every)
    if not rec["tokens_equal_on_every_process"]:
        bad.append("the processes' tokens differ")
    if ref is not None:
        rec["logit_abs"], rec["logits_close"] = _logits_close(run["logits"], ref["logits"])
        rec["tokens_equal"] = run["tokens"] == ref["tokens"]
        if ref.get("routes") is not None:
            rec["routes"] = _route_flips(run["routes"], ref["routes"])
        if cfg.num_experts and "drops" in ref:  # the one-process engine over the same units
            rec["drops"] = [int(d.sum()) for d in ref["drops"]]
        if not (rec["logits_close"] and rec["tokens_equal"]):
            bad.append(f"against the one-device run: logits {rec['logit_abs']} "
                       f"(tolerance {TP_TOL}), tokens equal {rec['tokens_equal']}")
    _raise_on_any(f"tensor_serve {key}", bad,
                  {k: rec.get(k) for k in ("logit_abs", "paths", "routes")})
    if ARGS.tp_temperature:
        temp = ARGS.tp_temperature
        sampled = _serve_run(api, params, (prompts, extra, cap), B, new, ctx, None,
                             temperature=temp)
        dist.all_gather_object(every, sampled["tokens"])
        rec["sampled"] = {"temperature": temp, "tokens": sampled["tokens"],
                          "equal_on_every_process": all(t == sampled["tokens"] for t in every),
                          "differs_from_greedy": sampled["tokens"] != run["tokens"]}
        if not rec["sampled"]["equal_on_every_process"]:
            raise AssertionError(f"tensor_serve {key}: sampled tokens differ between "
                                 "processes")
    if ARGS.tp_split:
        rec["split"] = _tp_split_check(api, params, prompts, ARGS.tp_split, ctx,
                                       run["logits"][0])
    if work is not None:
        rec["continuous"] = _tp_continuous(key, cfg, api, params, work, cont_refs, ctx,
                                           (prompts, extra, cap, new, run["tokens"]))
    if ARGS.tp_profile and DEV == "cuda":
        with mesh_context(ctx):
            batch = {"tokens": torch.from_numpy(prompts),
                     **{k: torch.as_tensor(v) for k, v in (extra or {}).items()}}
            logits, cache = api.prefill(params, {k: v.to(DEV) for k, v in batch.items()})
            cache = grow_cache(api, cache, B, cap)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        rec["decode_profile"] = _tp_decode_profile(api, params, cache, tok, S + side, ctx)
        del cache, logits
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return rec


def _states_close(got: dict, whole: dict, ctx) -> tuple[dict, bool]:
    """Each SSM state leaf's max |error| against this process's heads of the
    one-device run's leaf (heads on dim -3: ``[..., B, H, P, N]``), and
    whether every leaf is ``allclose`` at rtol = atol = ``TP_TOL``."""
    err, close = {}, set(got) == set(whole)
    for name, t in got.items():
        want = torch.as_tensor(np.asarray(whole[name])).float()
        Hl = t.shape[-3]
        want = want.narrow(-3, ctx.mesh.process_index * Hl if Hl < want.shape[-3] else 0, Hl)
        err[name] = float((t.float() - want).abs().max())
        close = close and torch.allclose(t.float(), want, rtol=TP_TOL, atol=TP_TOL)
    return err, close


def _tp_split_check(api, params, prompts: np.ndarray, n: int, ctx, full: torch.Tensor) -> dict:
    """``--tp-split N``: the prompts' first ``S - N`` tokens prefilled into a
    cache of ``S`` positions, then their last ``N`` fed one
    ``decode_step`` at a time (the last at position ``S - 1``, a long cell's
    decode step): the final logits' max |error| against the whole prefill's
    last-token logits ``full`` (recorded, no gate), the walls, the peak, and
    the last step's wall and peak alone."""
    from repro_torch.distributed.sharding import mesh_context

    B, S = prompts.shape
    toks = torch.from_numpy(prompts).to(DEV)
    _reset_peak()
    with mesh_context(ctx), torch.no_grad():
        (_, cache), pre = _synced(lambda: api.prefill(params, {"tokens": toks[:, :S - n]},
                                                      capacity=S))
        steps = []
        for i in range(S - n, S):
            if i == S - 1:
                peak = _peak()
                _reset_peak()
            (logits, cache), wall = _synced(
                lambda i=i: api.decode_step(params, toks[:, i:i + 1], cache, i))
            steps.append(wall)
    out = {"prefill_tokens": S - n, "steps": n, "prefill_s": pre,
           "decode_ms_a_step": 1e3 * sum(steps) / n, "last_step_ms": 1e3 * steps[-1],
           "peak": peak, "last_step_peak": _peak(),
           "logit_abs_max": float((logits.float().cpu() - full).abs().max())}
    del cache, logits
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_refuses_continuous(api, ctx) -> str:
    """The continuous engine's refusal of a family without
    ``decode_step_slots`` under the tensor table (its message); raises if
    it does not refuse."""
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.serve import ContinuousEngine

    try:
        with mesh_context(ctx):
            ContinuousEngine(api, batch_size=2, capacity=8, device=DEV)
    except NotImplementedError as e:
        return str(e)
    raise AssertionError(f"tensor_serve {api.cfg.name}: the continuous engine did not refuse "
                         f"the {api.cfg.family!r} family")


def _tp_continuous(key: str, cfg, api, params, work: tuple, refs: dict, ctx,
                   static: tuple) -> dict:
    """``--tp-mixed``'s workload through the continuous engine under the
    tensor table: every slot's cache rows on every process, each prefill
    group written in place, the same slot map, spans and tuned multiplexer
    on every process, the pod hop and the MoE paths as the schedule implies;
    held to each of ``refs`` that this process has: ``"reference"`` (the
    reference's continuous run from ``--tp-ref DIR``: logits, tokens, decode
    and slot steps) and ``"one_process"`` (process 0's one-process engine
    over the same units on the whole tree: also the admission and finish
    steps, the stats, the spans and the drops).  Then the static
    cell's prompts through the continuous engine (greedy tokens the static
    engine's, gated in f32) and the mixed workload through
    ``generate_bucketed`` (its slot-steps, beside the continuous engine's:
    with requests arriving over time either may take fewer)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.serve import Request, ServeEngine, generate_bucketed

    rank, R = INFO.process_id, INFO.num_processes
    B = ARGS.tp_mixed[0]
    reqs, extra, cap = work
    side = _tp_side(extra)
    sched = _continuous_schedule(api, B, work)
    mux = _continuous_mux(cfg, B, ctx.mesh)
    with mesh_context(ctx):
        cache_counted = _cache_bytes(api, B, cap)
    sync_processes()
    run = _continuous_run(api, params, work, B, ctx)
    calls = [(B, g["ctx_len"], side) for g in sched["groups"]]
    calls += [(B, 1, 0)] * sched["decode_steps"]
    want_hop = _tp_hop_bytes(cfg, calls, ctx, mux["impl"] if mux else cfg.exchange_impl)
    want_paths = _tp_paths(cfg, calls, ctx)
    on = DEV == "cuda"
    want_launches = {
        "flash_attention": _tp_flash(cfg) * len(sched["groups"]) if on else 0,
        "moe_dispatch": (want_paths.count("ep")
                         if on and mux is not None and mux["pack_impl"] == "cuda" else 0)}
    out = {"shape": [B, len(reqs), ARGS.tp_mixed[2]], "prompts": ARGS.serve_prompts,
           "rate": ARGS.serve_rate, "capacity": cap, "groups": len(sched["groups"]),
           "group_lengths": [g["plen"] for g in sched["groups"]],
           "rows": run["stats"]["rows"], "tokens": run["tokens"], "stats": run["stats"],
           "hop_bytes": run["hop_bytes"], "hop_kinds": run["hop_kinds"], "want_hop": want_hop,
           "launches": run["launches"], "want_launches": want_launches,
           "paths": {p: run["paths"].count(p) for p in sorted(set(run["paths"]))},
           "prefill_s": run["prefill_s"], "decode_s": run["decode_s"], "wall_s": run["wall_s"],
           "record": run["record"], "peak": run["peak"], "cache_bytes": run["cache_bytes"],
           "cache_bytes_counted": cache_counted, "mux": run["mux"], "leak_free": run["leak_free"]}
    fails = [k for k, bad in (
        ("rows", run["stats"]["rows"] != "tensor"),
        ("moved rows", run["stats"]["moved_rows"] != 0),
        ("done", not run["done"]), ("slot leak", not run["leak_free"]),
        ("cache", run["cache_bytes"] != cache_counted),
        ("pod hop", _tp_hop_bad(run, want_hop)),
        ("MoE paths", sorted(run["paths"]) != sorted(want_paths)),  # groups and steps mix
        ("launches", {k: run["launches"][k] for k in want_launches} != want_launches),
        ("spans", run["spans"] != sched["spans"]),
        ("multiplexer", run["mux"] != mux),
    ) if bad]
    every = [None] * R
    dist.all_gather_object(every, (run["tokens"], run["spans"], run["mux"],
                                   [d.tolist() for d in run["drops"]]))
    out["equal_on_every_process"] = {k: all(e[i] == every[0][i] for e in every)
                                     for i, k in enumerate(("tokens", "spans", "mux"))}
    fails += [f"{k} differ between processes"
              for k, same in out["equal_on_every_process"].items() if not same]
    # the rows a call serves: each group's admitted rows, each decode step's
    # live slots (padding rows and dead slots compute garbage nobody reads)
    live = [list(range(len(g["slots"]))) for g in sched["groups"]] + run["live"]
    for name, ref in refs.items():
        got = out[name] = {}
        got["logit_abs"], got["logits_close"] = _logits_close(run["logits"], ref["logits"], live)
        got["prefill_logit_abs"] = got["logit_abs"][:len(sched["groups"])]
        got["all_rows_logit_abs"], got["all_rows_close"] = _logits_close(run["logits"],
                                                                         ref["logits"])
        got["tokens_equal"] = run["tokens"] == ref["tokens"]
        if ref.get("routes") is not None:
            got["routes"] = _route_flips(run["routes"], ref["routes"])
        if name == "one_process":
            got["steps_equal"] = (run["admitted"], run["finished"]) == (ref["admitted"],
                                                                        ref["finished"])
            got["stats_equal"] = all(run["stats"][k] == ref["stats"][k] for k in _COUNTERS)
            got["spans_equal"] = run["spans"] == ref["spans"]
            drops = [sum((e[3][c] for e in every), []) for c in range(len(run["drops"]))]
            got["drops_equal"] = drops == [d.tolist() for d in ref["drops"]]
            got["drops"] = [sum(d) for d in drops]
            got["one_process_drops"] = [int(d.sum()) for d in ref["drops"]]
        else:
            got["stats_equal"] = all(run["stats"][k] == ref["stats"][k]
                                     for k in ("decode_steps", "slot_steps"))
        # the served rows are the gate; every row and the drops are recorded
        # (the callers gate them where they hold)
        fails += [f"{name} {k}" for k, v in got.items()
                  if v is False and k not in ("all_rows_close", "drops_equal")]
    if ARGS.tp_temperature:
        sampled = _continuous_run(api, params, work, B, ctx, temperature=ARGS.tp_temperature)
        dist.all_gather_object(every, (sampled["tokens"], sampled["spans"]))
        out["sampled"] = {"temperature": ARGS.tp_temperature, "tokens": sampled["tokens"],
                          "equal_on_every_process": all(e == every[0] for e in every),
                          "differs_from_greedy": sampled["tokens"] != run["tokens"],
                          "leak_free": sampled["leak_free"]}
        fails += ["sampled tokens differ between processes"] * (
            not out["sampled"]["equal_on_every_process"])
    # the static engine's guarantee: the same prompts, the same greedy tokens
    prompts, s_extra, s_cap, new, s_tokens = static
    if prompts.shape[0] == B:
        uniform = _continuous_run(api, params, ([Request(prompt=p.copy(), max_new_tokens=new)
                                                 for p in prompts], s_extra, s_cap), B, ctx)
        out["uniform_equal_static"] = uniform["tokens"] == s_tokens
        out["uniform_paths"] = {p: uniform["paths"].count(p) for p in set(uniform["paths"])}
        if cfg.dtype == "float32" and not out["uniform_equal_static"]:
            fails.append("continuous greedy tokens differ from the static engine's")
    engine = ServeEngine(api, batch_size=B, capacity=cap, device=DEV)
    with mesh_context(ctx):
        _, wall = _synced(lambda: generate_bucketed(engine, params, _fresh(reqs), extra))
    out["bucketed"] = {"slot_steps": engine.stats["slot_steps"],
                       "decode_steps": engine.stats["decode_steps"], "wall_s": wall,
                       "rows": engine.stats["rows"]}
    _raise_on_any(f"tensor_serve {key} continuous", fails, {
        k: out.get(k) for k in ("hop_kinds", "want_hop", "paths", "reference", "one_process")})
    return out


def _raise_on_any(tag: str, fails: list, detail: dict) -> None:
    """Every process's failures gathered, and every process raising if any
    failed: a gate only one process checks (its reference) must not leave
    the others waiting in the next collective."""
    import torch.distributed as dist

    every = [None] * INFO.num_processes
    dist.all_gather_object(every, fails)
    if any(every):
        if fails:
            print(f"[tensor-serve] FAIL {tag} process {INFO.process_id}: {fails}: {detail}",
                  flush=True)
        raise AssertionError(f"{tag}: failures by process {every}")


def _tp_capacity(S: int, extra, new: int) -> int:
    """The static engine's capacity: after the prompt (and a VLM's patch
    rows) or an encoder-decoder's frames, where its decode starts, ``new``
    positions and one more."""
    return max(S, _tp_frames(extra)) + new + 1 + _tp_side(extra)


def scenario_tensor_serve():
    """Tensor-parallel serving across the processes (``tensor_rules``): the
    static engine, and with ``--tp-mixed SLOTSxREQxNEW`` the continuous one,
    run the whole batch on every process over each process's slices of the
    heads, ``d_ff``, vocab and experts dims, the layers all-reducing and
    all-gathering over the pod hop (an MoE layer expert-parallel over the
    ``R x U`` units where they divide its tokens, else dense on the
    process's experts and an all-reduce).  ``--tp-ref DIR``: the reference's
    params and one-device greedy runs from ``DIR/<arch>.pkl`` (the CPU test
    writes them with the JAX package), the params cut by
    ``convert.tensor_params``; ``--tp-ref whole``: process 0 first runs the
    one-process engines on the whole tree from the seed over the same
    units, and the placed params must equal its slices.  Every config runs
    ``attn_impl="flash"``.  Gates: ``stats["rows"] == "tensor"``, logits
    within ``TP_TOL`` (``allclose``, rtol = atol) of the reference call for
    call, greedy tokens equal, tokens equal on every process, the pod hop's
    all-reduce and all-gather bytes and its total equal to the count from
    the shapes, each MoE call's path, ``flash_attention`` once a layer a
    prefill on the card under ``attn_impl="flash"``; the continuous
    engine's gates in :func:`_tp_continuous`.  ``--tp-temperature T``: a
    sampled run's tokens equal on every process.  ``--tp-profile``: one
    decode step profiled (the collectives' device time)."""
    from repro_torch.distributed.sharding import tensor_rules
    from repro_torch.launch.mesh import make_context

    ctx = make_context(multi_pod=True, rules=tensor_rules())
    if DEV == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"started_at": time.time(), "archs": {}}
    for key, arch, layers, shape, vocab, moe in _tp_cells():
        t0 = time.perf_counter()
        r = out["archs"][key] = _tp_arch(key, arch, layers, shape, vocab, moe, ctx)
        r["seconds"] = time.perf_counter() - t0
        print(f"[tensor-serve] {key}: {r['layers']} layers {r['dtype']}, {r['shape']}, rows "
              f"{r['rows']}, prefill {[round(s * 1e3, 1) for s in r['prefill_s'][-1]]} ms, "
              f"decode {sum(r['decode_s'][-1]) * 1e3:.1f} ms over {len(r['decode_s'][-1])} "
              f"steps, pod hop {r['hop_kinds']}, MoE paths {r['paths']}, peak {r['peak']}, "
              f"logits {max(r.get('logit_abs') or [0.0]):.3g}")
        if "continuous" in r:
            c = r["continuous"]
            print(f"[tensor-serve] {key} continuous: {c['shape']} (slots x requests x new), "
                  f"{c['groups']} prefill groups, {c['stats']['decode_steps']} decode steps, "
                  f"slot_steps {c['stats']['slot_steps']} (generate_bucketed "
                  f"{c['bucketed']['slot_steps']}), pod hop {c['hop_kinds']}, MoE paths "
                  f"{c['paths']}, logits "
                  f"{ {n: max(c[n]['logit_abs']) for n in ('reference', 'one_process') if n in c} }"
                  f", record {c['record']}")
    RESULTS["tensor_serve"] = out
    print("PASS tensor_serve")


def _grid_cells() -> list[tuple[str, str, int, int, str]]:
    """``--grid-cells``: ``(key, arch, layers, vocab, remat)`` from items
    ``arch[:layers[:vocab[:remat]]]`` (0 or empty: the config's)."""
    out = []
    for item in filter(None, ARGS.grid_cells.split(",")):
        arch, *rest = item.split(":")
        layers = int(rest[0]) if rest and rest[0] else 0
        vocab = int(rest[1]) if len(rest) > 1 and rest[1] else 0
        remat = rest[2] if len(rest) > 2 else ""
        out.append((f"{arch}:v{vocab}" if vocab else arch, arch, layers, vocab, remat))
    return out


def _grid_cfg(arch: str, layers: int, vocab: int, remat: str):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_config if ARGS.grid_full else get_smoke_config)(arch)
    kw = {"attn_impl": "flash", "dtype": ARGS.grid_dtype}
    if remat:
        kw["remat"] = remat
    if layers:
        kw["num_layers"] = layers
    if vocab:
        kw["vocab_size"] = vocab
    return cfg.scaled(**kw)


def _piece_numel(whole: int, held) -> int:
    """A leaf's elements on this process: ``whole`` cut along ``held``."""
    for h in held.dims() if held is not None else ():
        whole = whole // h.size * (h.stop - h.start)
    return whole


def _grid_hop_bytes(api, ctx, tokens: int) -> dict:
    """The bytes one train step (its gradient and its clipping norm) hands
    each group, by kind, from the shapes (``tokens``: this process's rows
    times the sequence).  The model row: the exits' all-reduces (the masked
    lookup where the vocab splits; a layer's attention and MLP where heads
    and ``d_ff`` split; under remat the attention's again in the recompute,
    which stops after the layer's last saved tensor, before the MLP's exit:
    ``torch.utils.checkpoint``'s early stop), the entries' gradient
    all-reduces (a layer's attention and MLP input and the logits' input
    where those split; the whole kv leaves a process reads in part) and the
    gathered logits.  The data column: each FSDP leaf's gather (a layer's
    again in a recompute; the tied table once for the lookup and once for
    the logits) and each gather's gradient reduce-scattered, then the mean
    of the leaves whole over it and of the loss.  The grid: the norm's one
    f32 scalar."""
    from repro_torch.distributed.sharding import mesh_context, tensor_split
    from repro_torch.models import layers as L
    from repro_torch.train.step import _state_shapes, grid_pieces, state_shardings
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = api.cfg
    act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    par = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    passes = 1 if cfg.remat == "none" else 2
    heads, ff, vocab = (tensor_split(n, name, ctx) > 1 for n, name in (
        (cfg.num_heads, "heads"), (cfg.d_ff, "d_ff"), (cfg.vocab_size, "vocab")))
    with mesh_context(ctx):
        read = L.kv_heads_read(cfg)
    shapes = _state_shapes(cfg).params
    held = leaves(state_shardings(api, ctx).params)
    reduces = vocab + cfg.num_layers * (2 * (heads + ff) + (passes - 1) * heads) + vocab
    kv_grads = 0
    gathered = scattered = whole = 0
    for (path, leaf), h, (over_data, _, _) in zip(leaves_with_paths(shapes), held,
                                                  grid_pieces(api, ctx)):
        n = _piece_numel(leaf.numel(), h)
        if read is not None and path[-2:-1] == ("attn",) and path[-1] in ("wk", "wv", "bk",
                                                                          "bv"):
            kv_grads += leaf.numel() * par  # the gathered leaf's gradient, summed over the row
        if not over_data:
            whole += 4 * n
            continue
        uses = passes if str(path[0]).startswith("seg") else \
            (2 if path[-1] == "table" and cfg.tie_embeddings else 1)
        grads = 1 if str(path[0]).startswith("seg") else uses
        gathered += uses * n * par
        scattered += grads * n * ctx.data.num_processes * par
    model = {"all-reduce": reduces * tokens * cfg.d_model * act + kv_grads}
    if vocab:
        model["all-gather"] = tokens * (cfg.vocab_size // ctx.mesh.num_processes) * act
    return {"model": model,
            "data": {"all-gather": gathered, "reduce-scatter": scattered,
                     "all-reduce": whole + 4},
            "grid": {"all-reduce": 4}}


def _from_rank0(t, shape, dtype) -> torch.Tensor:
    """A whole tensor on every process: ``t`` itself where every process
    ran the one-process step (``--grid-ref all``), else rank 0's, broadcast
    (through host memory under Gloo)."""
    import torch.distributed as dist

    if ARGS.grid_ref == "all":
        return t
    host = dist.get_backend() == "gloo"
    if INFO.process_id == 0:
        buf = t.detach().cpu() if host else t.detach().contiguous()
    else:
        buf = torch.empty(shape, dtype=dtype, device="cpu" if host else DEV)
    dist.broadcast(buf, src=0)
    return buf.to(DEV)


def _against_whole(got, want, held_tree, shapes, lead: float = 0.0) -> tuple[float, float]:
    """``(max over leaves of max |a - b| / max |b|, max |a - b|)`` between
    this process's pieces ``got`` and the same pieces of the whole tree
    ``want`` (``None`` away from rank 0 under ``--grid-ref rank0``: then
    broadcast a leaf at a time)."""
    from repro_torch.train.step import _keep
    from repro_torch.tree import leaves

    worst_rel, worst_abs = lead, 0.0
    wants = leaves(want) if want is not None else [None] * len(leaves(got))
    for a, w, h, shp in zip(leaves(got), wants, leaves(held_tree), leaves(shapes)):
        w = _from_rank0(w, tuple(shp.shape), shp.dtype)
        top = max(float(w.float().abs().max()), 1e-30)
        diff = float((a.float() - _keep(w, h).float()).abs().max())
        worst_rel, worst_abs = max(worst_rel, diff / top), max(worst_abs, diff)
    return worst_rel, worst_abs


def _replicated_identical(tree, ctx, api) -> dict:
    """Are the leaves whole over the model row bit-identical on the row's
    processes, and those whole over the data column on the column's?"""
    import hashlib

    import torch.distributed as dist

    from repro_torch.train.step import grid_pieces
    from repro_torch.tree import leaves

    pieces = grid_pieces(api, ctx)
    out = {}
    for label, mesh, col in (("model", ctx.mesh, 1), ("data", ctx.data, 0)):
        h = hashlib.sha256()
        for t, p in zip(leaves(tree), pieces):
            if not p[col]:
                h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
                         .numpy().tobytes())
        got = [None] * mesh.num_processes
        dist.all_gather_object(got, h.hexdigest(), group=mesh.group)
        out[label] = len(set(got)) == 1
    return out


def _grid_elastic(api, ctx_a, state_a, ctx_b, device) -> dict:
    """The state saved on grid ``a`` (each piece once, by its owner) and
    restored onto grid ``b``'s pieces, beside the whole state restored on
    every process: both grids' pieces equal its slices, bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.step import (TrainState, _keep, _state_shapes, grid_world,
                                        state_owners, state_shardings)
    from repro_torch.tree import leaves

    d = ARGS.grid_ckpt
    save_checkpoint(d, 1, state_a, state_shardings(api, ctx_a), grid_world(ctx_a),
                    state_owners(api, ctx_a))
    held_b = state_shardings(api, ctx_b)
    target = TrainState.create(api, 1, device=device, shardings=held_b)
    got_b = restore_checkpoint(d, 1, target, shardings=held_b)
    whole = restore_checkpoint(d, 1, _state_shapes(api.cfg), device=device)
    same = {}
    for tag, tree, held in (("a", state_a, state_shardings(api, ctx_a)), ("b", got_b, held_b)):
        same[tag] = all(torch.equal(t, _keep(w, h)) and t.shape == _keep(w, h).shape
                        for t, w, h in zip(leaves(tree), leaves(whole), leaves(held)))
    same["b_shapes"] = [list(t.shape) for t in leaves(got_b.params)] == \
        [list(t.shape) for t in leaves(target.params)]
    return same


def _grid_launcher(arch: str, layout: str) -> dict:
    """``launch.train.main(["--grid", layout, ...])`` inside this launch:
    a step with a checkpoint, then a run to 2 steps resuming from it,
    against 2 steps uninterrupted: the last metrics equal."""
    import contextlib
    import io
    import shutil

    from repro_torch.launch import train as train_cli

    d = os.path.join(ARGS.grid_ckpt, "cli")
    argv = ["--arch", arch, "--smoke", "--grid", layout, "--seq-len", "16", "--batch", "8",
            "--log-every", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(argv + ["--steps", "1", "--ckpt-dir", d, "--ckpt-every", "1"], device=DEV)
        st, resumed = train_cli.main(argv + ["--steps", "2", "--ckpt-dir", d, "--ckpt-every",
                                             "1"], device=DEV)
        _, straight = train_cli.main(argv + ["--steps", "2"], device=DEV)
    sync_processes()
    if INFO.process_id == 0:
        shutil.rmtree(d, ignore_errors=True)
    return {"resumed": "resumed from checkpoint at step 1" in out.getvalue(),
            "step": int(st.step), "equal": resumed == straight, "metrics": resumed}


# grid_train's gate on each gradient piece, relative to its leaf's max: the
# 1e-4 that ``scenario_dp_train`` and ``scenario_moe_train`` hold leaves to
# (the CPU tests hold the pieces to 1e-5 themselves).
GRID_GRAD_TOL = 1e-4


def scenario_grid_train():
    """Dense training on ``data x model`` grids of the launch's processes
    (``--grid-layouts``, each built by ``launch.mesh.make_grid_context`` over
    the same processes): for each ``--grid-cells`` cell, the state drawn
    already cut (``state_shardings``), each data column's rows of one global
    batch (``--grid-shape``, numpy from seed 0), the gradient and
    ``--grid-steps`` AdamW steps.  Against the one-process step on the whole
    batch (``--grid-ref``: every process runs it, or rank 0 and broadcasts
    it a leaf at a time, or none): the loss (rel 1e-5), every gradient piece
    (``GRID_GRAD_TOL`` of its leaf's max), each step's loss and
    grad norm (1e-5, 1e-4)
    and params (1e-5); the replicated leaves bit-identical within their
    groups; each group's bytes by kind to the shapes' count
    (:func:`_grid_hop_bytes`).  With ``--grid-ckpt DIR`` the state saved on
    the first layout restores onto the second bit for bit, and the
    launcher's ``--grid`` run resumes from its checkpoint.  Each process
    records its leaf shapes, losses, norms, walls and peak."""
    from repro_torch.distributed.sharding import local_rows, mesh_context
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_grid_context, parse_grid
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.step import _state_shapes, make_grad_fn, state_shardings
    from repro_torch.tree import leaves, leaves_with_paths

    B, S = ARGS.grid_shape
    opt = AdamWConfig()
    steps = ARGS.grid_steps
    layouts = [parse_grid(t) for t in ARGS.grid_layouts.split(",")]
    ctxs = [make_grid_context(D, M) for D, M in layouts]
    out = RESULTS.setdefault("grid_train", {})
    for key, arch, layers, vocab, remat in _grid_cells():
        cfg = _grid_cfg(arch, layers, vocab, remat)
        api = registry.build(cfg)
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(DEV),
                 "labels": torch.from_numpy(toks[:, 1:]).to(DEV)}
        rec = {"config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                          "remat": cfg.remat},
               "whole_state_bytes": 4 * 4 * sum(t.numel() for t in
                                                leaves(_state_shapes(cfg).params)),
               "layouts": {}}
        ref = None
        if ARGS.grid_ref == "all" or (ARGS.grid_ref == "rank0" and INFO.process_id == 0):
            _reset_peak()
            whole = TrainState.create(api, 0, device=DEV)
            (ref_loss, ref_grads), rec["one_process_grad_s"] = _synced(
                lambda: make_grad_fn(api)(whole.params, batch))
            one_step, s1, ref = make_train_step(api, opt), whole, {"params": [], "metrics": []}
            for _ in range(steps):
                (s1, m), wall = _synced(lambda: one_step(s1, batch))
                ref["params"].append(s1.params)
                ref["metrics"].append({k: float(v) for k, v in m.items()})
                rec.setdefault("one_process_step_s", []).append(wall)
            ref.update(loss=float(ref_loss), grads=ref_grads)
            rec["one_process"] = ref["metrics"]
            rec["one_process_peak"] = _peak()
            del whole, s1
        sync_processes()
        state_a = None
        for (D, M), ctx in zip(layouts, ctxs):
            tag = f"{D}x{M}"
            r = {"coords": [ctx.data.process_index, ctx.mesh.process_index]}
            held = state_shardings(api, ctx)
            _reset_peak()
            with mesh_context(ctx):
                (state, r["create_s"]) = _synced(
                    lambda: TrainState.create(api, 0, device=DEV, shardings=held))
                rows = local_rows(batch, ctx.data)
                r["shapes"] = {"/".join(map(str, path)): list(t.shape)
                               for path, t in leaves_with_paths(state.params)}
                r["state_bytes"] = sum(t.numel() * t.element_size() for t in leaves(state))
                grad_fn, step = make_grad_fn(api), make_train_step(api, opt)
                exchange.reset_pod_hop()
                k0 = fa.LAUNCHES["flash_attention"]
                (loss, grads), r["grad_s"] = _synced(lambda: grad_fn(state.params, rows))
                r["grad_launches"] = fa.LAUNCHES["flash_attention"] - k0
                r["grad_hop"] = {k: dict(v) for k, v in exchange.POD_HOP_GROUPS.items()}
                r["loss"] = float(loss)
                s, metrics, walls, hops, launched = state, [], [], [], []
                for i in range(steps):
                    exchange.reset_pod_hop()
                    k0 = fa.LAUNCHES["flash_attention"]
                    (s, m), wall = _synced(lambda: step(s, rows))
                    launched.append(fa.LAUNCHES["flash_attention"] - k0)
                    hops.append({k: dict(v) for k, v in exchange.POD_HOP_GROUPS.items()})
                    walls.append(wall)
                    metrics.append({k: float(v) for k, v in m.items()})
                    if ref is not None or ARGS.grid_ref == "rank0":
                        r.setdefault("params_rel", []), r.setdefault("params_abs", [])
                        rel, ab = _against_whole(s.params, ref["params"][i] if ref else None,
                                                 held.params, _state_shapes(cfg).params)
                        r["params_rel"].append(rel), r["params_abs"].append(ab)
                r.update(step_s=walls, step_hop=hops, launches=launched, metrics=metrics,
                         peak=_peak())
                r["hop_want"] = _grid_hop_bytes(api, ctx, rows["tokens"].numel())
                r["identical"] = _replicated_identical(s.params, ctx, api)
                if ref is not None or ARGS.grid_ref == "rank0":
                    r["grad_rel"] = _against_whole(grads, ref["grads"] if ref else None,
                                                   held.params, _state_shapes(cfg).params)[0]
            fails = []
            if hops[0] != r["hop_want"] or r["grad_hop"] != {
                    k: v for k, v in r["hop_want"].items() if k != "grid"}:
                fails.append(f"the groups carried {hops[0]} (gradient {r['grad_hop']}), the "
                             f"shapes' count {r['hop_want']}")
            if not all(r["identical"].values()):
                fails.append(f"replicated leaves differ within their group: {r['identical']}")
            per_pass = cfg.num_layers * (1 if cfg.remat == "none" else 2) if DEV == "cuda" else 0
            if any(n != per_pass for n in launched + [r["grad_launches"]]):
                fails.append(f"flash_attention launched {[r['grad_launches']] + launched} a "
                             f"call, {per_pass} implied")
            if ARGS.grid_ref == "all" or (ARGS.grid_ref == "rank0" and INFO.process_id == 0):
                r["loss_rel"] = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
                r["step_loss_rel"] = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                      for a, b in zip(metrics, ref["metrics"])]
                r["step_norm_rel"] = [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                                      for a, b in zip(metrics, ref["metrics"])]
                if (r["loss_rel"] > 1e-5 or r["grad_rel"] > GRID_GRAD_TOL
                        or max(r["step_loss_rel"]) > 1e-5 or max(r["step_norm_rel"]) > 1e-4
                        or max(r["params_abs"]) > 1e-5):
                    fails.append("against the one-process step: " + json.dumps(
                        {k: r[k] for k in ("loss_rel", "grad_rel", "step_loss_rel",
                                           "step_norm_rel", "params_abs")}))
            elif ARGS.grid_ref == "rank0" and (r["grad_rel"] > GRID_GRAD_TOL
                                               or max(r["params_abs"]) > 1e-5):
                fails.append(f"against rank 0's one-process step: gradient {r['grad_rel']}, "
                             f"params {r['params_abs']}")
            if not all(math.isfinite(m["loss"]) for m in metrics):
                fails.append(f"non-finite losses {metrics}")
            if fails:
                raise AssertionError(f"grid_train {key} on {tag}, process {INFO.process_id}: "
                                     + "; ".join(fails))
            print(f"[grid] {key} {tag} process {INFO.process_id} at {r['coords']}: steps "
                  + " ".join(f"{w * 1e3:.1f}" for w in walls) + f" ms; loss "
                  + " ".join(f"{m['loss']:.6f}" for m in metrics) + f"; state {r['state_bytes']} "
                  f"B of {rec['whole_state_bytes']}; peak {r['peak']}; hop {hops[0]}")
            if ARGS.grid_ckpt and state_a is None and len(ctxs) > 1:
                r["elastic"] = _grid_elastic(api, ctx, s, ctxs[1], DEV)
                if not all(r["elastic"].values()):
                    raise AssertionError(f"grid_train {key}: the state saved on {tag} restored "
                                         f"onto {layouts[1]}: {r['elastic']}")
                state_a = s
            rec["layouts"][tag] = r
            del state, s, grads
        out[key] = rec
    if ARGS.grid_ckpt:
        arch = _grid_cells()[0][1]
        out["launcher"] = _grid_launcher(arch, ARGS.grid_layouts.split(",")[0])
        if not (out["launcher"]["resumed"] and out["launcher"]["equal"]):
            raise AssertionError(f"grid_train: the launcher's resumed run {out['launcher']}")
    print("PASS grid_train")


SCENARIOS = {
    name.removeprefix("scenario_"): fn
    for name, fn in list(globals().items())
    if name.startswith("scenario_")
}
#: Run only when named: not part of "all".
ON_REQUEST = ("dp_train", "moe_train", "serve", "tensor_serve", "grid_train")


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", nargs="?", default="all")
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--morsel-rows", type=int, default=4096)
    ap.add_argument("--time-hop", action="store_true")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--dp-archs", default="train100m,mamba2-1.3b")
    ap.add_argument("--dp-full", action="store_true", help="full configs, not smoke ones")
    ap.add_argument("--dp-shape", default="8x32", help="dp_train's global batch, BxS")
    ap.add_argument("--moe-full", action="store_true", help="moe_train at full width")
    ap.add_argument("--moe-layers", type=int, default=0, help="moe_train's depth (0: the config's)")
    ap.add_argument("--moe-shape", default="8x32", help="moe_train's global batch, BxS")
    ap.add_argument("--moe-fabric-check", action="store_true")
    ap.add_argument("--moe-ckpt", default="")
    ap.add_argument("--moe-deep-steps", type=int, default=0)
    ap.add_argument("--profile", default="",
                    help="dp_train and moe_train: one more step counted op by op and one "
                         "under torch.profiler, its chrome trace written into this directory")
    ap.add_argument("--serve-cells", default="qwen2.5-3b",
                    help="serve: arch[:layers[:BxSxNEW]] items, comma-separated")
    ap.add_argument("--serve-full", action="store_true", help="serve at full width")
    ap.add_argument("--serve-dtype", default="float32")
    ap.add_argument("--serve-param-dtype", default="float32")
    ap.add_argument("--serve-ref", choices=("whole", "rows", "none"), default="whole")
    ap.add_argument("--serve-tol", type=float, default=1e-5)
    ap.add_argument("--serve-repeat", type=int, default=1)
    ap.add_argument("--serve-replicated", default="", help="serve: arch:B, a batch run whole")
    ap.add_argument("--serve-continuous", default="",
                    help="serve: arch[:layers[:BxREQxNEW]] items, comma-separated, through the "
                         "continuous engine")
    ap.add_argument("--serve-prompts", default="8,16",
                    help="serve: the continuous workload's prompt lengths")
    ap.add_argument("--serve-rate", type=float, default=2.0,
                    help="serve: the continuous workload's arrivals a step")
    ap.add_argument("--serve-uniform", default="",
                    help="serve: arch:BxSxNEW, uniform requests through both split engines")
    ap.add_argument("--serve-temperature", default="",
                    help="serve: arch:T, a continuous cell's workload sampled at T")
    ap.add_argument("--tp-cells", default="deepseek-67b",
                    help="tensor_serve: arch[:layers[:BxSxNEW[:vocab[:moe]]]] items, "
                         "comma-separated")
    ap.add_argument("--tp-full", action="store_true", help="tensor_serve at full width")
    ap.add_argument("--tp-dtype", default="float32")
    ap.add_argument("--tp-param-dtype", default="float32")
    ap.add_argument("--tp-ref", default="whole",
                    help="tensor_serve: whole (process 0's one-process engine), none, or a "
                         "directory of the reference's runs")
    ap.add_argument("--tp-repeat", type=int, default=1)
    ap.add_argument("--tp-temperature", type=float, default=0.0)
    ap.add_argument("--tp-profile", action="store_true",
                    help="tensor_serve: one decode step a cell under torch.profiler")
    ap.add_argument("--tp-capacity-factor", type=float, default=0.0,
                    help="tensor_serve: an MoE config's capacity factor (0: the config's)")
    ap.add_argument("--tp-states", action="store_true",
                    help="tensor_serve: each SSM or hybrid cell's prefill states against the "
                         "one-device run's, each process its heads")
    ap.add_argument("--tp-split", type=int, default=0,
                    help="tensor_serve: N, each cell's prefill of S - N tokens plus N decode "
                         "steps against the whole prefill's last-token logits (recorded)")
    ap.add_argument("--tp-mixed", default="",
                    help="tensor_serve: SLOTSxREQxNEW, a mixed workload (--serve-prompts, "
                         "--serve-rate) through the continuous engine after each cell")
    ap.add_argument("--tp-frames", type=int, default=0,
                    help="tensor_serve: an encoder-decoder cell's frame rows a request (0: "
                         "its prompt length)")
    ap.add_argument("--tp-routes", action="store_true",
                    help="tensor_serve: every MoE call's routes against process 0's "
                         "one-process run's (the flipped routes and their router margins)")
    ap.add_argument("--grid-cells", default="qwen2.5-3b",
                    help="grid_train: arch[:layers[:vocab[:remat]]] items, comma-separated")
    ap.add_argument("--grid-layouts", default="2x1",
                    help="grid_train: DxM grids of the launch's processes, comma-separated")
    ap.add_argument("--grid-shape", default="8x16", help="grid_train's global batch, BxS")
    ap.add_argument("--grid-steps", type=int, default=2)
    ap.add_argument("--grid-full", action="store_true", help="grid_train at full width")
    ap.add_argument("--grid-dtype", default="float32")
    ap.add_argument("--grid-ref", choices=("all", "rank0", "none"), default="all",
                    help="grid_train: the one-process step on every process, on rank 0 "
                         "(broadcast a leaf at a time), or none")
    ap.add_argument("--grid-ckpt", default="",
                    help="grid_train: a directory for the elastic restore and the launcher's "
                         "resumed run")
    args = ap.parse_args(argv)
    for k in ("cells", "layouts", "steps", "full", "dtype", "ref", "ckpt"):
        setattr(ARGS, f"grid_{k}", getattr(args, f"grid_{k}"))
    ARGS.grid_shape = tuple(int(v) for v in args.grid_shape.split("x"))
    for k in ("cells", "full", "dtype", "param_dtype", "ref", "repeat", "temperature",
              "profile", "capacity_factor", "states", "split", "frames", "routes"):
        setattr(ARGS, f"tp_{k}", getattr(args, f"tp_{k}"))
    ARGS.tp_mixed = tuple(int(v) for v in args.tp_mixed.split("x")) if args.tp_mixed else ()
    ARGS.sf, ARGS.morsel_rows, ARGS.time_hop = args.sf, args.morsel_rows, args.time_hop
    ARGS.dp_archs, ARGS.dp_full = args.dp_archs.split(","), args.dp_full
    ARGS.dp_shape = tuple(int(v) for v in args.dp_shape.split("x"))
    ARGS.moe_full, ARGS.moe_layers = args.moe_full, args.moe_layers
    ARGS.moe_shape = tuple(int(v) for v in args.moe_shape.split("x"))
    ARGS.moe_fabric_check, ARGS.moe_ckpt = args.moe_fabric_check, args.moe_ckpt
    ARGS.moe_deep_steps = args.moe_deep_steps
    ARGS.profile = args.profile
    for k in ("cells", "full", "dtype", "param_dtype", "ref", "tol", "repeat",
              "replicated", "continuous", "rate", "uniform", "temperature"):
        setattr(ARGS, f"serve_{k}", getattr(args, f"serve_{k}"))
    ARGS.serve_prompts = [int(v) for v in args.serve_prompts.split(",")]
    names = ([n for n in SCENARIOS if n not in ON_REQUEST] if args.scenario == "all"
             else args.scenario.split(","))
    start = _counts()
    seconds = {}
    for nm in names:
        t0 = time.perf_counter()
        SCENARIOS[nm]()
        seconds[nm] = time.perf_counter() - t0
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        with open(os.path.join(args.dump, f"p{INFO.process_id}.json"), "w") as f:
            json.dump({"results": RESULTS, "seconds": seconds, "device": INFO.device,
                       "backend": INFO.backend,
                       "launches": {k: v - start[k] for k, v in _counts().items()}}, f)
    if torch.distributed.is_initialized():
        sync_processes()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
