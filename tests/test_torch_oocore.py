"""Out-of-core morsel streaming in the port, against the JAX package.

Both packages compute on identical data: the reference's tables are handed
to the port with ``table_from_numpy``.  Integer outputs must be exact and
f32 sums within rtol 1e-5 (the two frameworks sum a morsel in different
orders); ``stats["passes"]`` and ``stats["morsels"]`` must be equal.

* One shard, in process: the counterparts of ``tests/test_oocore.py`` run
  on both sides (Q1 in one pass, Q17 in two with its re-scan, the
  ``morsel_rows`` auto-wrap, the device row budget, chunked generator
  sources byte for byte, the error surface), and ``explain()`` of plans
  built with ``morsel_rows`` at 1 and 8 shards.
* In ONE subprocess that runs this file as a script with 8 fake XLA devices
  (the flag is never set in the pytest process): the reference's
  ``oocore_streamed`` (Q1, Q17, Q18 at SF 0.01, morsels of 4,096 rows,
  budget half of lineitem), ``oocore_spill`` (Q18 with 16-row messages) and
  the 2 x 4 stream of ``oocore_pod_stream``, each with its answer, counters
  and per-edge reports (what ``run._run_fn()`` returns), and
  ``hash_shuffle_spill`` under ``shard_map`` at several capacities.
* ``gpu``-marked tests (skipped without a card): the kernel spill pack
  equals the plain one, the pinned prefetch delivers the same tensors, and
  Q18 streamed with spill on the card equals the same run on the CPU.
"""

import os
import subprocess
import sys

if __name__ == "__main__":  # the reference side, on 8 fake devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

SF = 0.002  # the one-shard cases (tests/test_oocore.py's)
SF_MESH = 0.01  # the reference's own 8-device out-of-core scenarios
MORSEL = 4096
SPILL_ROWS = 16
# (case, query, pods, exchange_rows, spill)
MESH_CASES = [
    ("q1", "q1", 1, None, False),
    ("q17", "q17", 1, None, False),
    ("q18", "q18", 1, None, False),
    ("q1_pods", "q1", 2, None, False),
    ("q17_pods", "q17", 2, None, False),
    ("q18_pods", "q18", 2, None, False),
    ("q18_spill", "q18", 1, SPILL_ROWS, True),
]
N, T = 8, 96  # hash_shuffle_spill units: shards, rows a shard
SPILL_CAPS = [3, 12, 96]


def _spill_data():
    rng = np.random.default_rng(11)
    keys = np.where(rng.random(N * T) < 0.3, 5, rng.integers(0, 5_000, N * T)).astype(np.int32)
    rows = np.stack([keys, np.arange(N * T, dtype=np.int32)], axis=1)
    valid = rng.random(N * T) >= 0.2
    return keys, rows, valid


def _mesh_sources(tabs, q, MorselView, as_source):
    names = {"q1": ("lineitem",), "q17": ("lineitem", "part"),
             "q18": ("lineitem", "orders", "customer")}[q]
    out = {t: as_source(tabs[t]) for t in names}
    out["lineitem"] = MorselView(tabs["lineitem"], morsel_rows=MORSEL)
    return out


def _report_arrays(prefix: str, reports: dict) -> dict:
    out = {}
    for key, rep in reports.items():
        out[f"{prefix}/hist/{key}"] = np.asarray(rep["hist"], np.int64)
        out[f"{prefix}/traversals/{key}"] = np.asarray(rep["traversals"])
    return out


def reference_main(out_path: str) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import exchange
    from repro.launch.mesh import make_test_mesh
    from repro.relational import datagen
    from repro.relational.context import ExecutionContext as Ctx
    from repro.relational.planner import tpch
    from repro.relational.planner.stream import compile_plan_streamed
    from repro.relational.source import MorselView, as_source

    arrays = {}
    tabs = datagen.gen_all(SF_MESH)
    budget = tabs["lineitem"].capacity // 2
    for case, q, pods, xrows, spill in MESH_CASES:
        pq = tpch.ALL_QUERIES[q]()
        sources = _mesh_sources(tabs, q, MorselView, as_source)
        catalog = {t: sources[t].capacity for t in pq.tables}
        plan = pq.plan(catalog, N, num_pods=pods)
        if spill:
            ctx = Ctx(num_shards=N, exchange_rows=xrows)
            try:
                compile_plan_streamed(plan, sources, ctx)()
            except RuntimeError as e:
                arrays[f"{case}/unspilled_error"] = np.asarray(str(e))
            ctx = ctx.with_(spill=True)
        else:
            ctx = Ctx(num_shards=N, num_pods=pods, device_row_budget=budget)
        run = compile_plan_streamed(plan, sources, ctx)
        raw, stats, reports = run._run_fn()
        got = pq.finalize(raw)
        got = got if isinstance(got, dict) else {"result": got}
        for k, v in got.items():
            arrays[f"{case}/result/{k}"] = np.asarray(v)
        for k in ("passes", "morsels", "spilled_rows", "drain_rounds"):
            arrays[f"{case}/stats/{k}"] = np.asarray(stats[k])
        arrays.update(_report_arrays(case, reports))
    flat = make_test_mesh((N,), ("x",))
    keys, rows, valid = map(jax.numpy.asarray, _spill_data())
    for cap in SPILL_CAPS:
        for pack in ("xla", "pallas"):
            fn = shard_map(
                lambda k, r, v, cap=cap, pack=pack: exchange.hash_shuffle_spill(
                    k, r, "x", capacity=cap, valid=v, pack_impl=pack),
                mesh=flat, in_specs=(P("x"),) * 3, out_specs=(P("x"),) * 3,
                check_vma=False,
            )
            for name, a in zip(("rows", "valid", "spilled"), jax.jit(fn)(keys, rows, valid)):
                arrays[f"spill_unit/{cap}/{pack}/{name}"] = np.asarray(a)
    np.savez(out_path, **arrays)


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

from repro.relational import datagen as ref_datagen  # noqa: E402
from repro.relational.context import ExecutionContext as RefContext  # noqa: E402
from repro.relational.planner import tpch as ref_tpch  # noqa: E402
from repro.relational.planner.executor import execute_plan as ref_execute_plan  # noqa: E402
from repro.relational.planner.stream import compile_plan_streamed as ref_streamed  # noqa: E402
from repro.relational.source import MorselView as RefMorselView  # noqa: E402
from repro.relational.source import as_source as ref_as_source  # noqa: E402
from repro_torch.core import exchange  # noqa: E402
from repro_torch.core.exchange import make_mesh  # noqa: E402
from repro_torch.core.multiplexer import CommMultiplexer, make_multiplexer  # noqa: E402
from repro_torch.data.pipeline import Prefetcher  # noqa: E402
from repro_torch.kernels.ref import fibonacci_hash  # noqa: E402
from repro_torch.relational import datagen  # noqa: E402
from repro_torch.relational.context import ExecutionContext  # noqa: E402
from repro_torch.relational.planner import tpch  # noqa: E402
from repro_torch.relational.planner.executor import compile_plan, execute_plan  # noqa: E402
from repro_torch.relational.planner.stream import compile_plan_streamed  # noqa: E402
from repro_torch.relational.source import (  # noqa: E402
    GeneratorSource,
    MorselView,
    as_source,
    concat_tables,
)
from repro_torch.relational.table import Table, morsels, table_from_numpy  # noqa: E402

CTX1 = ExecutionContext(num_shards=1, device="cpu")
REF1 = RefContext(num_shards=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every tensor here is small: one intra-op thread, so that in a
    parallel test run many small ops do not wait on oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_table(t) -> Table:
    return table_from_numpy(
        {c: np.asarray(v) for c, v in t.columns.items()}, np.asarray(t.valid), "cpu",
        t.dictionaries,
    )


@pytest.fixture(scope="module")
def ref_tabs():
    return {"lineitem": ref_datagen.gen_lineitem(SF), "part": ref_datagen.gen_part(SF)}


@pytest.fixture(scope="module")
def tabs(ref_tabs):
    return {name: _port_table(t) for name, t in ref_tabs.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "reference.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(path)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def mesh_tabs():
    return {name: _port_table(t) for name, t in ref_datagen.gen_all(SF_MESH).items()}


def _as_dict(r) -> dict:
    return r if isinstance(r, dict) else {"result": r}


def _assert_same_result(got, want, rtol=1e-5):
    got, want = _as_dict(got), _as_dict(want)
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)


def _both_streamed(q, ref_sources, sources, ref_ctx=REF1, ctx=CTX1):
    """The same query streamed on both sides, planned the same way."""
    pq, rpq = tpch.ALL_QUERIES[q](), ref_tpch.ALL_QUERIES[q]()
    catalog = {t: sources[t].capacity for t in pq.tables}
    rrun = ref_streamed(rpq.plan(catalog, ctx.num_shards), ref_sources, ref_ctx)
    run = compile_plan_streamed(pq.plan(catalog, ctx.num_shards), sources, ctx)
    want, got = rpq.finalize(rrun()), pq.finalize(run())
    _assert_same_result(got, want)
    for k in ("passes", "morsels", "spilled_rows", "drain_rounds"):
        assert run.stats[k] == rrun.stats[k], k
    return run.stats


# ---------------------------------------------------------------------------
# One shard, in process: streamed == the reference's streamed run.
# ---------------------------------------------------------------------------

def test_q1_streams_one_pass(ref_tabs, tabs):
    stats = _both_streamed(
        "q1", {"lineitem": RefMorselView(ref_tabs["lineitem"], 700)},
        {"lineitem": MorselView(tabs["lineitem"], 700)},
    )
    assert stats["passes"] == 1
    assert stats["morsels"] == MorselView(tabs["lineitem"], 700).num_chunks
    assert 0.0 <= stats["prefetch_overlap_fraction"] <= 1.0


def test_q17_streams_two_passes_with_rescan(ref_tabs, tabs):
    src = MorselView(tabs["lineitem"], 700)
    stats = _both_streamed(
        "q17",
        {"lineitem": RefMorselView(ref_tabs["lineitem"], 700),
         "part": ref_as_source(ref_tabs["part"])},
        {"lineitem": src, "part": as_source(tabs["part"])},
    )
    assert stats["passes"] == 2
    assert stats["morsels"] == 2 * src.num_chunks  # pass 2 re-scans the stream


def test_run_query_auto_wraps_oversized_table(ref_tabs, tabs):
    """``ctx.morsel_rows`` alone makes run_query stream the big table."""
    want = ref_tpch.run_query(ref_tpch.q17(), ref_tabs, REF1.with_(morsel_rows=700))
    got = tpch.run_query(tpch.q17(), tabs, CTX1.with_(morsel_rows=700))
    _assert_same_result(got, want)
    in_memory = tpch.run_query(tpch.q17(), tabs, CTX1)
    np.testing.assert_allclose(float(got), float(in_memory), rtol=1e-3)


def test_streaming_clears_budget_in_memory_execution_refuses(ref_tabs, tabs):
    li = tabs["lineitem"]
    budget = li.capacity // 4
    ctx = CTX1.with_(device_row_budget=budget)
    plan = tpch.q1().plan({"lineitem": li.capacity}, 1)
    with pytest.raises(ValueError, match="device_row_budget"):
        execute_plan(plan, {"lineitem": li}, ctx)
    with pytest.raises(ValueError, match="device_row_budget"):
        compile_plan(plan, {"lineitem": li}, ctx)
    morsel = budget // 2
    want = ref_tpch.run_query(
        ref_tpch.q1(), {"lineitem": RefMorselView(ref_tabs["lineitem"], morsel)},
        REF1.with_(device_row_budget=budget),
    )
    got = tpch.run_query(tpch.q1(), {"lineitem": MorselView(li, morsel)}, ctx)
    _assert_same_result(got, want)


def test_morsel_exceeding_budget_rejected(tabs):
    src = MorselView(tabs["lineitem"], morsel_rows=1024)
    plan = tpch.q1().plan({"lineitem": src.capacity}, 1)
    with pytest.raises(ValueError, match="device_row_budget"):
        compile_plan_streamed(plan, {"lineitem": src}, CTX1.with_(device_row_budget=512))


@pytest.mark.parametrize("sf,num_chunks", [(SF, 4), (SF_MESH, 7)])
def test_gen_lineitem_chunked_equals_reference_byte_for_byte(sf, num_chunks):
    src = datagen.gen_lineitem_chunked(sf, num_chunks=num_chunks)
    ref = ref_datagen.gen_lineitem_chunked(sf, num_chunks=num_chunks)
    assert isinstance(src, GeneratorSource) and src.is_chunked
    assert (src.num_chunks, src.chunk_rows, src.capacity) == (
        ref.num_chunks, ref.chunk_rows, ref.capacity)
    for mine, theirs in zip(src.chunks(), ref.chunks(), strict=True):
        assert mine.device.type == "cpu"  # chunks stay on the host
        assert sorted(mine.columns) == sorted(theirs.columns)
        for c in theirs.columns:
            w = np.asarray(theirs[c])
            g = mine[c].numpy()
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), c
        assert mine.dictionaries == theirs.dictionaries
    # materialize() is exactly the chunks, in order; chunks are deterministic
    whole = src.materialize()
    third_a, third_b = list(src.chunks())[2], list(src.chunks())[2]
    for c in whole.columns:
        np.testing.assert_array_equal(
            whole[c][2 * src.chunk_rows:3 * src.chunk_rows].numpy(), third_a[c].numpy(), c)
        assert torch.equal(third_a[c], third_b[c])


def test_generator_source_streams_without_materializing():
    src = datagen.gen_lineitem_chunked(SF, num_chunks=4)
    ref = ref_datagen.gen_lineitem_chunked(SF, num_chunks=4)
    want = ref_tpch.run_query(ref_tpch.q6(), {"lineitem": ref}, REF1)
    got = tpch.run_query(tpch.q6(), {"lineitem": src}, CTX1)
    _assert_same_result(got, want)
    in_memory = tpch.run_query(tpch.q6(), {"lineitem": src.materialize()}, CTX1)
    np.testing.assert_allclose(float(got), float(in_memory), rtol=1e-3)


def test_two_oversized_tables_cannot_both_stream(tabs):
    with pytest.raises(ValueError, match="one chunked relation"):
        tpch.run_query(tpch.q17(), tabs, CTX1.with_(morsel_rows=8))


def test_chunked_source_rejected_by_in_memory_compile(tabs):
    src = MorselView(tabs["lineitem"], morsel_rows=700)
    plan = tpch.q1().plan({"lineitem": src.capacity}, 1)
    with pytest.raises(ValueError, match="chunked"):
        compile_plan(plan, {"lineitem": src}, CTX1)


def test_sources_and_morsels_keep_rows_in_order(tabs):
    li = tabs["lineitem"]
    view = MorselView(li, 1000)
    chunks = list(view.chunks())
    assert view.capacity == 1000 * len(chunks) >= li.capacity
    assert not chunks[-1].valid[li.capacity - 1000 * (len(chunks) - 1):].any()  # padded
    whole = view.materialize()
    assert torch.equal(whole["l_orderkey"][:li.capacity], li["l_orderkey"])
    parts = list(morsels(li, 1000))
    assert [p.capacity for p in parts[:-1]] == [1000] * (len(parts) - 1)
    assert torch.equal(concat_tables(parts)["l_quantity"], li["l_quantity"])
    assert as_source(li).materialize() is li and not as_source(li).is_chunked
    with pytest.raises(ValueError, match="capacity"):
        list(GeneratorSource(lambda i: li, 2, 1000).chunks())


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("q", ["q1", "q17", "q18"])
def test_explain_with_morsel_rows_equals_reference(q, shards):
    catalog = tpch.tpch_catalog(1)
    for morsel in (MORSEL, 2**20):
        got = tpch.ALL_QUERIES[q]().plan(catalog, shards, morsel_rows=morsel).explain()
        want = ref_tpch.ALL_QUERIES[q]().plan(catalog, shards, morsel_rows=morsel).explain()
        # the port prints its pack knob as torch / cuda where the reference
        # prints xla / pallas
        assert got.replace("pack=torch", "pack=xla").replace("pack=cuda", "pack=pallas") == want
    if q != "q1" and shards > 1:  # streamed shuffles price one morsel
        assert got != tpch.ALL_QUERIES[q]().plan(catalog, shards).explain()


# ---------------------------------------------------------------------------
# 8 shards and 2 x 4: the reference's own scenarios, in its subprocess.
# ---------------------------------------------------------------------------

def _mesh_run(mesh_tabs, q, pods, **knobs):
    pq = tpch.ALL_QUERIES[q]()
    sources = _mesh_sources(mesh_tabs, q, MorselView, as_source)
    catalog = {t: sources[t].capacity for t in pq.tables}
    plan = pq.plan(catalog, N, num_pods=pods)
    ctx = ExecutionContext(num_shards=N, num_pods=pods, device="cpu", **knobs)
    return pq, plan, sources, ctx


def _assert_reports_equal(reference, case, reports):
    want = {k.split("/", 2)[2] for k in reference if k.startswith(f"{case}/hist/")}
    assert sorted(reports) == sorted(want)
    for key, rep in reports.items():
        np.testing.assert_array_equal(rep["hist"], reference[f"{case}/hist/{key}"], err_msg=key)
        assert rep["hist"].dtype == np.int64
        assert rep["traversals"] == int(reference[f"{case}/traversals/{key}"]), key


def _assert_equals_reference(reference, case, result, stats):
    want = {k.split("/", 2)[2]: v for k, v in reference.items()
            if k.startswith(f"{case}/result/")}
    _assert_same_result(_as_dict(result), want)
    for k in ("passes", "morsels", "spilled_rows", "drain_rounds"):
        assert stats[k] == int(reference[f"{case}/stats/{k}"]), k


@pytest.mark.parametrize("case,q,pods", [c[:3] for c in MESH_CASES if not c[4]])
def test_mesh_stream_equals_reference(reference, mesh_tabs, case, q, pods):
    budget = mesh_tabs["lineitem"].capacity // 2
    pq, plan, sources, ctx = _mesh_run(mesh_tabs, q, pods, device_row_budget=budget)
    run = compile_plan_streamed(plan, sources, ctx)
    got = pq.finalize(run())
    _assert_equals_reference(reference, case, got, run.stats)
    _assert_reports_equal(reference, case, run.reports)
    assert run.stats["passes"] == (1 if q == "q1" else 2)
    if q == "q18":
        assert len(got["o_orderkey"])  # a non-vacuous top-k
    if pods > 1:
        with pytest.raises(NotImplementedError, match="single-level"):
            compile_plan_streamed(plan, sources, ctx.with_(spill=True))


def test_spill_drains_to_the_reference_answer(reference, mesh_tabs):
    case = "q18_spill"
    pq, plan, sources, ctx = _mesh_run(mesh_tabs, "q18", 1, exchange_rows=SPILL_ROWS)
    with pytest.raises(RuntimeError, match="dropped"):
        compile_plan_streamed(plan, sources, ctx)()
    assert "dropped" in str(reference[f"{case}/unspilled_error"])
    unpressured = compile_plan_streamed(plan, sources, ctx.with_(exchange_rows=None))
    base = pq.finalize(unpressured())
    assert unpressured.stats["spilled_rows"] == 0
    for pack in ("torch", "cuda"):
        run = compile_plan_streamed(plan, sources, ctx.with_(spill=True, pack_impl=pack))
        got = pq.finalize(run())
        assert (run.stats["spilled_rows"], run.stats["drain_rounds"]) == (44_640, 46)
        _assert_equals_reference(reference, case, got, run.stats)
        _assert_reports_equal(reference, case, run.reports)
        for k in base:  # bit-identical to the run without pressure
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)


@pytest.mark.parametrize("q,pods,knobs", [
    ("q17", 1, {}),
    ("q18", 1, {}),
    ("q17", 2, {}),
    ("q18", 1, {"exchange_rows": SPILL_ROWS, "spill": True}),
])
def test_shuffles_per_step_counts_every_pack_and_resident_messages_fit_arrivals(
        monkeypatch, mesh_tabs, q, pods, knobs):
    """``shuffles_per_step`` with the run's steps and drain rounds names
    every shuffle the run packs; a streamed shuffle ships morsel-sized (or
    ``exchange_rows``) messages, a resident one messages sized by its
    largest (src, dst) count."""
    pq, plan, sources, ctx = _mesh_run(mesh_tabs, q, pods, **knobs)
    calls = []  # (rows a shard, message capacity, largest (src, dst) count)

    def watch(name):
        orig = getattr(CommMultiplexer, name)

        def wrapped(self, keys, rows, axis_name, capacity, valid=None):
            dest = (fibonacci_hash(keys) % N).long()
            pairs = torch.zeros((N, N), dtype=torch.int64).scatter_add_(1, dest, valid.long())
            calls.append((keys.shape[1], capacity, int(pairs.max())))
            return orig(self, keys, rows, axis_name, capacity, valid)

        monkeypatch.setattr(CommMultiplexer, name, wrapped)

    watch("hash_shuffle_global")
    watch("hash_shuffle_spill")
    run = compile_plan_streamed(plan, sources, ctx)
    got = pq.finalize(run())
    streamed = list(calls)  # the in-memory run below shuffles too
    _assert_same_result(got, pq.finalize(compile_plan(plan, {
        t: s.materialize() for t, s in sources.items()}, ctx)()))
    steps = sources["lineitem"].num_chunks
    sched = run.shuffles_per_step
    want = sum(steps * s["streamed"] + s["resident"] for s in sched)
    want += run.stats["drain_rounds"] * max(s["drain"] for s in sched)
    assert len(streamed) == want > 0
    morsel = -(-sources["lineitem"].chunk_rows // N)
    q_chunks = run.mux.pipeline_chunks * run.mux.transport_chunks
    for r, c, m in streamed:
        if r == morsel:  # streamed, or a drain round's re-offer
            assert c == min(r, knobs.get("exchange_rows") or r)
        else:
            assert c % q_chunks == 0 and c - q_chunks < m <= c < r
    if q == "q18":  # pass 2 shuffles the resident orders once
        assert sum(r != morsel for r, _c, _m in streamed) == 1


def _port_spill_inputs():
    keys, rows, valid = _spill_data()
    return (torch.from_numpy(keys).reshape(N, T), torch.from_numpy(rows).reshape(N, T, 2),
            torch.from_numpy(valid).reshape(N, T))


@pytest.mark.parametrize("pack", ["torch", "cuda"])
@pytest.mark.parametrize("cap", SPILL_CAPS)
def test_hash_shuffle_spill_equals_reference(reference, cap, pack):
    keys, rows, valid = _port_spill_inputs()
    got = exchange.hash_shuffle_spill(keys, rows, make_mesh(N), "q", cap, valid=valid,
                                      pack_impl=pack)
    for ref_pack in ("xla", "pallas"):
        for name, g in zip(("rows", "valid", "spilled"), got):
            want = reference[f"spill_unit/{cap}/{ref_pack}/{name}"]
            np.testing.assert_array_equal(g.reshape(want.shape).numpy(), want, err_msg=name)
    r_out, v_out, spilled = got
    # every valid row is delivered or flagged, never neither
    assert int(v_out.sum()) + int(spilled.sum()) == int(valid.sum())
    assert bool(spilled.any()) == (cap < T)


# ---------------------------------------------------------------------------
# Plain units.
# ---------------------------------------------------------------------------

def test_prefetcher_keeps_order_and_surfaces_errors():
    items = [{"x": torch.full((3,), i)} for i in range(7)]
    for device in (None, "cpu"):
        got = list(Prefetcher(iter(items), depth=2, device=device))
        assert [int(g["x"][0]) for g in got] == list(range(7))

    def bad():
        yield items[0]
        raise RuntimeError("boom")

    pf = Prefetcher(bad(), depth=1, device="cpu")
    assert torch.equal(next(pf)["x"], items[0]["x"])
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)


def test_spill_on_a_pod_mesh_raises():
    mux = make_multiplexer(make_mesh(N, num_pods=2))
    keys, rows, valid = _port_spill_inputs()
    with pytest.raises(NotImplementedError, match="single-level"):
        mux.hash_shuffle_spill(keys, rows, "q", 4, valid=valid)
    flat = make_multiplexer(make_mesh(N))
    want = exchange.hash_shuffle_spill(keys, rows, make_mesh(N), "q", 4, valid=valid)
    for g, w in zip(flat.hash_shuffle_spill(keys, rows, "q", 4, valid=valid), want):
        assert torch.equal(g, w)


def test_streaming_fields_are_accepted_and_trace_still_raises():
    ctx = ExecutionContext(morsel_rows=64, spill=True, exchange_rows=8,
                           device_row_budget=100, group_state_rows=10, prefetch_depth=3)
    assert ctx.with_(spill=False) == ExecutionContext(
        morsel_rows=64, exchange_rows=8, device_row_budget=100, group_state_rows=10,
        prefetch_depth=3)
    assert ExecutionContext().prefetch_depth == RefContext().prefetch_depth == 2
    # the telemetry slice has landed: a tracer is accepted, and is payload
    traced = ctx.with_(trace=object())
    assert traced == ctx and hash(traced) == hash(ctx)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cap", SPILL_CAPS)
def test_hash_shuffle_spill_kernel_equals_plain_on_the_card(cuda_device, cap):
    keys, rows, valid = (x.to(cuda_device) for x in _port_spill_inputs())
    mesh = make_mesh(N)
    got = exchange.hash_shuffle_spill(keys, rows, mesh, "q", cap, valid=valid, pack_impl="cuda")
    want = exchange.hash_shuffle_spill(keys, rows, mesh, "q", cap, valid=valid, pack_impl="torch")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_pinned_prefetch_delivers_the_same_tensors(cuda_device, tabs):
    chunks = list(MorselView(tabs["lineitem"], 700).chunks())
    got = list(Prefetcher(iter(chunks), depth=2, device=cuda_device))
    assert len(got) == len(chunks)
    for g, c in zip(got, chunks):
        assert g.valid.is_cuda and torch.equal(g.valid.cpu(), c.valid)
        for name in c.columns:
            assert torch.equal(g[name].cpu(), c[name])


@pytest.mark.gpu
def test_q18_spill_on_the_card_equals_the_cpu_run(cuda_device, mesh_tabs):
    pq, plan, sources, ctx = _mesh_run(mesh_tabs, "q18", 1, exchange_rows=SPILL_ROWS,
                                       spill=True)
    cpu = compile_plan_streamed(plan, sources, ctx)
    want = pq.finalize(cpu())
    card = compile_plan_streamed(plan, sources, ctx.with_(device="cuda"))
    got = pq.finalize(card())
    assert card.mux.pack_impl == "cuda"
    for k in ("spilled_rows", "drain_rounds", "morsels"):
        assert card.stats[k] == cpu.stats[k], k
    for k in want:  # integer-valued f32 sums: bit-exact on the card
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("sf,threshold", [(0.01, 300), (0.01, 250), (0.05, 250)])
def test_q18_oracle_equals_the_reference_loop(sf, threshold):
    """The port's whole-array Q18 oracle (what checks SF 30 on the card)
    gives the reference's row-loop answer, dtypes included."""
    from repro.relational import oracle as ref_oracle
    from repro_torch.relational import oracle

    ref = ref_datagen.gen_all(sf)
    t = {name: _port_table(x) for name, x in ref.items()}
    want = ref_oracle.q18_oracle(ref["lineitem"], ref["orders"], ref["customer"], threshold)
    got = oracle.q18_oracle(t["lineitem"], t["orders"], t["customer"], threshold)
    assert len(want["o_orderkey"]) > 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
