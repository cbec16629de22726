"""The port's telemetry spine (``repro_torch.obs``) against the JAX package.

* Host-side pieces, on both sides: the cases of ``tests/test_obs.py`` run
  against the port's ``obs``; a ``QueryTrace`` built from the same fields
  serializes to the same JSON on both sides, and the Chrome trace events of
  the same spans have the same names, categories and order.
* The exchange-report keys and ``collect`` (the cases of
  ``tests/test_exchange_report.py``), and a traced one-shard run equal to
  the reference's, in process.
* 8 shards and 2 x 4: ONE subprocess runs this file as a script with 8
  fake XLA devices (the flag is never set in the pytest process): the
  reference's in-memory Q3, Q17 and Q18 on both meshes, a salted Q17 on
  Zipf-skewed part keys, and Q17 streamed in morsels of 4,096 rows (two
  passes, ``@p`` keys).  The port's traces must equal them edge for edge:
  keys, histograms, measured and modeled bytes, overloads, the salting
  decision and traversals exactly, ``predicted_s`` within 1e-9 relative,
  ``measured_s`` present; each template's ``model_report`` (printed) has
  the reference's byte-model error ratios.
* The model-check CLI and the entry points without a card.
"""

import json
import os
import subprocess
import sys

if __name__ == "__main__":  # the reference side, on 8 fake devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

SF = 0.01
N = 8
MORSEL = 4096
# (case, query, pods, kind): "mem" in-memory, "salted" a salted plan on
# Zipf(1.2) part keys (Q17 with the heaviest key's brand and container),
# "stream" lineitem streamed in morsels of MORSEL rows
MESH_CASES = [
    ("q3", "q3", 1, "mem"),
    ("q17", "q17", 1, "mem"),
    ("q18", "q18", 1, "mem"),
    ("q3_pods", "q3", 2, "mem"),
    ("q17_pods", "q17", 2, "mem"),
    ("q18_pods", "q18", 2, "mem"),
    ("q17_salted", "q17", 1, "salted"),
    ("q17_stream", "q17", 1, "stream"),
]
STREAM_COUNTERS = ("passes", "morsels", "spilled_rows", "drain_rounds")
EDGE_FIELDS = ("key", "rows", "row_bytes", "hist", "measured_bytes", "modeled_wire_bytes",
               "overload", "plain_overload", "salted", "traversals")


def _query(mod, q, kind):
    return mod.q17(brand=11, container=25) if kind == "salted" else mod.ALL_QUERIES[q]()


def reference_main(out_path: str) -> None:
    from repro.obs.export import query_trace_to_dict
    from repro.obs.model_check import model_report
    from repro.relational import datagen
    from repro.relational import stats as rstats
    from repro.relational.context import ExecutionContext as Ctx
    from repro.relational.planner import executor, tpch
    from repro.relational.planner.stream import compile_plan_streamed
    from repro.relational.source import MorselView, as_source

    tabs = {"plain": datagen.gen_all(SF), "zipf": datagen.gen_all(SF, zipf_partkey=1.2)}
    traces, arrays = {}, {}
    for case, q, pods, kind in MESH_CASES:
        t = tabs["zipf" if kind == "salted" else "plain"]
        pq = _query(tpch, q, kind)
        tables = {name: t[name] for name in pq.tables}
        catalog = {name: tables[name].capacity for name in pq.tables}
        stats = rstats.collect_stats(tables) if kind == "salted" else None
        ctx = Ctx(num_shards=N, num_pods=pods)
        if kind == "stream":
            sources = {name: as_source(tables[name]) for name in pq.tables}
            sources["lineitem"] = MorselView(tables["lineitem"], MORSEL)
            catalog = {name: sources[name].capacity for name in pq.tables}
            plan = pq.plan(catalog, N, num_pods=pods, morsel_rows=MORSEL)
            run = compile_plan_streamed(plan, sources, ctx)
            raw = run()
            qt = run.last_trace
        else:
            plan = pq.plan(catalog, N, num_pods=pods, stats=stats)
            run = executor.compile_plan(plan, tables, ctx)
            raw, qt = run.collect(run.dispatch())
        got = pq.finalize(raw) if pq.finalize else raw
        got = got if isinstance(got, dict) else {"result": got}
        for k, v in got.items():
            arrays[f"{case}/{k}"] = np.asarray(v)
        traces[case] = {"trace": query_trace_to_dict(qt), "report": model_report(qt)}
    np.savez(out_path, traces=np.asarray(json.dumps(traces)), **arrays)


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)

import threading  # noqa: E402
import warnings  # noqa: E402

import torch  # noqa: E402

from repro.obs import export as ref_export  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.relational import datagen as ref_datagen  # noqa: E402
from repro.relational.context import ExecutionContext as RefContext  # noqa: E402
from repro.relational.planner import tpch as ref_tpch  # noqa: E402
from repro.relational.planner.executor import compile_plan as ref_compile_plan  # noqa: E402
from repro_torch.obs.export import (  # noqa: E402
    chrome_trace_events,
    merge_trace_dir,
    query_trace_from_json,
    query_trace_to_dict,
    query_trace_to_json,
    tracer_to_dict,
    write_trace_dir,
)
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.obs.model_check import (  # noqa: E402
    BYTE_MODEL_BOUND,
    assert_bytes_within,
    model_report,
)
from repro_torch.obs.trace import (  # noqa: E402
    ExchangeEdge,
    QueryTrace,
    Tracer,
    deposit,
    maybe_span,
    model_error,
)
from repro_torch.relational import datagen  # noqa: E402
from repro_torch.relational import stats as rstats  # noqa: E402
from repro_torch.relational.context import ExecutionContext  # noqa: E402
from repro_torch.relational.planner import tpch  # noqa: E402
from repro_torch.relational.planner.executor import _report_keys, compile_plan  # noqa: E402
from repro_torch.relational.planner.stream import compile_plan_streamed  # noqa: E402
from repro_torch.relational.source import MorselView, as_source  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every tensor here is small: one intra-op thread, so that in a
    parallel test run many small ops do not wait on oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edge_kw(key="shuffle[k]#0", measured=900, modeled=1000, **kw) -> dict:
    defaults = dict(
        key=key, rows=100, row_bytes=12, hist=(25, 25, 25, 25),
        measured_bytes=measured, modeled_wire_bytes=modeled,
        overload=1.2, plain_overload=1.2, salted=False,
        predicted_s=1e-4, measured_s=2e-4,
    )
    defaults.update(kw)
    return defaults


def _edge(key="shuffle[k]#0", measured=900, modeled=1000, **kw) -> ExchangeEdge:
    return ExchangeEdge(**_edge_kw(key, measured, modeled, **kw))


def _qt_kw(*edges, query="q17") -> dict:
    return dict(query=query, num_shards=4, num_pods=1, edges=tuple(edges),
                counters={"morsels": 4.0, "passes": 2.0}, measured_s=0.5)


def _qt(*edges, query="q17") -> QueryTrace:
    return QueryTrace(**_qt_kw(*edges, query=query))


# ---------------------------------------------------------------------------
# model_error and the byte-model gate (tests/test_obs.py's cases).
# ---------------------------------------------------------------------------

def test_model_error_symmetric_and_lower_bounded():
    assert model_error(2.0, 1.0) == model_error(1.0, 2.0) == 2.0
    assert model_error(3.0, 3.0) == 1.0
    assert model_error(None, 1.0) is None
    assert model_error(1.0, 0.0) is None  # zero-byte edges are vacuous


def test_assert_bytes_within():
    assert_bytes_within(_qt(_edge(measured=900, modeled=1000)))
    with pytest.raises(AssertionError, match="exceeds the 2.0x"):
        assert_bytes_within(_qt(_edge(measured=100, modeled=1000)))
    assert_bytes_within(_qt(_edge(measured=100, modeled=1000)), bound=10.0)
    assert_bytes_within(_qt(_edge(measured=0, modeled=1000)))
    assert BYTE_MODEL_BOUND == 2.0


def test_model_report_worst_edge():
    rep = model_report(_qt(
        _edge(key="a", measured=1000, modeled=1000),
        _edge(key="b", measured=500, modeled=900),
    ))
    assert rep["query"] == "q17"
    assert rep["edges"]["a"]["byte_model_err"] == 1.0
    assert rep["worst_byte_model_err"] == pytest.approx(1.8)


# ---------------------------------------------------------------------------
# Spans, metrics, deposit.
# ---------------------------------------------------------------------------

def test_spans_nest_and_close():
    tr = Tracer(pid=0)
    with tr.span("plan:q17", cat="plan"):
        with tr.span("compile:q17", cat="compile", streamed=True):
            pass
        with tr.span("execute:q17", cat="execute"):
            tr.add_span("exchange:e0", cat="exchange", measured_bytes=42)
    assert len(tr.spans) == 1
    root = tr.spans[0]
    assert [s.name for s in root.walk()] == [
        "plan:q17", "compile:q17", "execute:q17", "exchange:e0"
    ]
    assert all(s.dur is not None for s in root.walk())
    assert root.children[0].args == {"streamed": True}


def test_maybe_span_is_noop_without_tracer():
    with maybe_span(None, "anything") as s:
        assert s is None


def test_spans_from_threads_do_not_interleave():
    tr = Tracer(pid=0)
    barrier = threading.Barrier(2)

    def work(i):
        barrier.wait(timeout=30)
        with tr.span(f"root:{i}"):
            with tr.span(f"child:{i}"):
                pass

    ts = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(s.name for s in tr.spans) == ["root:0", "root:1"]
    for root in tr.spans:
        i = root.name.split(":")[1]
        assert [c.name for c in root.children] == [f"child:{i}"]


def test_counters_gauges_histograms():
    tr = Tracer(pid=0)
    tr.counter("runs")
    tr.counter("runs", 2.0)
    tr.gauge("depth", 3.0)
    tr.observe("wait_s", 0.1)
    tr.observe("wait_s", 0.3)
    assert tr.counters["runs"] == 3.0
    assert tr.gauges["depth"] == 3.0
    assert tr.histograms["wait_s"] == [0.1, 0.3]


def test_tracer_pid_is_zero_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert Tracer().pid == 0
    assert Tracer(pid=3).pid == 3


def test_deposit_lays_out_edges_and_counters():
    tr = Tracer(pid=0)
    qt = _qt(_edge(key="a"), _edge(key="b"))
    deposit(tr, qt)
    assert tr.query_traces == [qt]
    assert [s.name for s in tr.spans] == ["exchange:a", "exchange:b"]
    assert sum(s.dur for s in tr.spans) == pytest.approx(0.5)
    assert tr.counters["exchange.measured_bytes"] == 1800.0
    assert tr.counters["query.q17.runs"] == 1.0
    assert tr.counters["query.q17.morsels"] == 4.0
    deposit(None, qt)  # no-op without a tracer


# ---------------------------------------------------------------------------
# JSON and Chrome trace events, against the reference's.
# ---------------------------------------------------------------------------

def test_query_trace_json_roundtrip():
    qt = _qt(_edge(key="a"), _edge(key="b", salted=True, traversals=4))
    assert query_trace_from_json(query_trace_to_json(qt)) == qt


def test_query_trace_roundtrip_defaults_traversals():
    d = json.loads(query_trace_to_json(_qt(_edge())))
    for e in d["edges"]:
        del e["traversals"]
    assert query_trace_from_json(json.dumps(d)).edges[0].traversals == 1


@pytest.mark.parametrize("salted,traversals", [(False, 1), (True, 4)])
def test_query_trace_json_equals_reference(salted, traversals):
    edges = [_edge_kw(key="a"), _edge_kw(key="b", salted=salted, traversals=traversals,
                                         hist=(3, 0, 7, 1), measured_s=None)]
    mine = QueryTrace(**_qt_kw(*[ExchangeEdge(**e) for e in edges]))
    theirs = ref_trace.QueryTrace(**_qt_kw(*[ref_trace.ExchangeEdge(**e) for e in edges]))
    assert query_trace_to_json(mine) == ref_export.query_trace_to_json(theirs)
    # each side loads the other's JSON
    assert query_trace_from_json(ref_export.query_trace_to_json(theirs)) == mine
    assert mine.model_errors() == theirs.model_errors()


def _fill(tr, trace_mod):
    """The same spans on either side's tracer, with fixed times."""
    with tr.span("plan:q17", cat="plan"):
        tr.add_span("compile:q17", cat="compile", t0=10.0, dur=0.5, streamed=False)
        tr.add_span("mux:q17", cat="compile", t0=10.5, dur=0.0, impl="round_robin")
    for i in range(2):
        tr.add_span(f"admission-round:{i}", cat="serve", t0=20.0 + i, dur=0.25, admitted=2)
    edges = [trace_mod.ExchangeEdge(**_edge_kw(key=k)) for k in ("a", "b")]
    trace_mod.deposit(tr, trace_mod.QueryTrace(**_qt_kw(*edges)))
    tr.counter("runs", 2.0)


def test_chrome_events_equal_reference():
    mine, theirs = Tracer(pid=0), ref_trace.Tracer(pid=0)
    _fill(mine, port_trace)
    _fill(theirs, ref_trace)
    got = chrome_trace_events(mine, process_name="p")
    want = ref_export.chrome_trace_events(theirs, process_name="p")
    assert [(e["name"], e.get("cat"), e["ph"]) for e in got] == \
        [(e["name"], e.get("cat"), e["ph"]) for e in want]
    assert [sorted(e.get("args", {})) for e in got] == [sorted(e.get("args", {})) for e in want]
    d_got = tracer_to_dict(mine, process_name="p")
    d_want = ref_export.tracer_to_dict(theirs, process_name="p")
    assert sorted(d_got) == sorted(d_want)
    assert d_got["counters"] == d_want["counters"]
    assert d_got["queryTraces"] == d_want["queryTraces"]


def _traced_tracer() -> Tracer:
    tr = Tracer(pid=0)
    with tr.span("plan:q17", cat="plan"):
        with tr.span("compile:q17", cat="compile"):
            pass
    deposit(tr, _qt(_edge(key="a"), _edge(key="b")))
    return tr


def test_chrome_events_sorted_and_matched():
    events = chrome_trace_events(_traced_tracer())
    meta = [e for e in events if e["ph"] == "M"]
    dur = [e for e in events if e["ph"] in ("B", "E")]
    assert meta and meta[0]["name"] == "process_name"
    ts = [e["ts"] for e in dur]
    assert ts == sorted(ts)
    depth: dict = {}
    for e in dur:
        k = (e["name"], e["pid"], e["tid"])
        depth[k] = depth.get(k, 0) + (1 if e["ph"] == "B" else -1)
        assert depth[k] >= 0, f"E before B for {k}"
    assert all(v == 0 for v in depth.values()), depth


def test_tracer_to_dict_is_perfetto_loadable_json():
    d = tracer_to_dict(_traced_tracer(), process_name="proc 0")
    loaded = json.loads(json.dumps(d))
    assert loaded["traceEvents"][0]["args"]["name"] == "proc 0"
    assert loaded["displayTimeUnit"] == "ms"
    assert loaded["queryTraces"][0]["query"] == "q17"


def test_write_and_merge_trace_dir(tmp_path):
    d = str(tmp_path)
    for pid in (0, 1):
        tr = Tracer(pid=pid)
        with tr.span(f"work:p{pid}"):
            pass
        tr.counter("runs", 1.0)
        path = write_trace_dir(tr, d, basename="t")
        assert path.endswith(f"t-p{pid}.json")
    merged = merge_trace_dir(d, basename="t", out=f"{d}/merged.json")
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    assert merged["counters"]["runs"] == 2.0
    assert [e["ph"] for e in merged["traceEvents"]][:2] == ["M", "M"]
    with open(f"{d}/merged.json") as f:
        assert json.load(f) == merged
    with pytest.raises(FileNotFoundError):
        merge_trace_dir(d, basename="nope")
    # the reference merges the port's files into the same timeline
    assert ref_export.merge_trace_dir(d, basename="t") == merged


# ---------------------------------------------------------------------------
# Report keys and collect (tests/test_exchange_report.py's cases).
# ---------------------------------------------------------------------------

CATALOG_Q17 = {"lineitem": 480_000, "part": 2_000}


def _skewed_stats():
    """A synthetic l_partkey profile hot enough to flip Q17 to salted."""
    cs = rstats.ColumnStats(name="l_partkey", ndv=2_000,
                            heavy_hitters=((0, 0.25), (1, 0.05)), max_share=0.25)
    prof = rstats.TableProfile(table="lineitem", rows=480_000, sample_rows=1_024,
                               columns={"l_partkey": cs},
                               sample={"l_partkey": np.zeros(4, np.int64)})
    return {"lineitem": prof}


def test_keys_are_key_column_plus_ordinal():
    pq = tpch.q3()
    cat = tpch.tpch_catalog(0.08)
    keys = list(_report_keys(pq.plan({t: cat[t] for t in pq.tables}, 8).root).values())
    assert keys == ["shuffle[o_orderkey]#0", "shuffle[l_orderkey]#1"]


def test_keys_stable_across_replans_salting_and_pickle():
    import pickle

    pq = tpch.q17()
    static = pq.plan(CATALOG_Q17, 8)
    salted = pq.plan(CATALOG_Q17, 8, stats=_skewed_stats())
    assert "salted x" in salted.explain() and "salted x" not in static.explain()
    clone = pickle.loads(pickle.dumps(static))
    for plan in (pq.plan(CATALOG_Q17, 8), salted, clone):
        assert list(_report_keys(plan.root).values()) == ["shuffle[l_partkey]#0"]


@pytest.fixture(scope="module")
def small():
    """SF 0.004 (the reference tests' size), generated by both packages."""
    return ref_datagen.gen_all(0.004), datagen.gen_all(0.004, device="cpu")


def test_single_device_report_is_empty(small):
    _, tabs = small
    pq = tpch.q6()
    plan = pq.plan({t: tabs[t].capacity for t in pq.tables}, 1)
    run = compile_plan(plan, tabs, ExecutionContext(device="cpu"))
    with pytest.warns(DeprecationWarning, match="collect"):
        assert run.exchange_report == {}
    _result, qt = run.collect(run.dispatch())
    assert qt.exchange_report() == {} and qt.edges == ()


def test_collect_is_pure_and_per_run(small):
    _, tabs = small
    pq = tpch.q6()
    plan = pq.plan({t: tabs[t].capacity for t in pq.tables}, 1)
    run = compile_plan(plan, tabs, ExecutionContext(device="cpu"))
    out_a, out_b = run.dispatch(), run.dispatch()
    _res_a, qt_a = run.collect(out_a)
    _res_b, qt_b = run.collect(out_b)
    assert qt_a is not qt_b
    assert qt_a.query == qt_b.query == plan.name
    assert run.last_trace is None  # collect never wrote runner state
    run()
    assert run.last_trace is not None and run.last_trace.measured_s > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert run.exchange_report == {}


@pytest.mark.parametrize("q", ["q6", "q3", "q17", "q18"])
def test_one_shard_collect_equals_reference(small, q):
    """One shard, in process: ``collect`` gives the reference's result and
    trace (no shuffle edge: on one shard an exchange is the identity)."""
    ref_tabs, tabs = small
    rpq, pq = ref_tpch.ALL_QUERIES[q](), tpch.ALL_QUERIES[q]()
    catalog = {t: tabs[t].capacity for t in pq.tables}
    rrun = ref_compile_plan(rpq.plan(catalog, 1), ref_tabs, RefContext())
    run = compile_plan(pq.plan(catalog, 1), tabs, ExecutionContext(device="cpu"))
    want_raw, want_qt = rrun.collect(rrun.dispatch())
    got_raw, got_qt = run.collect(run.dispatch(), t_dispatch=0.0)
    _assert_same(pq.finalize(got_raw) if pq.finalize else got_raw,
                 rpq.finalize(want_raw) if rpq.finalize else want_raw)
    got_d, want_d = query_trace_to_dict(got_qt), ref_export.query_trace_to_dict(want_qt)
    assert got_d.pop("measured_s") is not None and want_d.pop("measured_s") is None
    assert got_d == want_d


def test_traced_run_query_records_the_span_families(small):
    _, tabs = small
    tr = Tracer()
    ctx = ExecutionContext(num_shards=8, device="cpu", trace=tr)
    assert ctx == ExecutionContext(num_shards=8, device="cpu")
    assert hash(ctx) == hash(ExecutionContext(num_shards=8, device="cpu"))
    got = tpch.run_query(tpch.q3(), tabs, ctx)
    want = tpch.run_query(tpch.q3(), tabs, ctx.with_(trace=None))
    _assert_same(got, want, rtol=0.0)
    fams = {s.name.split(":")[0] for root in tr.spans for s in root.walk()}
    assert fams == {"plan", "compile", "mux", "execute", "exchange"}
    (qt,) = tr.query_traces
    # in key order, as the reference fetches its reports
    assert [e.key for e in qt.edges] == ["shuffle[l_orderkey]#1", "shuffle[o_orderkey]#0"]
    tr2 = Tracer()
    tpch.run_query(tpch.q17(), tabs, ctx.with_(trace=tr2, morsel_rows=4096))
    fams = {s.name.split(":")[0] for root in tr2.spans for s in root.walk()}
    assert {"pass", "morsel", "exchange", "execute"} <= fams
    assert tr2.query_traces[-1].counters["passes"] == 2.0


# ---------------------------------------------------------------------------
# 8 shards and 2 x 4: the reference on 8 fake devices, in its subprocess.
# ---------------------------------------------------------------------------

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
    data = dict(np.load(path))
    return json.loads(str(data.pop("traces"))), data


@pytest.fixture(scope="module")
def mesh_tabs():
    return {"plain": datagen.gen_all(SF, device="cpu"),
            "zipf": datagen.gen_all(SF, zipf_partkey=1.2, device="cpu")}


def _as_dict(r) -> dict:
    return r if isinstance(r, dict) else {"result": r}


def _assert_same(got, want, rtol=1e-5):
    got, want = _as_dict(got), _as_dict(want)
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)


def _port_run(mesh_tabs, q, pods, kind):
    t = mesh_tabs["zipf" if kind == "salted" else "plain"]
    pq = _query(tpch, q, kind)
    tables = {name: t[name] for name in pq.tables}
    catalog = {name: tables[name].capacity for name in pq.tables}
    ctx = ExecutionContext(num_shards=N, num_pods=pods, device="cpu")
    if kind == "stream":
        sources = {name: as_source(tables[name]) for name in pq.tables}
        sources["lineitem"] = MorselView(tables["lineitem"], MORSEL)
        catalog = {name: sources[name].capacity for name in pq.tables}
        run = compile_plan_streamed(pq.plan(catalog, N, num_pods=pods, morsel_rows=MORSEL),
                                    sources, ctx)
        raw = run()
        qt = run.last_trace
    else:
        stats = rstats.collect_stats(tables) if kind == "salted" else None
        run = compile_plan(pq.plan(catalog, N, num_pods=pods, stats=stats), tables, ctx)
        raw, qt = run.collect(run.dispatch(), t_dispatch=0.0)
    return (pq.finalize(raw) if pq.finalize else raw), qt


@pytest.mark.parametrize("case,q,pods,kind", MESH_CASES)
def test_mesh_trace_equals_reference(reference, mesh_tabs, case, q, pods, kind):
    traces, arrays = reference
    got, qt = _port_run(mesh_tabs, q, pods, kind)
    want = {k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith(f"{case}/")}
    _assert_same(_as_dict(got), want)
    ref_qt = traces[case]["trace"]
    assert len(qt.edges) == len(ref_qt["edges"]) > 0
    for e, w in zip(qt.edges, ref_qt["edges"]):
        for f in EDGE_FIELDS:
            g = getattr(e, f)
            assert (list(g) if f == "hist" else g) == w[f], (case, e.key, f)
        assert e.predicted_s == pytest.approx(w["predicted_s"], rel=1e-9, abs=0.0)
        assert e.measured_s is not None
    assert (qt.query, qt.num_shards, qt.num_pods) == (
        ref_qt["query"], ref_qt["num_shards"], ref_qt["num_pods"])
    if kind == "salted":
        assert qt.edges[0].salted and qt.edges[0].overload < qt.edges[0].plain_overload
    if kind == "stream":
        assert [e.key for e in qt.edges] == [
            "shuffle[l_partkey]#0@p1", "shuffle[l_partkey]#0@p2"]
        for k in STREAM_COUNTERS:
            assert qt.counters[k] == ref_qt["counters"][k], k
    rep, ref_rep = model_report(qt), traces[case]["report"]
    print(case, json.dumps({k: v["byte_model_err"] for k, v in rep["edges"].items()}),
          "worst", rep["worst_byte_model_err"])
    assert rep["worst_byte_model_err"] == ref_rep["worst_byte_model_err"]
    for key, edge in rep["edges"].items():
        assert edge["byte_model_err"] == ref_rep["edges"][key]["byte_model_err"], key


# ---------------------------------------------------------------------------
# The CLI and the entry points.
# ---------------------------------------------------------------------------

def test_model_check_cli_on_the_cpu(capsys, tmp_path):
    from repro_torch.obs import model_check

    assert model_check.main(["--query", "q17", "--sf", "0.01", "--shards", "8",
                             "--streamed", "--trace-dir", str(tmp_path)], device="cpu") == 0
    rep = json.loads(capsys.readouterr().out)
    assert {"pass", "morsel", "exchange", "plan", "compile", "execute"} <= set(rep["span_names"])
    assert rep["worst_byte_model_err"] is not None and rep["result"] > 0
    with open(rep["trace_path"]) as f:
        assert json.load(f)["queryTraces"][0]["query"] == "q17"


def test_entry_points_need_a_device_without_cuda(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.obs import model_check

    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_check.main(["--query", "q6", "--sf", "0.001", "--shards", "1"])


def test_module_cli_runs_without_jax():
    """``python -m repro_torch.obs.model_check`` imports no JAX (run on the
    CPU through ``main``'s device argument)."""
    code = (
        "import sys\n"
        "from repro_torch.obs import model_check\n"
        "model_check.main(['--query', 'q3', '--sf', '0.002', '--shards', '8', '--bound', '0'],"
        " device='cpu')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["query"] == "q3"
