"""The port's query-serving engine against the JAX package.

The cases of ``tests/test_query_serve.py`` at its SF 0.004, on both sides
(each package generates the same seeded tables):

* randomized multi-tenant mixes: the same finish order, admitted and
  finished rounds, ``queue_rounds`` and plan and executor hits as the
  reference's engine, results equal to the reference's (integers exactly,
  f32 within rtol 1e-5) and to the port's solo ``run_query``, no slot leak,
  the starvation bound ``ceil(N / slots) + tenants``;
* a flooding tenant, arrival rounds;
* all nine templates served twice: the warm pass makes zero
  ``plan_physical`` calls and equals the cold pass bit for bit;
* the plan cache across a process restart (a subprocess that loads the
  plan without planning);
* 8 shards: ONE subprocess runs this file as a script with 8 fake XLA
  devices (the flag is never set in the pytest process) and serves the
  nine templates cold then warm through the reference's engine; the port's
  engine must give its schedule, cache counters, shared knobs, results and
  per-request traces, edge for edge.

Then the launcher (``launch.qserve.main(..., device="cpu")``: the
reference's record keys, a loadable trace, a second process with a warm
disk cache) and the entry points without a card.
"""

import json
import math
import os
import subprocess
import sys

if __name__ == "__main__":  # the reference side, on 8 fake devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

SF = 0.004
N = 8
SLOTS_8 = 3
REQUEST_FIELDS = ("tenant", "arrival_round", "admitted_round", "finished_round",
                  "queue_rounds", "plan_cache_hit", "executor_cache_hit")
EDGE_FIELDS = ("key", "rows", "row_bytes", "hist", "measured_bytes", "modeled_wire_bytes",
               "overload", "plain_overload", "salted", "traversals")


def _schedule(done) -> list:
    return [(r.query.name,) + tuple(getattr(r, f) for f in REQUEST_FIELDS) for r in done]


def _flat_result(prefix: str, r) -> dict:
    r = r if isinstance(r, dict) else {"result": r}
    return {f"{prefix}/{k}": np.asarray(v) for k, v in r.items()}


def reference_main(out_path: str) -> None:
    from repro.obs.export import query_trace_to_dict
    from repro.relational import datagen
    from repro.relational.context import ExecutionContext as Ctx
    from repro.relational.planner import tpch
    from repro.relational.planner.plan_cache import PlanCache
    from repro.serve import QueryRequest, QueryServeEngine

    tabs = datagen.gen_all(SF)
    templates = [tpch.ALL_QUERIES[q]() for q in sorted(tpch.ALL_QUERIES)]
    engine = QueryServeEngine(tabs, Ctx(num_shards=N), num_slots=SLOTS_8, cache=PlanCache(),
                              templates=templates)
    out, arrays = {}, {}
    for phase in ("cold", "warm"):
        done = engine.serve([QueryRequest("t", pq) for pq in templates])
        out[phase] = {"schedule": _schedule(done),
                      "traces": [query_trace_to_dict(r.trace) for r in done]}
        for i, r in enumerate(done):
            arrays.update(_flat_result(f"{phase}/{i}", r.result))
    t = engine.shared_tuned
    out["tuned"] = [t.impl, t.pack_impl, t.pipeline_chunks, t.transport_chunks]
    out["cache"] = engine.cache.record()
    np.savez(out_path, meta=np.asarray(json.dumps(out)), **arrays)


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

from repro.relational import datagen as ref_datagen  # noqa: E402
from repro.relational.context import ExecutionContext as RefContext  # noqa: E402
from repro.relational.planner import tpch as ref_tpch  # noqa: E402
from repro.relational.planner.plan_cache import PlanCache as RefPlanCache  # noqa: E402
from repro.serve import QueryRequest as RefRequest  # noqa: E402
from repro.serve import QueryServeEngine as RefEngine  # noqa: E402
from repro.serve import make_query_mix as ref_make_query_mix  # noqa: E402
from repro_torch.obs.export import query_trace_to_dict  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.relational import datagen  # noqa: E402
from repro_torch.relational.context import ExecutionContext, StatsMode  # noqa: E402
from repro_torch.relational.planner import tpch  # noqa: E402
from repro_torch.relational.planner.physical import plan_physical  # noqa: E402
from repro_torch.relational.planner.plan_cache import PlanCache, plan_key  # noqa: E402
from repro_torch.serve import QueryRequest, QueryServeEngine, make_query_mix  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


@pytest.fixture(scope="module")
def both():
    return ref_datagen.gen_all(SF), datagen.gen_all(SF, device="cpu")


def _tables(tabs, queries):
    return {name: tabs[name] for name in sorted({t for pq in queries for t in pq.tables})}


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
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0.0, err_msg=k)


def _serve_both(both, names, reqs_fn, num_slots, **kw):
    """The same stream through the reference's engine and the port's."""
    (ref_tabs, tabs) = both
    rt = [ref_tpch.ALL_QUERIES[n]() for n in names]
    pt = [tpch.ALL_QUERIES[n]() for n in names]
    ref_engine = RefEngine(_tables(ref_tabs, rt), REF1, num_slots=num_slots,
                           cache=RefPlanCache(), **kw)
    engine = QueryServeEngine(_tables(tabs, pt), CTX1, num_slots=num_slots, cache=PlanCache(),
                              **kw)
    want = ref_engine.serve(reqs_fn(rt, RefRequest, ref_make_query_mix))
    got = engine.serve(reqs_fn(pt, QueryRequest, make_query_mix))
    assert _schedule(got) == _schedule(want)
    for g, w in zip(got, want):
        _assert_same(g.result, w.result)
    return engine, got, ref_engine


# ---------------------------------------------------------------------------
# Randomized mixes, fairness, arrivals (tests/test_query_serve.py's cases).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_mix_equals_reference_no_leak_no_starvation(both, seed):
    tenants = ("alice", "bob", "carol")
    n_req, slots = 10, 2
    engine, done, ref_engine = _serve_both(
        both, ("q1", "q6", "q14"),
        lambda t, _R, mix: mix(t, tenants, n_req, seed=seed, max_arrival_round=3), slots)
    engine.alloc.check()
    assert engine.alloc.num_free == slots and not engine.alloc.live
    assert len(done) == n_req
    assert engine.record()["cache"] == ref_engine.record()["cache"]
    tables = engine.tables
    solo = {n: tpch.run_query(tpch.ALL_QUERIES[n](), tables, CTX1) for n in ("q1", "q6", "q14")}
    for r in done:
        _assert_same(r.result, solo[r.query.name], rtol=0.0)
    assert max(r.queue_rounds for r in done) <= math.ceil(n_req / slots) + len(tenants)
    assert sorted(engine.record()) == sorted(ref_engine.record())
    assert sorted(engine.tenant_report()) == list(tenants)


def test_flooding_tenant_cannot_starve_light_tenant(both):
    def reqs(t, R, _mix):
        return [R("heavy", t[0]) for _ in range(8)] + [R("light", t[0]) for _ in range(2)]

    engine, done, _ = _serve_both(both, ("q6",), reqs, 1)
    engine.alloc.check()
    waits = [r.queue_rounds for r in done if r.tenant == "light"]
    assert max(waits) <= 3, waits
    assert "light" in [r.tenant for r in done[:4]]


def test_admission_respects_arrival_rounds(both):
    def reqs(t, R, _mix):
        return [R("a", t[0], arrival_round=5), R("a", t[0], arrival_round=0)]

    _, done, _ = _serve_both(both, ("q1",), reqs, 2)
    late, early = sorted(done, key=lambda r: -r.arrival_round)
    assert early.admitted_round == 0
    assert late.admitted_round >= 5 and late.queue_rounds == 0


# ---------------------------------------------------------------------------
# Warm path and restart.
# ---------------------------------------------------------------------------

def test_warm_path_all_nine_queries_zero_replans(both):
    names = sorted(tpch.ALL_QUERIES)
    engine, cold, ref_engine = _serve_both(
        both, names, lambda t, R, _mix: [R("t", pq) for pq in t], 3)
    assert all(not r.plan_cache_hit for r in cold)
    before = plan_physical.calls
    warm = engine.serve([QueryRequest("t", pq) for pq in (r.query for r in cold)])
    assert plan_physical.calls == before, "warm path replanned"
    assert all(r.plan_cache_hit and r.executor_cache_hit for r in warm)
    ref_warm = ref_engine.serve([RefRequest("t", r.query) for r in ref_engine.served])
    assert _schedule(warm) == _schedule(ref_warm)
    by_name = {r.query.name: r.result for r in cold}
    for r, w in zip(warm, ref_warm):
        _assert_same(r.result, by_name[r.query.name], rtol=0.0)
        _assert_same(r.result, w.result)
    for name in ("q3", "q17"):
        pq = tpch.ALL_QUERIES[name]()
        _assert_same(by_name[name], tpch.run_query(pq, engine.tables, CTX1), rtol=0.0)
    assert engine.cache.record() == ref_engine.cache.record()


_RESTART_SCRIPT = """
import hashlib, sys
from repro_torch.relational.planner import tpch
from repro_torch.relational.planner.physical import plan_physical
from repro_torch.relational.planner.plan_cache import PlanCache, plan_key

pq = tpch.ALL_QUERIES["q17"]()
catalog = {{t: int(c) for t, c in zip({tnames!r}, {caps!r})}}
key = plan_key(pq.logical, catalog, 8)
assert key.digest == {digest!r}, "key not stable across processes"
plan = PlanCache(cache_dir={cache_dir!r}).lookup(key)
assert plan is not None, "persisted plan not found"
assert plan_physical.calls == 0, "restart path planned"
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print("EXPLAIN_SHA", hashlib.sha256(plan.explain().encode()).hexdigest())
"""


def test_plan_cache_survives_process_restart(both, tmp_path):
    import hashlib

    _, tabs = both
    pq = tpch.ALL_QUERIES["q17"]()
    catalog = {t: tabs[t].capacity for t in pq.tables}
    key = plan_key(pq.logical, catalog, 8)
    plan, hit = PlanCache(cache_dir=str(tmp_path)).get_plan(key, lambda: pq.plan(catalog, 8))
    assert not hit
    script = _RESTART_SCRIPT.format(tnames=tuple(catalog), caps=tuple(catalog.values()),
                                    digest=key.digest, cache_dir=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=180, env=env)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    assert f"EXPLAIN_SHA {hashlib.sha256(plan.explain().encode()).hexdigest()}" in proc.stdout


def test_collect_stats_engine_plans_once_per_template(both):
    _, tabs = both
    templates = [tpch.ALL_QUERIES[n]() for n in ("q3", "q17")]
    before = plan_physical.calls
    engine = QueryServeEngine(_tables(tabs, templates),
                              CTX1.with_(stats_mode=StatsMode.COLLECT), templates=templates)
    assert plan_physical.calls == before + 2 and engine.stats is not None
    engine.serve([QueryRequest("t", pq) for pq in templates * 2])
    assert plan_physical.calls == before + 2


# ---------------------------------------------------------------------------
# 8 shards: the reference's engine on 8 fake devices, in its subprocess.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "reference.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = dict(np.load(path))
    return json.loads(str(data.pop("meta"))), data


def test_eight_shards_cold_then_warm_equal_reference(both, reference):
    meta, arrays = reference
    _, tabs = both
    templates = [tpch.ALL_QUERIES[q]() for q in sorted(tpch.ALL_QUERIES)]
    tracer = Tracer()
    engine = QueryServeEngine(tabs, ExecutionContext(num_shards=N, device="cpu", trace=tracer),
                              num_slots=SLOTS_8, cache=PlanCache(), templates=templates)
    for phase in ("cold", "warm"):
        before = plan_physical.calls
        done = engine.serve([QueryRequest("t", pq) for pq in templates])
        if phase == "warm":
            assert plan_physical.calls == before
        assert [list(s) for s in _schedule(done)] == meta[phase]["schedule"]
        for i, r in enumerate(done):
            prefix = f"{phase}/{i}/"
            want = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
            _assert_same(r.result, want)
            got_t, want_t = query_trace_to_dict(r.trace), meta[phase]["traces"][i]
            assert len(got_t["edges"]) == len(want_t["edges"])
            for e, w in zip(got_t["edges"], want_t["edges"]):
                assert {f: e[f] for f in EDGE_FIELDS} == {f: w[f] for f in EDGE_FIELDS}
                assert e["predicted_s"] == pytest.approx(w["predicted_s"], rel=1e-9)
    t = engine.shared_tuned
    pack = {"torch": "xla", "cuda": "pallas"}
    assert [t.impl, pack[t.pack_impl], t.pipeline_chunks, t.transport_chunks] == meta["tuned"]
    assert engine.cache.record() == meta["cache"]
    engine.alloc.check()
    spans = [s.name for root in tracer.spans for s in root.walk()]
    assert spans.count("mux:shared") == 1
    assert sum(n.startswith("request:") for n in spans) == 2 * len(templates)
    assert sum(n.startswith("admission-round:") for n in spans) == engine.rounds
    assert sum(n.startswith("exchange:") for n in spans) == sum(
        len(qt.edges) for qt in tracer.query_traces) > 0


# ---------------------------------------------------------------------------
# The launcher and the entry points.
# ---------------------------------------------------------------------------

QSERVE_ARGS = ["--sf", "0.004", "--num-shards", "8", "--requests", "6", "--stats"]


def test_qserve_launcher_record_has_the_reference_keys(capsys, monkeypatch, tmp_path):
    from repro.launch import qserve as ref_qserve
    from repro_torch.launch import qserve

    monkeypatch.setattr(sys, "argv", ["qserve", "--sf", "0.004", "--requests", "6", "--stats"])
    ref_qserve.main()
    want = json.loads(capsys.readouterr().out)
    rec = qserve.main(QSERVE_ARGS + ["--trace-dir", str(tmp_path / "t"),
                                     "--cache-dir", str(tmp_path / "c")], device="cpu")
    got = json.loads(capsys.readouterr().out)
    assert got == json.loads(json.dumps(rec))
    assert sorted(got) == sorted([*want, "trace_path"])
    assert sorted(got["cache"]) == sorted(want["cache"])
    assert sorted(got["tenants"]) == sorted(want["tenants"])
    for tenant in got["tenants"]:
        assert sorted(got["tenants"][tenant]) == sorted(want["tenants"][tenant])
    assert got["served"] == 6 and got["plan_physical_calls"] == 5
    with open(got["trace_path"]) as f:
        trace = json.load(f)
    names = {e["name"].split(":")[0] for e in trace["traceEvents"] if e["ph"] == "B"}
    assert {"mux", "admission-round", "request", "exchange"} <= names
    # a second process on the same cache directory plans nothing
    code = ("import json\nfrom repro_torch.launch import qserve\n"
            f"qserve.main({QSERVE_ARGS + ['--cache-dir', str(tmp_path / 'c')]!r}, device='cpu')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    second = json.loads(proc.stdout)
    assert second["plan_physical_calls"] == 0 and second["cache"]["plan_disk_hits"] >= 5


def test_entry_points_need_a_device_without_cuda(both):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch import qserve

    _, tabs = both
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryServeEngine(tabs, ExecutionContext(num_shards=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryServeEngine(tabs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qserve.main(["--sf", "0.001", "--requests", "1"])


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (its atomics add in no fixed order)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_dense_group_sums_do_not_depend_on_the_order_on_the_card(cuda_device):
    """A dense group-by over one SF 1 lineitem shard slice a shard (Q1's
    shape: a few groups, ~190,000 money values each) gives the same f32
    sums every run, each the correctly rounded f64 sum within f32's
    rounding."""
    from repro_torch.relational import operators as ops

    rng = np.random.default_rng(0)
    S, T, G = 8, 750_000, 4
    gid = rng.integers(0, G, (S, T), dtype=np.int32)
    vals = rng.integers(90_000, 10_500_000, (S, T)).astype(np.float32)  # cents
    valid = rng.random((S, T)) >= 0.05
    args = [torch.from_numpy(a).to(cuda_device) for a in (gid, vals, valid)]
    runs = [ops.groupby_dense(args[0], G, {"s": (args[1], "sum"), "n": (args[1], "count")},
                              args[2]) for _ in range(5)]
    for r in runs[1:]:
        assert torch.equal(r["s"], runs[0]["s"]) and torch.equal(r["n"], runs[0]["n"])
    want = np.zeros((S, G))
    for g in range(G):
        want[:, g] = np.where(valid & (gid == g), vals.astype(np.float64), 0.0).sum(1)
    np.testing.assert_allclose(runs[0]["s"].cpu().numpy(), want, rtol=2.0**-23, atol=0.0)
    assert runs[0]["s"].dtype == torch.float32
