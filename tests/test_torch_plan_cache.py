"""The port's plan cache and shared tuner against the JAX package.

* Key material: for the nine TPC-H templates on 1, 8 and 2 x 4 shards, with
  static stats and with ``collect_stats`` of the same seeded SF 0.004 tables
  on both sides, the port's ``canonical_render``, ``stats_bucket`` and
  ``plan_key`` material and digest equal the reference's byte for byte.
* ``tune_shared_config`` over the nine plans' ``shuffle_stats`` equals the
  reference's on 8 and 2 x 4 (pack names ``cuda``/``torch`` for
  ``pallas``/``xla``).
* The cases of ``tests/test_plan_cache.py`` and ``tests/test_cache_evict.py``
  against the port's cache (the cross-process eviction case included).
* The port keeps apart from the reference's cache: it never counts, evicts
  or unpickles a reference entry in a shared directory — a subprocess
  checks that its lookup leaves JAX unimported, even where a reference
  entry sits under the port's own file name.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import autotune as ref_autotune
from repro.relational import datagen as ref_datagen
from repro.relational import stats as ref_stats
from repro.relational.planner import plan_cache as ref_pc
from repro.relational.planner import tpch as ref_tpch
from repro_torch.core import autotune
from repro_torch.relational import datagen
from repro_torch.relational import stats as S
from repro_torch.relational.planner import logical as L
from repro_torch.relational.planner import tpch
from repro_torch.relational.planner.physical import PlannerConfig, plan_physical
from repro_torch.relational.planner.plan_cache import (
    PlanCache,
    canonical_render,
    plan_key,
    stats_bucket,
)
from repro_torch.relational.planner.tpch import ALL_QUERIES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = sorted(ALL_QUERIES)
MESHES = [(1, 1), (8, 1), (8, 2)]
CATALOG = {"t": 4096, "u": 512}
PACK = {"torch": "xla", "cuda": "pallas"}


# ---------------------------------------------------------------------------
# Key material and the shared tuner, against the reference.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def profiles():
    """collect_stats of the same seeded SF 0.004 tables, on both sides."""
    return (ref_stats.collect_stats(ref_datagen.gen_all(0.004)),
            S.collect_stats(datagen.gen_all(0.004, device="cpu")))


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("q", QUERIES)
def test_key_material_equals_reference(q, mesh, with_stats, profiles):
    pq, rpq = ALL_QUERIES[q](), ref_tpch.ALL_QUERIES[q]()
    cat = tpch.tpch_catalog(0.004)
    catalog = {t: cat[t] for t in pq.tables}
    stats = ref = None
    if with_stats:
        stats = {t: profiles[1][t] for t in pq.tables}
        ref = {t: profiles[0][t] for t in pq.tables}
    assert canonical_render(pq.logical) == ref_pc.canonical_render(rpq.logical)
    assert stats_bucket(stats) == ref_pc.stats_bucket(ref)
    got = plan_key(pq.logical, catalog, mesh[0], num_pods=mesh[1], stats=stats)
    want = ref_pc.plan_key(rpq.logical, catalog, mesh[0], num_pods=mesh[1], stats=ref)
    assert got.material == want.material
    assert got.digest == want.digest
    for morsel in (None, 4096):  # every planner argument is in the material
        assert plan_key(pq.logical, catalog, 8, morsel_rows=morsel).material == \
            ref_pc.plan_key(rpq.logical, catalog, 8, morsel_rows=morsel).material


@pytest.mark.parametrize("pods", [1, 2])
def test_tune_shared_config_equals_reference(pods):
    cat = tpch.tpch_catalog(1)
    groups, ref_groups = [], []
    for q in QUERIES:
        pq, rpq = ALL_QUERIES[q](), ref_tpch.ALL_QUERIES[q]()
        catalog = {t: cat[t] for t in pq.tables}
        groups.append(pq.plan(catalog, 8, num_pods=pods).shuffle_stats)
        ref_groups.append(rpq.plan(catalog, 8, num_pods=pods).shuffle_stats)
    assert [[(s.rows, s.row_bytes) for s in g] for g in groups] == \
        [[(s.rows, s.row_bytes) for s in g] for g in ref_groups]
    assert sum(len(g) for g in groups) > 0
    for weights in (None, [float(i + 1) for i in range(len(groups))]):
        got = autotune.tune_shared_config(8 // pods, groups, num_pods=pods, weights=weights)
        want = ref_autotune.tune_shared_config(8 // pods, ref_groups, num_pods=pods,
                                               weights=weights)
        assert (got.impl, PACK[got.pack_impl], got.pipeline_chunks, got.transport_chunks) == (
            want.impl, want.pack_impl, want.pipeline_chunks, want.transport_chunks)
        assert got.modeled_s == want.modeled_s
        assert [(i, PACK[p], c, t, s) for i, p, c, t, s in got.candidates] == \
            list(want.candidates)
    # degenerate inputs collapse to tune_config's default
    assert autotune.tune_shared_config(1, groups) == autotune.tune_config(1, ())
    with pytest.raises(ValueError, match="weights"):
        autotune.tune_shared_config(8, groups[:2], weights=[1.0])


# ---------------------------------------------------------------------------
# The key layer (tests/test_plan_cache.py's cases).
# ---------------------------------------------------------------------------

@st.composite
def plans(draw):
    cols = draw(st.sampled_from([("a", "b"), ("a", "c"), ("a", "b", "c")]))
    node = L.Scan("t", cols)
    thresh = draw(st.none() | st.integers(0, 100))
    if thresh is not None:
        node = L.Filter(node, L.col("a") < L.lit(thresh))
    join = draw(st.booleans())
    payload = None
    if join:
        payload = draw(st.sampled_from([("v",), ()]))
        node = L.HashJoin(build=L.Scan("u", ("k", "v")), probe=node,
                          build_key="k", probe_key="a", payload=payload)
    terminal = draw(st.sampled_from(["agg", "topk", "none"]))
    k = None
    if terminal == "agg":
        node = L.Aggregate(node, (("s", L.col("a"), "sum"),))
    elif terminal == "topk":
        k = draw(st.integers(1, 8))
        node = L.TopK(node, key="a", k=k, payload=("a",))
    return (cols, thresh, join, payload, terminal, k), node


@given(plans(), plans())
@settings(max_examples=80, deadline=None)
def test_render_is_injective_over_the_grammar(p1, p2):
    (params1, n1), (params2, n2) = p1, p2
    assert (params1 == params2) == (canonical_render(n1) == canonical_render(n2))
    if params1 != params2:
        assert plan_key(n1, CATALOG, 8).digest != plan_key(n2, CATALOG, 8).digest


@given(plans())
@settings(max_examples=40, deadline=None)
def test_key_stable_across_reconstruction(p):
    _params, node = p
    assert canonical_render(node) == canonical_render(node)
    k1 = plan_key(node, CATALOG, 8)
    k2 = plan_key(node, dict(reversed(list(CATALOG.items()))), 8)
    assert k1.digest == k2.digest


def test_shared_vs_duplicated_subtree_render_identically():
    shared = L.Scan("t", ("a", "b"))
    j_shared = L.HashJoin(build=shared, probe=shared, build_key="a", probe_key="a", payload=())
    j_dup = L.HashJoin(build=L.Scan("t", ("a", "b")), probe=L.Scan("t", ("a", "b")),
                       build_key="a", probe_key="a", payload=())
    assert canonical_render(j_shared) == canonical_render(j_dup)
    assert plan_key(j_shared, CATALOG, 8).digest == plan_key(j_dup, CATALOG, 8).digest


@given(st.sampled_from([(1, 1), (4, 1), (8, 1), (8, 2), (16, 4)]),
       st.sampled_from([(1, 1), (4, 1), (8, 1), (8, 2), (16, 4)]))
@settings(max_examples=25, deadline=None)
def test_distinct_mesh_shapes_never_collide(m1, m2):
    node = ALL_QUERIES["q6"]().logical
    k1 = plan_key(node, {"lineitem": 8192}, m1[0], num_pods=m1[1])
    k2 = plan_key(node, {"lineitem": 8192}, m2[0], num_pods=m2[1])
    assert (m1 == m2) == (k1.digest == k2.digest)


@given(st.integers(1, 10**7), st.integers(1, 10**7))
@settings(max_examples=40, deadline=None)
def test_distinct_catalogs_never_collide(cap1, cap2):
    node = ALL_QUERIES["q6"]().logical
    k1 = plan_key(node, {"lineitem": cap1}, 8)
    k2 = plan_key(node, {"lineitem": cap2}, 8)
    assert (cap1 == cap2) == (k1.digest == k2.digest)


def _profile(rows: int, heavy: tuple = (), ndv: int = 100) -> dict:
    cs = S.ColumnStats(name="a", ndv=ndv, heavy_hitters=heavy,
                       max_share=heavy[0][1] if heavy else 0.001)
    prof = S.TableProfile(table="t", rows=rows, sample_rows=min(rows, 1024),
                          columns={"a": cs}, sample={"a": np.zeros(4, np.int64)})
    return {"t": prof}


@given(st.integers(1, 10**6), st.integers(1, 10**6))
@settings(max_examples=40, deadline=None)
def test_stats_bucket_rows_quantize_to_powers_of_two(r1, r2):
    b1, b2 = stats_bucket(_profile(r1)), stats_bucket(_profile(r2))
    assert (b1 == b2) == (r1.bit_length() == r2.bit_length())


def test_stats_bucket_static_vs_profiled_and_noise_floor():
    assert stats_bucket(None) == "static"
    assert stats_bucket(None) != stats_bucket(_profile(1000))
    assert stats_bucket(_profile(1000, heavy=((7, 0.001),))) == stats_bucket(_profile(1000))
    assert stats_bucket(_profile(1000, heavy=((7, 0.3),))) != stats_bucket(_profile(1000))
    assert stats_bucket(_profile(1000, heavy=((7, 0.30),))) == \
        stats_bucket(_profile(1000, heavy=((7, 0.33),)))


def test_stats_bucket_shift_invalidates_entry():
    """When the stats bucket shifts, the second lookup replans (the
    ``plan_physical.calls`` counter)."""
    node = ALL_QUERIES["q6"]().logical
    cat = {"lineitem": 8192}
    cache = PlanCache()
    cfg = PlannerConfig(num_units=8, hybrid=True)

    def planner():
        return plan_physical(node, cat, 8, cfg=cfg, name="q6")

    uniform = {"lineitem": _profile(8192)["t"]}
    skewed = {"lineitem": _profile(8192, heavy=((7, 0.4),))["t"]}
    k_uni = plan_key(node, cat, 8, cfg=cfg, stats=uniform)
    k_skew = plan_key(node, cat, 8, cfg=cfg, stats=skewed)
    assert k_uni.digest != k_skew.digest
    before = plan_physical.calls
    _, hit = cache.get_plan(k_uni, planner)
    assert not hit and plan_physical.calls == before + 1
    _, hit = cache.get_plan(k_uni, planner)
    assert hit and plan_physical.calls == before + 1  # warm: no replan
    _, hit = cache.get_plan(k_skew, planner)  # bucket shifted -> replan
    assert not hit and plan_physical.calls == before + 2


def test_material_mismatch_reads_as_miss(tmp_path):
    node = ALL_QUERIES["q6"]().logical
    cat = {"lineitem": 8192}
    key = plan_key(node, cat, 8)
    cache = PlanCache(cache_dir=str(tmp_path))
    cache.get_plan(key, lambda: plan_physical(node, cat, 8, name="q6"))
    fresh = PlanCache(cache_dir=str(tmp_path))
    forged = dataclasses.replace(key, material=key.material + "?")
    assert fresh.lookup(forged) is None
    (entry,) = tmp_path.glob("torchplan-*.pkl")
    entry.write_bytes(b"not a pickle")
    assert PlanCache(cache_dir=str(tmp_path)).lookup(key) is None


# ---------------------------------------------------------------------------
# LRU eviction (tests/test_cache_evict.py's cases).
# ---------------------------------------------------------------------------

NODE = ALL_QUERIES["q6"]().logical
T0 = 1_000_000_000.0  # any fixed epoch; only the ORDER matters


def _key(rows: int):
    return plan_key(NODE, {"lineitem": rows}, 8)


def _plan():
    return plan_physical(NODE, {"lineitem": 8192}, 8, name="q6")


def _entries(cache_dir, prefix="torchplan-") -> list:
    return sorted(n for n in os.listdir(cache_dir)
                  if n.startswith(prefix) and n.endswith(".pkl"))


def _set_mtime(cache_dir, digest: str, t: float) -> None:
    os.utime(os.path.join(cache_dir, f"torchplan-{digest}.pkl"), (t, t))


def test_cap_bounds_entry_count_and_counts_evictions(tmp_path):
    cache = PlanCache(cache_dir=str(tmp_path), max_entries=3)
    plan = _plan()
    keys = [_key(1024 * (i + 1)) for i in range(6)]
    for i, k in enumerate(keys):
        cache.insert(k, plan)
        _set_mtime(tmp_path, k.digest, T0 + i)
    assert len(_entries(tmp_path)) == 3
    assert cache.evictions == 3 and cache.record()["plan_evictions"] == 3
    assert _entries(tmp_path) == sorted(f"torchplan-{k.digest}.pkl" for k in keys[3:])


def test_unlimited_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE_MAX", raising=False)
    monkeypatch.setenv("REPRO_PLAN_CACHE_MAX", "1")  # the reference's variable: not read
    cache = PlanCache(cache_dir=str(tmp_path))
    assert cache.max_entries == 0
    plan = _plan()
    for i in range(8):
        cache.insert(_key(512 * (i + 1)), plan)
    assert len(_entries(tmp_path)) == 8 and cache.evictions == 0


def test_env_vars_set_cap_and_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_MAX", "2")
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "reference"))
    cache = PlanCache()
    assert cache.max_entries == 2 and cache.cache_dir == str(tmp_path)
    plan = _plan()
    for i in range(4):
        cache.insert(_key(512 * (i + 1)), plan)
    assert len(_entries(tmp_path)) == 2
    assert not (tmp_path / "reference").exists()


def test_disk_hit_refreshes_recency(tmp_path):
    cache = PlanCache(cache_dir=str(tmp_path), max_entries=2)
    plan = _plan()
    ka, kb = _key(1024), _key(2048)
    cache.insert(ka, plan)
    cache.insert(kb, plan)
    _set_mtime(tmp_path, ka.digest, T0)
    _set_mtime(tmp_path, kb.digest, T0 + 1)
    reader = PlanCache(cache_dir=str(tmp_path), max_entries=2)
    assert reader.lookup(ka) is not None and reader.disk_hits == 1
    assert os.path.getmtime(tmp_path / f"torchplan-{ka.digest}.pkl") > T0 + 1
    cache.insert(_key(4096), plan)  # cap exceeded: victim is B, not A
    names = _entries(tmp_path)
    assert f"torchplan-{ka.digest}.pkl" in names
    assert f"torchplan-{kb.digest}.pkl" not in names


def test_keep_shields_the_just_inserted_entry(tmp_path):
    cache = PlanCache(cache_dir=str(tmp_path), max_entries=1)
    plan = _plan()
    ka, kb = _key(1024), _key(2048)
    cache.insert(ka, plan)
    _set_mtime(tmp_path, ka.digest, T0 + 100)  # A looks newer than B will
    cache.insert(kb, plan)
    PlanCache(cache_dir=str(tmp_path), max_entries=1).insert(kb, plan)
    assert _entries(tmp_path) == [f"torchplan-{kb.digest}.pkl"]


def _subprocess(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for var in ("REPRO_TORCH_PLAN_CACHE_DIR", "REPRO_TORCH_PLAN_CACHE_MAX"):
        env.pop(var, None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=180, env=env)


_EVICTOR_SCRIPT = """
from repro_torch.relational.planner import tpch
from repro_torch.relational.planner.plan_cache import PlanCache, plan_key

node = tpch.ALL_QUERIES["q6"]().logical
cache = PlanCache(cache_dir={cache_dir!r}, max_entries=2)
key = plan_key(node, {{"lineitem": 9999}}, 8)
plan, hit = cache.get_plan(key, lambda: tpch.ALL_QUERIES["q6"]().plan(
    {{"lineitem": 8192}}, 8))
assert not hit
print("EVICTIONS", cache.evictions)
"""


def test_eviction_across_processes(tmp_path):
    cache = PlanCache(cache_dir=str(tmp_path), max_entries=2)
    plan = _plan()
    keys = [_key(1024 * (i + 1)) for i in range(2)]
    for i, k in enumerate(keys):
        cache.insert(k, plan)
        _set_mtime(tmp_path, k.digest, T0 + i)
    proc = _subprocess(_EVICTOR_SCRIPT.format(cache_dir=str(tmp_path)))
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    assert "EVICTIONS 1" in proc.stdout
    assert len(_entries(tmp_path)) == 2
    fresh = PlanCache(cache_dir=str(tmp_path), max_entries=2)
    assert fresh.lookup(keys[0]) is None
    assert fresh.lookup(keys[1]) is not None


# ---------------------------------------------------------------------------
# Apart from the reference's cache.
# ---------------------------------------------------------------------------

_LOOKUP_SCRIPT = """
import sys
from repro_torch.relational.planner.plan_cache import PlanCache, plan_key
from repro_torch.relational.planner import tpch

cache = PlanCache(cache_dir={cache_dir!r})
key = plan_key(tpch.ALL_QUERIES["q6"]().logical, {{"lineitem": 8192}}, 8)
assert key.digest == {digest!r}
print("FOUND", cache.lookup(key) is not None)
print("JAX", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_reference_entries_are_never_unpickled(tmp_path):
    """The reference writes ``plan-<digest>.pkl`` with the SAME digest as the
    port's key; the port neither counts, evicts nor loads it, and a
    reference entry placed under the port's own file name is refused
    before any JAX module is imported — a miss, not an error."""
    node = ALL_QUERIES["q6"]().logical
    key = plan_key(node, {"lineitem": 8192}, 8)
    ref_key = ref_pc.plan_key(ref_tpch.ALL_QUERIES["q6"]().logical, {"lineitem": 8192}, 8)
    assert ref_key.digest == key.digest
    ref_pc.PlanCache(cache_dir=str(tmp_path)).get_plan(
        ref_key, lambda: ref_tpch.ALL_QUERIES["q6"]().plan({"lineitem": 8192}, 8))
    assert _entries(tmp_path, "plan-") == [f"plan-{key.digest}.pkl"]

    proc = _subprocess(_LOOKUP_SCRIPT.format(cache_dir=str(tmp_path), digest=key.digest))
    assert proc.returncode == 0, proc.stderr
    assert "FOUND False" in proc.stdout and "JAX []" in proc.stdout

    # a reference entry under the port's name: refused by the unpickler
    shutil.copy(tmp_path / f"plan-{key.digest}.pkl", tmp_path / f"torchplan-{key.digest}.pkl")
    proc = _subprocess(_LOOKUP_SCRIPT.format(cache_dir=str(tmp_path), digest=key.digest))
    assert proc.returncode == 0, proc.stderr
    assert "FOUND False" in proc.stdout and "JAX []" in proc.stdout

    # the port's cap counts and evicts its own entries only
    os.unlink(tmp_path / f"torchplan-{key.digest}.pkl")
    cache = PlanCache(cache_dir=str(tmp_path), max_entries=1)
    cache.insert(_key(1024), _plan())
    cache.insert(_key(2048), _plan())
    assert cache.evictions == 1 and len(_entries(tmp_path)) == 1
    assert _entries(tmp_path, "plan-") == [f"plan-{key.digest}.pkl"]
    # and the port's entry round-trips through its own unpickler
    assert PlanCache(cache_dir=str(tmp_path)).lookup(_key(2048)).explain() == _plan().explain()
