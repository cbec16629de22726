"""The port's planner, cost model, data and statistics against the JAX package.

* ``explain()`` equals all 13 golden plans and the reference's
  ``explain_query`` for all nine queries at SF 1 and SF 10, on 8 shards and
  on 2 pods x 4 (planning only: no data).  The one documented difference is
  the pack knob's name (:data:`PACK_NAMES`).
* The port's datagen equals the reference's column for column; its
  statistics equal the reference's profile.
* ``import repro_torch`` (every module) never imports jax or the JAX
  package, and neither does ``chip_smoke.py``.
"""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

from repro.core import autotune as ref_autotune
from repro.core import schedule as ref_schedule
from repro.relational import datagen as ref_datagen
from repro.relational import stats as ref_stats
from repro.relational.context import ExecutionContext as RefContext
from repro.relational.context import StatsMode as RefStatsMode
from repro.relational.planner import tpch as ref_tpch
from repro_torch.core import autotune, schedule
from repro_torch.relational import datagen, stats
from repro_torch.relational.context import ExecutionContext, StatsMode
from repro_torch.relational.planner import tpch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden_plans")

# The port's pack knob values -> the reference's names: the plain one-hot
# pack prints pack=torch where the reference prints pack=xla, the CUDA
# kernel pack=cuda where it prints pack=pallas.
PACK_NAMES = {"pack=torch": "pack=xla", "pack=cuda": "pack=pallas"}


def as_reference(text: str) -> str:
    for port, reference in PACK_NAMES.items():
        text = text.replace(port, reference)
    return text


STATIC_GOLDENS = [
    ("q1", "q1", 1), ("q3", "q3", 1), ("q4", "q4", 1), ("q6", "q6", 1),
    ("q12", "q12", 1), ("q14", "q14", 1), ("q17", "q17", 1), ("q18", "q18", 1),
    ("q19", "q19", 1), ("q3_pods2", "q3", 2), ("q18_pods2", "q18", 2),
]


def _golden(fname: str) -> str:
    with open(os.path.join(GOLDEN_DIR, f"{fname}.txt")) as f:
        return f.read()


@pytest.mark.parametrize("fname,query,pods", STATIC_GOLDENS)
def test_explain_equals_golden(fname, query, pods):
    text = tpch.explain_query(
        tpch.ALL_QUERIES[query](), tpch.tpch_catalog(0.01),
        ExecutionContext(num_shards=8, num_pods=pods),
    )
    assert as_reference(text) == _golden(fname)


@pytest.fixture(scope="module")
def zipf_columns():
    """Zipf-skewed tables (the reference's adaptive-planning scenario),
    generated by both packages."""
    kw = dict(zipf_partkey=1.2, zipf_orderkey=1.5)
    return ref_datagen.gen_all(0.01, **kw), datagen.gen_all(0.01, device="cpu", **kw)


@pytest.mark.parametrize("fname,query", [("q17_salted", "q17"), ("q18_salted", "q18")])
def test_salted_explain_equals_golden(fname, query, zipf_columns):
    _, tabs = zipf_columns
    pq = tpch.ALL_QUERIES[query]()
    profile = stats.collect_stats({t: tabs[t] for t in pq.tables})
    ctx = ExecutionContext(num_shards=8, stats_mode=StatsMode.PROFILE, stats_profile=profile)
    text = tpch.explain_query(pq, {t: tabs[t].capacity for t in pq.tables}, ctx)
    assert "salted x" in text
    assert as_reference(text) == _golden(fname)


@pytest.mark.parametrize("sf", [1, 10])
@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("query", sorted(tpch.ALL_QUERIES))
def test_explain_equals_reference(query, sf, pods):
    want = ref_tpch.explain_query(
        ref_tpch.ALL_QUERIES[query](), ref_tpch.tpch_catalog(sf),
        RefContext(num_shards=8, num_pods=pods),
    )
    got = tpch.explain_query(
        tpch.ALL_QUERIES[query](), tpch.tpch_catalog(sf),
        ExecutionContext(num_shards=8, num_pods=pods),
    )
    assert as_reference(got) == want


def test_tuner_scales_its_knobs_like_the_reference():
    """At SF 10 the tuner picks scheduled transports with pipeline and
    transport chunks (and Q17 on 2 pods reshards): the port must carry
    every knob, not just SF 1's choices."""
    text = tpch.explain_query(
        tpch.q17(), tpch.tpch_catalog(10), ExecutionContext(num_shards=8, num_pods=2)
    )
    assert "cross_pod=reshard" in text
    head = tpch.explain_query(
        tpch.q3(), tpch.tpch_catalog(10), ExecutionContext(num_shards=8, num_pods=2)
    ).splitlines()[1]
    assert "impl=one_factorization" in head and "pipeline_chunks=4" in head
    assert "transport_chunks=2" in head


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("pods", [1, 2])
def test_tune_config_equals_reference(n, pods):
    shapes = [
        (autotune.TableStats(rows=r, row_bytes=b), ref_autotune.TableStats(rows=r, row_bytes=b))
        for r, b in ((7500, 16), (1875, 4), (750_000, 12))
    ]
    got = autotune.tune_config(n, [p for p, _ in shapes], num_pods=pods,
                               broadcast_stats=shapes[1][0])
    want = ref_autotune.tune_config(n, [r for _, r in shapes], num_pods=pods,
                                    broadcast_stats=shapes[1][1])
    pack = {"torch": "xla", "cuda": "pallas"}
    assert (got.impl, pack[got.pack_impl], got.pipeline_chunks, got.transport_chunks) == (
        want.impl, want.pack_impl, want.pipeline_chunks, want.transport_chunks
    )
    assert got.modeled_s == want.modeled_s and got.cross_pod == want.cross_pod
    assert [(i, pack[p], c, t, s) for i, p, c, t, s in got.candidates] == list(want.candidates)


@pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
def test_schedules_equal_reference(n):
    assert schedule.shift_schedule(n).phases == ref_schedule.shift_schedule(n).phases
    if n % 2 == 0:
        assert schedule.one_factorization(n).phases == ref_schedule.one_factorization(n).phases


@pytest.mark.parametrize("zipf", [None, "partkey", "orderkey"])
def test_datagen_equals_reference(zipf):
    kw = {} if zipf is None else {f"zipf_{zipf}": 1.2}
    want = ref_datagen.gen_all(0.01, **kw)
    got = datagen.gen_all(0.01, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name].columns) == sorted(want[name].columns), name
        for c, col in want[name].columns.items():
            np.testing.assert_array_equal(got[name][c].numpy(), np.asarray(col), err_msg=c)
        assert got[name].dictionaries == want[name].dictionaries
        assert bool(got[name].valid.all())


def test_collect_stats_equals_reference(zipf_columns):
    ref_tabs, tabs = zipf_columns
    want = ref_stats.collect_stats(ref_tabs)
    got = stats.collect_stats(tabs)
    assert sorted(got) == sorted(want)
    for t in want:
        assert (got[t].rows, got[t].sample_rows) == (want[t].rows, want[t].sample_rows)
        fields = lambda cols: {c: dataclasses.astuple(cs) for c, cs in cols.items()}  # noqa: E731
        assert fields(got[t].columns) == fields(want[t].columns), t
        for c in want[t].sample:
            np.testing.assert_array_equal(got[t].sample[c], want[t].sample[c])


def test_profile_planning_needs_a_profile():
    with pytest.raises(ValueError, match="PROFILE"):
        ExecutionContext(num_shards=8, stats_mode=StatsMode.PROFILE)
    assert RefStatsMode.PROFILE.value == StatsMode.PROFILE.value


@pytest.mark.parametrize("field,value", [("trace", object())])
def test_later_slice_fields_raise(field, value):
    """``trace`` was the last field a later slice brought; it has landed
    (the telemetry slice), and like the reference's it is payload: a
    context that sets it equals and hashes as one that does not."""
    ctx = ExecutionContext(**{field: value})
    assert getattr(ctx, field) is value
    assert ctx == ExecutionContext() and hash(ctx) == hash(ExecutionContext())
    assert field not in repr(ctx)
    ref = RefContext(**{field: value})
    assert ref == RefContext() and field not in repr(ref)


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_port_sources_import_neither_jax_nor_the_reference():
    import repro_torch

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.dirname(repro_torch.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_every_port_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    import repro_torch

    n_modules = sum(1 for _ in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
    assert int(proc.stdout.strip()) >= n_modules
