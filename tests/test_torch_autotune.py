"""The port's autotuner, its measured side included, against the JAX package.

* ``tune_multiplexer``'s analytical half at the full signature: meshes
  1 x 8 and 2 x 4, ``V5E`` and a replaced ``ChipSpec``, ring and switch,
  with and without ``broadcast_stats`` and an explicit ``axis``: knobs,
  ``cross_pod``, ``modeled_s`` (rel 1e-12) and every candidate equal to the
  reference's, pack names mapped (``torch``/``cuda`` for ``xla``/``pallas``).
* ``refine=True`` with one deterministic wall function patched into both
  packages' ``measure_shuffle_config``: the same winner, ``measured_s`` and
  ``modeled_s``; on 2 x 4 both warn and return the analytical winner.
* ``calibrate_chip``'s fit: both packages' ``_best_wall`` patched to return
  the same four walls; the reference runs on 8 fake CPU devices in one
  subprocess (``tests/_torch_autotune_ref_run.py``); the four fitted fields
  and the name equal, rel 1e-12, floors included.
* ``measure_shuffle_config`` and ``calibrate_chip`` for real on the CPU.
* ``moe_expert_time``, ``ep_dispatch_makespan`` and ``tune_ep_dispatch``
  equal to the reference's, rel 1e-12.
* ``make_multiplexer(auto=True, ...)`` applies the tuned knobs and
  ``cross_pod``; a calibrated spec's plan-cache keys never hit V5E entries.
* On the card (``gpu``): ``measure_shuffle_config`` launches
  ``hash_partition_pack``; ``calibrate_chip`` at ``chip_smoke.py`` phase
  4d's ``message_rows`` gives finite constants, neither slope at its floor.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import autotune as ref_autotune
from repro.core import multiplexer as ref_multiplexer
from repro.core import topology as ref_topology
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import autotune, topology
from repro_torch.core.exchange import make_mesh
from repro_torch.core.multiplexer import make_multiplexer
from repro_torch.relational.planner import tpch
from repro_torch.relational.planner.physical import plan_physical
from repro_torch.relational.planner.plan_cache import PlanCache, plan_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK = {"xla": "torch", "pallas": "cuda"}
REF_PACK = {v: k for k, v in PACK.items()}
# an H100-like spec (the card's name, peak and memory; calibrated-looking links)
CHIP_FIELDS = dict(
    name="NVIDIA H100 80GB HBM3", peak_flops_bf16=989e12, hbm_bytes=80 * 2**30,
    ici_link_bandwidth=6.2e11, ici_launch_latency=2.3e-5, hbm_bandwidth=1.7e12,
    kernel_launch_latency=1.4e-4,
)
STATS = [(750_080, 16), (187_520, 12)]
BUILD = (25_000, 8)


def _chips(kind):
    if kind == "v5e":
        return ref_topology.V5E, topology.V5E
    return (dataclasses.replace(ref_topology.V5E, **CHIP_FIELDS),
            dataclasses.replace(topology.V5E, **CHIP_FIELDS))


def _ref_mesh(pods):
    if pods == 1:
        return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((1, 8)))
    return types.SimpleNamespace(axis_names=("pod", "model"), devices=np.empty((2, 4)))


def _stats(mod, rows_bytes):
    return [mod.TableStats(rows=r, row_bytes=b) for r, b in rows_bytes]


def _knobs(t, mapped=False):
    pack = PACK[t.pack_impl] if mapped else t.pack_impl
    return (t.impl, pack, t.pipeline_chunks, t.transport_chunks)


def _assert_tuned_equal(got, want):
    assert _knobs(got) == _knobs(want, mapped=True)
    assert got.modeled_s == pytest.approx(want.modeled_s, rel=1e-12, abs=0.0)
    assert got.cross_pod == want.cross_pod
    if want.cross_pod_modeled_s is None:
        assert got.cross_pod_modeled_s is None
    else:
        assert got.cross_pod_modeled_s == pytest.approx(want.cross_pod_modeled_s, rel=1e-12,
                                                        abs=0.0)
    assert len(got.candidates) == len(want.candidates)
    for g, w in zip(got.candidates, want.candidates):
        assert g[:4] == (w[0], PACK[w[1]], w[2], w[3])
        assert g[4] == pytest.approx(w[4], rel=1e-12, abs=0.0)


# ----------------------------------------------------------------------------
# tune_multiplexer: the analytical half at the full signature.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("explicit_axis", [False, True])
@pytest.mark.parametrize("with_build", [False, True])
@pytest.mark.parametrize("topo", ["ring", "switch"])
@pytest.mark.parametrize("chip", ["v5e", "replaced"])
@pytest.mark.parametrize("pods", [1, 2])
def test_tune_multiplexer_analytical_matches_reference(pods, chip, topo, with_build,
                                                       explicit_axis):
    ref_chip, chip_ = _chips(chip)
    kw, ref_kw = dict(chip=chip_, topology=topo), dict(chip=ref_chip, topology=topo)
    if with_build:
        kw["broadcast_stats"] = autotune.TableStats(*BUILD)
        ref_kw["broadcast_stats"] = ref_autotune.TableStats(*BUILD)
    if explicit_axis:
        kw["axis"], ref_kw["axis"] = "q", "model"
    want = ref_autotune.tune_multiplexer(_ref_mesh(pods), _stats(ref_autotune, STATS), **ref_kw)
    got = autotune.tune_multiplexer(make_mesh(8, pods), _stats(autotune, STATS), **kw)
    _assert_tuned_equal(got, want)
    assert got.measured_s is None and want.measured_s is None
    assert (got.cross_pod is not None) == (pods > 1 and with_build)


def test_tune_multiplexer_single_unit_axis_matches_reference():
    """An explicit axis of one unit collapses to the unchunked default."""
    ref_mesh = types.SimpleNamespace(axis_names=("model",), devices=np.empty((1,)))
    want = ref_autotune.tune_multiplexer(ref_mesh, _stats(ref_autotune, STATS), axis="model")
    got = autotune.tune_multiplexer(make_mesh(1), _stats(autotune, STATS), axis="q")
    _assert_tuned_equal(got, want)


# ----------------------------------------------------------------------------
# refine=True with injected walls.
# ----------------------------------------------------------------------------

def _fake_wall(impl, pack_impl, C, t):
    """Deterministic and unlike the model: one_factorization and the plain
    pack measure best, more chunks slightly worse."""
    base = {"one_factorization": 1.0, "round_robin": 1.5, "xla": 2.0}[impl]
    return 1e-4 * (base + (0.0 if pack_impl in ("xla", "torch") else 0.25) + 0.01 * C + 0.001 * t)


@pytest.fixture
def fake_measure(monkeypatch):
    """Patch both packages' measure_shuffle_config with :func:`_fake_wall`
    and record every call, pack names as the reference spells them."""
    calls = {"ref": [], "port": []}

    def ref_measure(mesh, axis, stats, impl="round_robin", pack_impl="xla",
                    pipeline_chunks=1, transport_chunks=1, **kw):
        calls["ref"].append((axis, stats.rows, stats.row_bytes, impl, pack_impl,
                             pipeline_chunks, transport_chunks))
        return _fake_wall(impl, pack_impl, pipeline_chunks, transport_chunks)

    def port_measure(mesh, axis, stats, impl="round_robin", pack_impl="torch",
                     pipeline_chunks=1, transport_chunks=1, device="cuda", **kw):
        calls["port"].append((axis, stats.rows, stats.row_bytes, impl, REF_PACK[pack_impl],
                              pipeline_chunks, transport_chunks))
        return _fake_wall(impl, pack_impl, pipeline_chunks, transport_chunks)

    monkeypatch.setattr(ref_autotune, "measure_shuffle_config", ref_measure)
    monkeypatch.setattr(autotune, "measure_shuffle_config", port_measure)
    return calls


@pytest.mark.parametrize("chip", ["v5e", "replaced"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_refine_matches_reference_on_injected_walls(fake_measure, top_k, chip):
    ref_chip, chip_ = _chips(chip)
    want = ref_autotune.tune_multiplexer(
        _ref_mesh(1), _stats(ref_autotune, STATS), chip=ref_chip, refine=True,
        refine_top_k=top_k,
    )
    got = autotune.tune_multiplexer(
        make_mesh(8), _stats(autotune, STATS), chip=chip_, refine=True, refine_top_k=top_k,
    )
    _assert_tuned_equal(got, want)
    assert got.measured_s == want.measured_s
    # the same candidates timed, in order, on the largest exchange
    assert [c[1:] for c in fake_measure["port"]] == [c[1:] for c in fake_measure["ref"]]
    assert len(fake_measure["port"]) == top_k
    assert {c[:3] for c in fake_measure["port"]} == {("q", *STATS[0])}
    timed = [_fake_wall(*c[3:]) for c in fake_measure["port"]]
    assert got.measured_s == min(timed)


def test_refine_on_two_level_mesh_warns_like_reference(fake_measure):
    with pytest.warns(UserWarning, match="two-level") as ref_w:
        want = ref_autotune.tune_multiplexer(_ref_mesh(2), _stats(ref_autotune, STATS),
                                             refine=True)
    with pytest.warns(UserWarning, match="two-level") as got_w:
        got = autotune.tune_multiplexer(make_mesh(8, 2), _stats(autotune, STATS), refine=True)
    assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]
    _assert_tuned_equal(got, want)
    assert got.measured_s is None and want.measured_s is None
    assert fake_measure == {"ref": [], "port": []}


# ----------------------------------------------------------------------------
# calibrate_chip: the fit on given walls, against the reference.
# ----------------------------------------------------------------------------

CAL_CASES = [
    # link walls, pack walls: an ordinary fit
    dict(walls=[1.2e-4, 9.5e-4, 6.0e-5, 4.1e-4], message_rows=[1024, 65536], row_bytes=16,
         chip=None),
    # equal walls: both slopes sit at their 1e-15 floor
    dict(walls=[3.0e-4, 3.0e-4, 2.0e-4, 2.0e-4], message_rows=[1024, 65536], row_bytes=16,
         chip=None),
    # falling walls: both slopes floored, intercepts from the first walls
    dict(walls=[2.0e-3, 1.0e-3, 5.0e-4, 1.0e-4], message_rows=[1024, 65536], row_bytes=16,
         chip=None),
    # steep slopes from tiny first walls: both intercepts at their 1e-9 floor
    dict(walls=[1.0e-9, 5.0e-2, 1.0e-9, 3.0e-2], message_rows=[1024, 65536], row_bytes=16,
         chip=None),
    # another width and size pair, on a replaced spec
    dict(walls=[4.0e-5, 2.5e-4, 3.0e-5, 1.1e-4], message_rows=[256, 4096], row_bytes=12,
         chip={"name": "NVIDIA H100 80GB HBM3", "peak_flops_bf16": 989e12}),
    # three sizes: the fit uses the first and the last
    dict(walls=[1.0e-4, 5.0e-4, 4.0e-5, 2.0e-4], message_rows=[1024, 2048, 16384],
         row_bytes=8, chip=None),
]
CAL_FIELDS = ("ici_link_bandwidth", "ici_launch_latency", "hbm_bandwidth",
              "kernel_launch_latency")


@pytest.fixture(scope="module")
def ref_calibrated(tmp_path_factory):
    """The reference's calibrate_chip on every case, in one subprocess."""
    d = tmp_path_factory.mktemp("calib")
    cases = []
    for c in CAL_CASES:
        walls = c["walls"]
        if len(c["message_rows"]) == 3:  # one wall per size and law
            walls = [walls[0], 0.0, walls[1], walls[2], 0.0, walls[3]]
        cases.append({**c, "walls": walls})
    src, dst = d / "in.json", d / "out.json"
    src.write_text(json.dumps(cases))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_torch_autotune_ref_run.py"),
         str(src), str(dst)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(dst.read_text())


@pytest.mark.parametrize("case", range(len(CAL_CASES)))
def test_calibrate_chip_fit_matches_reference(ref_calibrated, monkeypatch, case):
    c = CAL_CASES[case]
    walls = list(c["walls"])
    if len(c["message_rows"]) == 3:
        walls = [walls[0], 0.0, walls[1], walls[2], 0.0, walls[3]]
    it = iter(walls)
    monkeypatch.setattr(autotune, "_best_wall", lambda fn, *a, **kw: next(it))
    chip = dataclasses.replace(topology.V5E, **(c["chip"] or {}))
    got = autotune.calibrate_chip(make_mesh(8), "q", chip=chip,
                                  message_rows=tuple(c["message_rows"]),
                                  row_bytes=c["row_bytes"], device="cpu")
    want = ref_calibrated[case]
    assert got.name == want["name"] == chip.name + "-calibrated"
    for f in CAL_FIELDS:
        assert getattr(got, f) == pytest.approx(want[f], rel=1e-12, abs=0.0), f
        assert math.isfinite(getattr(got, f)) and getattr(got, f) > 0
    # every other field is the input spec's
    rest = {k: v for k, v in dataclasses.asdict(got).items() if k not in CAL_FIELDS + ("name",)}
    assert rest == {k: v for k, v in dataclasses.asdict(chip).items()
                    if k not in CAL_FIELDS + ("name",)}
    assert rest == {k: v for k, v in want.items() if k not in CAL_FIELDS + ("name",)}
    if case == 1:  # equal walls: the floors
        assert got.hbm_bandwidth == pytest.approx(1e15, rel=1e-12, abs=0.0)
    if case == 3:
        assert got.kernel_launch_latency == 1e-9


def test_calibrate_chip_single_unit_returns_chip_unchanged(monkeypatch):
    def never(*a, **kw):
        raise AssertionError("a one-unit axis measures nothing")

    monkeypatch.setattr(autotune, "_best_wall", never)
    ref_mesh = types.SimpleNamespace(axis_names=("x",), devices=np.empty((1,)))
    assert ref_autotune.calibrate_chip(ref_mesh, "x") is ref_topology.V5E
    assert autotune.calibrate_chip(make_mesh(1), "q", device="cpu") is topology.V5E
    chip = dataclasses.replace(topology.V5E, **CHIP_FIELDS)
    assert autotune.calibrate_chip(make_mesh(8, 8), "q", chip=chip, device="cpu") is chip


# ----------------------------------------------------------------------------
# The measured side for real on the CPU.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    ("round_robin", "torch", 1, 1), ("one_factorization", "cuda", 2, 2),
    ("xla", "torch", 1, 1), ("round_robin", "cuda", 4, 1),
])
def test_measure_shuffle_config_runs_on_the_cpu(knobs):
    impl, pack, C, t = knobs
    wall = autotune.measure_shuffle_config(
        make_mesh(8), "q", autotune.TableStats(rows=1030, row_bytes=12), impl=impl,
        pack_impl=pack, pipeline_chunks=C, transport_chunks=t, device="cpu",
    )
    assert math.isfinite(wall) and wall > 0


def test_measure_shuffle_config_caps_and_aligns_rows(monkeypatch):
    """``max_rows`` caps the probe and rows align down to ``C * t``; the
    shuffle runs at zero-drop capacity on the requested device."""
    seen = []
    real = autotune._best_wall

    def spy(fn, keys, data, **kw):
        seen.append((tuple(keys.shape), tuple(data.shape), keys.device.type))
        out = fn(keys, data)
        assert int(out) > 0
        return real(fn, keys, data, **kw)

    monkeypatch.setattr(autotune, "_best_wall", spy)
    autotune.measure_shuffle_config(
        make_mesh(8), "q", autotune.TableStats(rows=5000, row_bytes=20),
        pipeline_chunks=2, transport_chunks=4, max_rows=1030, device="cpu",
    )
    assert seen == [((8, 1024), (8, 1024, 5), "cpu")]


def test_calibrate_chip_runs_on_the_cpu():
    base = dataclasses.replace(topology.V5E, **CHIP_FIELDS)
    cal = autotune.calibrate_chip(make_mesh(8), "q", chip=base, message_rows=(256, 8192),
                                  device="cpu")
    assert cal.name == base.name + "-calibrated"
    for f in CAL_FIELDS:
        assert math.isfinite(getattr(cal, f)) and getattr(cal, f) > 0, f
    tuned = autotune.tune_multiplexer(make_mesh(8), autotune.TableStats(4096, 16), chip=cal,
                                      refine=True, refine_top_k=2, device="cpu")
    assert tuned.measured_s is not None and tuned.measured_s > 0
    assert (tuned.impl, tuned.pack_impl, tuned.pipeline_chunks, tuned.transport_chunks,
            tuned.modeled_s) in [tuple(c) for c in tuned.candidates[:2]]


def test_measurement_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.measure_shuffle_config(make_mesh(8), "q", autotune.TableStats(64, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.calibrate_chip(make_mesh(8), "q")


# ----------------------------------------------------------------------------
# EP dispatch pricing.
# ----------------------------------------------------------------------------

def _ep_configs(which):
    if which == "olmoe":
        return ref_get_config("olmoe-1b-7b"), get_config("olmoe-1b-7b")
    return ref_get_smoke_config("olmoe-1b-7b"), get_smoke_config("olmoe-1b-7b")


@pytest.mark.parametrize("pack", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["round_robin", "xla"])
@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("which", ["olmoe", "smoke"])
def test_ep_pricing_matches_reference(which, batch, pods, impl, pack):
    ref_cfg, cfg = _ep_configs(which)
    units, n_inner = 8, 8 // pods
    want_c = ref_autotune.moe_expert_time(ref_cfg, batch, units)
    got_c = autotune.moe_expert_time(cfg, batch, units)
    assert got_c == pytest.approx(want_c, rel=1e-12, abs=0.0)
    ref_st = ref_autotune.decode_table_stats(ref_cfg, batch, units)
    st = autotune.decode_table_stats(cfg, batch, units)
    assert (st.rows, st.row_bytes) == (ref_st.rows, ref_st.row_bytes)
    for chunks in (1, 2, 3, 4):
        for overlap in (True, False):
            want = ref_autotune.ep_dispatch_makespan(
                ref_st, n_inner, want_c, impl, pack, chunks, 1, num_pods=pods,
                overlap=overlap)
            got = autotune.ep_dispatch_makespan(
                st, n_inner, got_c, impl, PACK[pack], chunks, 1, num_pods=pods,
                overlap=overlap)
            assert got == pytest.approx(want, rel=1e-12, abs=0.0), (chunks, overlap)
    want = ref_autotune.tune_ep_dispatch(ref_cfg, batch, units, num_pods=pods, impl=impl,
                                         pack_impl=pack)
    got = autotune.tune_ep_dispatch(cfg, batch, units, num_pods=pods, impl=impl,
                                    pack_impl=PACK[pack])
    assert got["chunks"] == want["chunks"]
    for k in ("serial_s", "async_s", "overlap_fraction"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0.0), k
    assert [c[0] for c in got["candidates"]] == [c[0] for c in want["candidates"]]
    for g, w in zip(got["candidates"], want["candidates"]):
        assert g[1:] == pytest.approx(w[1:], rel=1e-12, abs=0.0)


@pytest.mark.parametrize("pods", [1, 2])
def test_tune_ep_dispatch_on_a_replaced_chip_matches_reference(pods):
    ref_chip, chip = _chips("replaced")
    ref_cfg, cfg = _ep_configs("olmoe")
    want = ref_autotune.tune_ep_dispatch(ref_cfg, 64, 8, num_pods=pods, chip=ref_chip)
    got = autotune.tune_ep_dispatch(cfg, 64, 8, num_pods=pods, chip=chip)
    assert got["chunks"] == want["chunks"]
    for k in ("serial_s", "async_s", "overlap_fraction"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0.0), k


# ----------------------------------------------------------------------------
# make_multiplexer(auto=True, ...).
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("pods", [1, 2])
def test_make_multiplexer_applies_tuned_knobs_and_cross_pod(fake_measure, pods, refine):
    ref_chip, chip = _chips("replaced")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # refine on 2 x 4 warns on both sides
        want = ref_multiplexer.make_multiplexer(
            _ref_mesh(pods), auto=True, table_stats=_stats(ref_autotune, STATS), chip=ref_chip,
            topology="switch", refine=refine,
            broadcast_stats=ref_autotune.TableStats(*BUILD),
        )
        got = make_multiplexer(
            make_mesh(8, pods), auto=True, table_stats=_stats(autotune, STATS), chip=chip,
            topology="switch", refine=refine, broadcast_stats=autotune.TableStats(*BUILD),
        )
        tuned = autotune.tune_multiplexer(
            make_mesh(8, pods), _stats(autotune, STATS), chip=chip, topology="switch",
            refine=refine, broadcast_stats=autotune.TableStats(*BUILD),
        )
    assert _knobs(got) == _knobs(want, mapped=True) == _knobs(tuned)
    assert got.cross_pod == want.cross_pod
    assert got.cross_pod == (tuned.cross_pod or "broadcast")
    assert bool(fake_measure["port"]) == (refine and pods == 1)


def test_make_multiplexer_reshard_when_the_build_side_is_large():
    """A build side past the broadcast threshold flips ``cross_pod`` to
    reshard, as in the reference; without one the argument stands."""
    big = (2_000_000, 16)
    want = ref_multiplexer.make_multiplexer(
        _ref_mesh(2), auto=True, table_stats=_stats(ref_autotune, STATS),
        broadcast_stats=ref_autotune.TableStats(*big))
    got = make_multiplexer(make_mesh(8, 2), auto=True, table_stats=_stats(autotune, STATS),
                           broadcast_stats=autotune.TableStats(*big))
    assert got.cross_pod == want.cross_pod == "reshard"
    kept = make_multiplexer(make_mesh(8, 2), auto=True, table_stats=_stats(autotune, STATS),
                            cross_pod="reshard")
    assert kept.cross_pod == "reshard"


# ----------------------------------------------------------------------------
# Plan-cache keys under a calibrated spec.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("q", ["q3", "q17", "q18"])
def test_calibrated_plan_keys_never_hit_v5e_entries(q, tmp_path):
    pq = tpch.ALL_QUERIES[q]()
    cat = tpch.tpch_catalog(0.004)
    catalog = {t: cat[t] for t in pq.tables}
    cal = dataclasses.replace(topology.V5E, **CHIP_FIELDS)
    cal = dataclasses.replace(cal, name=cal.name + "-calibrated")
    cache = PlanCache(str(tmp_path))
    for pods in (1, 2):
        k_v5e = plan_key(pq.logical, catalog, 8, num_pods=pods)
        k_cal = plan_key(pq.logical, catalog, 8, num_pods=pods, chip=cal)
        assert k_v5e.digest != k_cal.digest
        assert f"chip={cal.name}" in k_cal.material
        v5e_plan, hit = cache.get_plan(
            k_v5e, lambda: plan_physical(pq.logical, catalog, 8, num_pods=pods, name=q))
        assert not hit
        planned = []

        def plan_cal():
            planned.append(1)
            return plan_physical(pq.logical, catalog, 8, num_pods=pods, chip=cal, name=q)

        cal_plan, hit = cache.get_plan(k_cal, plan_cal)
        assert not hit and planned == [1]
        assert cal_plan is not v5e_plan
        # a fresh cache on the same directory reads each back under its own key
        again = PlanCache(str(tmp_path))
        assert again.lookup(k_cal).explain() == cal_plan.explain()
        assert again.lookup(k_v5e).explain() == v5e_plan.explain()


# ----------------------------------------------------------------------------
# On the card.
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _phase_4d_rows():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CAL_MESSAGE_ROWS


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2])
def test_cuda_measure_shuffle_config_launches_the_pack_kernel(cuda_device, C):
    from repro_torch.kernels import hash_partition as hp

    before = hp.LAUNCHES["hash_partition_pack"]
    wall = autotune.measure_shuffle_config(
        make_mesh(8), "q", autotune.TableStats(rows=65536, row_bytes=16), pack_impl="cuda",
        pipeline_chunks=C, iters=3,
    )
    assert math.isfinite(wall) and wall > 0
    # warm-up 2 + 3 timed runs, one launch a pipeline chunk each
    assert hp.LAUNCHES["hash_partition_pack"] - before == 5 * C
    before = hp.LAUNCHES["hash_partition_pack"]
    autotune.measure_shuffle_config(make_mesh(8), "q", autotune.TableStats(65536, 16))
    assert hp.LAUNCHES["hash_partition_pack"] == before  # the plain pack


@pytest.mark.gpu
def test_cuda_calibrate_chip_fits_both_laws(cuda_device):
    rows = _phase_4d_rows()
    base = dataclasses.replace(topology.V5E, name=torch.cuda.get_device_name(0))
    cal = autotune.calibrate_chip(make_mesh(8), "q", chip=base, message_rows=rows)
    for f in CAL_FIELDS:
        assert math.isfinite(getattr(cal, f)) and getattr(cal, f) > 0, f
    n = 8
    load_sum = sum(autotune.schedule_ring_loads(autotune.make_schedule(n, "shift")))
    # neither slope at its 1e-15 floor
    assert cal.ici_link_bandwidth < load_sum / 1e-15 * 0.5
    assert cal.hbm_bandwidth < 1e15 * 0.5
