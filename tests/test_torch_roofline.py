"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), and its measured side.

``model_flops``, ``_cache_bytes`` and ``ideal_memory_bytes`` equal the
reference's for every ``ARCH_IDS`` x ``shapes_for`` cell (each side with
its own config; both given the reference's parameter counts, which
``tests/test_torch_models.py`` holds the port's to);
``RooflineTerms.row()`` and ``format_table`` for one artifact equal the
reference's under ``V5E`` (the default chip); ``H100_SXM`` divides by the
H100's published peaks.  ``trace_overlap`` gives exact values on a
hand-written chrome trace and finds the process fabric's ``exchange.*``
spans in a real CPU ``torch.profiler`` trace; ``measured_row`` gives MFU.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import shapes_for as ref_shapes_for
from repro.launch import roofline as ref_rl
from repro.models import registry as ref_registry
from repro_torch.configs import ARCH_IDS, get_config, shapes_for
from repro_torch.core.topology import H100_SXM, V5E
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.train.step import process_mean


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_cache_and_ideal_bytes_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    ref_act = n_act = ref_registry.param_count(ref_cfg, active_only=True)
    ref_tot = n_tot = ref_registry.param_count(ref_cfg)
    assert [s.name for s in shapes_for(cfg)] == [s.name for s in ref_shapes_for(ref_cfg)]
    for shape in shapes_for(cfg):
        ref_shape = REF_SHAPES[shape.name]
        for mb in (1, 4):
            assert rl.ideal_memory_bytes(cfg, shape, n_act, n_tot, mb) == \
                ref_rl.ideal_memory_bytes(ref_cfg, ref_shape, ref_act, ref_tot, mb)
        assert rl.model_flops(cfg, shape, n_act) == ref_rl.model_flops(ref_cfg, ref_shape,
                                                                      ref_act)
        assert rl._cache_bytes(cfg, shape) == ref_rl._cache_bytes(ref_cfg, ref_shape)


ARTIFACT = {
    "arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "4x2", "chips": 4,
    "cost_analysis": {"flops": 3.25e15, "bytes accessed": 7.5e13},
    "collective_bytes": {"all-reduce": 1_906_581_512, "collective-permute": 12_079_595_520},
    "async_collective_bytes": {}, "model_flops": 1.7e16, "ideal_bytes": 5.3e11,
}


def test_row_and_table_equal_the_reference_under_v5e():
    terms, ref = rl.from_artifact(ARTIFACT), ref_rl.from_artifact(ARTIFACT)
    assert terms.chip is V5E
    assert terms.row() == ref.row()
    other = dict(ARTIFACT, arch="mamba2-1.3b", shape="decode_32k", mesh="1x8", chips=1,
                 collective_bytes={}, model_flops=3.4e11, ideal_bytes=1.4e11)
    assert rl.format_table([terms, rl.from_artifact(other)]) == \
        ref_rl.format_table([ref, ref_rl.from_artifact(other)])


def test_h100_terms_divide_by_its_published_peaks():
    t = rl.from_artifact(ARTIFACT, chip=H100_SXM)
    assert (H100_SXM.peak_flops_bf16, H100_SXM.hbm_bandwidth, H100_SXM.ici_link_bandwidth,
            H100_SXM.hbm_bytes) == (989e12, 3.35e12, 450e9, 80 * 10**9)
    assert t.compute_s == 3.25e15 / 989e12
    assert t.memory_s == 7.5e13 / 3.35e12
    assert t.collective_s == (1_906_581_512 + 12_079_595_520) / 450e9
    assert t.ideal_s == max(1.7e16 / 4 / 989e12, 5.3e11 / 4 / 3.35e12)
    m = rl.measured_row(t, 2.0)
    assert m["mfu"] == 1.7e16 / 4 / (2.0 * 989e12)
    assert m["ideal_over_step"] == t.ideal_s / 2.0


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_overlap_on_a_hand_written_trace(tmp_path):
    trace = {"traceEvents": [
        _x("aten::mm", "cpu_op", -10, 5),
        _x("sm90_gemm", "kernel", 0, 100),
        _x("ncclDevKernel_AllReduce_Sum_f32", "kernel", 50, 100),
        _x("exchange.all-reduce", "user_annotation", 140, 60),
        _x("exchange.all-reduce", "gpu_user_annotation", 0, 200),  # device-side: not counted
        _x("elementwise_kernel", "kernel", 180, 40),
        _x("Memcpy DtoH", "gpu_memcpy", 300, 10),
        {"ph": "i", "name": "marker", "ts": 1000},
    ]}
    got = rl.trace_overlap(trace)
    want = {"window_s": 320e-6, "collective_s": 150e-6, "compute_s": 140e-6,
            "overlapped_s": 70e-6, "overlap_fraction": 70 / 150, "device_busy": 190 / 320,
            "idle_share": 1 - 190 / 320}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-15), k
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    assert rl.trace_overlap(str(path)) == got
    assert rl.trace_overlap({"traceEvents": []})["overlap_fraction"] == 0.0


def test_trace_overlap_finds_the_exchange_spans_in_a_cpu_profile(tmp_path):
    tree = {"g": torch.ones((64, 64)), "b": torch.ones(64)}
    with dryrun.fake_processes(2) as group:
        mesh = dryrun.layout_mesh(2, 4, group)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            process_mean(tree, mesh)
    path = tmp_path / "cpu_trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("name") == "exchange.all-reduce" and e.get("cat") == "user_annotation"]
    assert len(spans) == 2  # one all-reduce a leaf
    got = rl.trace_overlap(str(path))
    assert got["collective_s"] > 0 and got["window_s"] >= got["collective_s"]
    assert (got["compute_s"], got["overlap_fraction"], got["device_busy"]) == (0.0, 0.0, 0.0)
