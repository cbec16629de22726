"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), and its cells.

Against the reference: ``SHAPES``, ``shapes_for`` and ``ARCH_IDS``;
``MICROBATCHES`` and ``dryrun_config`` for every arch x shape x
``multi_pod`` (the reference's module sets the fake-device count when it is
imported, so it runs ONCE, in a subprocess); ``input_specs`` (shapes,
dtypes, logical axes) for every arch x shape; ``param_shape_specs`` (smoke
configs) and ``cache_shape_specs`` (full configs at ``decode_32k``) numel
per leaf, the reference's stacked layer dims summed over the port's list
entries.  The port's cells: every family and kind at a smoke size on
``1x8`` and ``4x2`` (serving on ``4x2`` with each rank's rows of the
batch), with every op on ``meta``; a dense train, prefill and decode cell's
flops on ``4x2`` times 4 equal ``1x8``'s; ``long_500k``'s one row counted
whole on ``4x2``; the microbatch count multiplied out equals the looped
step's count, key for key; the skipped cells' reasons; Mamba2-1.3B's
``long_500k`` at full size counted in under 30 s; ``ssd_scan``'s launch
scratch held on ``meta``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import shapes_for as ref_shapes_for
from repro.models import registry as ref_registry
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, get_smoke_config, \
    shapes_for
from repro_torch.kernels import ssd_scan as sk
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models import registry
from repro_torch.tree import leaves_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
REF_DUMP = """
import dataclasses, json, sys
from repro.configs import ARCH_IDS
from repro.configs.base import SHAPES
from repro.launch import dryrun
out = {"MICROBATCHES": dryrun.MICROBATCHES, "configs": {}}
for arch in ARCH_IDS:
    for name, shape in SHAPES.items():
        for mp in (False, True):
            cfg = dryrun.dryrun_config(arch, shape, multi_pod=mp)
            out["configs"][f"{arch}|{name}|{mp}"] = dataclasses.asdict(cfg)
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_DUMP], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    return json.loads(out.stdout)


def _jsonable(d: dict) -> dict:
    return json.loads(json.dumps(d))


def test_shapes_and_arch_ids_equal_the_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in ARCH_IDS:
        assert [s.name for s in shapes_for(get_config(arch))] == \
            [s.name for s in ref_shapes_for(ref_get_config(arch))]
        assert get_config(arch).supports_long_context == \
            ref_get_config(arch).supports_long_context


def test_dryrun_config_equals_the_reference(ref_dryrun):
    assert dryrun.MICROBATCHES == ref_dryrun["MICROBATCHES"]
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            for mp in (False, True):
                got = _jsonable(dataclasses.asdict(dryrun.dryrun_config(arch, shape,
                                                                        multi_pod=mp)))
                assert got == ref_dryrun["configs"][f"{arch}|{name}|{mp}"], (arch, name, mp)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        specs, axes = registry.input_specs(cfg, shape)
        ref_specs, ref_axes = ref_registry.input_specs(ref_cfg, REF_SHAPES[name])
        assert axes == ref_axes
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."), v.device.type)
                for k, v in specs.items()} == \
            {k: (tuple(v.shape), str(v.dtype), "meta") for k, v in ref_specs.items()}


def _numel_by_path(tree) -> dict:
    """numel per leaf path, list indices (the port's layers) dropped."""
    out: dict = {}
    for path, leaf in leaves_with_paths(tree):
        key = tuple(k for k in path if not isinstance(k, int))
        out[key] = out.get(key, 0) + leaf.numel()
    return out


def _ref_numel_by_path(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): int(leaf.size) for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_shape_specs_match_the_reference_numel(arch):
    params, p_axes = registry.param_shape_specs(get_smoke_config(arch))
    ref_params, _ = ref_registry.param_shape_specs(ref_get_smoke_config(arch))
    assert all(t.device.type == "meta" for _, t in leaves_with_paths(params))
    assert _numel_by_path(params) == _ref_numel_by_path(ref_params)
    assert len(list(leaves_with_paths(p_axes))) == len(list(leaves_with_paths(params)))
    cache, c_axes = registry.cache_shape_specs(get_config(arch), SHAPES["decode_32k"])
    ref_cache, ref_c_axes = ref_registry.cache_shape_specs(ref_get_config(arch),
                                                           REF_SHAPES["decode_32k"])
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in leaves_with_paths(cache)} == \
        {tuple(k.key for k in p): (tuple(t.shape), str(t.dtype))
         for p, t in jax.tree_util.tree_flatten_with_path(ref_cache)[0]}
    assert _jsonable(c_axes) == _jsonable(ref_c_axes)


FAMILIES = ("minicpm-2b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-7b", "whisper-medium",
            "qwen2-vl-2b")  # dense, moe, ssm, hybrid, encdec, vlm
SMOKE_SHAPES = {"train": ShapeSpec("train", 64, 16, "train"),
                "prefill": ShapeSpec("prefill", 64, 8, "prefill"),
                "decode": ShapeSpec("decode", 64, 8, "decode")}


def _smoke_cfg(arch, kind, **over):
    cfg = get_smoke_config(arch)
    policy = dict(dtype="bfloat16", remat="block")
    if cfg.num_experts:
        policy["moe_impl"] = "ep_shardmap" if kind != "decode" else "gspmd"
    return cfg.scaled(**policy, **over)


class _MetaOnly(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the device of every op's tensor outputs but the 0-dim
    constants a Python scalar becomes (``torch.tensor(x)``: ``lift_fresh``
    on the CPU, as on any device)."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and (t.dim() or func != torch.ops.aten.lift_fresh.default):
                self.devices.add(t.device.type)
        return out


# every family and kind on 1x8 and 4x2 (serving: each rank its rows of the batch)
CELLS = [(arch, kind, layout) for arch in FAMILIES for kind in ("train", "prefill", "decode")
         for layout in ("1x8", "4x2")]


@pytest.mark.parametrize("arch,kind,layout", CELLS)
def test_smoke_cells_run_on_meta(arch, kind, layout):
    processes, units = (int(v) for v in layout.split("x"))
    cfg = _smoke_cfg(arch, kind)
    spy = _MetaOnly()
    with spy:
        r = dryrun.count_cell(cfg, SMOKE_SHAPES[kind], processes, units)
    assert spy.devices == {"meta"}
    assert r["flops"] > 0 and r["bytes"] > 0 and r["peak_live_bytes"] > 0
    assert r["argument_bytes"] > 0 and r["output_bytes"] > 0
    want = None  # decode runs no kernel: the SSMs' one-token recurrence, the dense MoE
    if kind != "decode":
        want = {"mamba2-1.3b": "ssd_scan", "zamba2-7b": "ssd_scan",
                "olmoe-1b-7b": "moe_dispatch"}.get(arch)
    assert list(r["kernels"]) == ([want] if want else [])
    # across processes a train step syncs its gradient; a serving cell's rows
    # cross no process but through the expert-parallel layer (OLMoE's prefill)
    crosses = kind == "train" or (arch == "olmoe-1b-7b" and kind == "prefill")
    assert bool(r["collective_bytes"]) == (processes > 1 and crosses)
    assert not torch.distributed.is_initialized()


def test_dense_train_flops_on_4x2_times_4_equal_1x8():
    cfg = _smoke_cfg("qwen2.5-3b", "train", num_microbatches=2)
    one = dryrun.count_cell(cfg, SMOKE_SHAPES["train"], 1, 8)
    four = dryrun.count_cell(cfg, SMOKE_SHAPES["train"], 4, 2)
    assert 4 * four["flops"] == one["flops"]
    assert one["collective_bytes"] == {}
    # one all-reduce a leaf of the f32 gradient, the loss and the norm's scalar
    assert set(four["collective_bytes"]) == {"all-reduce"}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b"])
def test_microbatches_multiplied_equal_the_looped_step(arch):
    cfg = _smoke_cfg(arch, "train", num_microbatches=3)
    shape = ShapeSpec("train", 64, 24, "train")  # 6 rows a process, 2 a microbatch
    multiplied = dryrun.count_cell(cfg, shape, 4, 2)
    with dryrun.fake_processes(4) as group:
        mesh = dryrun.layout_mesh(4, 2, group)
        ctx = dryrun.MeshContext(mesh)
        mux = (dryrun.use_multiplexer(dryrun.make_multiplexer(mesh, pack_impl="cuda"))
               if cfg.num_experts else dryrun.contextlib.nullcontext())
        with dryrun.mesh_context(ctx), mux:
            fn, args = dryrun.build_cell(registry.build(cfg), shape, ctx)
            counter = OpCounter()
            with counter.counting():
                fn(*args)
    looped = counter.result()
    assert looped["regions"]["microbatch"]["flops"] > 0
    for key in ("flops", "bytes", "collective_bytes"):
        assert multiplied[key] == looped[key], key
    assert multiplied["argument_bytes"] == dryrun._nbytes(args)


def test_skipped_cells_say_why():
    art = dryrun.run_cell("qwen2.5-3b", "long_500k", False, verbose=False)
    assert (art["status"], art["reason"]) == ("skipped", dryrun.LONG_CONTEXT_REASON)
    # serving across processes is counted: each rank holds 8 of the 32 rows
    art = dryrun.run_cell("mamba2-1.3b", "prefill_32k", True, verbose=False)
    assert (art["status"], art["mesh"], art["chips"]) == ("ok", "4x2", 4)
    one = dryrun.run_cell("mamba2-1.3b", "prefill_32k", False, verbose=False)
    assert 4 * art["cost_analysis"]["flops"] == one["cost_analysis"]["flops"]
    assert art["kernels"]["ssd_scan"]["calls"] == get_config("mamba2-1.3b").num_layers


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dense_serving_flops_on_4x2_times_4_equal_1x8(kind):
    cfg = _smoke_cfg("qwen2.5-3b", kind)
    one = dryrun.count_cell(cfg, SMOKE_SHAPES[kind], 1, 8)
    four = dryrun.count_cell(cfg, SMOKE_SHAPES[kind], 4, 2)
    assert 4 * four["flops"] == one["flops"]
    assert one["collective_bytes"] == four["collective_bytes"] == {}
    assert four["argument_bytes"] < one["argument_bytes"]  # a quarter of the rows and cache


def test_long_500k_on_4x2_counts_a_replicated_batch():
    """One row over four ranks: the batch and the cache stay whole on every
    rank, so rank 0 counts what one process counts."""
    one = dryrun.run_cell("mamba2-1.3b", "long_500k", False, verbose=False)
    four = dryrun.run_cell("mamba2-1.3b", "long_500k", True, verbose=False)
    assert four["status"] == "ok" and four["mesh"] == "4x2"
    assert four["cost_analysis"] == one["cost_analysis"]
    assert four["memory_analysis"] == one["memory_analysis"]
    assert four["collective_bytes"] == {}


def test_ssd_scan_on_meta_holds_its_launch_scratch():
    """The wrapper's ``meta`` branch allocates the launch's f32 scratch
    (chunk states, scores, cumsums), so a counter's peak holds it."""
    Bt, L, H, P, G, N, Q = 2, 512, 4, 16, 1, 16, 128
    meta = dict(device="meta")
    x = torch.empty((Bt, L, H, P), **meta)
    dt = torch.empty((Bt, L, H), **meta)
    A = torch.empty((H,), **meta)
    Bm = torch.empty((Bt, L, G, N), **meta)
    counter = OpCounter()
    with counter.counting():
        y, fin = sk.ssd_scan(x, dt, A, Bm, Bm, Q)
    nc = L // Q
    scratch = 4 * (Bt * nc * H * N * P + Bt * nc * G * Q * Q + Bt * H * L)
    outputs = 4 * (x.numel() + Bt * H * P * N)
    assert counter.result()["peak_live_bytes"] >= scratch + outputs
    assert (y.shape, fin.shape) == (x.shape, (Bt, H, P, N))


def test_mamba2_long_500k_full_size_counts_in_under_30_s(tmp_path):
    t0 = time.perf_counter()
    art = dryrun.run_cell("mamba2-1.3b", "long_500k", False, str(tmp_path), verbose=False)
    assert time.perf_counter() - t0 < 30
    assert art["status"] == "ok" and art["mesh"] == "1x8" and art["chips"] == 1
    assert art["kernels"] == {}  # decode is the one-token recurrence, no scan kernel
    assert art["roofline"]["arch"] == "mamba2-1.3b" and art["chip"] == "h100-sxm"
    saved = json.loads((tmp_path / "mamba2-1.3b__long_500k__1x8.json").read_text())
    assert saved["cost_analysis"] == art["cost_analysis"]
    for key in ("memory_analysis", "cost_analysis", "collective_bytes",
                "async_collective_bytes", "unknown_trip_whiles", "count_s", "params",
                "active_params", "model_flops", "ideal_bytes", "roofline"):
        assert key in art, key
