"""The sharding layer and the models' logical-axis trees against the
reference's (``repro.distributed.sharding``, every model's ``specs`` and
``cache_specs``).

For every config (smoke and full), the port's ``param_specs`` and
``cache_spec_fn()`` equal the reference's leaf for leaf: the port keeps a
list entry a layer where the reference stacks layers under leading
``None`` dims, which the comparison strips.  Every spec's rank equals its
leaf's (``init(..., device="meta")``, ``init_cache`` at batch 6 and
capacity 35, sizes some mesh factors do not divide).  ``logical_sharding``
resolves every such leaf, with and without ``allow_uneven`` and ``strict``,
to the reference's ``NamedSharding.spec`` on the ``(4, 2)`` ``data x
model`` and ``(2, 2, 2)`` ``pod x data x model`` meshes; the reference runs
ONCE, in a subprocess on 8 fake CPU devices
(``tests/_torch_sharding_ref_run.py``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import _MODULES, get_config, get_smoke_config
from repro_torch.core.exchange import Mesh, make_mesh
from repro_torch.distributed.sharding import (
    LOGICAL_AXES,
    AxisRules,
    MeshContext,
    build_shardings,
    default_rules,
    is_spec_leaf,
    logical_sharding,
    mesh_context,
    shard,
    unit_rules,
)
from repro_torch.models import registry
from repro_torch.models.convert import _stack_depth
from repro_torch.tree import leaves_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = [(arch, size) for arch in _MODULES for size in ("smoke", "full")]
CACHE_BATCH, CACHE_LEN = 6, 35
#: the reference's meshes, as axis sizes of the port's contexts
MESHES = {"data4_model2": ({"data": 4, "model": 2}, False),
          "pod2_data2_model2": ({"pod": 2, "data": 2, "model": 2}, True)}
FLAGS = [(uneven, strict) for uneven in (False, True) for strict in (False, True)]


def _cfg(arch, size):
    return (get_smoke_config if size == "smoke" else get_config)(arch)


def _listed(spec) -> list:
    return [a if a is None or isinstance(a, str) else list(a) for a in spec]


@pytest.fixture(scope="module")
def port():
    """Per config: the spec trees and every (shape, names) leaf pair."""
    out = {}
    for arch, size in CONFIGS:
        api = registry.build(_cfg(arch, size))
        params = api.init(0, device="meta")
        cache = api.init_cache(CACHE_BATCH, CACHE_LEN, device="meta")
        out[f"{arch}:{size}"] = {
            "specs": list(leaves_with_paths(api.param_specs)),
            "params": list(leaves_with_paths(params)),
            "cache_specs": list(leaves_with_paths(api.cache_spec_fn())),
            "cache": list(leaves_with_paths(cache)),
        }
    return out


@pytest.fixture(scope="module")
def pairs(port):
    """Every distinct (shape, names) leaf pair of every config's trees."""
    seen = {}
    for rec in port.values():
        for specs, tensors in ((rec["specs"], rec["params"]), (rec["cache_specs"], rec["cache"])):
            for (_, spec), (_, t) in zip(specs, tensors):
                seen.setdefault((tuple(t.shape), spec), len(seen))
    return seen


@pytest.fixture(scope="module")
def ref(pairs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    src, dst = tmp / "in.json", tmp / "out.json"
    src.write_text(json.dumps({"configs": CONFIGS,
                               "pairs": [[list(s), list(n)] for s, n in pairs]}))
    run = subprocess.run([sys.executable, os.path.join(HERE, "_torch_sharding_ref_run.py"),
                          str(src), str(dst)], capture_output=True, text=True, timeout=300)
    assert "PASS torch_sharding_ref" in run.stdout, run.stdout + run.stderr
    return json.loads(dst.read_text())


def _ref_leaf(tree, path):
    """The reference's spec for a port leaf path: list indices dropped (the
    reference stacks layers), and as many leading ``None`` dims stripped as
    the entry stacks."""
    node = tree
    for key in path:
        if not isinstance(key, int):
            node = node[key]
    depth = sum(isinstance(key, int) for key in path)
    assert depth == _stack_depth(path[0]), path
    assert node[:depth] == [None] * depth, (path, node)
    return node[depth:]


@pytest.mark.parametrize("arch,size", CONFIGS)
def test_param_specs_equal_reference(port, ref, arch, size):
    rec, want = port[f"{arch}:{size}"], ref["specs"][f"{arch}:{size}"]
    assert len(rec["specs"]) == len(rec["params"])
    for (path, spec), (ppath, t) in zip(rec["specs"], rec["params"]):
        assert path == ppath and len(spec) == t.ndim, (path, spec, tuple(t.shape))
        assert is_spec_leaf(spec) and all(n is None or n in LOGICAL_AXES for n in spec)
        assert _listed(spec) == _ref_leaf(want, path), path
    # and no reference leaf is missing from the port's tree
    got = {tuple(k for k in p if not isinstance(k, int)) for p, _ in rec["specs"]}

    def names(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from names(v, prefix + (k,))
        else:
            yield prefix

    assert got == set(names(want))


@pytest.mark.parametrize("arch,size", CONFIGS)
def test_cache_specs_equal_reference(port, ref, arch, size):
    rec, want = port[f"{arch}:{size}"], ref["cache_specs"][f"{arch}:{size}"]
    flat = {path: leaf for path, leaf in _flatten(want)}
    assert len(rec["cache_specs"]) == len(rec["cache"]) == len(flat)
    for (path, spec), (cpath, t) in zip(rec["cache_specs"], rec["cache"]):
        assert path == cpath and len(spec) == t.ndim, (path, spec, tuple(t.shape))
        assert _listed(spec) == flat[path], path


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch,size", CONFIGS)
def test_resolution_equals_reference(port, pairs, ref, arch, size, mesh_key):
    sizes, multi_pod = MESHES[mesh_key]
    rec = port[f"{arch}:{size}"]
    leaf_pairs = [(tuple(t.shape), spec) for specs, tensors in
                  ((rec["specs"], rec["params"]), (rec["cache_specs"], rec["cache"]))
                  for (_, spec), (_, t) in zip(specs, tensors)]
    for uneven, strict in FLAGS:
        ctx = MeshContext(make_mesh(8, 2 if multi_pod else 1),
                          rules=default_rules(multi_pod).replace(allow_uneven=uneven),
                          axis_sizes=sizes)
        want = ref["resolved"][f"{mesh_key}:{uneven}:{strict}"]
        for shape, spec in leaf_pairs:
            got = logical_sharding(shape, *spec, ctx=ctx, strict=strict)
            assert _listed(got) == want[pairs[(shape, spec)]], (shape, spec, uneven, strict)


def test_rules_port_the_reference_table():
    rules = default_rules(True)
    assert rules.spec_for("batch", None, "experts") == (("pod", "data"), None, "model")
    assert default_rules(False).table["batch"] == ("data",)
    wide = rules.replace(allow_uneven=True, heads=None)
    assert wide.allow_uneven and wide.table["heads"] is None and rules.table["heads"] == "model"
    assert isinstance(wide, AxisRules)
    assert set(rules.table) == set(LOGICAL_AXES)


def test_unit_rules_place_only_the_experts():
    """On the port's own mesh the experts dim goes over the joint unit axis,
    where the expert-parallel layer consumes it, and nothing else is
    split."""
    for rules, unit in ((unit_rules(True), ("pod", "q")), (unit_rules(False), ("q",))):
        assert {k: v for k, v in rules.table.items() if v} == {"experts": unit}
    ctx = MeshContext(make_mesh(8, 2))
    assert ctx.axis_sizes == {"pod": 2, "q": 4}
    assert logical_sharding((64, 2048, 1024), "experts", "expert_fsdp", None, ctx=ctx) == \
        (("pod", "q"), None, None)
    assert logical_sharding((12, 2048, 1024), "experts", None, None, ctx=ctx) == \
        (None, None, None)
    assert logical_sharding((64, 8), "experts", None, ctx=MeshContext(make_mesh(8))) == \
        ("q", None)
    spanning = MeshContext(Mesh(2, 4, num_processes=2, process_index=1))
    assert spanning.rules.table["experts"] == ("pod", "q")


def test_off_mesh_resolves_nothing_and_shard_is_an_identity():
    assert logical_sharding((4, 8), "batch", None) is None
    assert build_shardings({"w": ("experts", None)}, {"w": torch.zeros(8, 2)}) is None
    x = torch.arange(6.0).reshape(2, 3)
    with mesh_context(MeshContext(make_mesh(8, 2))):
        assert shard(x, "batch", "d_model") is x
        assert build_shardings({"w": ("experts", None)}, {"w": torch.zeros(8, 2)}) == \
            {"w": (("pod", "q"), None)}
    with pytest.raises(ValueError, match="rank-2"):
        shard(x, "batch")


def test_leftmost_name_wins_a_mesh_axis():
    ctx = MeshContext(make_mesh(8), rules=default_rules(False), axis_sizes={"data": 4, "model": 2})
    assert logical_sharding((8, 4, 6), "batch", "fsdp", "heads", ctx=ctx) == ("data", None, "model")
    assert logical_sharding((6, 4), "batch", "fsdp", ctx=ctx) == (None, "data")
    uneven = MeshContext(make_mesh(8), rules=default_rules(False).replace(allow_uneven=True),
                         axis_sizes={"data": 4, "model": 2})
    assert logical_sharding((6, 4), "batch", "fsdp", ctx=uneven) == ("data", None)
    assert logical_sharding((6, 4), "batch", "fsdp", ctx=uneven, strict=True) == (None, "data")
    assert logical_sharding((3, 4), "batch", "fsdp", ctx=uneven) == (None, "data")
