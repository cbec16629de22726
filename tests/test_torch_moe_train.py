"""MoE training with the experts sharded across processes (``train/step.py``'s
sharded state, ``models/moe.py``'s local token contract, the differentiable
pod hop of ``core/exchange.py``) and sharded checkpoints
(``checkpoint/ckpt.py``).

* **EP gradient against the reference.**  At OLMoE's smoke config with
  ``moe_impl="ep_shardmap"`` in f32, the port's one-process gradient on the
  flat 8-unit and the 2 x 4 mesh, from the reference's params
  (``models/convert.py``), equals ``jax.value_and_grad`` of the reference's
  ``train_loss`` under its ``shard_map`` on 8 fake devices: the loss within
  rel 1e-5, every leaf within ``1e-4 * max |b|``, each layer's per-unit drop
  counts bit-exact (ONE subprocess, ``tests/_torch_moe_train_ref_run.py``).
* **Across processes.**  ONE port cluster (2 Gloo processes x 4 units on
  the CPU) runs the ``moe_train`` scenario of
  ``tests/_torch_multiproc_driver.py`` at the smoke config (``remat="block"``,
  global batch 8 x 32): the sharded step against process 0's one-process
  8-unit step with the gates of ``chip_smoke.py`` phase 6c, the sharded init
  against the whole init sliced, and a checkpoint saved over the 2
  processes.  The test restores that checkpoint whole into this process and
  into a 4-process layout, bit for bit.
"""

import inspect
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt as C
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core.autotune import ep_capacity
from repro_torch.core.exchange import Mesh, make_mesh
from repro_torch.distributed.sharding import MeshContext, mesh_context
from repro_torch.launch.cluster import run_local_cluster
from repro_torch.models import convert, moe, registry
from repro_torch.train import TrainState
from repro_torch.train.step import Shard, make_grad_fn, state_shardings
from repro_torch.tree import leaves, leaves_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
PROCESSES, UNITS = 2, 4
SHAPE = (8, 32)


def _cfg(**kw):
    return get_smoke_config("olmoe-1b-7b").scaled(moe_impl="ep_shardmap", **kw)


def _expert(path) -> bool:
    return path[-1] in ("w_gate", "w_up", "w_down") and "ffn" in path


# ----------------------------------------------------------------------------
# The one-process EP gradient against the reference's.
# ----------------------------------------------------------------------------

def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    dst = tmp_path_factory.mktemp("moe_ref") / "out.npz"
    run = subprocess.run([sys.executable, os.path.join(HERE, "_torch_moe_train_ref_run.py"),
                          str(dst)], capture_output=True, text=True, timeout=600)
    assert "PASS torch_moe_train_ref" in run.stdout, run.stdout + run.stderr
    data = dict(np.load(dst))
    part = lambda tag: _nest({k.split(":", 1)[1]: v for k, v in data.items()  # noqa: E731
                              if k.startswith(tag + ":")})
    return {"params": convert.from_reference(part("param"), device="cpu"),
            "grads": {P: convert.from_reference(part(f"grad_pods{P}"), device="cpu")
                      for P in (1, 2)},
            "loss": {P: float(data[f"loss_pods{P}"]) for P in (1, 2)},
            "drops": {P: data[f"drops_pods{P}"] for P in (1, 2)},
            "batch": {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}}


@pytest.mark.parametrize("pods", [1, 2])
def test_ep_gradient_equals_reference(ref, pods):
    api = registry.build(_cfg(dtype="float32"))
    with mesh_context(MeshContext(make_mesh(8, pods))), moe.record_drops() as drops:
        loss, grads = make_grad_fn(api)(ref["params"], ref["batch"])
    assert abs(float(loss) - ref["loss"][pods]) <= 1e-5 * abs(ref["loss"][pods])
    want = dict(leaves_with_paths(ref["grads"][pods]))
    got = dict(leaves_with_paths(grads))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape, path
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), path
    # remat "none": one call a layer, each unit's drops as the reference's
    assert np.array_equal(torch.stack(drops).numpy(), ref["drops"][pods])
    assert ref["drops"][pods].sum() > 0  # the capacity binds somewhere


# ----------------------------------------------------------------------------
# Across processes: the driver's moe_train scenario.
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_train")
    outs = run_local_cluster(
        [DRIVER, "moe_train", "--moe-shape", "x".join(map(str, SHAPE)), "--moe-fabric-check",
         "--moe-ckpt", str(tmp / "ckpt"), "--dump", str(tmp)],
        num_processes=PROCESSES, local_units=UNITS, timeout_s=300, echo=False,
        backend="gloo", device="cpu", env={"OMP_NUM_THREADS": "2"},
    )
    assert all("PASS moe_train" in o for o in outs), outs
    recs = []
    for pid in range(PROCESSES):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            recs.append(json.load(f)["results"]["moe_train"]["check"])
    return {"recs": recs, "ckpt": tmp / "ckpt"}


def test_sharded_step_equals_the_one_process_step(cluster):
    rec = cluster["recs"][0]
    assert rec["loss_rel"] <= 1e-5
    assert rec["leaf_rel"] <= 1e-4 and rec["replicated_rel"] <= 1e-4
    assert max(rec["step_loss_rel"]) <= 1e-5
    assert max(rec["step_norm_rel"]) <= 1e-4
    assert rec["params_abs"] <= 1e-5
    for other in cluster["recs"][1:]:  # every process reports the synced metrics
        assert other["metrics"] == rec["metrics"]


@pytest.mark.parametrize("process", range(PROCESSES))
def test_each_process_expert_slice_equals_the_same_slice(cluster, process):
    assert cluster["recs"][0]["expert_slice_rel"][str(process)] <= 1e-4


def test_drop_counts_bit_exact(cluster):
    """Each unit's drops in every expert-parallel call of the first gradient
    (3 layers, the remat recompute calling again) equal the one-process
    run's."""
    rec = cluster["recs"][0]
    assert rec["drops_equal"] and len(rec["drops"]) == 2 * rec["layers"]
    assert sum(rec["drops"]) > 0


@pytest.mark.parametrize("process", range(PROCESSES))
def test_replicated_params_bit_identical_and_experts_held_once(cluster, process):
    rec = cluster["recs"][process]
    assert rec["ranks_identical"]
    # 3 layers x 3 expert leaves x (params, m, v), each this process's 4 of 8
    assert rec["expert_leaves"] == 27
    whole = registry.build(_cfg()).init(0, device="meta")
    expert = sum(t.numel() for p, t in leaves_with_paths(whole) if _expert(p))
    rest = sum(t.numel() for p, t in leaves_with_paths(whole) if not _expert(p))
    assert rec["state_bytes"] == 3 * 4 * (rest + expert // PROCESSES) + 2 * 4


def test_sharded_init_equals_the_whole_init_sliced(cluster):
    assert cluster["recs"][0]["init_equal"]


def test_pod_hop_backward_is_the_hop(cluster):
    for rec in cluster["recs"]:
        assert rec["hop_grad"] == {"xla": True, "round_robin": True}


def test_fabric_route_equals_the_multiplexer_route(cluster):
    rec = cluster["recs"][0]
    assert rec["fabric_loss_rel"] == 0.0 and rec["fabric_leaf_rel"] <= 1e-6


def test_pod_hop_bytes_a_step(cluster):
    """A step puts on the pod hop the replicated leaves' f32 gradient and the
    loss (one all-reduce each), the norm's one scalar, and 6 expert-parallel
    trips a layer (dispatch and combine, their remat recompute, their
    backward), each a process's units' messages to the other pod's units;
    never an expert gradient."""
    cfg = _cfg()
    whole = registry.build(cfg).init(0, device="meta")
    rest = sum(t.numel() for p, t in leaves_with_paths(whole) if not _expert(p))
    N, E = PROCESSES * UNITS, cfg.num_experts
    C = ep_capacity(SHAPE[0] * SHAPE[1] // N, cfg.top_k, E, cfg.capacity_factor)
    trip = UNITS * UNITS * (E // N) * C * cfg.d_model * 4
    want = 4 * (rest + 1) + 4 + 6 * cfg.num_layers * trip
    for rec in cluster["recs"]:
        assert rec["step_hop_bytes"] == [want] * 3
        assert rec["grad_hop"]["bytes"] == want - 4


def _sharded_ckpt(cluster):
    return str(cluster["ckpt"] / "sharded"), str(cluster["ckpt"] / "whole")


def test_sharded_checkpoint_restores_whole_bit_exact(cluster):
    sharded, whole = _sharded_ckpt(cluster)
    like = TrainState.create(registry.build(_cfg()), 1, device="cpu")
    got = restore_checkpoint(sharded, None, like)
    want = restore_checkpoint(whole, None, like)
    assert latest_step(sharded) == 3 and int(got.step) == 3
    with open(os.path.join(sharded, "step_00000003", C.MANIFEST)) as f:
        manifest = json.load(f)["leaves"]
    for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
        assert torch.equal(g, w), path
        assert len(manifest[C._name(path)]["shards"]) == (PROCESSES if _expert(path) else 1)


@pytest.mark.parametrize("process", range(4))
def test_sharded_checkpoint_restores_into_another_layout(cluster, process):
    """Saved over 2 processes (4 experts each), restored over 4 (2 each)."""
    sharded, whole = _sharded_ckpt(cluster)
    api = registry.build(_cfg())
    mesh = Mesh(4, 2, num_processes=4, process_index=process)
    shardings = state_shardings(api, MeshContext(mesh))
    like = TrainState.create(api, 1, device="cpu", shardings=shardings)
    got = restore_checkpoint(sharded, 3, like, shardings=shardings)
    want = restore_checkpoint(whole, 3, TrainState.create(api, 1, device="cpu"))
    for (path, g), w, held in zip(leaves_with_paths(got), leaves(want), leaves(shardings)):
        if _expert(path):
            assert held == Shard(0, 2 * process, 2 * process + 2, 8) and g.shape[0] == 2
            w = w[held.start:held.stop]
        assert torch.equal(g, w), path


# ----------------------------------------------------------------------------
# In process: placement, the sharded init, checkpoints.
# ----------------------------------------------------------------------------

def test_state_shardings_place_the_experts_over_the_processes():
    api = registry.build(_cfg())
    assert state_shardings(api) is None
    assert state_shardings(api, MeshContext(make_mesh(8, 2))) is None  # one process
    for rank in range(2):
        sh = state_shardings(api, MeshContext(Mesh(2, 4, num_processes=2, process_index=rank)))
        for tree in (sh.params, sh.opt["m"], sh.opt["v"]):
            for path, held in leaves_with_paths(tree):
                assert held == (Shard(0, 4 * rank, 4 * rank + 4, 8) if _expert(path) else None)
        assert sh.step is None and sh.opt["count"] is None
    # no expert leaves, nothing split
    dense = registry.build(get_smoke_config("train100m"))
    sh = state_shardings(dense, MeshContext(Mesh(2, 4, num_processes=2, process_index=0)))
    assert all(h is None for h in leaves(sh))


@pytest.mark.parametrize("rank", range(2))
def test_sharded_create_equals_the_whole_state_sliced(rank):
    api = registry.build(_cfg())
    sh = state_shardings(api, MeshContext(Mesh(2, 4, num_processes=2, process_index=rank)))
    got = TrainState.create(api, 3, device="cpu", shardings=sh)
    want = TrainState.create(api, 3, device="cpu")
    for (path, g), w, held in zip(leaves_with_paths(got), leaves(want), leaves(sh)):
        if held is not None:
            w = w.narrow(held.dim, held.start, held.stop - held.start)
            assert g.untyped_storage().nbytes() == g.numel() * g.element_size(), path
        assert torch.equal(g, w), path


def test_hierarchical_moe_on_one_process_runs_each_unit_through_every_unit():
    """What ``grad_sync="hierarchical"`` does with the MoE family on a mesh
    inside one process (ROADMAP §C): each unit's rows run through the whole
    8-unit expert-parallel layer, with a capacity sized for those rows, and
    the gradients are averaged over the units; with no drops it equals the
    ``"auto"`` step."""
    cfg = _cfg(capacity_factor=8.0)
    state = TrainState.create(registry.build(cfg), 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with mesh_context(MeshContext(make_mesh(8, 2))), moe.record_drops() as drops:
        a_loss, a_grads = make_grad_fn(registry.build(cfg))(state.params, batch)
        h_loss, h_grads = make_grad_fn(registry.build(cfg.scaled(grad_sync="hierarchical")))(
            state.params, batch)
    # 3 layers for the auto pass, 3 for each of the 8 unit passes; each call
    # spreads one unit's 16 tokens over all 8 units
    assert len(drops) == 3 + 8 * 3 and all(d.shape == (8,) for d in drops)
    assert abs(float(h_loss) - float(a_loss)) <= 1e-6 * abs(float(a_loss))
    for (path, h), a in zip(leaves_with_paths(h_grads), leaves(a_grads)):
        assert float((h - a).abs().max()) <= 1e-5 * float(a.abs().max()), path


def test_interrupted_save_leaves_the_previous_checkpoint_readable(monkeypatch):
    api = registry.build(_cfg())
    first = TrainState.create(api, 0, device="cpu")
    second = TrainState.create(api, 1, device="cpu")
    calls = {"n": 0}
    real = np.save

    def crash(*args, **kw):
        calls["n"] += 1
        if calls["n"] > 5:
            raise OSError("disk gone")
        return real(*args, **kw)

    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, first)
        monkeypatch.setattr(C.np, "save", crash)
        with pytest.raises(OSError, match="disk gone"):
            save_checkpoint(d, 2, second)
        monkeypatch.setattr(C.np, "save", real)
        assert os.path.isdir(os.path.join(d, "step_00000002.tmp"))
        assert latest_step(d) == 1
        got = restore_checkpoint(d, None, TrainState.create(api, 2, device="cpu"))
        for a, b in zip(leaves(got), leaves(first)):
            assert torch.equal(a, b)
        save_checkpoint(d, 2, second)  # a later save clears the stale .tmp
        assert latest_step(d) == 2 and not os.path.exists(os.path.join(d, "step_00000002.tmp"))


def test_one_file_a_leaf_checkpoints_still_restore():
    """The layout the port wrote before the sharded one: a ``file`` a leaf."""
    tree = {"w": torch.randn(3, 5), "b": [torch.arange(4, dtype=torch.int32)],
            "h": torch.randn(2, 2).bfloat16()}
    with tempfile.TemporaryDirectory() as d:
        step_dir = os.path.join(d, "step_00000007")
        os.makedirs(step_dir)
        entries = {}
        for path, t in leaves_with_paths(tree):
            fn = C._name(path).replace("/", "_") + ".npy"
            np.save(os.path.join(step_dir, fn), C._to_numpy(t))
            entries[C._name(path)] = {"file": fn, "shape": list(t.shape),
                                      "dtype": str(t.dtype).removeprefix("torch.")}
        with open(os.path.join(step_dir, C.MANIFEST), "w") as f:
            json.dump({"step": 7, "leaves": entries}, f)
        got = restore_checkpoint(d, None, {"w": torch.zeros(3, 5),
                                           "b": [torch.zeros(4, dtype=torch.int32)],
                                           "h": torch.zeros(2, 2, dtype=torch.bfloat16)})
        part = restore_checkpoint(d, 7, {"w": torch.zeros(1, 5)},
                                  shardings={"w": Shard(0, 2, 3, 3)})
    for a, b in zip(leaves(got), leaves(tree)):
        assert torch.equal(a, b)
    assert torch.equal(part["w"], tree["w"][2:3])


def test_from_reference_defaults_to_the_card():
    assert inspect.signature(convert.from_reference).parameters["device"].default == "cuda"
