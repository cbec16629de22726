"""Serving across REAL processes (2 x 4 units over Gloo on the CPU): the
static engine (``serve/engine.py``) with its batch split over a mesh that
spans processes.

ONE port cluster (``repro_torch.launch.cluster``) runs the ``serve`` scenario
of ``tests/_torch_multiproc_driver.py`` at five families' smoke configs, a
global batch of 4 x 16-token prompts + 4 new (2 rows a process), and dumps
each process's numbers: Qwen2.5-3B (dense), OLMoE-1B-7B (expert-parallel:
its prefill's 64 tokens over the 8 units under ``moe_tokens="local"`` on the
two-level mesh, its decode steps' 4 tokens, which the 8 units do not divide,
through the dense path on both sides), Mamba2-1.3B, Whisper-medium (the
frames split with the rows) and Qwen2-VL-2B (the patches split).  Process 0
holds each split run to its own one-process engine on the whole batch over
the same 8 units; the one-process engine is held to the reference by
``tests/test_torch_serve.py``, ``tests/test_torch_models.py``,
``tests/test_torch_ssm.py`` and ``tests/test_torch_whisper.py``, so this
chain holds the split engine to the reference.  Gates: greedy tokens equal,
each call's logits within ``1e-5 * max |b|``, the per-unit drop counts
bit-exact, the pod hop's bytes equal to a count derived here from the
configs.  Also: a batch of 3 over the 2 processes runs whole on each
(``stats["rows"] == "replicated"``), and the continuous engine raises.  In
process: the rows helpers, the engine's ``"whole"`` mode, and the MoE
layer's dense path for a process's own tokens.
"""

import json
import os

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.autotune import ep_capacity
from repro_torch.core.exchange import Mesh, make_mesh
from repro_torch.distributed.sharding import (
    MeshContext,
    gather_rows,
    local_rows,
    mesh_context,
    split_rows,
)
from repro_torch.launch.cluster import run_local_cluster
from repro_torch.models import moe, registry
from repro_torch.serve import Request, ServeEngine

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
PROCESSES, UNITS = 2, 4
ARCHS = ["qwen2.5-3b", "olmoe-1b-7b", "mamba2-1.3b", "whisper-medium", "qwen2-vl-2b"]
B, S, NEW = 4, 16, 4
ODD_BATCH = 3


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    outs = run_local_cluster(
        [DRIVER, "serve", "--serve-cells", ",".join(f"{a}:0:{B}x{S}x{NEW}" for a in ARCHS),
         "--serve-replicated", f"qwen2.5-3b:{ODD_BATCH}", "--dump", str(tmp)],
        num_processes=PROCESSES, local_units=UNITS, timeout_s=300, echo=False,
        backend="gloo", device="cpu", env={"OMP_NUM_THREADS": "2"},
    )
    assert all("PASS serve" in o for o in outs), outs
    got = []
    for pid in range(PROCESSES):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            got.append(json.load(f)["results"]["serve"])
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_split_engine_equals_the_one_process_engine(dumps, arch):
    rec = dumps[0]["archs"][arch]
    assert rec["rows"] == "split"
    assert rec["tokens_equal"]
    assert [len(t) for t in rec["tokens"]] == [NEW] * B
    assert len(rec["logit_rel"]) == NEW  # the prefill and every decode step
    assert max(rec["logit_rel"]) <= 1e-5
    assert rec["drops_equal"]
    # every process fills every request with the same tokens
    for other in dumps[1:]:
        assert other["archs"][arch]["tokens"] == rec["tokens"]
        assert other["archs"][arch]["tokens_equal_on_every_process"]


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_hop_carries_the_gathered_tokens_and_the_expert_trips(dumps, arch):
    """A process's int32 tokens of its rows once a call; for the MoE layer's
    expert-parallel calls, the dispatch and the combine of the process's 4
    units' capacity buffers to the other process's 4 units."""
    cfg = get_smoke_config(arch)
    rows = B // PROCESSES
    want = NEW * rows * 4
    if cfg.num_experts:
        N, E = PROCESSES * UNITS, cfg.num_experts
        C = ep_capacity(rows * S // UNITS, cfg.top_k, E, cfg.capacity_factor)
        want += cfg.num_layers * 2 * UNITS * (N - UNITS) * (E // N) * C * cfg.d_model * 4
    for d in dumps:
        rec = d["archs"][arch]
        assert rec["hop_bytes"] == rec["want_hop"]["total"] == want
        assert rec["hop_kinds"].get("all-gather") == NEW * rows * 4


def test_moe_prefill_is_expert_parallel_and_its_decode_dense(dumps):
    """The prefill's 64 tokens split over the 8 units; a decode step's 4 do
    not, and both sides take the dense path; the drops are those of the
    prefill's expert-parallel calls, one a layer, bit-exact."""
    layers = get_smoke_config("olmoe-1b-7b").num_layers
    for d in dumps:
        rec = d["archs"]["olmoe-1b-7b"]
        assert rec["expert_calls"] == layers
        assert set(rec["hop_kinds"]) == {"collective-permute", "all-gather"}
    rec = dumps[0]["archs"]["olmoe-1b-7b"]
    assert len(rec["drops"]) == layers and rec["drops_equal"]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-medium", "qwen2-vl-2b"])
def test_no_expert_trips_where_no_layer_crosses_processes(dumps, arch):
    for d in dumps:
        rec = d["archs"][arch]
        assert rec["want_hop"]["expert_trips"] == 0 and rec["expert_calls"] == 0
        assert set(rec["hop_kinds"]) == {"all-gather"}


def test_indivisible_batch_is_replicated_and_says_so(dumps):
    split = dumps[0]["archs"]["qwen2.5-3b"]["tokens"]
    for d in dumps:
        rep = d["replicated"]
        assert (rep["batch"], rep["rows"]) == (ODD_BATCH, "replicated")
        assert rep["hop_bytes"] == 0  # every process runs the whole batch: nothing to gather
        assert rep["tokens_equal_on_every_process"]
        assert rep["tokens"] == split[:ODD_BATCH]


def test_continuous_engine_raises_across_processes(dumps):
    for d in dumps:
        msg = d["continuous_raises"]
        assert msg and "processes" in msg and "8(b)" in msg


@pytest.mark.parametrize("arch", ARCHS)
def test_split_run_makes_the_same_calls_on_every_process(dumps, arch):
    for d in dumps:
        s = d["archs"][arch]["stats"]
        assert s["decode_steps"] == NEW - 1 and s["slot_steps"] == B * (NEW - 1)
        assert s["prefill_tokens"] == B * S


# ----------------------------------------------------------------------------
# In process: the rows helpers, the engine off a process-spanning mesh, and
# the MoE layer's dense path for a process's own tokens.
# ----------------------------------------------------------------------------

def _fake_mesh(rank: int) -> Mesh:
    """Rank ``rank`` of a 2 x 4 mesh over 2 processes, with no group: enough
    for what needs no collective."""
    return Mesh(PROCESSES, UNITS, PROCESSES, rank)


def test_split_rows_and_local_rows():
    mesh = _fake_mesh(1)
    assert split_rows(8, mesh) and not split_rows(3, mesh)
    assert split_rows(3, make_mesh(8))  # one process divides every batch
    batch = {"tokens": torch.arange(8).reshape(4, 2), "frames": torch.arange(12).reshape(4, 3)}
    mine = local_rows(batch, mesh)
    assert torch.equal(mine["tokens"], batch["tokens"][2:]) and torch.equal(
        mine["frames"], batch["frames"][2:])
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        local_rows({"tokens": torch.zeros(3, 2)}, mesh)
    t = torch.arange(6)
    assert gather_rows(t, make_mesh(8)) is t  # one process: nothing to gather


def test_engine_in_one_process_runs_whole_rows():
    cfg = get_smoke_config("qwen2.5-3b")
    api = registry.build(cfg)
    params = api.init(0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    outs = {}
    for ctx in (None, MeshContext(make_mesh(8, 2))):
        engine = ServeEngine(api, batch_size=2, capacity=16, device="cpu")
        reqs = [Request(prompt=p.numpy(), max_new_tokens=3) for p in prompts]
        with mesh_context(ctx):
            engine.generate(params, reqs)
        assert engine.stats["rows"] == "whole"
        outs[ctx is None] = [r.out_tokens for r in reqs]
    assert outs[True] == outs[False]


def test_local_tokens_take_the_dense_path_with_whole_expert_leaves():
    """Across processes under ``moe_tokens="local"``, tokens the units do not
    divide go through the dense path on this process's own tokens when the
    expert leaves are whole (serving), and raise when they are this
    process's shard (the train state)."""
    cfg = get_smoke_config("olmoe-1b-7b").scaled(moe_impl="ep_shardmap")
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe_layer(gen, cfg)
    x = torch.randn((2, cfg.d_model), generator=gen)  # 2 tokens a process, 4 over 8 units
    ctx = MeshContext(_fake_mesh(0), moe_tokens="local")
    with mesh_context(ctx):
        assert torch.equal(moe.moe_ep(params, cfg, x), moe.moe_dense(params, cfg, x))
        held = {k: (v[: cfg.num_experts // 2] if k.startswith("w_") else v)
                for k, v in params.items()}
        with pytest.raises(ValueError, match="must both split"):
            moe.moe_ep(held, cfg, x)
