"""Serving across REAL processes (2 x 4 units over Gloo on the CPU): both
engines (``serve/engine.py``) with their batch split over a mesh that spans
processes.

ONE port cluster (``repro_torch.launch.cluster``) runs the ``serve`` scenario
of ``tests/_torch_multiproc_driver.py`` and dumps each process's numbers.

The static engine, at five families' smoke configs, a global batch of 4 x
16-token prompts + 4 new (2 rows a process): Qwen2.5-3B (dense), OLMoE-1B-7B
(expert-parallel: its prefill's 64 tokens over the 8 units under
``moe_tokens="local"`` on the two-level mesh, its decode steps' 4 tokens,
which the 8 units do not divide, through the dense path on both sides),
Mamba2-1.3B, Whisper-medium (the frames split with the rows) and Qwen2-VL-2B
(the patches split).

The continuous engine, at four smoke configs, 8 slots (4 a process, so a
decode step's 8 tokens are expert-parallel too) and 12 mixed requests
(``make_mixed_workload``, seed 0: prompts of 8 and 16 tokens, 1-6 new, 2
arrivals a step): Qwen2.5-3B (GQA), OLMoE-1B-7B (expert-parallel, with
drops), DeepSeek-V2-Lite-16B (MLA's ``c``/``kr`` cache, expert-parallel)
and Qwen2-VL-2B (the patches split with the rows).  Each process holds its 4
slots' cache rows; a prefilled row whose slot the other process owns is sent
there.

Process 0 holds each split run to its own one-process engine over the same 8
units; the one-process engines are held to the reference by
``tests/test_torch_serve.py``, ``tests/test_torch_models.py``,
``tests/test_torch_ssm.py`` and ``tests/test_torch_whisper.py``, so this
chain holds the split engines to the reference.  Gates: greedy tokens equal
(and, for the continuous engine, each request's admission and finish steps,
the stats' counters and the tracer's spans), each call's logits within
``1e-5 * max |b|``, the per-unit drop counts bit-exact, the pod hop's bytes
equal to a count the driver derives from the configs and, for the continuous
engine, from the one-process engine's schedule (its slots, recorded by
wrapping ``_scatter_prefill``).  Also: a uniform workload through both split
engines (the same tokens, no row moved), a sampled continuous run, a batch
of 3 over the 2 processes run whole on each (``stats["rows"] ==
"replicated"``) by both engines, and the SSM family still refusing the
continuous engine.  In process: the rows rule, the row-routing plan, both
engines' ``"whole"`` mode, and the MoE layer's dense path for a process's
own tokens.
"""

import json
import os

import numpy as np
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
from repro_torch.serve import ContinuousEngine, Request, ServeEngine, make_mixed_workload
from repro_torch.serve.engine import _batch_rows, route_rows

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
PROCESSES, UNITS = 2, 4
ARCHS = ["qwen2.5-3b", "olmoe-1b-7b", "mamba2-1.3b", "whisper-medium", "qwen2-vl-2b"]
B, S, NEW = 4, 16, 4
ODD_BATCH = 3
CONTINUOUS = ["qwen2.5-3b", "olmoe-1b-7b", "deepseek-v2-lite-16b", "qwen2-vl-2b"]
SLOTS, REQUESTS, MAX_NEW = 8, 12, 6
UNIFORM = ("olmoe-1b-7b", 8, 16, 4)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    outs = run_local_cluster(
        [DRIVER, "serve", "--serve-cells", ",".join(f"{a}:0:{B}x{S}x{NEW}" for a in ARCHS),
         "--serve-replicated", f"qwen2.5-3b:{ODD_BATCH}",
         "--serve-continuous", ",".join(f"{a}:0:{SLOTS}x{REQUESTS}x{MAX_NEW}" for a in CONTINUOUS),
         "--serve-prompts", "8,16", "--serve-rate", "2",
         "--serve-uniform", "{}:{}x{}x{}".format(*UNIFORM),
         "--serve-temperature", "qwen2.5-3b:0.8", "--dump", str(tmp)],
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
    """Across processes the continuous engine still refuses a family with no
    per-slot decode (the SSM family), as on one process and in the
    reference; no refusal is left for the mesh itself."""
    for d in dumps:
        msg = d["continuous_raises"]
        assert msg and "decode_step_slots" in msg and "'ssm'" in msg
        assert "processes" not in msg


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_continuous_split_equals_the_one_process_engine(dumps, arch):
    rec = dumps[0]["continuous"][arch]
    assert rec["rows"] == "split"
    assert rec["tokens_equal"] and rec["steps_equal"] and rec["stats_equal"]
    assert len(rec["tokens"]) == REQUESTS and all(1 <= len(t) <= MAX_NEW for t in rec["tokens"])
    s = rec["stats"]
    assert s["admitted"] == s["finished"] == REQUESTS
    # the prefill groups' and every decode step's logits
    assert len(rec["logit_rel"]) == s["prefill_calls"] + s["decode_steps"]
    assert max(rec["logit_rel"]) <= 1e-5
    assert rec["drops_equal"]
    for other in dumps[1:]:
        assert other["continuous"][arch]["tokens"] == rec["tokens"]


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_continuous_split_agrees_on_every_process(dumps, arch):
    """The gathered tokens, the tracer's spans (equal to the one-process
    run's) and the tuned multiplexer are the same on every process, and so
    are the stats' counters."""
    assert dumps[0]["continuous"][arch]["spans_equal"]
    stats = [{k: v for k, v in d["continuous"][arch]["stats"].items() if k != "wall"}
             for d in dumps]
    assert all(st == stats[0] for st in stats)
    for d in dumps:
        rec = d["continuous"][arch]
        assert rec["equal_on_every_process"] == {"tokens": True, "spans": True, "mux": True}
        assert rec["mux"] == dumps[0]["continuous"][arch]["mux"]


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_continuous_split_holds_half_the_cache(dumps, arch):
    for d in dumps:
        rec = d["continuous"][arch]
        assert rec["cache_bytes"] * PROCESSES == rec["whole_cache_bytes"]
    assert dumps[0]["continuous"][arch]["one_process"]["cache_bytes"] == \
        dumps[0]["continuous"][arch]["whole_cache_bytes"]


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_continuous_pod_hop_carries_tokens_trips_and_moved_rows(dumps, arch):
    """A process's int32 tokens of its 4 slots once a prefill group and once
    a decode step, the expert trips, and the prefilled rows it sends to the
    other process: the mixed workload moves at least one row, and the
    engine's own count of moved rows equals the one derived from the
    one-process engine's slots."""
    moved = dumps[0]["continuous"][arch]["want_hop"]["moved_rows"]
    assert moved > 0
    assert sum(d["continuous"][arch]["want_hop"]["sent_rows"] for d in dumps) == moved
    for d in dumps:
        rec = d["continuous"][arch]
        want, s = rec["want_hop"], rec["stats"]
        assert rec["hop_bytes"] == want["total"]
        assert s["moved_rows"] == want["moved_rows"] == moved
        calls = s["prefill_calls"] + s["decode_steps"]
        assert rec["hop_kinds"]["all-gather"] == want["gathers"] == calls * (SLOTS // PROCESSES) * 4
        assert rec["hop_kinds"].get("collective-permute", 0) == want["moved_row_bytes"]
        assert (want["moved_row_bytes"] > 0) == (want["sent_rows"] > 0)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_continuous_moe_prefill_and_decode_are_expert_parallel(dumps, arch):
    """8 slots over the 8 units: every prefill group and every decode step
    is one expert-parallel call a MoE layer, on the tuned two-level
    multiplexer, with rows dropped."""
    cfg = get_smoke_config(arch)
    layers = cfg.num_layers - cfg.first_dense_layers
    for d in dumps:
        rec = d["continuous"][arch]
        s = rec["stats"]
        assert rec["expert_calls"] == layers * (s["prefill_calls"] + s["decode_steps"])
        assert rec["want_hop"]["expert_trips"] > 0
        assert rec["mux"]["num_pods"] == PROCESSES and rec["mux"]["pack_impl"] == "cuda"
    assert sum(dumps[0]["continuous"][arch]["drops"]) > 0


def test_continuous_uniform_run_moves_no_row_and_equals_static(dumps):
    arch, b, s, new = UNIFORM
    for d in dumps:
        u = d["uniform"]
        assert (u["arch"], u["shape"]) == (arch, [b, s, new])
        assert u["rows"] == u["static_rows"] == "split"
        assert u["moved_rows"] == 0 and u["tokens_equal_static"]
        assert [len(t) for t in u["tokens"]] == [new] * b
        assert u["tokens"] == dumps[0]["uniform"]["tokens"]


def test_continuous_sampled_run_agrees_on_every_process(dumps):
    for d in dumps:
        t = d["sampled"]
        assert t["temperature"] == 0.8 and t["rows"] == "split" and t["done"]
        assert t["admitted"] == t["finished"] == t["requests"] == REQUESTS
        assert t["equal_on_every_process"]
        assert t["tokens"] == dumps[0]["sampled"]["tokens"]


def test_indivisible_batch_runs_the_continuous_engine_replicated(dumps):
    for d in dumps:
        c = d["replicated"]["continuous"]
        assert c["rows"] == "replicated" and c["done"]
        assert c["hop_bytes"] == 0 and c["tokens_equal_on_every_process"]
        assert c["cache_bytes"] == c["whole_cache_bytes"]  # every process the whole cache


@pytest.mark.parametrize("arch", ARCHS)
def test_split_run_makes_the_same_calls_on_every_process(dumps, arch):
    for d in dumps:
        s = d["archs"][arch]["stats"]
        assert s["decode_steps"] == NEW - 1 and s["slot_steps"] == B * (NEW - 1)
        assert s["prefill_tokens"] == B * S


# ----------------------------------------------------------------------------
# In process: the rows helpers and rule, the row-routing plan, the engines
# off a process-spanning mesh, and the MoE layer's dense path for a
# process's own tokens.
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


def test_batch_rows_rule_has_three_modes():
    assert _batch_rows(8) == ("whole", None, None)
    one = MeshContext(make_mesh(8, 2))
    with mesh_context(one):
        assert _batch_rows(8) == ("whole", None, one)
    ctx = MeshContext(_fake_mesh(1))
    with mesh_context(ctx):
        mode, mesh, run_ctx = _batch_rows(8)
        assert (mode, mesh, run_ctx.moe_tokens) == ("split", ctx.mesh, "local")
        assert _batch_rows(3) == ("replicated", None, ctx)
        assert ctx.moe_tokens == "global"


@pytest.mark.parametrize("rank", [0, 1])
def test_route_rows_all_local(rank):
    """Slots in admission order: every row stays where it was prefilled."""
    r = route_rows([0, 1, 2, 3, 4, 5], 8, 2, rank)
    assert r.send == {} and r.recv == {}
    assert r.keep == ([(0, 0), (1, 1), (2, 2), (3, 3)] if rank == 0 else [(0, 0), (1, 1)])


def test_route_rows_all_remote():
    """Rows 0-1 (process 0) land in process 1's slots and rows 4-5 (process
    1) in process 0's: each pair's message holds its rows in admission
    order, and the receiver's slot rows line up with them."""
    slot_of = [6, 5, 7, 4, 1, 3]
    r0, r1 = (route_rows(slot_of, 8, 2, k) for k in (0, 1))
    assert r0.keep == [] and r0.send == {1: [0, 1, 2, 3]} and r0.recv == {1: [1, 3]}
    assert r1.keep == [] and r1.send == {0: [0, 1]} and r1.recv == {0: [2, 1, 3, 0]}


def test_route_rows_mixed_over_four_processes():
    slot_of = [0, 5, 2, 7, 3]  # n = 2 slots a process
    plans = [route_rows(slot_of, 8, 4, k) for k in range(4)]
    assert plans[0].keep == [(0, 0)] and plans[0].send == {2: [1]}
    assert plans[1].keep == [(0, 0)] and plans[1].send == {3: [1]} and plans[1].recv == {2: [1]}
    assert plans[2].send == {1: [0]} and plans[2].recv == {0: [1]} and plans[2].keep == []
    assert plans[3].recv == {1: [1]} and plans[3].keep == [] and plans[3].send == {}
    # every row sent is received once, by its slot's owner
    assert sum(len(v) for p in plans for v in p.send.values()) == \
        sum(len(v) for p in plans for v in p.recv.values()) == 3


def test_route_rows_one_process_keeps_everything():
    r = route_rows([3, 0, 2], 4, 1, 0)
    assert r.keep == [(0, 3), (1, 0), (2, 2)] and r.send == {} and r.recv == {}


def test_continuous_engine_in_one_process_runs_whole_rows():
    cfg = get_smoke_config("qwen2.5-3b")
    api = registry.build(cfg)
    params = api.init(0, device="cpu")
    work = make_mixed_workload(cfg.vocab_size, 6, [8, 16], 4, np.random.default_rng(0),
                               arrival_rate=2)
    outs = {}
    for ctx in (None, MeshContext(make_mesh(8, 2))):
        reqs = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                        arrival_step=r.arrival_step) for r in work]
        with mesh_context(ctx):
            engine = ContinuousEngine(api, batch_size=4, capacity=24, device="cpu")
            engine.serve(params, reqs)
        assert engine.stats["rows"] == "whole" and engine.stats["moved_rows"] == 0
        outs[ctx is None] = [r.out_tokens for r in reqs]
    assert outs[True] == outs[False]
