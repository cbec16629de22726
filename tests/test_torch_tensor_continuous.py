"""The continuous engine under the tensor table, and OLMoE tensor-parallel
with its experts split over the processes, across REAL processes (Gloo on
the CPU) against the reference: the reference's own ``serve_continuous_ep``
guarantees (``tests/_multidev_driver.py``) on a mesh that spans processes.

The reference's own engines run each cell on one device (greedy, f32 smoke
configs): ``ServeEngine`` on 4 x 16-token prompts + 4 new, and
``ContinuousEngine`` on a mixed workload (4 slots, 8 requests of 8 and 16
tokens, 1-6 new, 2 arriving a step), each prefill and decode call's logits
recorded, on params that the port's ``init`` draws from seed 0 and stacks
into the reference's layout.  OLMoE runs there with ``moe_impl="dense"``
(exact; the reference's expert-parallel layer needs a mesh), at its own
vocab (479, whole) and at 512 (split).  Then ONE port cluster a process
count (2 and 4 processes of 2 units over Gloo, run at once) runs the
``tensor_serve`` scenario of ``tests/_torch_multiproc_driver.py`` with
``--tp-mixed`` on the reference's params cut into each process's slices
(``attn_impl="flash"``, the kernel's plain version on the CPU): OLMoE with
``moe_impl="dense"`` and ``"ep_shardmap"`` at ``capacity_factor=8.0`` (as
the reference's test), DeepSeek-67B, Qwen2.5-3B (whose 2 kv heads stay
whole over 4) and DeepSeek-V2-Lite under ``"ep_shardmap"`` (MLA through
``mla_decode_slots`` on the process's heads over the whole compressed
cache; a dense first layer, then MoE layers with a shared expert, top-2
of 8 with ``router_norm_topk``; the reference runs it dense, exact).  Under
the tensor table every process holds all 4 slots' cache rows of its kv
heads (MLA: the whole compressed rows) and its ``E / R`` experts.  Over 2 x 2 units a
decode step's 4 tokens split over the 4 units (expert-parallel); over 4 x
2 they do not, so every decode step takes the new dense path on the
process's experts (one all-reduce), while the prefill's 64 tokens take the
expert-parallel one.

Held, cell by cell and process count by process count: both engines'
logits within ``rtol = atol = 2e-4`` of the reference's call for call and
their greedy tokens equal; the continuous engine equal to process 0's
one-process continuous engine on the whole tree over the same units
(tokens, admission and finish steps, stats, spans, drops; logits within
``2e-4``); the continuous engine's greedy tokens on the static prompts
equal to the static engine's on the same mesh; the mixed workload with no
slot leak and fewer slot-steps than ``generate_bucketed``; each MoE call's
path; the pod hop's bytes against the shapes (in the driver and here);
sampled tokens (temperature 0.8) equal on every process; each process's
leaves equal to the placement ``tensor_place`` gives in process (which
``test_torch_tensor_parallel.py`` holds to the reference's
``logical_sharding``); and ``launch.serve --tensor --continuous`` for
OLMoE under ``launch.cluster`` equal to the one-process launcher's slot
counts.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.exchange import Mesh
from repro_torch.distributed.sharding import MeshContext, tensor_place, tensor_rules
from repro_torch.launch.cluster import run_local_cluster
from repro_torch.models import registry
from repro_torch.serve import make_mixed_workload
from repro_torch.tree import leaves_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
#: (key, arch, vocab, moe): the driver's cells
CELLS = [("olmoe-1b-7b:dense", "olmoe-1b-7b", 0, "dense"),
         ("olmoe-1b-7b:ep", "olmoe-1b-7b", 0, "ep"),
         ("olmoe-1b-7b:v512:dense", "olmoe-1b-7b", 512, "dense"),
         ("olmoe-1b-7b:v512:ep", "olmoe-1b-7b", 512, "ep"),
         ("deepseek-67b", "deepseek-67b", 0, ""),
         ("qwen2.5-3b", "qwen2.5-3b", 0, ""),
         ("deepseek-v2-lite-16b:ep", "deepseek-v2-lite-16b", 0, "ep")]
KEYS = [c[0] for c in CELLS]
B, S, NEW = 4, 16, 4
SLOTS, REQUESTS, MAX_NEW, PROMPTS, RATE = 4, 8, 6, (8, 16), 2.0
CAPACITY_FACTOR = 8.0
TOL = 2e-4
PROCESSES = (2, 4)
UNITS = 2
TEMPERATURE = 0.8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every tensor here is small: one intra-op thread, so that in a
    parallel test run many small ops do not wait on oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, vocab=0, moe=""):
    cfg = get_smoke_config(arch)
    over = {"vocab_size": vocab} if vocab else {}
    if moe:
        over.update(moe_impl={"dense": "dense", "ep": "ep_shardmap"}[moe],
                    capacity_factor=CAPACITY_FACTOR)
    return cfg.scaled(**over)


def _stacked(params: dict) -> dict:
    """Port params in the reference's layout (numpy): each ``seg<i>`` list
    of layers stacked on a leading dim (DeepSeek-V2-Lite's one dense first
    layer too)."""
    from repro_torch.tree import tree_map

    def np_leaf(*ts):
        return np.stack([t.numpy() for t in ts])

    return {k: tree_map(np_leaf, *v) if isinstance(v, list) else tree_map(lambda t: t.numpy(), v)
            for k, v in params.items()}


def _recorded(fn, out: list):
    def call(*args):
        got = fn(*args)
        out.append(np.asarray(got[0]))
        return got
    return call


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's params and one-device static and continuous runs of
    every (arch, vocab), as the pickles ``--tp-ref`` reads."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.serve.engine import ContinuousEngine as RefContinuousEngine
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import ServeEngine as RefServeEngine

    out = tmp_path_factory.mktemp("tensor_continuous_ref")
    for arch, vocab in sorted({(a, v) for _, a, v, _ in CELLS}):
        cfg = ref_smoke(arch)
        api = ref_registry.build(cfg.scaled(vocab_size=vocab) if vocab else cfg)
        params = _stacked(registry.build(_smoke(arch, vocab)).init(0, device="cpu"))
        jparams = jax.tree.map(jax.numpy.asarray, params)
        prompts = np.random.default_rng(0).integers(0, api.cfg.vocab_size, (B, S),
                                                    dtype=np.int32)
        static = RefServeEngine(api, batch_size=B, capacity=S + NEW + 1)
        logits = []
        static._prefill = _recorded(static._prefill, logits)
        static._decode = _recorded(static._decode, logits)
        reqs = [RefRequest(prompt=p.copy(), max_new_tokens=NEW) for p in prompts]
        static.generate(jparams, reqs)

        work = make_mixed_workload(api.cfg.vocab_size, REQUESTS, PROMPTS, MAX_NEW,
                                   np.random.default_rng(0), arrival_rate=RATE)
        cap = max(PROMPTS) + MAX_NEW + 1
        cont = RefContinuousEngine(api, batch_size=SLOTS, capacity=cap)
        pre, dec = [], []
        cont._prefill, cont._decode = _recorded(cont._prefill, pre), _recorded(cont._decode, dec)
        creqs = [RefRequest(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                            arrival_step=r.arrival_step) for r in work]
        cont.serve(jparams, creqs)
        key = arch if not vocab else f"{arch}:v{vocab}"
        with open(out / (key.replace(":", "_") + ".pkl"), "wb") as f:
            pickle.dump({"params": params, "prompts": prompts, "logits": logits,
                         "tokens": [r.out_tokens for r in reqs],
                         "continuous": {
                             "requests": [(r.prompt, r.max_new_tokens, r.arrival_step)
                                          for r in work],
                             "capacity": cap, "logits": pre + dec,
                             "tokens": [r.out_tokens for r in creqs],
                             "stats": {k: cont.stats[k] for k in ("decode_steps",
                                                                  "slot_steps")}}}, f)
    return out


def _cluster(R: int, reference, tmp) -> list:
    """Every process's ``tensor_serve`` record of every cell, over ``R``
    processes."""
    cells = ",".join(f"{arch}:0:{B}x{S}x{NEW}:{vocab}:{moe}" for _, arch, vocab, moe in CELLS)
    outs = run_local_cluster(
        [DRIVER, "tensor_serve", "--tp-cells", cells, "--tp-ref", str(reference),
         "--tp-capacity-factor", str(CAPACITY_FACTOR),
         "--tp-mixed", f"{SLOTS}x{REQUESTS}x{MAX_NEW}",
         "--serve-prompts", ",".join(map(str, PROMPTS)), "--serve-rate", str(RATE),
         "--tp-temperature", str(TEMPERATURE), "--dump", str(tmp)],
        num_processes=R, local_units=UNITS, timeout_s=300, echo=False, backend="gloo",
        device="cpu", env={"OMP_NUM_THREADS": "1"},
    )
    assert all("PASS tensor_serve" in o for o in outs), outs
    got = []
    for pid in range(R):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            got.append(json.load(f)["results"]["tensor_serve"]["archs"])
    return got


CLI = ["--arch", "olmoe-1b-7b", "--smoke", "--continuous", "--requests", "8", "--batch", "4",
       "--prompt-len", "16", "--max-new", "6", "--arrival-rate", "2"]


def _launcher() -> list:
    """``launch.serve --tensor --continuous`` under ``launch.cluster``, 2
    processes of 2 units: each process's printed lines."""
    src = os.path.join(HERE, "..", "src")
    return run_local_cluster(
        ["-m", "repro_torch.launch.serve", "--tensor"] + CLI, num_processes=2, local_units=2,
        timeout_s=300, echo=False, backend="gloo", device="cpu",
        env={"OMP_NUM_THREADS": "1",
             "PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))},
    )


@pytest.fixture(scope="module")
def clusters(reference, tmp_path_factory):
    """Both clusters (2 and 4 processes) and the launcher's at once: each
    collective over Gloo waits on localhost, so they overlap well."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(PROCESSES) + 1) as pool:
        runs = {R: pool.submit(_cluster, R, reference,
                               tmp_path_factory.mktemp(f"tensor_continuous{R}"))
                for R in PROCESSES}
        runs["launcher"] = pool.submit(_launcher)
        return {R: run.result() for R, run in runs.items()}


@pytest.fixture(scope="module", params=PROCESSES, ids=lambda r: f"{r}proc")
def dumps(request, clusters):
    return request.param, clusters[request.param]


def _cell(key):
    return next(c for c in CELLS if c[0] == key)


@pytest.mark.parametrize("key", KEYS)
def test_static_engine_equals_the_reference(dumps, key):
    """The static engine under the tensor table: every call's logits within
    ``2e-4`` of the reference's one-device engine, its greedy tokens."""
    R, recs = dumps
    for pid, rec in enumerate(recs):
        r = rec[key]
        assert r["rows"] == "tensor" and r["tol"] == TOL
        assert r["logits_close"] and len(r["logit_abs"]) == NEW, (pid, r["logit_abs"])
        assert r["tokens_equal"] and r["tokens_equal_on_every_process"]
        assert r["tokens"] == recs[0][key]["tokens"]


@pytest.mark.parametrize("key", KEYS)
def test_continuous_engine_equals_the_reference_and_one_process(dumps, key):
    """The continuous engine under the tensor table against the reference's
    continuous engine (logits, tokens, decode and slot steps) and, on
    process 0, against the port's one-process continuous engine over the
    same units (also admission and finish steps, stats, spans, drops)."""
    R, recs = dumps
    for pid, rec in enumerate(recs):
        c = rec[key]["continuous"]
        assert c["rows"] == "tensor" and c["stats"]["moved_rows"] == 0
        assert c["shape"] == [SLOTS, REQUESTS, MAX_NEW] and c["leak_free"]
        ref = c["reference"]  # the served rows, and every row (padding, dead slots) here too
        assert ref["logits_close"] and ref["all_rows_close"], ref
        assert ref["tokens_equal"] and ref["stats_equal"], ref
        assert len(ref["logit_abs"]) == c["groups"] + c["stats"]["decode_steps"]
        assert all(c["equal_on_every_process"].values())
        assert c["tokens"] == recs[0][key]["continuous"]["tokens"]
        assert c["cache_bytes"] == c["cache_bytes_counted"]
    one = recs[0][key]["continuous"]["one_process"]
    assert one["logits_close"] and one["all_rows_close"] and one["tokens_equal"], one
    assert one["steps_equal"] and one["stats_equal"] and one["spans_equal"]
    assert one["drops_equal"]
    if key.endswith(":ep"):  # every expert-parallel call's drops: none at capacity factor 8
        assert one["drops"] and not any(one["drops"])


@pytest.mark.parametrize("key", KEYS)
def test_continuous_greedy_tokens_equal_static_on_the_same_mesh(dumps, key):
    """The reference's guarantee (``serve_continuous_ep``): the static
    cell's prompts through the continuous engine give the static engine's
    greedy tokens; the mixed workload leaves no slot leak and takes fewer
    slot-steps than ``generate_bucketed`` on the same mesh."""
    R, recs = dumps
    for rec in recs:
        c = rec[key]["continuous"]
        assert c["uniform_equal_static"]
        assert c["bucketed"]["rows"] == "tensor"
        assert c["stats"]["slot_steps"] < c["bucketed"]["slot_steps"], c["bucketed"]
        assert c["leak_free"] and c["stats"]["finished"] == REQUESTS


@pytest.mark.parametrize("key", [k for k in KEYS if not k.startswith(("deepseek-67b", "qwen"))])
def test_each_moe_call_takes_the_path_its_tokens_and_units_give(dumps, key):
    """``moe_impl="dense"``: every call on the process's experts, then an
    all-reduce.  ``"ep_shardmap"`` over ``N = 2 R`` units: the static
    prefill's 64 tokens expert-parallel; a decode step's 4 tokens
    expert-parallel over 4 units (2 processes), dense on the process's
    experts over 8 (4 processes).  Both paths in one run over 4.  Each MoE
    layer's call: DeepSeek-V2-Lite's 2 after its dense first layer."""
    R, recs = dumps
    _, arch, _, moe = _cell(key)
    cfg = _smoke(arch, 0, moe)
    L = cfg.num_layers - cfg.first_dense_layers
    for rec in recs:
        r = rec[key]
        if cfg.moe_impl == "dense":
            assert r["paths"] == {"dense-tensor": L * NEW}
            assert set(r["continuous"]["paths"]) == {"dense-tensor"}
        elif R == 2:
            assert r["paths"] == {"ep": L * NEW}
            assert set(r["continuous"]["paths"]) == {"ep"}
        else:
            assert r["paths"] == {"ep": L, "dense-tensor": L * (NEW - 1)}
            c = r["continuous"]
            assert c["paths"] == {"ep": L * c["groups"],
                                  "dense-tensor": L * c["stats"]["decode_steps"]}


def _hop(cfg, R: int, calls: list, impl: str) -> dict:
    """The pod hop of ``calls`` (``(rows, tokens a row)``) for the smoke
    configs here, written out for them: every layer's attention output
    (MLA's ``wo`` too) all-reduced where the heads split; a dense layer's
    MLP (DeepSeek's, Qwen's, DeepSeek-V2-Lite's first) where ``d_ff``
    splits; an MoE layer all-reduced on its dense path, or on its
    expert-parallel one the units' outputs all-gathered and the capacity
    buffers' trips, and its shared MLP (DeepSeek-V2-Lite's width 48)
    all-reduced where its width splits; the embedding all-reduced and the
    logits gathered where the vocab splits."""
    from repro_torch.core.autotune import ep_capacity

    d, V, Lyr = cfg.d_model, cfg.vocab_size, cfg.num_layers
    moe = Lyr - cfg.first_dense_layers if cfg.num_experts else 0
    shared = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
    N, U = R * UNITS, UNITS
    out = {"all-reduce": 0, "all-gather": 0, "total": 0}
    for rows, t in calls:
        T = rows * t
        per = Lyr * (cfg.num_heads % R == 0) + (Lyr - moe) * (cfg.d_ff % R == 0)
        if moe:
            per += moe * bool(shared and shared % R == 0)
            if cfg.moe_impl == "ep_shardmap" and T % N == 0:
                C = ep_capacity(T // N, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
                out["all-gather"] += moe * T // R * d * 4
                out["total"] += moe * 2 * U * (N if impl == "xla" else N - U) * \
                    (cfg.num_experts // N) * C * d * 4
            else:
                per += moe
        out["all-reduce"] += per * T * d * 4
        if V % R == 0:
            out["all-reduce"] += T * d * 4
            out["all-gather"] += rows * (V // R) * 4
    out["total"] += out["all-reduce"] + out["all-gather"]
    return out


@pytest.mark.parametrize("key", KEYS)
def test_pod_hop_carries_what_the_shapes_give(dumps, key):
    R, recs = dumps
    _, arch, vocab, moe = _cell(key)
    cfg = _smoke(arch, vocab, moe)
    for rec in recs:
        r = rec[key]
        want = _hop(cfg, R, [(B, S)] + [(B, 1)] * (NEW - 1), cfg.exchange_impl)
        got = {k: r["hop_kinds"].get(k, 0) for k in ("all-reduce", "all-gather")}
        assert {**got, "total": r["hop_bytes"]} == want
        c = r["continuous"]
        calls = [(SLOTS, n) for n in c["group_lengths"]] + [(SLOTS, 1)] * \
            c["stats"]["decode_steps"]
        want = _hop(cfg, R, calls, c["mux"]["impl"] if c["mux"] else cfg.exchange_impl)
        got = {k: c["hop_kinds"].get(k, 0) for k in ("all-reduce", "all-gather")}
        assert {**got, "total": c["hop_bytes"]} == want


@pytest.mark.parametrize("key", KEYS)
def test_sampled_tokens_equal_on_every_process(dumps, key):
    """At temperature 0.8 every process draws the same tokens, through both
    engines: the logits are gathered whole on each and the generators
    seeded alike, so the slot map stays the same on every process."""
    R, recs = dumps
    for rec in recs:
        for s, first in ((rec[key]["sampled"], recs[0][key]["sampled"]),
                         (rec[key]["continuous"]["sampled"],
                          recs[0][key]["continuous"]["sampled"])):
            assert s["temperature"] == TEMPERATURE and s["equal_on_every_process"]
            assert s["tokens"] == first["tokens"] and s["differs_from_greedy"]


@pytest.mark.parametrize("key", KEYS)
def test_each_process_holds_its_placed_slices(dumps, key):
    """Every leaf a worker serves from (the reference's params cut by
    ``convert.tensor_params``) has the shape ``init``'s ``tensor_place``
    gives process ``r`` in process: OLMoE's ``E / R`` experts (4 of 8 over
    2, 2 over 4) beside its heads; the router whole."""
    R, recs = dumps
    _, arch, vocab, moe = _cell(key)
    api = registry.build(_smoke(arch, vocab, moe))
    for r, rec in enumerate(recs):
        ctx = MeshContext(Mesh(R, UNITS, num_processes=R, process_index=r), rules=tensor_rules())
        placed = api.init(0, device="meta", place=tensor_place(api.param_specs, ctx))
        want = {"/".join(map(str, p)): list(t.shape) for p, t in leaves_with_paths(placed)}
        assert rec[key]["leaf_shapes"] == want
        if arch == "olmoe-1b-7b":
            assert want["seg0/0/ffn/w_gate"][0] == 8 // R
            assert want["seg0/0/ffn/router"] == [64, 8]


def test_launcher_serves_olmoe_tensor_parallel_continuously(clusters, capsys):
    """``python -m repro_torch.launch.cluster ... -- -m repro_torch.launch.serve
    --tensor --continuous --arch olmoe-1b-7b``: both processes print the
    one-process launcher's slot counts (the static comparison included)."""
    from repro_torch.launch import serve

    serve.main(CLI, device="cpu")
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("slot_steps")]
    assert len(want) == 1
    for out in clusters["launcher"]:
        assert [ln for ln in out.splitlines() if ln.startswith("slot_steps")] == want, out
