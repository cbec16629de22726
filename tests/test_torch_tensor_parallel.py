"""Tensor-parallel serving across REAL processes (Gloo on the CPU) against the
reference: ``distributed.sharding.tensor_rules``, the layers' collectives,
``init``'s ``tensor_place``, ``convert.tensor_params`` and the static
engine's ``"tensor"`` rows.

The reference's own ``ServeEngine`` runs each cell on one device (greedy, 4 x
16-token prompts + 4 new, smoke configs in f32), each prefill and decode
call's logits recorded, on params that the port's ``init`` draws from seed 0
and stacks into the reference's layout (a ``jax.random`` init would compile
for seconds a cell; the distributions are the reference's).  Then ONE
port cluster a process count (2 and 4 processes of 2 units over Gloo) runs
the ``tensor_serve`` scenario of ``tests/_torch_multiproc_driver.py`` on the
reference's params cut into each process's slices, with
``attn_impl="flash"`` (the kernel's plain version on the CPU): every call's
logits within ``rtol = atol = 2e-4`` (the tolerance of the reference's
``decode_sharded_equiv``), greedy tokens equal, tokens equal on every
process (also sampled at temperature 0.8), and the pod hop's all-reduce and
all-gather bytes equal to a count from the shapes.  The cells: DeepSeek-67B
(GQA 8:2; over 4 processes its 2 kv heads stay whole and each process reads
the one its 2 query heads map to), Qwen1.5-32B (5 heads, which neither
count divides: attention runs whole, the MLP split), Qwen2.5-3B (q/k/v
biases, kv heads whole over 4) and MiniCPM-2B (a tied table, muP scales);
DeepSeek-V2-Lite (MLA: each process its heads of ``wq``, ``wk_b``,
``wv_b`` and ``wo``, the compressed cache whole; MoE on the process's
experts, the shared experts' MLP and the dense first layer split as
``d_ff``) and Whisper-medium (the encoder-decoder: encoder self-attention,
decoder self- and cross-attention and both GELU MLPs split like a dense
layer, 24 frame rows a request, more than the prompt's 16 tokens, drawn with
numpy from the seed after the prompts, as the serving launcher draws them); their smoke vocabs are odd and stay whole, so
DeepSeek-67B, MiniCPM-2B and Whisper-medium also run at a vocab of 512,
split (the masked lookup, the gathered logits; the tied table both).

Each process's leaf shapes equal the reference's shard shapes: the full
shape divided along every dim that the reference's ``logical_sharding``
puts on ``model`` on a ``data x model`` mesh with ``model`` = 2 and 4 (ONE
subprocess on 8 fake devices, ``tests/_torch_sharding_ref_run.py``); at
smoke size from the workers' own params, at full width on ``meta``; and
OLMoE's, its ``E / R`` experts beside its heads and vocab (the workers
that serve it run in ``tests/test_torch_tensor_continuous.py``), at smoke
size and at full width on ``meta``.  In process: the placed init equals
the whole init's slices, the cache holds the process's kv heads (MLA's
compressed cache whole), the kv heads a process reads (Whisper's cross K/V
too), ``grow_cache`` growing only along the positions, and the refusals
(the continuous engine for the encoder-decoder and SSM families, training
the families other than the dense one under the tensor table, a mesh
inside one process).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.exchange import Mesh, make_mesh
from repro_torch.distributed.sharding import (
    MeshContext,
    mesh_context,
    tensor_place,
    tensor_rules,
    tensor_slices,
    unit_rules,
)
from repro_torch.launch.cluster import run_local_cluster
from repro_torch.launch.mesh import make_context
from repro_torch.models import convert, registry
from repro_torch.models import layers as L
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.tree import leaves, leaves_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
ARCHS = ["deepseek-67b", "qwen1.5-32b", "qwen2.5-3b", "minicpm-2b", "deepseek-v2-lite-16b",
         "whisper-medium"]
#: (key, arch, vocab): the smoke configs, and three at a vocab both counts split
CELLS = [(a, a, 0) for a in ARCHS] + [(f"{a}:v512", a, 512) for a in ("deepseek-67b",
                                                                    "minicpm-2b",
                                                                    "whisper-medium")]
B, S, NEW = 4, 16, 4
#: an encoder-decoder's frame rows a request: more than the prompt's tokens,
#: as on the card (1,500 frames, 8 tokens), so decode starts at the frames'
#: length and the capacity covers them
FRAMES = 24
TOL = 2e-4
PROCESSES = (2, 4)
UNITS = 2
TEMPERATURE = 0.8
#: served under the tensor table by ``tests/test_torch_tensor_continuous.py``;
#: its placement is held to the reference here
MOE_ARCHS = ["olmoe-1b-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every tensor here is small: one intra-op thread, so that in a
    parallel test run many small ops do not wait on oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, vocab=0):
    cfg = get_smoke_config(arch)
    return cfg.scaled(vocab_size=vocab) if vocab else cfg


@pytest.fixture(scope="module")
def reference(resolver, tmp_path_factory):
    """The reference's params and one-device greedy run of every cell, as
    the pickles ``--tp-ref`` reads."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import ServeEngine as RefServeEngine

    out = tmp_path_factory.mktemp("tensor_ref")
    for key, arch, vocab in CELLS:
        cfg = ref_smoke(arch)
        api = ref_registry.build(cfg.scaled(vocab_size=vocab) if vocab else cfg)
        params = _stacked(registry.build(_smoke(arch, vocab)).init(0, device="cpu"))
        prompts, extra = _inputs(api.cfg)
        engine = RefServeEngine(api, batch_size=B, capacity=_capacity(api.cfg))
        logits = []

        def recorded(fn):
            def call(*args):
                got = fn(*args)
                logits.append(np.asarray(got[0]))
                return got
            return call

        engine._prefill, engine._decode = recorded(engine._prefill), recorded(engine._decode)
        reqs = [RefRequest(prompt=p.copy(), max_new_tokens=NEW) for p in prompts]
        engine.generate(jax.tree.map(jax.numpy.asarray, params), reqs, extra)
        with open(out / (key.replace(":", "_") + ".pkl"), "wb") as f:
            pickle.dump({"params": params, "prompts": prompts, "extra": extra,
                         "logits": logits, "tokens": [r.out_tokens for r in reqs]}, f)
    return out


def _inputs(cfg):
    """The prompts ``[B, S]`` and, for an encoder-decoder, its frames ``[B,
    FRAMES, d]``, drawn with numpy from seed 0 (the frames after the prompts,
    as the driver and the serving launcher draw them)."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    if cfg.family != "encdec":
        return prompts, None
    return prompts, {"frames": rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)}


def _capacity(cfg) -> int:
    """The static engine's capacity, the driver's: ``NEW`` positions and one
    more after the prompt, or after an encoder-decoder's frames, where its
    decode starts."""
    return (FRAMES if cfg.family == "encdec" else S) + NEW + 1


def _stacked(params: dict) -> dict:
    """Port params in the reference's layout (numpy): each list of layers
    (``seg<i>``, Whisper's ``encoder`` and ``decoder``) stacked on a leading
    dim, a list of one layer too, the inverse of ``convert.from_reference``."""
    from repro_torch.tree import tree_map

    def np_leaf(*ts):
        return np.stack([t.numpy() for t in ts])

    return {k: tree_map(np_leaf, *v) if isinstance(v, list) else tree_map(lambda t: t.numpy(), v)
            for k, v in params.items()}


def _cluster(R: int, reference, tmp) -> list:
    """Every process's ``tensor_serve`` record of every cell, over ``R``
    processes."""
    cells = ",".join(f"{arch}:0:{B}x{S}x{NEW}:{vocab}" for _, arch, vocab in CELLS)
    outs = run_local_cluster(
        [DRIVER, "tensor_serve", "--tp-cells", cells, "--tp-ref", str(reference),
         "--tp-temperature", str(TEMPERATURE),
         "--dump", str(tmp)],
        num_processes=R, local_units=UNITS, timeout_s=300, echo=False, backend="gloo",
        device="cpu", env={"OMP_NUM_THREADS": "1"},
    )
    assert all("PASS tensor_serve" in o for o in outs), outs
    got = []
    for pid in range(R):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            got.append(json.load(f)["results"]["tensor_serve"]["archs"])
    return got


CLI = ["--arch", "deepseek-67b", "--smoke", "--requests", "4", "--batch", "2",
       "--prompt-len", "8", "--max-new", "4"]
#: the launcher's other families: MLA + MoE, and the encoder-decoder (its
#: frames from ``launch.serve._extra_inputs``)
LAUNCHED = ("deepseek-v2-lite-16b", "whisper-medium")


def _launcher(cli=CLI) -> list:
    """``launch.serve --tensor`` under ``launch.cluster``, 2 processes of one
    unit: each process's printed lines."""
    src = os.path.join(HERE, "..", "src")
    return run_local_cluster(
        ["-m", "repro_torch.launch.serve", "--tensor"] + cli, num_processes=2, local_units=1,
        timeout_s=300, echo=False, backend="gloo", device="cpu",
        env={"OMP_NUM_THREADS": "1",
             "PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))},
    )


@pytest.fixture(scope="module")
def clusters(reference, tmp_path_factory):
    """Both clusters (2 and 4 processes) and the launcher's at once: each
    collective over Gloo waits on localhost, so they overlap well."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(PROCESSES) + 1 + len(LAUNCHED)) as pool:
        runs = {R: pool.submit(_cluster, R, reference, tmp_path_factory.mktemp(f"tensor{R}"))
                for R in PROCESSES}
        runs["launcher"] = pool.submit(_launcher)
        for arch in LAUNCHED:
            runs[arch] = pool.submit(_launcher, ["--arch", arch] + CLI[2:])
        return {R: run.result() for R, run in runs.items()}


def test_launcher_serves_tensor_parallel_as_one_process(clusters, capsys):
    """``python -m repro_torch.launch.cluster ... -- -m repro_torch.launch.serve
    --tensor``: both processes print the one-process launcher's batches."""
    from repro_torch.launch import serve

    serve.main(CLI, device="cpu")
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("batch")]
    assert len(want) == 2
    for out in clusters["launcher"]:
        assert [ln for ln in out.splitlines() if ln.startswith("batch")] == want, out
    with pytest.raises(ValueError, match="tensor table"):  # no launch: no processes to split over
        serve.main(["--tensor"] + CLI, device="cpu")


@pytest.mark.parametrize("arch", LAUNCHED)
def test_launcher_serves_mla_and_whisper_tensor_parallel(clusters, capsys, arch):
    """``launch.serve --tensor --arch deepseek-v2-lite-16b`` and ``--arch
    whisper-medium`` (the frames drawn first from the run's generator) over 2
    processes print the one-process launcher's batches."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch] + CLI[2:], device="cpu")
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("batch")]
    assert len(want) == 2
    for out in clusters[arch]:
        assert [ln for ln in out.splitlines() if ln.startswith("batch")] == want, out


@pytest.fixture(scope="module", params=PROCESSES, ids=lambda r: f"{r}proc")
def dumps(request, clusters):
    return request.param, clusters[request.param]


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_tensor_parallel_engine_equals_the_reference(dumps, key):
    R, recs = dumps
    for pid, rec in enumerate(recs):
        r = rec[key]
        assert r["rows"] == "tensor"
        assert r["tokens_equal"], (pid, r["tokens"])
        assert len(r["logit_abs"]) == NEW  # the prefill and every decode step
        assert r["tol"] == TOL and r["logits_close"], (pid, r["logit_abs"])
        assert r["tokens_equal_on_every_process"]
        assert r["tokens"] == recs[0][key]["tokens"]
        assert [len(t) for t in r["tokens"]] == [NEW] * B


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_sampled_tokens_equal_on_every_process(dumps, key):
    """At temperature 0.8 every process draws the same tokens: the logits
    are gathered whole on each and the generators seeded alike."""
    R, recs = dumps
    for rec in recs:
        s = rec[key]["sampled"]
        assert s["temperature"] == TEMPERATURE and s["equal_on_every_process"]
        assert s["tokens"] == recs[0][key]["sampled"]["tokens"]
        assert s["differs_from_greedy"]


def _splits(cfg, R: int) -> dict:
    shared = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
    return {name: dim % R == 0 for name, dim in (("heads", cfg.num_heads), ("d_ff", cfg.d_ff),
                                                  ("vocab", cfg.vocab_size),
                                                  ("shared", shared or 1))}


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_pod_hop_carries_the_reductions_and_the_gathered_logits(dumps, key):
    """Per call over ``T`` tokens a row: one ``[B, T, d]`` f32 all-reduce
    for the embedding where the vocab splits, and one for each layer's
    attention (heads split; MLA's ``wo``) and MLP (``d_ff`` split); an MoE
    layer (DeepSeek-V2-Lite's 2 after its dense first layer, ``moe_impl=
    "dense"``) one for its experts (8, split over 2 and 4) and one for its
    shared MLP (width 48, split); Whisper's decoder layers one each for
    self-attention, cross-attention and the MLP, and the prefill's encoder
    layers one each for attention and the MLP over the ``[B, S, d]``
    frames; one all-gather of the ``[B, 1, V / R]`` logits where the vocab
    splits."""
    R, recs = dumps
    _, arch, vocab = next(c for c in CELLS if c[0] == key)
    cfg = _smoke(arch, vocab)
    split = _splits(cfg, R)
    tokens = B * S + (NEW - 1) * B
    moe = cfg.num_layers - cfg.first_dense_layers if cfg.num_experts else 0
    attn = 2 if cfg.family == "encdec" else 1
    per_token = (cfg.num_layers * attn * split["heads"]
                 + (cfg.num_layers - moe) * split["d_ff"]
                 + moe * (1 + split["shared"]) + split["vocab"])
    frames = cfg.encoder_layers * (split["heads"] + split["d_ff"]) * B * FRAMES
    want = {"all-reduce": (per_token * tokens + frames) * cfg.d_model * 4}
    if split["vocab"]:
        want["all-gather"] = NEW * B * (cfg.vocab_size // R) * 4
    for rec in recs:
        assert rec[key]["hop_kinds"] == want


def _ref_shard_shapes(ref, pairs, shape, spec, R):
    """The reference's shard shape: the dims its ``logical_sharding`` puts
    on ``model`` (``model`` = R) divided by R; ``data`` dims stay whole, as
    serving keeps no FSDP."""
    mesh_key = {2: "data4_model2", 4: "data2_model4"}[R]
    resolved = ref["resolved"][f"{mesh_key}:False:False"][pairs[(shape, spec)]]
    return [n // R if a == "model" or (isinstance(a, list) and "model" in a) else n
            for n, a in zip(shape, resolved)]


def _full(arch):
    """Full width at depth 2 (Whisper's encoder too): every layer's leaves
    have the same shapes; DeepSeek-V2-Lite's are its dense first layer and
    one MoE layer."""
    cfg = get_config(arch)
    return cfg.scaled(num_layers=2, **({"encoder_layers": 2} if cfg.encoder_layers else {}))


@pytest.fixture(scope="module")
def full_meta():
    """Per (arch, R, rank): every leaf of ``init(..., device="meta")`` placed
    by the tensor table at full width, and the whole tree's."""
    out = {}
    for arch in ARCHS + MOE_ARCHS:
        api = registry.build(_full(arch))
        out[(arch, "whole")] = api.init(0, device="meta")
        for R in PROCESSES:
            for r in range(R):
                ctx = _fake_ctx(R, r)
                out[(arch, R, r)] = api.init(0, device="meta",
                                             place=tensor_place(api.param_specs, ctx))
    return out


@pytest.fixture(scope="module")
def resolver(full_meta, tmp_path_factory):
    """The reference's resolution of every leaf of the cells' trees (smoke,
    the 512-vocab variants, full width) on ``data x model`` meshes, started
    in its subprocess here and read by :func:`ref_shapes`, so that it runs
    beside the reference's greedy runs."""
    pairs = {}

    def add(cfg_params, specs):
        for (_, spec), (_, t) in zip(leaves_with_paths(specs), leaves_with_paths(cfg_params)):
            pairs.setdefault((tuple(t.shape), spec), len(pairs))

    for arch, vocab in [c[1:] for c in CELLS] + [(a, v) for a in MOE_ARCHS for v in (0, 512)]:
        api = registry.build(_smoke(arch, vocab))
        add(api.init(0, device="meta"), api.param_specs)
    for arch in ARCHS + MOE_ARCHS:
        add(full_meta[(arch, "whole")], registry.build(_full(arch)).param_specs)
    tmp = tmp_path_factory.mktemp("tensor_sharding")
    src, dst = tmp / "in.json", tmp / "out.json"
    src.write_text(json.dumps({"configs": [],
                               "pairs": [[list(s), list(n)] for s, n in pairs]}))
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_sharding_ref_run.py"),
                             str(src), str(dst)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, dst, pairs
    proc.kill()


@pytest.fixture(scope="module")
def ref_shapes(resolver):
    proc, dst, pairs = resolver
    out, _ = proc.communicate(timeout=300)
    assert "PASS torch_sharding_ref" in out, out
    return json.loads(dst.read_text()), pairs


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_each_process_holds_the_reference_shard_shapes(dumps, ref_shapes, key):
    R, recs = dumps
    ref, pairs = ref_shapes
    _, arch, vocab = next(c for c in CELLS if c[0] == key)
    api = registry.build(_smoke(arch, vocab))
    whole = api.init(0, device="meta")
    for rec in recs:
        got = rec[key]["leaf_shapes"]
        assert len(got) == len(leaves(whole))
        for (path, spec), (_, t) in zip(leaves_with_paths(api.param_specs),
                                        leaves_with_paths(whole)):
            want = _ref_shard_shapes(ref, pairs, tuple(t.shape), spec, R)
            assert got["/".join(map(str, path))] == want, (path, spec)


@pytest.mark.parametrize("R", PROCESSES)
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_full_size_shard_shapes_on_meta(full_meta, ref_shapes, arch, R):
    """At full width (DeepSeek-67B: 16 q and 2 kv heads a process over 4;
    Qwen1.5-32B: 10 and 10; Qwen2.5-3B's 2 kv heads whole over 4; MiniCPM-2B's
    odd vocab whole; OLMoE: 4 q and 4 kv heads and 16 of its 64 experts over
    4, the router whole), on ``meta``: every process's leaf the reference's
    shard shape."""
    ref, pairs = ref_shapes
    api = registry.build(_full(arch))
    whole = full_meta[(arch, "whole")]
    for r in range(R):
        placed = full_meta[(arch, R, r)]
        for (path, spec), (_, t), (_, p) in zip(leaves_with_paths(api.param_specs),
                                                leaves_with_paths(whole),
                                                leaves_with_paths(placed)):
            assert list(p.shape) == _ref_shard_shapes(ref, pairs, tuple(t.shape), spec, R), \
                (path, spec)
    if arch == "deepseek-67b" and R == 4:
        wq = full_meta[(arch, R, 0)]["seg0"][0]["attn"]
        assert wq["wq"].shape == (8192, 16, 128) and wq["wk"].shape == (8192, 2, 128)
    if arch == "qwen1.5-32b" and R == 4:
        a = full_meta[(arch, R, 0)]["seg0"][0]["attn"]
        assert a["wq"].shape[1] == a["wk"].shape[1] == 10 and a["bk"].shape == (10, 128)
    if arch == "olmoe-1b-7b" and R == 4:
        layer = full_meta[(arch, R, 3)]["seg0"][0]
        assert layer["attn"]["wq"].shape == layer["attn"]["wk"].shape == (2048, 4, 128)
        assert layer["ffn"]["w_gate"].shape == (16, 2048, 1024)
        assert layer["ffn"]["router"].shape == (2048, 64)
    if arch == "deepseek-v2-lite-16b" and R == 4:  # MLA: heads split, the compressed path whole
        dense, moe = full_meta[(arch, R, 1)]["seg0"][0], full_meta[(arch, R, 1)]["seg1"][0]
        a = dense["attn"]
        assert a["wq"].shape == (2048, 4, 192) and a["wkv_a"].shape == (2048, 576)
        assert a["wk_b"].shape == (512, 4, 128) and a["wv_b"].shape == (512, 4, 128)
        assert a["wo"].shape == (4, 128, 2048) and a["kv_norm"]["scale"].shape == (512,)
        assert dense["ffn"]["w_down"].shape == (2736, 2048)  # d_ff 10,944
        assert moe["ffn"]["w_gate"].shape == (16, 2048, 1408)
        assert moe["ffn"]["shared"]["w_up"].shape == (2048, 704)  # 2 x 1,408 over 4
    if arch == "whisper-medium" and R == 4:  # 16 heads: 4 q and 4 kv a process
        tree = full_meta[(arch, R, 2)]
        for attn in (tree["encoder"][0]["attn"], tree["decoder"][1]["cross_attn"]):
            assert attn["wk"].shape == (1024, 4, 64) and attn["bv"].shape == (4, 64)
            assert attn["wo"].shape == (4, 64, 1024)
        assert tree["decoder"][0]["mlp"]["w_in"].shape == (1024, 1024)
        assert tree["decoder"][0]["mlp"]["b_out"].shape == (1024,)
        assert tree["embedding"]["table"].shape == (51865, 1024)  # an odd vocab stays whole


@pytest.mark.parametrize("R", PROCESSES)
@pytest.mark.parametrize("vocab", [0, 512])
def test_expert_leaves_hold_the_reference_shard_shapes(ref_shapes, vocab, R):
    """OLMoE's smoke config placed for each process of ``R`` (2 units a
    process): every leaf the reference's shard shape on ``data x model``
    with ``model`` = R, so its 8 experts lie ``8 / R`` a process, in
    contiguous runs (process ``r`` holds experts ``r * 8 / R ..``), and
    the vocab splits only at 512."""
    ref, pairs = ref_shapes
    api = registry.build(_smoke("olmoe-1b-7b", vocab))
    whole = api.init(0, device="cpu")
    for r in range(R):
        placed = api.init(0, device="cpu", place=tensor_place(api.param_specs, _fake_ctx(R, r)))
        for (path, spec), (_, t), (_, p) in zip(leaves_with_paths(api.param_specs),
                                                leaves_with_paths(whole),
                                                leaves_with_paths(placed)):
            assert list(p.shape) == _ref_shard_shapes(ref, pairs, tuple(t.shape), spec, R), \
                (path, spec)
        n = 8 // R
        ffn, ffn_whole = placed["seg0"][1]["ffn"], whole["seg0"][1]["ffn"]
        assert torch.equal(ffn["w_down"], ffn_whole["w_down"][r * n:(r + 1) * n])
        assert torch.equal(ffn["router"], ffn_whole["router"])


def _fake_ctx(R: int, r: int) -> MeshContext:
    """Process ``r``'s tensor context over ``R`` processes a pod each, for
    what needs no collective (placement, counting, the refusals)."""
    return MeshContext(Mesh(R, UNITS, num_processes=R, process_index=r), rules=tensor_rules())


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_placed_init_equals_the_whole_init_sliced(arch):
    """``init`` with ``tensor_place`` draws the whole tree from the seed and
    keeps each process's slices: exactly ``tensor_slices`` of the whole
    init, which ``convert.tensor_params`` also gives."""
    api = registry.build(_smoke(arch, 512))
    whole = api.init(0, device="cpu")
    for R in PROCESSES:
        for r in range(R):
            ctx = _fake_ctx(R, r)
            placed = api.init(0, device="cpu", place=tensor_place(api.param_specs, ctx))
            cut = tensor_slices(whole, api.param_specs, ctx)
            converted = convert.tensor_params(whole, api.cfg, ctx)
            for a, b, c in zip(leaves(placed), leaves(cut), leaves(converted)):
                assert torch.equal(a, b) and torch.equal(a, c)
                assert a.untyped_storage().size() == a.numel() * a.element_size()


def test_kv_heads_a_process_reads():
    cfg = get_config("qwen2.5-3b")  # 16 heads, 2 kv heads
    with mesh_context(_fake_ctx(4, 1)):
        assert L.kv_heads_read(cfg) == [0] and L.local_kv_heads(cfg) == 1
    with mesh_context(_fake_ctx(4, 3)):
        assert L.kv_heads_read(cfg) == [1]
    with mesh_context(_fake_ctx(2, 1)):  # kv heads split: the process holds its own
        assert L.kv_heads_read(cfg) is None and L.local_kv_heads(cfg) == 1
    odd = cfg.scaled(num_heads=12, num_kv_heads=3)  # 3 q heads a process, groups of 4
    with mesh_context(_fake_ctx(4, 1)):
        assert L.kv_heads_read(odd) == [0, 1, 1]
    whole = get_smoke_config("qwen1.5-32b")  # 5 heads: nothing split
    with mesh_context(_fake_ctx(4, 0)):
        assert L.kv_heads_read(whole) is None and L.local_kv_heads(whole) == 5
    assert L.kv_heads_read(cfg) is None and L.local_kv_heads(cfg) == 2


@pytest.mark.parametrize("arch,R,kv", [("deepseek-67b", 4, 2), ("qwen1.5-32b", 4, 10),
                                       ("qwen2.5-3b", 4, 1), ("deepseek-67b", 2, 4),
                                       ("olmoe-1b-7b", 4, 4)])
def test_cache_holds_the_process_kv_heads(arch, R, kv):
    """``init_cache`` allocates the kv heads the process attends with;
    ``cache_specs`` stays the reference's (``kv_seq`` over ``model``)."""
    api = registry.build(get_config(arch))
    with mesh_context(_fake_ctx(R, 0)):
        cache = api.init_cache(8, 2064, device="meta")
    assert cache["seg0"]["k"].shape == (get_config(arch).num_layers, 8, 2064, kv, 128)
    assert api.cache_spec_fn()["seg0"]["k"] == (None, "batch", "kv_seq", None, None)


@pytest.mark.parametrize("R", PROCESSES)
def test_mla_and_whisper_caches_under_the_tensor_table(R):
    """MLA's compressed ``c``/``kr`` cache carries no head dim and stays
    whole on every process (ROADMAP §C, a deliberate difference: the
    reference's ``cache_specs`` put ``kv_seq`` on ``model``); Whisper's four
    caches hold the process's ``16 / R`` kv heads."""
    mla = registry.build(get_config("deepseek-v2-lite-16b"))
    whisper = registry.build(get_config("whisper-medium"))
    with mesh_context(_fake_ctx(R, R - 1)):
        c = mla.init_cache(8, 2064, device="meta")
        w = whisper.init_cache(2, 1541, device="meta")
    assert c["seg1"]["c"].shape == (26, 8, 2064, 512) and c["seg1"]["kr"].shape == (26, 8, 2064, 64)
    assert mla.cache_spec_fn()["seg1"]["c"] == (None, "batch", "kv_seq", None)
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        assert w[name].shape == (24, 2, 1541, 16 // R, 64)
        assert whisper.cache_spec_fn()[name] == (None, "batch", "kv_seq", None, None)
    assert whisper.init_cache(2, 1541, device="meta")["cross_k"].shape[3] == 16


def test_whisper_cross_kv_reads_the_process_kv_heads():
    """Over 4 processes, 4 query heads and 2 kv heads: the kv heads stay
    whole and each process's cross K/V are the one kv head its query head
    reads (``kv_heads_read``), as its self-attention's are."""
    from repro_torch.models import whisper

    cfg = _smoke("whisper-medium").scaled(num_kv_heads=2)
    api = registry.build(cfg)
    p = api.init(0, device="cpu")["decoder"][0]["cross_attn"]
    memory = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    k, v = whisper._memory_kv(p, cfg, memory)
    for r in range(4):
        ctx = _fake_ctx(4, r)
        mine = tensor_slices(p, api.param_specs["decoder"][0]["cross_attn"], ctx)
        assert mine["wq"].shape[1] == 1 and mine["wk"].shape[1] == 2
        with mesh_context(ctx):
            got_k, got_v = whisper._memory_kv(mine, cfg, memory)
        assert torch.equal(got_k, k[:, :, [r // 2]]) and torch.equal(got_v, v[:, :, [r // 2]])


def test_grow_cache_grows_only_the_positions():
    """A prefill cache grows to the engine's capacity along its ``kv_seq``
    dim alone: a leaf of other kv heads (a 4-head cache where the template
    holds 2, say) raises instead of growing with heads of zeros."""
    from repro_torch.serve import grow_cache

    api = registry.build(_smoke("whisper-medium"))
    cache = api.init_cache(2, 6, device="cpu")
    for name, leaf in cache.items():
        leaf.normal_(generator=torch.Generator().manual_seed(len(name)))
    grown = grow_cache(api, cache, 2, 9)
    for name, leaf in grown.items():
        assert leaf.shape == (2, 2, 9, 4, 16)
        assert torch.equal(leaf[:, :, :6], cache[name]) and not leaf[:, :, 6:].any()
    with mesh_context(_fake_ctx(2, 0)):  # the template holds 2 of the 4 kv heads
        with pytest.raises(ValueError, match="outside its positions"):
            grow_cache(api, cache, 2, 9)
    with pytest.raises(ValueError, match="outside its positions"):  # rows
        grow_cache(api, {k: v[:, :1] for k, v in cache.items()}, 2, 9)
    with pytest.raises(ValueError, match="exceeds"):
        grow_cache(api, cache, 2, 5)


def test_training_refuses_the_tensor_table(monkeypatch):
    """Queue A item 9(d)(i): under the tensor table and on a ``data x model``
    grid the dense family trains (its runs against the reference:
    ``tests/test_torch_train_grid.py``; here a process's gradient on its
    pieces, the collectives stood in by its own part, is finite and shaped
    like its pieces), while the families of item 9(d)(ii), Mamba2, OLMoE,
    DeepSeek-V2-Lite, Qwen2-VL and Whisper, make ``make_grad_fn``'s gradient
    and the training launcher raise, naming the item; off the table the same
    step runs."""
    from repro_torch.core import exchange
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch import train as train_cli
    from repro_torch.train.step import TrainState, make_grad_fn, state_shardings

    monkeypatch.setattr(exchange, "_all_reduce", lambda mesh, t, op=None: t.clone())
    monkeypatch.setattr(exchange, "_all_gather",
                        lambda mesh, t: torch.stack([t] * mesh.num_processes))
    monkeypatch.setattr(exchange, "_reduce_scatter",
                        lambda mesh, t: t.chunk(mesh.num_processes)[mesh.process_index])
    api = registry.build(_smoke("qwen2.5-3b").scaled(num_layers=1))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    grad_fn = make_grad_fn(api)
    loss, _ = grad_fn(api.init(0, device="cpu"), batch)
    assert torch.isfinite(loss)
    grid = MeshContext(Mesh(2, UNITS, 2, 1), rules=default_rules(False),
                       axis_sizes={"data": 2, "model": 2}, data=Mesh(2, 1, 2, 1))
    for ctx in (_fake_ctx(2, 0), grid):
        mine = TrainState.create(api, 0, device="cpu", shardings=state_shardings(api, ctx)).params
        with mesh_context(ctx):
            loss, grads = grad_fn(mine, batch)
        assert torch.isfinite(loss)
        assert [g.shape for g in leaves(grads)] == [t.shape for t in leaves(mine)]
    for arch in ("mamba2-1.3b", "olmoe-1b-7b", "deepseek-v2-lite-16b", "qwen2-vl-2b",
                 "whisper-medium"):
        other = make_grad_fn(registry.build(get_smoke_config(arch)))
        for ctx in (_fake_ctx(2, 0), grid):
            with mesh_context(ctx):
                with pytest.raises(NotImplementedError, match=r"item 9\(d\)\(ii\)"):
                    other(None, batch)
        with mesh_context(_fake_ctx(2, 0)):
            with pytest.raises(NotImplementedError, match=r"item 9\(d\)\(ii\)"):
                train_cli.main(["--arch", arch, "--smoke", "--steps", "1"], device="cpu")


def test_continuous_engine_and_one_process_meshes_refuse():
    """The continuous engine serves the tensor table's transformer families,
    MLA included (its runs: ``tests/test_torch_tensor_continuous.py``), and
    refuses the encoder-decoder and SSM families through their missing
    ``decode_step_slots``, with the reference's message, as it does off the
    table; a mesh inside one process has no tensor table."""
    for arch in ("deepseek-67b", "olmoe-1b-7b", "deepseek-v2-lite-16b"):
        with mesh_context(_fake_ctx(2, 0)):
            ContinuousEngine(registry.build(get_smoke_config(arch)), batch_size=2, capacity=8,
                             device="cpu")
    for arch in ("whisper-medium", "mamba2-1.3b"):
        api = registry.build(get_smoke_config(arch))
        with mesh_context(_fake_ctx(2, 0)):
            with pytest.raises(NotImplementedError, match=f"family '{api.cfg.family}' does not "
                                                          "provide decode_step_slots"):
                ContinuousEngine(api, batch_size=2, capacity=8, device="cpu")
    for mesh in (make_mesh(8, 2), make_mesh(8)):
        with pytest.raises(ValueError, match="tensor table"):
            MeshContext(mesh, rules=tensor_rules())
        with pytest.raises(ValueError, match="tensor table"):
            make_context(mesh=mesh, rules=tensor_rules())
    assert not MeshContext(make_mesh(8, 2)).tensor
    assert not MeshContext(make_mesh(8, 2), rules=unit_rules(True)).tensor
    assert _fake_ctx(2, 0).tensor
    assert {k for k, v in tensor_rules().table.items() if v} == \
        {"heads", "kv_heads", "d_ff", "vocab", "experts", "ssm_heads", "conv_dim"}
    assert tensor_rules().table["experts"] == ("pod", "q") == unit_rules(True).table["experts"]


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_layer_slices_sum_to_the_whole_layer(monkeypatch, shared):
    """OLMoE's MoE layer under the tensor table on each process's slices
    (the dense path: each process's experts for every token, weighted by
    their router columns), with and without a shared-experts MLP, whose
    width (48) splits over 4 where ``d_ff`` (here 50) does not: every
    process all-reduces once for the routed experts and once for the shared
    MLP, and the processes' partial sums add up to the whole layer's output
    (the all-reduce stood in for by the sum over the processes here)."""
    from repro_torch.models import moe as M

    calls = []

    def partial(y, ctx):
        calls.append(tuple(y.shape))
        return y

    monkeypatch.setattr(M, "tensor_all_reduce", partial)
    monkeypatch.setattr(L, "tensor_all_reduce", partial)
    cfg = get_smoke_config("olmoe-1b-7b").scaled(num_shared_experts=shared, d_ff=50)
    p = M.init_moe_layer(L.make_generator(0, "cpu"), cfg)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want = M.moe_ffn(p, cfg, x)
    R = 4
    got = torch.zeros_like(want)
    for r in range(R):
        ctx = _fake_ctx(R, r)
        mine = tensor_slices(p, M.specs_moe_layer(cfg), ctx)
        assert mine["w_gate"].shape[0] == cfg.num_experts // R
        with mesh_context(ctx), M.record_paths() as paths:
            got += M.moe_ffn(mine, cfg, x)
        assert paths == ["dense-tensor"]
    per_process = [(10, cfg.d_model)] + [(2, 5, cfg.d_model)] * shared
    assert calls == per_process * R
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_record_routes_gives_each_call_its_top_k_sets_and_margins():
    """``moe.record_routes`` (the four-card probe's ``--tp-routes``): each MoE
    layer call's top-k sets, ascending, the router's own (``moe.route``),
    and the gap between each token's k-th and (k+1)-th router logit; nothing
    is recorded outside the block."""
    from repro_torch.models import moe as M

    cfg = get_smoke_config("olmoe-1b-7b")
    p = M.init_moe_layer(L.make_generator(0, "cpu"), cfg)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with M.record_routes() as routes:
        M.moe_ffn(p, cfg, x)
        M.moe_ffn(p, cfg, x[:, :2])
    M.moe_ffn(p, cfg, x)
    assert [r[0].shape for r in routes] == [(10, cfg.top_k), (4, cfg.top_k)]
    ids, margin = routes[0]
    tokens = x.reshape(10, cfg.d_model)
    _, idx = M.route(p, cfg, tokens)
    assert ids.dtype == torch.int16 and torch.equal(ids.long(), idx.sort(dim=-1).values)
    top = (tokens.float() @ p["router"]).topk(cfg.top_k + 1).values
    torch.testing.assert_close(margin, top[:, cfg.top_k - 1] - top[:, cfg.top_k])
    assert (margin >= 0).all()
