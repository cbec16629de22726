"""Tensor-parallel serving of the SSM and hybrid families across REAL
processes (Gloo on the CPU) against the reference: the Mamba2 block's
head-aligned cut (``models/mamba2.py``: ``tensor_index``, the ``gate_norm``
and ``out_proj`` all-reduces), ``distributed.sharding``'s
``ssm_heads`` and ``conv_dim`` in the tensor table, ``init``'s
``tensor_place``, ``convert.tensor_params``, Zamba2's prefill writing its
KV cache at the engine's capacity, and the static engine's ``"tensor"``
rows.

The reference's own ``ServeEngine`` runs each cell on one device (greedy,
4 x 16-token prompts + 4 new, the Mamba2 and Zamba2 smoke configs in f32,
at their own vocab and at 512), each call's logits and the prefill's SSM
states recorded, on params that the port's ``init`` draws from seed 0 and
stacks into the reference's layout.  Then ONE port cluster a process count
(2 and 4 processes of 2 units over Gloo) runs the driver's
``tensor_serve`` scenario (``tests/_torch_multiproc_driver.py``,
``--tp-states``) on the reference's params cut into each process's slices,
Zamba2 under ``attn_impl="flash"`` (the kernel's plain version on the CPU)
and ``"sdpa"``: every call's logits and each process's heads of the
prefill states within ``rtol = atol = 2e-4``, greedy tokens equal to the
reference's and on every process, the pod hop's bytes equal to a count
from the shapes (two all-reduces a Mamba2 layer).  Beside them, ``launch.serve
--tensor`` clusters print the one-process launcher's batches.

In process: each process's leaves are the head-aligned slices of the whole
tree and put back together give it; the leaves both cuts resolve alike
have the reference's shard shapes (``logical_sharding`` on ``data x
model``, ONE subprocess on 8 fake devices, ``tests/_torch_sharding_ref_run.py``),
at smoke size and at full width on ``meta``; the cache holds the process's
SSM heads, conv channels and kv heads.  With threads standing in for the
processes (a barrier-backed all-reduce): a head count the processes do not
divide keeps the block whole and equal to the reference, ``gate_norm``
normalises over the whole ``d_inner`` (a local norm would not match), and
the cut refuses ``B``/``C`` in more than one group.  The refusals: MLA and encoder-decoder
under the tensor table (``tests/test_torch_tensor_parallel.py``), and the
continuous engine for the SSM and hybrid families.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import exchange
from repro_torch.core.exchange import Mesh
from repro_torch.distributed.sharding import (
    MeshContext,
    mesh_context,
    tensor_place,
    tensor_rules,
    tensor_slices,
)
from repro_torch.launch.cluster import run_local_cluster
from repro_torch.models import convert, registry
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as MB
from repro_torch.serve import ContinuousEngine
from repro_torch.serve.engine import grow_cache
from repro_torch.tree import leaves, leaves_with_paths, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
ARCHS = ["mamba2-1.3b", "zamba2-7b"]
#: (key, arch, vocab, impl): the smoke configs at their own (odd, whole)
#: vocab and at 512 (split), Zamba2 under "flash" and, at its own vocab, "sdpa"
CELLS = [("mamba2-1.3b", "mamba2-1.3b", 0, ""), ("mamba2-1.3b:v512", "mamba2-1.3b", 512, ""),
         ("zamba2-7b", "zamba2-7b", 0, ""), ("zamba2-7b:v512", "zamba2-7b", 512, ""),
         ("zamba2-7b:sdpa", "zamba2-7b", 0, "sdpa")]
#: the threaded check's config: 10 SSM heads, which 4 processes do not divide
UNEVEN = ("mamba2-1.3b:d40", "mamba2-1.3b", {"d_model": 40})
B, S, NEW = 4, 16, 4
TOL = 2e-4
PROCESSES = (2, 4)
UNITS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every tensor here is small: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, vocab=0, **over):
    cfg = get_smoke_config(arch)
    return cfg.scaled(**({"vocab_size": vocab} if vocab else {}), **over)


def _stacked(params: dict) -> dict:
    """Port params in the reference's layout (numpy): the layer lists
    stacked on leading dims as ``convert.from_reference`` unstacks them."""
    def stack(sub, depth):
        if depth == 0:
            return tree_map(lambda t: t.numpy(), sub)
        return tree_map(lambda *ls: np.stack(ls), *[stack(s, depth - 1) for s in sub])

    return {k: stack(v, convert._stack_depth(k)) for k, v in params.items()}


def _ssm_states(cache) -> dict:
    return {"/".join(map(str, p)): np.array(t, copy=True) for p, t in leaves_with_paths(cache)
            if p[-1] == "ssm"}


@pytest.fixture(scope="module")
def reference(resolver, tmp_path_factory):
    """The reference's params, one-device greedy run (each call's logits,
    the prefill's SSM states, the tokens) of every (arch, vocab) and of the
    uneven config, as the pickles ``--tp-ref`` reads."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import ServeEngine as RefServeEngine
    from repro.models import registry as ref_registry

    out = tmp_path_factory.mktemp("tensor_ssm_ref")
    runs = {(key, arch): ({"vocab_size": vocab} if vocab else {})
            for key, arch, vocab, impl in CELLS if not impl}
    runs[UNEVEN[:2]] = UNEVEN[2]
    for (key, arch), over in runs.items():
        api = ref_registry.build(ref_smoke(arch).scaled(**over))
        params = _stacked(registry.build(_smoke(arch, **over)).init(0, device="cpu"))
        prompts = np.random.default_rng(0).integers(0, api.cfg.vocab_size, (B, S),
                                                    dtype=np.int32)
        engine = RefServeEngine(api, batch_size=B, capacity=S + NEW + 1)
        logits, states = [], []

        def recorded(fn):
            def call(*args):
                got = fn(*args)
                logits.append(np.asarray(got[0]))
                states.append(_ssm_states(got[1]))
                return got
            return call

        engine._prefill, engine._decode = recorded(engine._prefill), recorded(engine._decode)
        reqs = [RefRequest(prompt=p.copy(), max_new_tokens=NEW) for p in prompts]
        engine.generate(jax.tree.map(jax.numpy.asarray, params), reqs)
        with open(out / (key.replace(":", "_") + ".pkl"), "wb") as f:
            pickle.dump({"params": params, "prompts": prompts, "logits": logits,
                         "states": states[0], "tokens": [r.out_tokens for r in reqs]}, f)
    return out


def _cluster(R: int, reference, tmp) -> list:
    """Every process's ``tensor_serve`` record of every cell, over ``R``
    processes."""
    cells = ",".join(f"{arch}:0:{B}x{S}x{NEW}:{vocab}" + (f":{impl}" if impl else "")
                     for _, arch, vocab, impl in CELLS)
    outs = run_local_cluster(
        [DRIVER, "tensor_serve", "--tp-cells", cells, "--tp-ref", str(reference),
         "--tp-states", "--dump", str(tmp)],
        num_processes=R, local_units=UNITS, timeout_s=300, echo=False, backend="gloo",
        device="cpu", env={"OMP_NUM_THREADS": "1"},
    )
    assert all("PASS tensor_serve" in o for o in outs), outs
    got = []
    for pid in range(R):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            got.append(json.load(f)["results"]["tensor_serve"]["archs"])
    return got


CLI = ["--smoke", "--requests", "4", "--batch", "2", "--prompt-len", "8", "--max-new", "4"]


def _launcher(arch: str) -> list:
    """``launch.serve --tensor --arch <arch>`` under ``launch.cluster``, 2
    processes of one unit: each process's printed lines."""
    src = os.path.join(HERE, "..", "src")
    return run_local_cluster(
        ["-m", "repro_torch.launch.serve", "--tensor", "--arch", arch] + CLI, num_processes=2,
        local_units=1, timeout_s=300, echo=False, backend="gloo", device="cpu",
        env={"OMP_NUM_THREADS": "1",
             "PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))},
    )


@pytest.fixture(scope="module")
def clusters(reference, tmp_path_factory):
    """Both clusters (2 and 4 processes) and the launchers' at once."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(PROCESSES) + len(ARCHS)) as pool:
        runs = {R: pool.submit(_cluster, R, reference, tmp_path_factory.mktemp(f"tssm{R}"))
                for R in PROCESSES}
        runs.update({arch: pool.submit(_launcher, arch) for arch in ARCHS})
        return {k: run.result() for k, run in runs.items()}


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
        assert r["attn_impl"] == ("sdpa" if key.endswith("sdpa") else "flash")


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_prefill_states_are_the_reference_heads(dumps, key):
    """Each process's prefill SSM states (every layer's ``[B, H / R, P, N]``)
    equal its heads of the reference's within 2e-4."""
    R, recs = dumps
    H = MB.dims(get_smoke_config(key.split(":")[0]))[1]
    for pid, rec in enumerate(recs):
        r = rec[key]
        assert r["states_close"], (pid, r["state_abs"])
        assert set(r["state_abs"]) == ({"ssm"} if key.startswith("mamba2")
                                       else {"groups/ssm", "tail/ssm"})
        leaf = "layers/0/mamba/A_log" if key.startswith("mamba2") else "groups/0/0/mamba/A_log"
        assert r["leaf_shapes"][leaf] == [H // R]


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_pod_hop_carries_two_reductions_a_mamba_layer(dumps, key):
    """Per call over ``T`` tokens: each Mamba2 layer all-reduces its
    ``gate_norm`` sum of squares (``[B, T, 1]`` f32) and its ``out_proj``
    (``[B, T, d]``); Zamba2's shared block its attention output and MLP
    once a group; the embedding ``[B, T, d]`` where the vocab splits, and
    the ``[B, V / R]`` logits are all-gathered."""
    R, recs = dumps
    _, arch, vocab, _ = next(c for c in CELLS if c[0] == key)
    cfg = _smoke(arch, vocab)
    tokens = B * S + (NEW - 1) * B
    d = cfg.d_model
    blocks = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    per_token = cfg.num_layers * (d + 1) + 2 * blocks * d + d * (cfg.vocab_size % R == 0)
    want = {"all-reduce": per_token * tokens * 4}
    if cfg.vocab_size % R == 0:
        want["all-gather"] = NEW * B * (cfg.vocab_size // R) * 4
    for rec in recs:
        assert rec[key]["hop_kinds"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_tensor_parallel_as_one_process(clusters, capsys, arch):
    """``python -m repro_torch.launch.cluster ... -- -m repro_torch.launch.serve
    --tensor --arch <arch>``: both processes print the one-process
    launcher's batches."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch] + CLI, device="cpu")
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("batch")]
    assert len(want) == 2
    for out in clusters[arch]:
        assert [ln for ln in out.splitlines() if ln.startswith("batch")] == want, out


# ----------------------------------------------------------------------------
# Placement, in process.
# ----------------------------------------------------------------------------

def _fake_ctx(R: int, r: int) -> MeshContext:
    """Process ``r``'s tensor context over ``R`` processes a pod each, for
    what needs no collective."""
    return MeshContext(Mesh(R, UNITS, num_processes=R, process_index=r), rules=tensor_rules())


def _indices(t, spec, cfg, ctx) -> list:
    """Along each dim of a whole leaf, the indices ``ctx``'s process holds."""
    from repro_torch.distributed.sharding import SSM_AXES, logical_sharding

    R, r = ctx.mesh.num_processes, ctx.mesh.process_index
    plain = tuple(None if n in SSM_AXES else n for n in spec)
    out = []
    for d, (name, axes) in enumerate(zip(spec, logical_sharding(tuple(t.shape), *plain,
                                                                ctx=ctx))):
        n = t.shape[d]
        idx = MB.tensor_index(cfg, n, ctx) if name in SSM_AXES else None
        if axes is not None and "pod" in (axes if isinstance(axes, tuple) else (axes,)):
            idx = torch.arange(r * n // R, (r + 1) * n // R)
        out.append(torch.arange(n) if idx is None else idx)
    return out


@pytest.mark.parametrize("R", PROCESSES)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_process_holds_its_head_aligned_slices(arch, R):
    """``init`` with ``tensor_place`` keeps exactly ``tensor_slices`` of the
    whole init (and ``convert.tensor_params``' cut), each in storage of its
    own, and the ``R`` processes' slices put back together give the whole
    tree: every ``B``/``C`` column on every process, each head's ``z``,
    ``x``, ``dt`` and ``out_proj`` rows on one."""
    cfg = _smoke(arch, 512)
    api = registry.build(cfg)
    whole = api.init(0, device="cpu")
    rebuilt = [torch.full_like(t, float("nan")) for t in leaves(whole)]
    for r in range(R):
        ctx = _fake_ctx(R, r)
        placed = api.init(0, device="cpu", place=tensor_place(api.param_specs, ctx,
                                                                   api.tensor_index))
        cut = tensor_slices(whole, api.param_specs, ctx, api.tensor_index)
        converted = convert.tensor_params(whole, cfg, ctx)
        for a, b, c in zip(leaves(placed), leaves(cut), leaves(converted)):
            assert torch.equal(a, b) and torch.equal(a, c)
            assert a.untyped_storage().size() == a.numel() * a.element_size()
        for i, (t, spec, mine) in enumerate(zip(leaves(whole), leaves(api.param_specs),
                                                leaves(placed))):
            rebuilt[i][torch.meshgrid(*_indices(t, spec, cfg, ctx), indexing="ij")] = mine
    for got, want in zip(rebuilt, leaves(whole)):
        assert torch.equal(got, want)
    mamba = (placed["layers"][0] if arch.startswith("mamba2") else placed["groups"][0][0])["mamba"]
    d_inner, H, conv_ch = MB.dims(cfg)
    GN2 = conv_ch - d_inner
    assert mamba["in_proj"].shape == (cfg.d_model, 2 * d_inner // R + GN2 + H // R)
    assert mamba["conv_w"].shape == (cfg.ssm_conv, d_inner // R + GN2)
    assert mamba["out_proj"].shape == (d_inner // R, cfg.d_model)
    assert mamba["gate_norm"]["scale"].shape == (d_inner,)


def test_tensor_index_cuts_by_sections():
    """Mamba2-1.3B over 4 processes (``d_inner`` 4,096, 64 heads, ``2 G N``
    256): process 1 holds ``z`` and ``x`` columns 1,024-2,047 of each, all
    256 ``B``/``C`` columns and heads 16-31 of ``dt``; the reference's equal
    runs of the 8,512-column projection would give it 2,128-4,255."""
    cfg = get_config("mamba2-1.3b")
    ctx = _fake_ctx(4, 1)
    idx = MB.tensor_index(cfg, 8512, ctx).tolist()
    assert idx == (list(range(1024, 2048)) + list(range(5120, 6144)) + list(range(8192, 8448))
                   + list(range(8464, 8480)))
    assert MB.tensor_index(cfg, 4352, ctx).tolist() == list(range(1024, 2048)) + list(
        range(4096, 4352))
    assert MB.tensor_index(cfg, 4096, ctx).tolist() == list(range(1024, 2048))
    assert MB.tensor_index(cfg, 64, ctx).tolist() == list(range(16, 32))
    with mesh_context(ctx):
        assert MB.local_dims(cfg) == (1024, 16, 1280)
    assert MB.tensor_heads(cfg.scaled(d_model=2048 + 32), ctx) == (1, 0)  # 65 heads: whole
    with pytest.raises(ValueError, match="no Mamba section"):
        MB.tensor_index(cfg, 1000, ctx)


def _full(arch):
    """Full width, one group and its tail for Zamba2, two layers for Mamba2."""
    return get_config(arch).scaled(num_layers=2 if arch.startswith("mamba2") else 7)


@pytest.fixture(scope="module")
def resolver(tmp_path_factory):
    """The reference's resolution of every leaf of the smoke (and 512-vocab)
    and full-width trees, and of their caches, on ``data x model`` meshes,
    in its subprocess (started first, read by :func:`ref_shapes`)."""
    pairs = {}

    def add(tree, specs):
        for (_, spec), (_, t) in zip(leaves_with_paths(specs), leaves_with_paths(tree)):
            pairs.setdefault((tuple(t.shape), spec), len(pairs))

    for cfg in [_smoke(a, v) for a in ARCHS for v in (0, 512)] + [_full(a) for a in ARCHS]:
        api = registry.build(cfg)
        add(api.init(0, device="meta"), api.param_specs)
        add(api.init_cache(8, 64, device="meta"), api.cache_spec_fn())
    tmp = tmp_path_factory.mktemp("tensor_ssm_sharding")
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


def _ref_shard_shape(ref, pairs, shape, spec, R):
    mesh_key = {2: "data4_model2", 4: "data2_model4"}[R]
    resolved = ref["resolved"][f"{mesh_key}:False:False"][pairs[(shape, spec)]]
    return [n // R if a == "model" or (isinstance(a, list) and "model" in a) else n
            for n, a in zip(shape, resolved)]


def _alike(t, spec, cfg) -> bool:
    """Does the port's cut resolve this leaf as the reference's does?  Every
    one but those with ``conv_dim`` over ``in_proj``'s and the conv's
    concatenated channels, where the port cuts by sections and the
    reference in equal runs, and the KV cache, which the port places by kv
    heads, not ``kv_seq`` (ROADMAP §C)."""
    d_inner = MB.dims(cfg)[0]
    return "kv_seq" not in spec and all(n != "conv_dim" or w == d_inner
                                        for n, w in zip(spec, t.shape))


@pytest.mark.parametrize("R", PROCESSES)
@pytest.mark.parametrize("size", ["smoke", "smoke512", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_both_cuts_resolve_alike_have_the_reference_shard_shapes(ref_shapes, arch,
                                                                        size, R):
    """``dt_bias``, ``A_log``, ``D``, ``out_proj``'s rows, the ``ssm``
    cache, the attention, MLP and vocab leaves: every process's shape is the
    reference's shard shape (``model`` = R), at smoke size and at full width
    on ``meta`` (Mamba2-1.3B: 32 or 16 of its 64 heads a process; Zamba2-7B:
    56 or 28 of 112, and 16 or 8 of its 32 attention heads; the spec trees
    themselves are held to the reference's by ``tests/test_torch_sharding.py``).
    The cut ``in_proj`` and
    conv hold ``2 d_inner / R + 2 G N + H / R`` and ``d_inner / R + 2 G N``
    columns, the KV cache the process's kv heads at every position."""
    ref, pairs = ref_shapes
    cfg = {"smoke": _smoke(arch), "smoke512": _smoke(arch, 512), "full": _full(arch)}[size]
    api = registry.build(cfg)
    dev = "meta" if size == "full" else "cpu"
    whole = api.init(0, device=dev)
    whole_cache = api.init_cache(8, 64, device="meta")
    d_inner, H, conv_ch = MB.dims(cfg)
    for r in (0, R - 1):
        ctx = _fake_ctx(R, r)
        placed = api.init(0, device=dev, place=tensor_place(api.param_specs, ctx,
                                                                   api.tensor_index))
        with mesh_context(ctx):
            cache = api.init_cache(8, 64, device="meta")
        checked = 0
        for trees in ((api.param_specs, whole, placed), (api.cache_spec_fn(), whole_cache,
                                                         cache)):
            for (path, spec), (_, t), (_, p) in zip(*(leaves_with_paths(x) for x in trees)):
                if _alike(t, spec, cfg):
                    assert list(p.shape) == _ref_shard_shape(ref, pairs, tuple(t.shape), spec,
                                                             R), (path, spec)
                    checked += 1
                elif path[-1] == "in_proj":
                    assert p.shape[1] == 2 * d_inner // R + conv_ch - d_inner + H // R
                elif "kv_seq" in spec:
                    assert p.shape[2:] == (64, cfg.num_kv_heads // R, cfg.resolved_head_dim)
                else:
                    assert p.shape[-1] == d_inner // R + conv_ch - d_inner, path
        assert checked > 0
        if size == "full" and arch == "zamba2-7b":
            assert placed["groups"][0][0]["mamba"]["A_log"].shape == (112 // R,)
            assert placed["shared"]["attn"]["wq"].shape == (3584, 32 // R, 112)
            assert cache["attn"]["k"].shape == (1, 8, 64, 32 // R, 112)
        if size == "full" and arch == "mamba2-1.3b":
            assert cache["ssm"].shape == (2, 8, 64 // R, 64, 128)
            assert cache["conv"].shape == (2, 8, 3, 4096 // R + 256)


# ----------------------------------------------------------------------------
# Threads for processes: a barrier-backed fabric, no process group.
# ----------------------------------------------------------------------------

class _Fabric:
    """Every thread's tensor at a barrier, stacked in process order."""

    def __init__(self, R: int):
        self.bar, self.buf = threading.Barrier(R, timeout=60), [None] * R

    def gather(self, mesh, x):
        self.buf[mesh.process_index] = x
        self.bar.wait()
        out = torch.stack(list(self.buf))
        self.bar.wait()
        return out


def _threaded(monkeypatch, R: int, fn) -> list:
    """``fn(ctx)`` on ``R`` threads, each under its process's tensor context,
    the pod hop's all-reduce and all-gather over a :class:`_Fabric`."""
    fabric = _Fabric(R)
    monkeypatch.setattr(exchange, "_all_reduce", lambda mesh, x: fabric.gather(mesh, x).sum(0))
    monkeypatch.setattr(exchange, "_all_gather", fabric.gather)
    out, errors = [None] * R, []

    def run(r):
        try:
            ctx = MeshContext(Mesh(R, 1, num_processes=R, process_index=r), rules=tensor_rules())
            with mesh_context(ctx):
                out[r] = fn(ctx)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            fabric.bar.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(R)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def test_a_head_count_the_processes_do_not_divide_keeps_the_block_whole(reference,
                                                                          monkeypatch):
    """Mamba2 at ``d_model`` 40 has 10 SSM heads: over 4 processes every
    Mamba leaf stays whole (``d_inner`` 80 would divide, but the block
    keeps one rule), the block runs with no all-reduce, and the static
    engine's logits and tokens equal the reference's."""
    from repro_torch.serve import Request, ServeEngine

    with open(reference / (UNEVEN[0].replace(":", "_") + ".pkl"), "rb") as f:
        ref = pickle.load(f)
    cfg = _smoke(UNEVEN[1], **UNEVEN[2])
    api = registry.build(cfg)
    whole = convert.from_reference(ref["params"], device="cpu")

    def serve(ctx):
        params = convert.tensor_params(whole, cfg, ctx)
        same = all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(whole)))
        reqs = [Request(prompt=p.copy(), max_new_tokens=NEW) for p in ref["prompts"]]
        got = []
        rec = dataclasses.replace(api, prefill=lambda *a, **k: _keep(got, api.prefill(*a, **k)),
                                  decode_step=lambda *a: _keep(got, api.decode_step(*a)))
        exchange.reset_pod_hop()
        ServeEngine(rec, batch_size=B, capacity=S + NEW + 1, device="cpu").generate(params, reqs)
        return same, got, [r.out_tokens for r in reqs], exchange.POD_HOP["bytes"]

    for same, got, tokens, hop in _threaded(monkeypatch, 4, serve):
        assert same and hop == 0  # whole leaves, and no collective at all (vocab 491 whole)
        assert tokens == ref["tokens"]
        for a, b in zip(got, ref["logits"]):
            torch.testing.assert_close(a, torch.from_numpy(b), rtol=TOL, atol=TOL)


def _keep(got: list, out):
    got.append(out[0])
    return out


@pytest.mark.parametrize("R", PROCESSES)
def test_gate_norm_normalises_over_the_whole_d_inner(monkeypatch, R):
    """One Mamba2 block under the head cut (prefill and a decode step): the
    processes' outputs equal the whole block's, which an RMSNorm over a
    process's own ``d_inner / R`` columns would not give."""
    cfg = _smoke("mamba2-1.3b")
    p = MB.init_mamba_block(L.make_generator(0, "cpu"), cfg)
    spec = MB.specs_mamba_block(cfg)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, st = MB.mamba_block(p, cfg, x, return_state=True)
    step, _ = MB.mamba_block_step(p, cfg, x[:, :1], st)

    def block(ctx):
        mine = tensor_slices(p, spec, ctx, registry.build(cfg).tensor_index)
        out, mst = MB.mamba_block(mine, cfg, x, return_state=True)
        return out, MB.mamba_block_step(mine, cfg, x[:, :1], mst)[0]

    for out, got_step in _threaded(monkeypatch, R, block):
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_step, step, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [2, 8, 16])
def test_the_head_cut_refuses_more_than_one_group(monkeypatch, groups):
    """``B``/``C`` in more than one group (16 heads over 4 processes): the
    cut takes ``G = 1``, as every config has, so placing the params raises
    on every process; off the table the same config serves."""
    cfg = _smoke("mamba2-1.3b", ssm_ngroups=groups)
    api = registry.build(cfg)
    whole = api.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match=f"one B/C group, not {groups}"):
        _threaded(monkeypatch, 4, lambda ctx: convert.tensor_params(whole, cfg, ctx))
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    assert api.prefill(whole, {"tokens": tokens})[0].shape == (2, cfg.vocab_size)


@pytest.mark.parametrize("impl", ["sdpa", "flash"])
def test_zamba2_prefill_writes_its_cache_once_at_capacity(impl):
    """``zamba2.prefill(..., capacity=C)`` writes each group's k/v into one
    ``[ng, B, C, kh, hd]`` cache: bit for bit the stacked ``S``-position
    cache grown by the engine, which then keeps the very tensors."""
    cfg = _smoke("zamba2-7b", attn_impl=impl)
    api = registry.build(cfg)
    params = api.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                                                dtype=np.int32))
    want_logits, stacked = api.prefill(params, {"tokens": tokens})
    assert stacked["attn"]["k"].shape[2] == 16
    grown = grow_cache(api, stacked, 2, 40)
    logits, cache = api.prefill(params, {"tokens": tokens}, capacity=40)
    assert torch.equal(logits, want_logits)
    for (path, a), (_, b) in zip(leaves_with_paths(cache), leaves_with_paths(grown)):
        assert a.shape == b.shape and torch.equal(a, b), path
    kept = grow_cache(api, cache, 2, 40)
    assert all(a is b for a, b in zip(leaves(kept), leaves(cache)))
    with pytest.raises(ValueError, match="cannot hold"):
        api.prefill(params, {"tokens": tokens}, capacity=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_still_refuses_the_ssm_and_hybrid_families(arch):
    """Under the tensor table the SSM and hybrid families serve through
    the static engine but have no ``decode_step_slots``, as in the
    reference: the continuous engine refuses them with the reference's
    message."""
    api = registry.build(get_smoke_config(arch))
    with mesh_context(_fake_ctx(2, 0)):
        with pytest.raises(NotImplementedError, match=f"family '{api.cfg.family}' does not "
                                                      "provide decode_step_slots"):
            ContinuousEngine(api, batch_size=2, capacity=8, device="cpu")
