"""Dense training on a ``data x model`` grid of REAL processes (Gloo on the
CPU) against the reference: ``launch.mesh.make_grid_context``, the
collectives' backward (``distributed.sharding``: the row-parallel exit, the
column-parallel entry, the gathered logits, the FSDP gather), the grid's
gradient sync and clipping norm (``train/step.py``, ``train/optim.py``), the
sharded create and the checkpoint of pieces split along two dims.

ONE cluster of 8 Gloo processes runs the ``grid_train`` scenario of
``tests/_torch_multiproc_driver.py`` on the reference's ``(4, 2)`` mesh and
on a ``(2, 4)`` grid built from the same processes.  Two cells: Qwen2.5-3B's
smoke config (the reference's ``sharded_train_equiv`` cell: vocab 509, which
stays whole; over ``model = 4`` its 2 kv heads stay whole and each process
reads one) and the same at a vocab of 512, which both grids split (the masked
lookup, the gathered logits, the tied table taking both gradients), under
``remat="block"`` (each layer's FSDP gather again in its recompute).  The
global batch is 8 x 16 tokens drawn with numpy from seed 0, the params the
port's ``init(0)`` with ``attn_impl="flash"`` (the kernel's plain version on
the CPU).

The reference's gate (``tests/_multidev_driver.py:241-272``): the JAX
package's one-device ``make_train_step`` on the same params (stacked into
its layout) and batch, run here: the first step's loss within rtol 1e-5 and
its ``grad_norm`` within rtol 1e-4.  Against the port's one-process step on
the whole batch (run by every worker): the loss within rtol 1e-5, every
gradient piece within 1e-5 of its leaf's max, two steps' losses, norms and
params (within 1e-5), the replicated leaves bit-identical within their
group, each group's bytes by kind to the count from the shapes.  Each
process's leaf shapes equal the reference's shard shapes on the same mesh
(``tests/_torch_sharding_ref_run.py``, one subprocess on 8 fake devices).
The state saved on ``(4, 2)`` restores onto ``(2, 4)`` bit for bit (the
reference's ``ckpt_elastic``), and ``launch.train --grid 4x2`` resumes from
its checkpoint.  In process: a 2-way split attention block and MLP, and an
FSDP leaf's gather and reduce-scatter, with the collectives stood in by sums
over the slices, give the whole block's gradients; ``state_shardings`` on a
grid names both split dims.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import exchange
from repro_torch.core.exchange import Mesh
from repro_torch.distributed.sharding import (
    MeshContext,
    default_rules,
    fsdp_gather,
    mesh_context,
    tensor_rules,
    tensor_slices,
)
from repro_torch.launch.cluster import run_local_cluster
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.train.step import Shard, state_shardings
from repro_torch.tree import leaves, leaves_with_paths, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
ARCH = "qwen2.5-3b"
#: (key, vocab, remat): the smoke vocab (509, whole) and one both grids
#: split, under remat (the recompute gathers again)
CELLS = [(ARCH, 0, ""), (f"{ARCH}:v512", 512, "block")]
LAYOUTS = {"4x2": (4, 2), "2x4": (2, 4)}
B, S = 8, 16
PROCESSES = 8
#: the reference mesh's resolutions, by layout (``_torch_sharding_ref_run``)
MESH_KEYS = {"4x2": "data4_model2:False:True", "2x4": "data2_model4:False:True"}


def _cfg(vocab: int = 0, remat: str = ""):
    cfg = get_smoke_config(ARCH).scaled(attn_impl="flash")
    cfg = cfg.scaled(remat=remat) if remat else cfg
    return cfg.scaled(vocab_size=vocab) if vocab else cfg


def _batch(cfg) -> dict:
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _stacked(params: dict) -> dict:
    """Port params in the reference's layout (numpy): each list of layers
    stacked on a leading dim."""
    return {k: tree_map(lambda *ts: np.stack([t.numpy() for t in ts]), *v)
            if isinstance(v, list) else tree_map(lambda t: t.numpy(), v)
            for k, v in params.items()}


def _reference_step(vocab: int) -> dict:
    """The reference's one-device step (``make_train_step``, jitted) on the
    port's ``init(0)`` and the test's batch: its loss and grad norm."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.train import AdamWConfig, make_train_step
    from repro.train.optim import adamw_init
    from repro.train.step import TrainState

    cfg = ref_smoke(ARCH)
    api = ref_registry.build(cfg.scaled(vocab_size=vocab) if vocab else cfg)
    params = jax.tree.map(jax.numpy.asarray,
                          _stacked(registry.build(_cfg(vocab)).init(0, device="cpu")))
    state = TrainState(params=params, opt=adamw_init(params),
                       step=jax.numpy.zeros((), jax.numpy.int32))
    batch = {k: jax.numpy.asarray(v) for k, v in _batch(api.cfg).items()}
    _, m = jax.jit(make_train_step(api, AdamWConfig(lr=1e-3)))(state, batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _cluster(tmp) -> list:
    """Every process's ``grid_train`` record."""
    cells = ",".join(f"{ARCH}:0:{v}:{r}" if v else ARCH for _, v, r in CELLS)
    outs = run_local_cluster(
        [DRIVER, "grid_train", "--grid-cells", cells, "--grid-layouts", ",".join(LAYOUTS),
         "--grid-shape", f"{B}x{S}", "--grid-ckpt", str(tmp / "ckpt"), "--dump", str(tmp)],
        num_processes=PROCESSES, local_units=1, timeout_s=300, echo=False, backend="gloo",
        device="cpu", env={"OMP_NUM_THREADS": "1"},
    )
    assert all("PASS grid_train" in o for o in outs), outs
    got = []
    for pid in range(PROCESSES):
        with open(tmp / f"p{pid}.json") as f:
            got.append(json.load(f)["results"]["grid_train"])
    return got


def _pairs() -> list:
    """Every param leaf of both cells as ``[whole shape, logical axes]``."""
    out = []
    for _, vocab, _ in CELLS:
        api = registry.build(_cfg(vocab))
        for (_, spec), (_, t) in zip(leaves_with_paths(api.param_specs),
                                     leaves_with_paths(api.init(0, device="meta"))):
            out.append([list(t.shape), list(spec)])
    return out


def _resolve(tmp) -> dict:
    src, dst = tmp / "in.json", tmp / "out.json"
    src.write_text(json.dumps({"configs": [], "pairs": _pairs()}))
    out = subprocess.run([sys.executable, os.path.join(HERE, "_torch_sharding_ref_run.py"),
                          str(src), str(dst)], capture_output=True, text=True, timeout=300)
    assert "PASS torch_sharding_ref" in out.stdout, out.stdout + out.stderr
    return json.loads(dst.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cluster and the reference's resolutions in threads beside the
    reference's steps here (the cluster waits on localhost and subprocesses
    most of its time)."""
    tmp = tmp_path_factory.mktemp("grid")
    with ThreadPoolExecutor(2) as pool:
        cluster = pool.submit(_cluster, tmp)
        resolved = pool.submit(_resolve, tmp)
        reference = {key: _reference_step(vocab) for key, vocab, _ in CELLS}
        return {"cluster": cluster.result(), "resolved": resolved.result(),
                "reference": reference}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_grid_step_meets_the_reference_gate(runs, key, layout):
    """``sharded_train_equiv``'s gate on every process: the first step's
    loss within rtol 1e-5 and grad norm within rtol 1e-4 of the JAX
    package's one-device step."""
    want = runs["reference"][key]
    for rec in runs["cluster"]:
        got = rec[key]["layouts"][layout]["metrics"][0]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"], (got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_grid_step_equals_the_one_process_step(runs, key, layout):
    """Every process against its own one-process step on the whole batch:
    the loss, every gradient piece (1e-5 of its leaf's max), two steps'
    losses (1e-5), norms (1e-4) and params (1e-5)."""
    for rec in runs["cluster"]:
        r = rec[key]["layouts"][layout]
        assert r["loss_rel"] <= 1e-5 and r["grad_rel"] <= 1e-5, r
        assert len(r["step_loss_rel"]) == 2 and max(r["step_loss_rel"]) <= 1e-5
        assert max(r["step_norm_rel"]) <= 1e-4
        assert max(r["params_abs"]) <= 1e-5


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_replicated_leaves_identical_and_the_groups_bytes(runs, key, layout):
    """Leaves whole over the model row are bit-identical on the row, those
    whole over the data column on the column; each group carried the
    shapes' count by kind (``_grid_hop_bytes`` in the multiprocess script), the same on
    every step, and no process stands at another's coordinates."""
    coords = set()
    for rec in runs["cluster"]:
        r = rec[key]["layouts"][layout]
        assert r["identical"] == {"model": True, "data": True}
        assert r["step_hop"] == [r["hop_want"]] * 2
        assert set(r["hop_want"]["data"]) == {"all-gather", "reduce-scatter", "all-reduce"}
        coords.add(tuple(r["coords"]))
    D, M = LAYOUTS[layout]
    assert coords == {(d, m) for d in range(D) for m in range(M)}


def _ref_shard_shape(resolved: dict, index: int, shape: list, layout: str) -> list:
    D, M = LAYOUTS[layout]
    spec = resolved["resolved"][MESH_KEYS[layout]][index]
    return [n // (D if a == "data" else M if a == "model" else 1) for n, a in zip(shape, spec)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_each_process_holds_the_reference_shard_shapes(runs, key, layout):
    """Each process's param leaves have the reference's shard shapes on the
    same mesh: its ``logical_sharding`` under ``default_rules(False)``,
    strict, the dims on ``data`` divided by D and those on ``model`` by M."""
    pairs = _pairs()
    offset = 0 if key == ARCH else len(pairs) // 2
    cfg = _cfg(next(v for k, v, _ in CELLS if k == key))
    paths = ["/".join(map(str, p)) for p, _ in leaves_with_paths(registry.build(cfg).param_specs)]
    for rec in runs["cluster"]:
        got = rec[key]["layouts"][layout]["shapes"]
        assert list(got) == paths
        for i, path in enumerate(paths):
            shape = pairs[offset + i][0]
            assert got[path] == _ref_shard_shape(runs["resolved"], offset + i, shape, layout), path


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_state_saved_on_one_grid_restores_onto_another(runs, key):
    """``ckpt_elastic``: the train state after two steps on ``(4, 2)``, saved
    by pieces (each once, by its owner), restored onto ``(2, 4)``'s pieces:
    both grids' pieces equal the whole restored state's slices, bit for
    bit."""
    for rec in runs["cluster"]:
        assert rec[key]["layouts"]["4x2"]["elastic"] == {"a": True, "b": True, "b_shapes": True}


def test_launcher_trains_on_a_grid_and_resumes(runs):
    """``launch.train --grid 4x2``: a step with a checkpoint, then a run to
    2 steps resuming from it, ends where 2 uninterrupted steps end."""
    for rec in runs["cluster"]:
        cli = rec["launcher"]
        assert cli["resumed"] and cli["equal"] and cli["step"] == 2, cli


def _tensor_ctx(R: int, r: int) -> MeshContext:
    return MeshContext(Mesh(R, 1, num_processes=R, process_index=r), rules=tensor_rules())


def _grid_ctx(D: int, M: int, d: int, m: int) -> MeshContext:
    return MeshContext(Mesh(M, 1, M, m, label="model"), rules=default_rules(False),
                       axis_sizes={"data": D, "model": M}, data=Mesh(D, 1, D, d, label="data"))


@pytest.fixture
def partial_sums(monkeypatch):
    """The model row's all-reduce stood in by this process's own part: the
    test adds the processes' outputs and gradients itself."""
    monkeypatch.setattr(exchange, "_all_reduce", lambda mesh, t, op=None: t.clone())


def _whole_and_split(block, specs, params, x, R, cotangent):
    """``block(params, x)``'s output and gradients (input and params),
    whole, and each of ``R`` processes' on its slices with partial sums."""
    xw = x.clone().requires_grad_()
    pw = tree_map(lambda t: t.clone().requires_grad_(), params)
    y = block(pw, xw)
    (y * cotangent).sum().backward()
    whole = (y.detach(), xw.grad, tree_map(lambda t: t.grad, pw))
    parts = []
    for r in range(R):
        ctx = _tensor_ctx(R, r)
        mine = tree_map(lambda t: t.clone().requires_grad_(), tensor_slices(params, specs, ctx))
        xr = x.clone().requires_grad_()
        with mesh_context(ctx):
            yr = block(mine, xr)
        (yr * cotangent).sum().backward()
        parts.append((yr.detach(), xr.grad, tree_map(lambda t: t.grad, mine), ctx))
    return whole, parts


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("block", ["attention", "mlp"])
def test_split_block_gradients_sum_to_the_whole_block(partial_sums, block, R):
    """A block on each process's slices (``R = 2``: kv heads split; ``R =
    4``: Qwen2.5-3B's 2 kv heads whole, each process reading one): the
    processes' outputs and input gradients add up to the whole block's; a
    split leaf's gradient is the whole gradient's slice, and a whole kv
    leaf's (``wk``, ``wv``, ``bk``, ``bv``) adds up over the processes, which
    ``tensor_entry`` sums on a real row."""
    cfg = _cfg()
    gen = L.make_generator(0, "cpu")
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    if block == "attention":
        params, specs = L.init_attention(gen, cfg), L.specs_attention(cfg)
        pos = torch.arange(5)[None].repeat(2, 1)
        cos, sin = L.rope_tables(cfg, pos, cfg.resolved_head_dim)
        fn = lambda p, h: L.attention_block(p, cfg, h, cos, sin)  # noqa: E731
    else:
        params, specs = L.init_mlp(gen, cfg), L.specs_mlp(cfg)
        fn = lambda p, h: L.mlp_block(p, cfg, h)  # noqa: E731
    for name in ("bq", "bk", "bv"):  # biases off zero, so their gradients are read
        if name in params:
            params[name] = torch.randn(params[name].shape, generator=torch.Generator()
                                       .manual_seed(len(name)))
    cot = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(2))
    (y, dx, dp), parts = _whole_and_split(fn, specs, params, x, R, cot)
    torch.testing.assert_close(sum(p[0] for p in parts), y, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sum(p[1] for p in parts), dx, rtol=1e-5, atol=1e-6)
    for name in params:
        got = [p[2][name] for p in parts]
        if got[0].shape == dp[name].shape:  # whole on every process: the parts add up
            torch.testing.assert_close(sum(got), dp[name], rtol=1e-5, atol=1e-6)
        else:
            for g, (*_, ctx) in zip(got, parts):
                want = tensor_slices({name: dp[name]}, {name: specs[name]}, ctx)[name]
                torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)
    if block == "attention":  # over 4 the 2 kv heads stay whole, over 2 they split
        assert (parts[0][2]["wk"].shape == dp["wk"].shape) == (R == 4)


def test_gate_norm_split_gradients_equal_the_whole(monkeypatch):
    """Mamba2's ``gate_norm`` over split SSM heads, each of 2 processes a
    thread whose all-reduce sums the threads' tensors: each process's
    input gradient is its slice of the whole norm's, which needs the sum of
    squares' gradient summed over the processes (``tensor_shared_sum``), and
    the scale's gradients add up to the whole one's."""
    import threading

    from repro_torch.models import mamba2

    cfg = get_smoke_config("mamba2-1.3b")
    R, d_inner = 2, mamba2.dims(cfg)[0]
    y = torch.randn((2, 5, d_inner), generator=torch.Generator().manual_seed(1))
    scale = 1 + 0.1 * torch.randn(d_inner, generator=torch.Generator().manual_seed(2))
    cot = torch.randn((2, 5, d_inner), generator=torch.Generator().manual_seed(3))
    yw, sw = y.clone().requires_grad_(), scale.clone().requires_grad_()
    (mamba2._gate_norm({"scale": sw}, cfg, yw) * cot).sum().backward()
    handed, barrier = [None] * R, threading.Barrier(R)

    def all_reduce(mesh, t, op=None):
        handed[mesh.process_index] = t
        barrier.wait()
        total = sum(handed)
        barrier.wait()
        return total

    monkeypatch.setattr(exchange, "_all_reduce", all_reduce)
    dl, got = d_inner // R, [None] * R

    def run(r):
        yr = y[..., r * dl:(r + 1) * dl].clone().requires_grad_()
        sr = scale.clone().requires_grad_()
        with mesh_context(_tensor_ctx(R, r)):
            out = mamba2._gate_norm({"scale": sr}, cfg, yr)
            (out * cot[..., r * dl:(r + 1) * dl]).sum().backward()
        got[r] = (yr.grad, sr.grad)

    with ThreadPoolExecutor(R) as pool:
        list(pool.map(run, range(R)))
    torch.testing.assert_close(torch.cat([g[0] for g in got], -1), yw.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sum(g[1] for g in got), sw.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,dim", [("w_gate", 0), ("w_down", 1)])
def test_fsdp_gather_and_reduce_scatter_give_the_whole_gradient(monkeypatch, name, dim):
    """An MLP leaf split along its ``fsdp`` dim (``w_gate``'s 0, ``w_down``'s
    1) over a data column of 2, each process on its rows of a batch: the
    gather joins the pieces (the all-gather stood in by the known pieces),
    each process hands the reduce-scatter its rows' gradient of the whole
    leaf, so their sum is the whole batch's, and the rule gives back this
    process's block along the leaf's ``fsdp`` dim."""
    cfg = _cfg()
    w = L.init_mlp(L.make_generator(0, "cpu"), cfg)[name]
    spec = L.specs_mlp(cfg)[name]
    x = torch.randn((4, 3, w.shape[0]), generator=torch.Generator().manual_seed(1))
    D = 2
    pieces = list(w.chunk(D, dim=dim))
    handed = []

    def scatter(mesh, g):
        handed.append(g.movedim(0, dim))
        return g.chunk(D, dim=0)[mesh.process_index]

    monkeypatch.setattr(exchange, "_all_gather", lambda mesh, t: torch.stack(pieces))
    monkeypatch.setattr(exchange, "_reduce_scatter", scatter)
    got = []
    for d in range(D):
        mine = pieces[d].clone().requires_grad_()
        full = fsdp_gather({name: mine}, {name: spec},
                           {name: torch.empty(w.shape, device="meta")}, _grid_ctx(D, 2, d, 0))
        assert torch.equal(full[name], w)
        (x[2 * d:2 * d + 2] @ full[name]).square().sum().backward()
        got.append(mine.grad)
    ww = w.clone().requires_grad_()
    (x @ ww).square().sum().backward()
    assert len(handed) == D
    torch.testing.assert_close(sum(handed), ww.grad, rtol=1e-5, atol=1e-5)
    for d in range(D):
        assert torch.equal(got[d], handed[d].chunk(D, dim=dim)[d])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_state_shardings_name_both_dims_on_a_grid(runs, layout):
    """On a grid ``state_shardings`` gives ``wq`` (``fsdp``, heads) and
    ``w_gate`` (``fsdp``, ``d_ff``) a :class:`Shard` along both dims, the
    reference's resolved specs' (dim 0 on ``data``, dim 1 on ``model``),
    ``wk`` over 4 only its ``fsdp`` dim, and each process its own run of
    each."""
    D, M = LAYOUTS[layout]
    cfg = _cfg()
    api = registry.build(cfg)
    pairs = _pairs()
    index = {"/".join(map(str, path)): i
             for i, (path, _) in enumerate(leaves_with_paths(api.param_specs))}
    for d in range(D):
        for m in range(M):
            sh = state_shardings(api, _grid_ctx(D, M, d, m))
            layer = sh.params["seg0"][0]
            for sub, name, size in (("attn", "wq", cfg.num_heads), ("ffn", "w_gate", cfg.d_ff)):
                held = layer[sub][name]
                spec = runs["resolved"]["resolved"][MESH_KEYS[layout]][index[f"seg0/0/{sub}/{name}"]]
                assert spec[:2] == ["data", "model"]
                n, k = cfg.d_model // D, size // M
                assert held == Shard(0, d * n, (d + 1) * n, cfg.d_model,
                                     (Shard(1, m * k, (m + 1) * k, size),))
                assert held.dims()[1] == Shard(1, m * k, (m + 1) * k, size)
            wk = layer["attn"]["wk"]
            assert [h.dim for h in wk.dims()] == ([0] if M == 4 else [0, 1])
            assert sh.opt["m"]["seg0"][0]["attn"]["wq"] == layer["attn"]["wq"]
            assert sh.params["final_norm"]["scale"] is None
    assert len(pairs) == 2 * len(leaves(api.param_specs))
