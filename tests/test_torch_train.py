"""The port's training path (train100m, flash attention) against the JAX package.

At train100m's smoke config widened to d_model 128 with 4 query and 2 KV
heads (head_dim 32) and ``attn_impl="flash"``, so that at seq 256 the
reference really runs its Pallas kernel (interpret mode) and the port its
kernel's wrapper.  The reference's params (from ``jax.random``) go through
:mod:`repro_torch.models.convert`; tokens are made with numpy from a seed.
Tolerances: the loss within rtol 1e-5, every gradient leaf at 1e-4; three
train steps with params and ``loss``/``grad_norm``/``lr`` within 1e-5
(f32 sums in another order).  The data pipeline must give the reference's
batches bit for bit; checkpoints and the CLI must resume exactly.
"""

import os
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import exchange
from repro_torch.core.exchange import make_mesh
from repro_torch.data import (Prefetcher, SyntheticLM, TokenFileDataset, make_batch_iterator,
                              write_token_file)
from repro_torch.distributed.sharding import MeshContext, mesh_context
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import convert, registry, transformer
from repro_torch.train import AdamWConfig, TrainState, adamw_init, adamw_update, lr_at
from repro_torch.train import make_train_step
from repro_torch.train.step import local_rows, make_grad_fn
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

OVER = dict(d_model=128, num_heads=4, num_kv_heads=2, attn_impl="flash")
B, S = 4, 256


def _np_tree(jax, tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jref():
    """The reference's model at the test config, its step-0 state, one
    batch, its loss and gradients, and three of its train steps."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import make_train_step as ref_make_train_step
    from repro.train.step import TrainState as RefTrainState

    cfg = ref_smoke("train100m").scaled(**OVER)
    api = ref_registry.build(cfg)
    state = RefTrainState.create(api, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(api.train_loss)(state.params, jbatch)
    step = jax.jit(ref_make_train_step(api, RefAdamW()))
    steps, s = [], state
    for _ in range(3):
        s, m = step(s, jbatch)
        steps.append(({k: float(v) for k, v in m.items()}, _np_tree(jax, s.params)))
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, params=_np_tree(jax, state.params), batch=batch,
        loss=float(loss), grads=_np_tree(jax, grads), steps=steps,
    )


def _port(jref, **over):
    cfg = get_smoke_config("train100m").scaled(**{**OVER, **over})
    api = registry.build(cfg)
    params = convert.from_reference(jref.params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in jref.batch.items()}
    return api, TrainState.from_params(params), batch


def _by_path(tree) -> dict:
    return dict(leaves_with_paths(tree))


def _assert_trees_close(got, want, rtol, atol):
    """Leaf for leaf, matched by path (the reference's dicts come back with
    sorted keys)."""
    got, want = _by_path(got), _by_path(convert.from_reference(want, device="cpu"))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].detach().numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=str(path))


# ----------------------------------------------------------------------------
# Model: loss and gradients.
# ----------------------------------------------------------------------------

def test_params_have_the_reference_structure(jref):
    api, state, _ = _port(jref)
    mine = api.init(0, device="cpu")
    want = convert.from_reference(jref.params, device="cpu")
    assert sorted((p, tuple(t.shape), t.dtype) for p, t in leaves_with_paths(mine)) == \
        sorted((p, tuple(t.shape), t.dtype) for p, t in leaves_with_paths(want))
    assert "unembed" not in mine["embedding"]  # tied


def test_full_width_params_match_the_reference_shapes(jref):
    """train100m as configured (12 layers, d_model 768, tied): every leaf's
    shape and dtype equals the reference's (``jax.eval_shape`` of its init,
    its stacked segment leaves split per layer); 100,092,672 params."""
    from repro.configs import get_config as ref_get_config
    from repro.models import registry as ref_registry

    jax = jref.jax
    shapes = jax.eval_shape(ref_registry.build(ref_get_config("train100m")).init,
                            jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        if keys[0].startswith("seg"):
            for layer in range(leaf.shape[0]):
                want[(keys[0], layer) + keys[1:]] = (leaf.shape[1:], str(leaf.dtype))
        else:
            want[keys] = (leaf.shape, str(leaf.dtype))
    params = registry.build(get_config("train100m")).init(0, device="cpu")
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in leaves_with_paths(params)}
    assert got == want
    assert sum(t.numel() for t in leaves(params)) == 100_092_672


def test_train_loss_and_grads_match_reference(jref, monkeypatch):
    api, state, batch = _port(jref)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    live = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    loss = api.train_loss(live, batch)
    grads = unflatten(live, torch.autograd.grad(loss, leaves(live)))
    assert len(calls) == jref.cfg.num_layers, "the flash wrapper runs in every layer"
    np.testing.assert_allclose(loss.item(), jref.loss, rtol=1e-5)
    _assert_trees_close(grads, jref.grads, rtol=1e-4, atol=1e-4)


def test_bf16_train_loss_matches_reference(jref, monkeypatch):
    """bf16 compute over f32 master params, the reference's default dtypes,
    with ``attn_impl="flash"`` (the reference's Pallas kernel in interpret
    mode, the port's wrapper in bf16): the loss within rtol 2**-7, four units
    of bf16 roundoff (u = 2**-9), since the two frameworks round the bf16
    activations at other places; the gradient norms within 2**-5 (16 u)."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry

    jax, jnp = jref.jax, jref.jnp
    ref_api = ref_registry.build(ref_smoke("train100m").scaled(**OVER, dtype="bfloat16"))
    jparams = jax.tree.map(jnp.asarray, jref.params)
    jbatch = {k: jnp.asarray(v) for k, v in jref.batch.items()}
    want, want_g = jax.value_and_grad(ref_api.train_loss)(jparams, jbatch)
    api, state, batch = _port(jref, dtype="bfloat16")
    dtypes = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, *a, **k: dtypes.append(q.dtype) or real(q, *a, **k))
    live = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    loss = api.train_loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    assert dtypes == [torch.bfloat16] * jref.cfg.num_layers
    np.testing.assert_allclose(loss.item(), float(want), rtol=2.0**-7)
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    want_norm = float(jnp.sqrt(sum((g.astype(jnp.float32) ** 2).sum()
                                   for g in jax.tree.leaves(want_g))))
    np.testing.assert_allclose(norm, want_norm, rtol=2.0**-5)


def test_three_train_steps_match_reference(jref):
    api, state, batch = _port(jref)
    step = make_train_step(api, AdamWConfig())
    for i, (want_m, want_p) in enumerate(jref.steps):
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), want_m[k], rtol=1e-5, err_msg=f"step {i} {k}")
        _assert_trees_close(state.params, want_p, rtol=1e-5, atol=1e-5)
    assert int(state.step) == 3 and int(state.opt["count"]) == 3


def test_microbatches_match_the_full_batch(jref):
    """The reference's own tolerances for this check
    (``tests/test_train_ckpt_data.py``)."""
    api, state, batch = _port(jref)
    api2, _, _ = _port(jref, num_microbatches=2)
    s1, m1 = make_train_step(api, AdamWConfig())(state, batch)
    s2, m2 = make_train_step(api2, AdamWConfig())(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-4)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-6)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(api2, AdamWConfig())(state, {k: v[:3] for k, v in batch.items()})


@pytest.mark.parametrize("remat,per_step", [("none", 1), ("block", 2), ("full", 2)])
def test_remat_gives_the_same_loss_and_launch_count(jref, monkeypatch, remat, per_step):
    """Remat recomputes each layer in the backward pass: the flash wrapper
    runs ``per_step`` times a layer a step (``chip_smoke.py`` asserts the
    same count, 2 x 12, for train100m's ``remat="block"`` on the card); the
    chunked path never calls it.  Remat changes no value: the step's loss,
    grad norm and updated params match the reference's first step at the
    tolerances of ``test_three_train_steps_match_reference``."""
    api, state, batch = _port(jref, remat=remat)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    s1, m = make_train_step(api, AdamWConfig())(state, batch)
    assert len(calls) == per_step * jref.cfg.num_layers
    want_m, want_p = jref.steps[0]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), want_m[k], rtol=1e-5, err_msg=k)
    _assert_trees_close(s1.params, want_p, rtol=1e-5, atol=1e-5)
    api_c, _, _ = _port(jref, remat=remat, attn_impl="chunked", attn_q_block=64)
    calls.clear()
    _, mc = make_train_step(api_c, AdamWConfig())(state, batch)
    assert calls == []
    np.testing.assert_allclose(float(mc["loss"]), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mc["grad_norm"]), float(m["grad_norm"]), rtol=1e-4)


# ----------------------------------------------------------------------------
# Optimizer and schedules.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches_reference(jref, schedule):
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import lr_at as ref_lr_at

    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    for s in (0, 1, 5, 10, 11, 50, 89, 90, 95, 100, 150):
        want = float(ref_lr_at(RefAdamW(**kw), jref.jnp.asarray(s, jref.jnp.int32)))
        assert float(lr_at(AdamWConfig(**kw), s)) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_adamw_update_matches_reference_on_given_grads(jref):
    """Three updates from the same gradients (no model in between), at a
    learning rate that moves every param: tight, since only elementwise
    f32 arithmetic differs."""
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import adamw_init as ref_init
    from repro.train import adamw_update as ref_update

    jax, jnp = jref.jax, jref.jnp
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
    params = jax.tree.map(jnp.asarray, jref.params)
    grads = jax.tree.map(jnp.asarray, jref.grads)
    ropt = ref_init(params)
    mine = convert.from_reference(jref.params, device="cpu")
    my_grads = convert.from_reference(jref.grads, device="cpu")
    opt = adamw_init(mine)
    for _ in range(3):
        params, ropt, rm = ref_update(RefAdamW(**kw), grads, ropt, params)
        mine, opt, m = adamw_update(AdamWConfig(**kw), my_grads, opt, mine)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
    _assert_trees_close(mine, _np_tree(jax, params), rtol=1e-6, atol=1e-7)
    _assert_trees_close(opt["m"], _np_tree(jax, ropt["m"]), rtol=1e-6, atol=1e-9)
    _assert_trees_close(opt["v"], _np_tree(jax, ropt["v"]), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("grad_sync", ["hierarchical", "auto"])
@pytest.mark.parametrize("shards,pods", [(8, 2), (8, 1)])
def test_grad_sync_in_one_process_equals_the_no_mesh_step(shards, pods, grad_sync):
    """A mesh that lives in one process: under ``"hierarchical"`` on the pod
    mesh each of the 8 units takes one row and the per-unit gradients go
    through the two-level psum tree; every other case runs the whole batch
    once.  Each equals the no-mesh step: the loss within 1e-6, every
    gradient leaf within 1e-5 of its largest magnitude, one AdamW step's
    params likewise."""
    cfg = get_smoke_config("train100m").scaled(**OVER)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 65), dtype=np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    plain = registry.build(cfg)
    state = TrainState.create(plain, 0, device="cpu")
    want_loss, want = make_grad_fn(plain)(state.params, batch)
    want_state, want_m = make_train_step(plain, AdamWConfig())(state, batch)
    api = registry.build(cfg.scaled(grad_sync=grad_sync))
    with mesh_context(MeshContext(make_mesh(shards, pods))):
        loss, grads = make_grad_fn(api)(state.params, batch)
        got_state, got_m = make_train_step(api, AdamWConfig())(state, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]), rtol=1e-5)
    for tree, ref in ((grads, want), (got_state.params, want_state.params)):
        for (path, g), w in zip(leaves_with_paths(tree), leaves(ref)):
            assert g.shape == w.shape, path
            bound = 1e-5 * float(w.abs().max())
            assert float((g.float() - w.float()).abs().max()) <= bound, path


def test_moe_over_a_mesh_across_processes_raises():
    """The MoE family trains across processes under ``grad_sync="auto"``
    (``tests/test_torch_moe_train.py``); under ``"hierarchical"`` the
    per-unit passes cannot run the expert-parallel layer unit by unit, and
    the step says so before it computes anything (the mesh's process group
    is never reached)."""
    cfg = get_smoke_config("olmoe-1b-7b").scaled(moe_impl="ep_shardmap",
                                                 grad_sync="hierarchical")
    api = registry.build(cfg)
    assert cfg.family == "moe"
    state = TrainState.create(api, 0, device="cpu")
    toks = torch.zeros((4, 9), dtype=torch.int32)
    batch = {"tokens": toks[:, :8], "labels": toks[:, 1:]}
    spanning = exchange.Mesh(2, 4, num_processes=2, process_index=0)
    with mesh_context(MeshContext(spanning)):
        with pytest.raises(NotImplementedError, match=r"hierarchical.*ROADMAP §C"):
            make_train_step(api, AdamWConfig())(state, batch)


def test_local_rows_is_this_process_slice_and_refuses_an_uneven_batch():
    batch = {"tokens": torch.arange(24).reshape(8, 3), "labels": torch.arange(8)}
    for rank in range(2):
        mesh = exchange.Mesh(2, 4, num_processes=2, process_index=rank)
        got = local_rows(batch, mesh)
        assert torch.equal(got["tokens"], batch["tokens"][4 * rank:4 * rank + 4])
        assert torch.equal(got["labels"], batch["labels"][4 * rank:4 * rank + 4])
    assert torch.equal(local_rows(batch, make_mesh(8, 2))["tokens"], batch["tokens"])
    with pytest.raises(ValueError, match="processes"):
        local_rows({k: v[:7] for k, v in batch.items()}, exchange.Mesh(2, 4, 2, 1))


def test_unported_model_features_still_raise():
    """No model feature is left to a later slice: the encoder-decoder family
    (Whisper) builds and takes a train step at its smoke config with frames;
    MLA, M-RoPE, q/k/v biases and the patch prefix, refused before the
    dense-model slice, build and train at train100m's smoke config."""
    wcfg = get_smoke_config("whisper-medium")
    wapi = registry.build(wcfg)
    assert wapi.cfg.family == "encdec" and wapi.decode_step_slots is None
    rng = np.random.default_rng(0)
    wtoks = torch.from_numpy(rng.integers(0, wcfg.vocab_size, (2, 9), dtype=np.int32))
    wbatch = {"tokens": wtoks[:, :8], "labels": wtoks[:, 1:],
              "frames": torch.from_numpy(rng.standard_normal((2, 8, wcfg.d_model),
                                                             dtype=np.float32))}
    state = TrainState.create(wapi, 0, device="cpu")
    state, m = make_train_step(wapi, AdamWConfig(lr=1e-3, warmup_steps=0))(state, wbatch)
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    assert float(m["grad_norm"]) > 0
    cfg = get_smoke_config("train100m")
    toks = torch.zeros((1, 5), dtype=torch.int32)
    batch = {"tokens": toks[:, :4], "labels": toks[:, 1:]}
    for over in (dict(attn_kind="mla", kv_lora_rank=16, qk_nope_head_dim=8,
                      qk_rope_head_dim=8, v_head_dim=8),
                 dict(rope_kind="mrope", mrope_sections=(2, 3, 3)), dict(qkv_bias=True)):
        api = registry.build(cfg.scaled(**over))
        assert torch.isfinite(api.train_loss(api.init(0, device="cpu"), batch))
    params = transformer.init(0, cfg, device="cpu")
    h = transformer.forward(params, cfg, {"tokens": toks[:, :4],
                                          "patches": torch.zeros((1, 2, cfg.d_model))})
    assert h.shape == (1, 6, cfg.d_model)
    assert get_config("train100m").tie_embeddings and get_config("train100m").num_layers == 12


# ----------------------------------------------------------------------------
# Data pipeline.
# ----------------------------------------------------------------------------

def test_batches_equal_the_reference(jref):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.configs.base import ShapeSpec as RefShapeSpec
    from repro.data import SyntheticLM as RefSyntheticLM
    from repro.data import make_batch_iterator as ref_iter

    for start in (0, 3):
        got = make_batch_iterator(get_smoke_config("train100m"), ShapeSpec("t", 32, 8, "train"),
                                  seed=1, start_step=start)
        want = ref_iter(ref_smoke("train100m"), RefShapeSpec("t", 32, 8, "train"), seed=1,
                        start_step=start)
        for _ in range(4):
            g, w = next(got), next(want)
            assert sorted(g) == sorted(w) == ["labels", "tokens"]
            for k in g:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    for shards, shard in ((1, 0), (4, 2)):
        kw = dict(vocab_size=97, seq_len=16, global_batch=8, seed=5, num_shards=shards,
                  shard=shard)
        g, w = SyntheticLM(**kw).batch(2), RefSyntheticLM(**kw).batch(2)
        assert all(np.array_equal(g[k], w[k]) for k in w)


def test_token_file_dataset_equals_the_reference(jref, tmp_path):
    from repro.data import TokenFileDataset as RefTokenFileDataset

    path = str(tmp_path / "toks.bin")
    write_token_file(path, np.arange(10_000) % 251)
    got = TokenFileDataset(path, seq_len=32, global_batch=4, seed=0).batch(3)
    want = RefTokenFileDataset(path, seq_len=32, global_batch=4, seed=0).batch(3)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_unported_families_raise_in_the_pipeline():
    """No family raises in the pipeline any more: an encoder-decoder batch
    carries frame embeddings ``[B, S, d]`` beside its whole token rows; a
    VLM batch gives its last P = S // 2 token positions to patch
    embeddings."""
    shape = ShapeSpec("t", 8, 2, "train")
    ecfg = get_smoke_config("train100m").scaled(family="encdec")
    batch = next(make_batch_iterator(ecfg, shape))
    assert sorted(batch) == ["frames", "labels", "tokens"]
    assert batch["tokens"].shape == batch["labels"].shape == (2, 8)
    assert batch["frames"].shape == (2, 8, ecfg.d_model) and batch["frames"].dtype == np.float32
    cfg = get_smoke_config("train100m").scaled(family="vlm")
    batch = next(make_batch_iterator(cfg, shape))
    assert batch["tokens"].shape == batch["labels"].shape == (2, 4)
    assert batch["patches"].shape == (2, 4, cfg.d_model)


def test_prefetcher_propagates_errors():
    def bad():
        yield {"x": 1}
        raise RuntimeError("boom")

    pf = Prefetcher(bad(), depth=1)
    assert next(pf) == {"x": 1}
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)


# ----------------------------------------------------------------------------
# Checkpoints.
# ----------------------------------------------------------------------------

def _state():
    api = registry.build(get_smoke_config("train100m"))
    return TrainState.create(api, 0, device="cpu")


def _assert_states_equal(a, b):
    pa, pb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_checkpoint_roundtrip_and_retention():
    state = _state()
    state = TrainState(state.params, {**state.opt, "count": state.opt["count"] + 7},
                       state.step + 7)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, every=1, keep=2)
        for s in (1, 2, 3):
            mgr.maybe_save(s, state)
        assert mgr.maybe_save(4, state) is not None and latest_step(d) == 4
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
        got = restore_checkpoint(d, None, _state())
        assert isinstance(got, TrainState) and int(got.step) == 7
        _assert_states_equal(got, state)
        step, again = mgr.restore_latest(_state(), device="cpu")
        assert step == 4
        _assert_states_equal(again, state)


def test_checkpoint_keeps_bfloat16():
    tree = {"w": torch.randn(3, 5).bfloat16(), "n": [torch.arange(4, dtype=torch.int32)]}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        got = restore_checkpoint(d, 1, {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                                        "n": [torch.zeros(4, dtype=torch.int32)]})
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["n"][0], tree["n"][0])


def test_checkpoint_crash_consistency():
    """A stale .tmp directory must not shadow the last good checkpoint."""
    state = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 5, state)
        os.makedirs(os.path.join(d, "step_00000009.tmp"))  # simulated crash
        os.makedirs(os.path.join(d, "step_00000011"))  # no manifest: incomplete
        assert latest_step(d) == 5
        _assert_states_equal(restore_checkpoint(d, None, _state()), state)


def test_checkpoint_missing_leaf_raises():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.ones(3)})
        with pytest.raises(KeyError, match="b"):
            restore_checkpoint(d, 1, {"b": torch.zeros(3)})
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(os.path.join(d, "none"), None, {"a": torch.zeros(3)})


# ----------------------------------------------------------------------------
# The CLI: kill and resume.
# ----------------------------------------------------------------------------

def test_cli_resumes_to_the_uninterrupted_params(capsys):
    from repro_torch.launch.train import main

    common = ["--arch", "train100m", "--smoke", "--seq-len", "32", "--batch", "4",
              "--log-every", "1", "--seed", "3"]
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d2:
        # "killed" after step 3: its last checkpoint is step 2
        main(common + ["--steps", "3", "--ckpt-dir", d, "--ckpt-every", "2"], device="cpu")
        assert latest_step(d) == 2
        resumed, last = main(common + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2"],
                             device="cpu")
        assert "resumed from checkpoint at step 2" in capsys.readouterr().out
        assert latest_step(d) == 6 and int(resumed.step) == 6
        straight, last2 = main(common + ["--steps", "6", "--ckpt-dir", d2], device="cpu")
    _assert_states_equal(resumed, straight)
    assert last == last2 and np.isfinite(last["loss"])
