"""The port's six transformer configs of ROADMAP A.12 against the JAX package.

MiniCPM-2B, Qwen2.5-3B, Qwen1.5-32B, DeepSeek-67B, Qwen2-VL-2B and
DeepSeek-V2-Lite-16B at their smoke configs in f32: q/k/v biases, μP scales,
M-RoPE with the VLM patch prefix, MLA with its compressed cache, and shared
experts beside a dense first layer.  The reference's params (from
``jax.random``) go through :mod:`repro_torch.models.convert`; tokens and
patches are made with numpy from a seed.  Forward hidden states, prefill
logits and every cache leaf, four ``decode_step``s and a
``decode_step_slots`` at uneven positions must give the reference's within
``rtol=1e-4, atol=1e-5`` (f32 sums in another order), ``train_loss`` within
rtol 1e-5 and every gradient leaf within rtol 1e-4 of ``jax.grad``'s (atol
1e-4 of the leaf's largest magnitude).  The
reference's own properties hold on the port's side, Qwen2-VL's patches go
through both engines to the reference's greedy tokens, and
``param_count`` equals the reference's for every full-size config the port
builds, Whisper-medium's included.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, registry
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.tree import leaves, leaves_with_paths, unflatten

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["minicpm-2b", "qwen2.5-3b", "qwen1.5-32b", "deepseek-67b", "qwen2-vl-2b",
         "deepseek-v2-lite-16b"]
B, PLEN, CAP, P = 2, 8, 20, 4  # P: VLM patch rows before every prompt
# every full-size config the port builds: the reference's ARCH_IDS and
# train100m
BUILT = ["minicpm-2b", "qwen2.5-3b", "deepseek-67b", "qwen1.5-32b", "mamba2-1.3b",
         "deepseek-v2-lite-16b", "olmoe-1b-7b", "zamba2-7b", "qwen2-vl-2b", "whisper-medium",
         "train100m"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The reference's smoke model and params, and the port's with the
    reference's params."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer

    arch = request.param
    ref_api = ref_registry.build(ref_smoke(arch))
    ref_params = jax.jit(ref_api.init)(jax.random.PRNGKey(0))  # one compile, not op by op
    np_params = jax.tree.map(np.asarray, ref_params)
    return types.SimpleNamespace(
        arch=arch, jax=jax, jnp=jax.numpy, ref_api=ref_api, ref_params=ref_params,
        ref_module=ref_transformer, np_params=np_params,
        api=registry.build(get_smoke_config(arch)),
        params=convert.from_reference(np_params, device="cpu"),
    )


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _ref_leaves(jax, tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close_cache(pair, got, want):
    want = _ref_leaves(pair.jax, want)
    got = {tuple(str(k) for k in path): v for path, v in leaves_with_paths(got)}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        _close(got[key].numpy(), w, msg=str(key))


def _inputs(pair, seed=0, plen=PLEN):
    """Tokens ``[B, plen]`` and, for the VLM, patches ``[B, P, d]``, as
    numpy: ``(numpy batch, reference batch, port batch)``."""
    rng = np.random.default_rng(seed)
    cfg = pair.api.cfg
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, plen), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    return (batch, {k: pair.jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _side(pair) -> int:
    return P if pair.api.cfg.family == "vlm" else 0


def _padded_ref_cache(pair, batch):
    """The reference's prefill cache grown to CAP positions, as numpy."""
    _, cache = pair.ref_api.prefill(pair.ref_params, batch)

    def pad(a):
        a = np.asarray(a)
        width = [(0, 0)] * a.ndim
        width[2] = (0, CAP - a.shape[2])
        return np.pad(a, width)
    return pair.jax.tree.map(pad, cache)


def _port_cache(np_cache):
    return {s: {k: torch.from_numpy(v.copy()) for k, v in d.items()} for s, d in np_cache.items()}


# ----------------------------------------------------------------------------
# Params.
# ----------------------------------------------------------------------------

def test_meta_init_has_the_reference_keys_and_shapes(pair):
    """``init(..., device="meta")`` builds the converted reference tree's
    structure and shapes, allocating nothing."""
    meta = pair.api.init(0, device="meta")
    want = dict(leaves_with_paths(pair.params))
    got = dict(leaves_with_paths(meta))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        assert got[path].device.type == "meta"
        assert got[path].shape == w.shape and got[path].dtype == w.dtype, path


def test_converter_carries_biases_mla_and_shared_leaves(pair):
    """``convert.from_reference`` keeps every leaf of the ``seg{i}`` stacks:
    the q/k/v biases, the MLA projections and the shared experts."""
    n_ref = sum(a.size for a in pair.jax.tree.leaves(pair.np_params))
    assert sum(t.numel() for t in leaves(pair.params)) == n_ref
    cfg = pair.api.cfg
    names = {path[-1] for path, _ in leaves_with_paths(pair.params)}
    if cfg.qkv_bias:
        assert {"bq", "bk", "bv"} <= names
    if cfg.attn_kind == "mla":
        assert {"wkv_a", "wk_b", "wv_b"} <= names
    if cfg.num_shared_experts:
        assert pair.params["seg1"][0]["ffn"]["shared"]["w_gate"].shape[-1] == \
            cfg.moe_d_ff * cfg.num_shared_experts


# ----------------------------------------------------------------------------
# Held to the reference.
# ----------------------------------------------------------------------------

def test_forward_matches_reference(pair):
    _, jb, tb = _inputs(pair)
    want = pair.ref_module.forward(pair.ref_params, pair.ref_api.cfg, jb)
    got = T.forward(pair.params, pair.api.cfg, tb)
    assert got.shape == (B, PLEN + _side(pair), pair.api.cfg.d_model)
    _close(got.numpy(), want)


def test_prefill_matches_reference(pair):
    """Logits and every cache leaf (``k``/``v``, or MLA's ``c``/``kr``),
    the VLM's holding its patch rows before the prompt."""
    _, jb, tb = _inputs(pair)
    want_logits, want_cache = pair.ref_api.prefill(pair.ref_params, jb)
    got_logits, got_cache = pair.api.prefill(pair.params, tb)
    _close(got_logits.numpy(), want_logits)
    _close_cache(pair, got_cache, want_cache)
    assert leaves(got_cache)[0].shape[2] == PLEN + _side(pair)


def test_four_decode_steps_match_reference(pair):
    """Four tokens after a prefill, from the reference's cache grown to CAP
    positions: logits and every cache leaf after each step."""
    _, jb, _ = _inputs(pair, seed=1)
    np_cache = _padded_ref_cache(pair, jb)
    jcache = pair.jax.tree.map(pair.jnp.asarray, np_cache)
    cache = _port_cache(np_cache)
    step = pair.jax.jit(pair.ref_api.decode_step)
    toks = np.random.default_rng(2).integers(0, pair.api.cfg.vocab_size, (4, B, 1), dtype=np.int32)
    pos = PLEN + _side(pair)
    for i in range(4):
        want_logits, jcache = step(pair.ref_params, pair.jnp.asarray(toks[i]), jcache,
                                   pair.jnp.int32(pos + i))
        got_logits, cache = pair.api.decode_step(pair.params, torch.from_numpy(toks[i]), cache,
                                                 pos + i)
        _close(got_logits.numpy(), want_logits, msg=f"step {i}")
        _close_cache(pair, cache, jcache)


def test_decode_step_slots_at_uneven_positions_match_reference(pair):
    _, jb, _ = _inputs(pair, seed=3)
    np_cache = _padded_ref_cache(pair, jb)
    step = np.array([[3], [17]], np.int32)
    positions = np.array([PLEN + _side(pair), PLEN - 3], np.int32)
    want_logits, want_cache = pair.ref_api.decode_step_slots(
        pair.ref_params, pair.jnp.asarray(step), pair.jax.tree.map(pair.jnp.asarray, np_cache),
        pair.jnp.asarray(positions))
    got_logits, got_cache = pair.api.decode_step_slots(
        pair.params, torch.from_numpy(step), _port_cache(np_cache), torch.from_numpy(positions))
    _close(got_logits.numpy(), want_logits)
    _close_cache(pair, got_cache, want_cache)


def _train_batch(pair):
    nb, _, _ = _inputs(pair, seed=4)
    nb["labels"] = np.random.default_rng(5).integers(
        0, pair.api.cfg.vocab_size, nb["tokens"].shape, dtype=np.int32)
    return nb


def test_train_loss_and_every_gradient_match_the_reference(pair):
    """The loss over the text positions (rtol 1e-5) and every gradient leaf
    against ``jax.grad`` (rtol 1e-4; atol 1e-4 of the leaf's largest
    magnitude)."""
    nb = _train_batch(pair)
    loss, grads = pair.jax.value_and_grad(pair.ref_api.train_loss)(
        pair.ref_params, {k: pair.jnp.asarray(v) for k, v in nb.items()})
    live = [t.detach().requires_grad_() for t in leaves(pair.params)]
    params = unflatten(pair.params, live)
    got = pair.api.train_loss(params, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got_grads = dict(leaves_with_paths(unflatten(params, torch.autograd.grad(got, live))))
    want = dict(leaves_with_paths(
        convert.from_reference(pair.jax.tree.map(np.asarray, grads), device="cpu")))
    assert sorted(got_grads, key=str) == sorted(want, key=str)
    for path, w in want.items():
        # f32 sums in another order: near-zero elements within 1e-4 of the
        # leaf's largest magnitude
        _close(got_grads[path].numpy(), w.numpy(), rtol=1e-4,
               atol=1e-4 * float(w.abs().max()), msg=str(path))


# ----------------------------------------------------------------------------
# The reference's own properties, on the port's side.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the teacher-forced forward pass
    (the reference's ``test_decode_matches_forward`` tolerance)."""
    cfg = get_smoke_config(arch)
    api = registry.build(cfg)
    params = api.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 16),
                                                              dtype=np.int32))
    full = L.unembed(params["embedding"], cfg, T.forward(params, cfg, {"tokens": toks}))
    cache = api.init_cache(B, 18, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = api.decode_step(params, toks[:, t : t + 1], cache, t)
    _close(logits.numpy(), full[:, -1].detach().numpy(), rtol=3e-3, atol=3e-3)


def test_prefill_matches_forward():
    cfg = get_smoke_config("minicpm-2b")
    api = registry.build(cfg)
    params = api.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 16),
                                                              dtype=np.int32))
    full = L.unembed(params["embedding"], cfg, T.forward(params, cfg, {"tokens": toks}))
    logits, _ = api.prefill(params, {"tokens": toks})
    _close(logits.numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def test_mrope_sections_differ_from_rope():
    """M-RoPE with distinct t/h/w positions changes the result; with the
    three streams equal it is the default positions' result."""
    cfg = get_smoke_config("qwen2-vl-2b")
    params = registry.build(cfg).init(0, device="cpu")
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 12), dtype=np.int32)),
             "patches": torch.from_numpy(rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))}
    S = 12 + P
    lin = torch.arange(S, dtype=torch.int32)[None, :].repeat(B, 1)
    h0 = T.forward(params, cfg, batch)
    h1 = T.forward(params, cfg, dict(batch, positions=lin[None].expand(3, B, S)))
    h2 = T.forward(params, cfg, dict(batch, positions=torch.stack([lin, lin // 2, lin % 7])))
    assert torch.equal(h0, h1)
    assert not np.allclose(h1.numpy(), h2.numpy())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_chunked_attention_equals_sdpa(arch):
    """Query-block chunking (GQA's ``chunked_sdpa``, MLA's ``_mla_attend``
    loop) gives the one-block loss."""
    cfg = get_smoke_config(arch).scaled(attn_impl="chunked", attn_q_block=4)
    params = registry.build(cfg).init(0, device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (B, 17), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :16]), "labels": torch.from_numpy(toks[:, 1:])}
    chunked = T.train_loss(params, cfg, batch)
    whole = T.train_loss(params, cfg.scaled(attn_impl="sdpa"), batch)
    np.testing.assert_allclose(chunked.item(), whole.item(), rtol=1e-5)


def test_chunked_mla_matches_reference_chunked():
    """The MLA chunk loop against the reference's scan over query blocks."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_transformer

    over = dict(attn_impl="chunked", attn_q_block=4)
    ref_cfg = ref_smoke("deepseek-v2-lite-16b").scaled(**over)
    ref_params = ref_registry.build(ref_cfg).init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(10).integers(0, ref_cfg.vocab_size, (B, 16), dtype=np.int32)
    want = ref_transformer.forward(ref_params, ref_cfg, {"tokens": jax.numpy.asarray(toks)})
    cfg = get_smoke_config("deepseek-v2-lite-16b").scaled(**over)
    params = convert.from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    _close(T.forward(params, cfg, {"tokens": torch.from_numpy(toks)}).numpy(), want)


# ----------------------------------------------------------------------------
# Qwen2-VL's patches through the engines; its data pipeline.
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.serve import ContinuousEngine as RefContinuousEngine
    from repro.serve import Request as RefRequest
    from repro.serve import ServeEngine as RefServeEngine

    ref_api = ref_registry.build(ref_smoke("qwen2-vl-2b"))
    ref_params = ref_api.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("qwen2-vl-2b")
    rng = np.random.default_rng(11)
    return types.SimpleNamespace(
        ref_api=ref_api, ref_params=ref_params, Request=RefRequest, ServeEngine=RefServeEngine,
        ContinuousEngine=RefContinuousEngine, api=registry.build(cfg),
        params=convert.from_reference(jax.tree.map(np.asarray, ref_params), device="cpu"),
        prompts=[rng.integers(0, cfg.vocab_size, PLEN, dtype=np.int32) for _ in range(4)],
        extra={"patches": rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)},
    )


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_vlm_patches_through_the_engines_match_reference(vlm, engine):
    """Patch rows before every prompt: the engines' greedy tokens equal the
    reference engine's, decode continuing after patches + prompt."""
    cap = PLEN + P + 7
    want = [vlm.Request(prompt=p.copy(), max_new_tokens=6) for p in vlm.prompts]
    got = [Request(prompt=p.copy(), max_new_tokens=6) for p in vlm.prompts]
    if engine == "static":
        se = vlm.ServeEngine(vlm.ref_api, batch_size=B, capacity=cap)
        ours = ServeEngine(vlm.api, batch_size=B, capacity=cap, device="cpu")
        for i in range(0, 4, B):
            se.generate(vlm.ref_params, want[i : i + B], extra_inputs=vlm.extra)
            ours.generate(vlm.params, got[i : i + B], extra_inputs=vlm.extra)
        assert ours.stats["decode_steps"] == 2 * 5
    else:
        vlm.ContinuousEngine(vlm.ref_api, batch_size=B, capacity=cap).serve(
            vlm.ref_params, want, extra_inputs=vlm.extra)
        ce = ContinuousEngine(vlm.api, batch_size=B, capacity=cap, device="cpu")
        ce.serve(vlm.params, got, extra_inputs=vlm.extra)
        ce.alloc.check()
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 6 for r in got)


def test_vlm_admission_counts_the_side_input_rows(vlm):
    """A prompt that fits a slot alone but not after its patch rows is
    refused up front, by both packages, with the same message."""
    cap = PLEN + P  # PLEN fits; PLEN + P does not
    prompts = [Request(prompt=vlm.prompts[0].copy(), max_new_tokens=2)]
    with pytest.raises(ValueError, match="side-input rows") as got:
        ContinuousEngine(vlm.api, batch_size=B, capacity=cap, device="cpu").serve(
            vlm.params, prompts, extra_inputs=vlm.extra)
    with pytest.raises(ValueError, match="side-input rows") as want:
        vlm.ContinuousEngine(vlm.ref_api, batch_size=B, capacity=cap).serve(
            vlm.ref_params, [vlm.Request(prompt=vlm.prompts[0].copy(), max_new_tokens=2)],
            extra_inputs=vlm.extra)
    assert str(got.value) == str(want.value)
    assert prompts[0].out_tokens == []  # nothing ran


def test_vlm_batch_iterator_equals_reference():
    """``make_batch_iterator`` for Qwen2-VL: the text positions shrink by
    the patch rows, and the patches come from the reference's per-step
    generator, bit for bit."""
    pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.configs.base import ShapeSpec as RefShapeSpec
    from repro.data.pipeline import make_batch_iterator as ref_iterator

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import make_batch_iterator

    cfg = get_smoke_config("qwen2-vl-2b")
    want = ref_iterator(ref_smoke("qwen2-vl-2b"), RefShapeSpec("t", 24, 4, "train"), seed=3,
                        start_step=2)
    got = make_batch_iterator(cfg, ShapeSpec("t", 24, 4, "train"), seed=3, start_step=2)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(g) == sorted(w) == ["labels", "patches", "tokens"]
        assert g["tokens"].shape == (4, 12) and g["patches"].shape == (4, 12, cfg.d_model)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


# ----------------------------------------------------------------------------
# Parameter counts and the registry.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", BUILT)
def test_param_counts_equal_the_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config

    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
