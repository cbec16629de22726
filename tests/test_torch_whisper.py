"""The port's Whisper-medium (smoke config, f32) against the JAX package.

The reference's params (from ``jax.random``) go through
:mod:`repro_torch.models.convert`; tokens and frames are made with numpy
from a seed.  ``sinusoidal``, ``layernorm``, ``encode``, ``decode_train``,
prefill logits and every cache leaf and four ``decode_step``s on a grown
cache must give the reference's within ``rtol=1e-4, atol=1e-5`` (f32 sums
in another order), ``train_loss`` within rtol 1e-5 and every gradient leaf
within rtol 1e-4 of ``jax.grad``'s (atol 1e-4 of the leaf's largest
magnitude).  The data pipeline's frames equal the reference's bit for bit,
and the static engine's greedy tokens the reference engine's, with the two
parities kept on purpose: the cross cache grown with zero rows that decode
attends over, and decode starting at the frames' length.  The ``gpu`` case
holds the attention kernel to its plain version at the encoder's shape.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as kref
from repro_torch.models import convert, registry
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.serve import ContinuousEngine, Request, ServeEngine, grow_cache
from repro_torch.tree import leaves, leaves_with_paths, unflatten

RTOL, ATOL = 1e-4, 1e-5
B, PLEN, CAP = 2, 8, 20  # frames: PLEN rows unless a test says otherwise


@pytest.fixture(scope="module")
def pair():
    """The reference's smoke Whisper and params, and the port's with the
    reference's params."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import layers as ref_layers
    from repro.models import registry as ref_registry
    from repro.models import whisper as ref_whisper
    from repro.serve import Request as RefRequest
    from repro.serve import ServeEngine as RefServeEngine

    ref_api = ref_registry.build(ref_smoke("whisper-medium"))
    ref_params = jax.jit(ref_api.init)(jax.random.PRNGKey(0))  # one compile, not op by op
    np_params = jax.tree.map(np.asarray, ref_params)
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, ref_api=ref_api, ref_params=ref_params, ref_W=ref_whisper,
        ref_L=ref_layers, np_params=np_params, Request=RefRequest, ServeEngine=RefServeEngine,
        cfg=get_smoke_config("whisper-medium"), api=registry.build(get_smoke_config("whisper-medium")),
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


def _inputs(cfg, seed=0, plen=PLEN, frames=PLEN):
    """``tokens [B, plen]`` and ``frames [B, frames, d]``, as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, plen), dtype=np.int32),
            "frames": rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32)}


def _jax(pair, nb):
    return {k: pair.jnp.asarray(v) for k, v in nb.items()}


def _torch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


# ----------------------------------------------------------------------------
# Params and layers.
# ----------------------------------------------------------------------------

def test_meta_init_has_the_reference_keys_and_shapes(pair):
    """``init(..., device="meta")`` builds the converted reference tree's
    structure and shapes, and the converter keeps every leaf of the stacked
    ``encoder`` and ``decoder``."""
    meta = pair.api.init(0, device="meta")
    want = dict(leaves_with_paths(pair.params))
    got = dict(leaves_with_paths(meta))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        assert got[path].device.type == "meta"
        assert got[path].shape == w.shape and got[path].dtype == w.dtype, path
    n_ref = sum(a.size for a in pair.jax.tree.leaves(pair.np_params))
    assert sum(t.numel() for t in leaves(pair.params)) == n_ref
    assert len(pair.params["encoder"]) == pair.cfg.encoder_layers
    assert len(pair.params["decoder"]) == pair.cfg.num_layers
    assert {"bias", "scale"} == set(pair.params["decoder"][0]["ln3"])


@pytest.mark.parametrize("d,S", [(64, 8), (1024, 2048)])
def test_sinusoidal_matches_reference(pair, d, S):
    pos = np.stack([np.arange(S, dtype=np.int32), np.arange(S, dtype=np.int32)[::-1]])
    want = pair.ref_W.sinusoidal(pair.jnp.asarray(pos), d)
    got = W.sinusoidal(torch.from_numpy(pos.copy()), d)
    assert got.dtype == torch.float32 and got.shape == (2, S, d)
    # the angles reach S rad, where an f32 angle's rounding moves sin and
    # cos by up to one f32 spacing of S
    _close(got.numpy(), want, atol=max(ATOL, float(np.spacing(np.float32(S)))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(pair, dtype):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((B, 5, 64)) + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jdt = getattr(pair.jnp, dtype)
    want = pair.ref_L.layernorm({k: pair.jnp.asarray(v) for k, v in p.items()},
                                pair.jnp.asarray(x).astype(jdt), 1e-5)
    got = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x).to(getattr(torch, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got.numpy(), want)
    else:  # f32 inside, one rounding to bf16 at the end: the same bits
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(pair.jnp.float32)))
    assert L.init_layernorm(64, torch.float32, "cpu")["bias"].abs().sum() == 0


# ----------------------------------------------------------------------------
# Held to the reference.
# ----------------------------------------------------------------------------

def test_encode_matches_reference(pair):
    nb = _inputs(pair.cfg, frames=12)
    want = pair.ref_W.encode(pair.ref_params, pair.ref_api.cfg, pair.jnp.asarray(nb["frames"]))
    got = W.encode(pair.params, pair.cfg, torch.from_numpy(nb["frames"]))
    assert got.shape == (B, 12, pair.cfg.d_model)
    _close(got.numpy(), want)


def test_decode_train_matches_reference(pair):
    nb = _inputs(pair.cfg, seed=1, frames=12)
    memory = pair.ref_W.encode(pair.ref_params, pair.ref_api.cfg, pair.jnp.asarray(nb["frames"]))
    want = pair.ref_W.decode_train(pair.ref_params, pair.ref_api.cfg,
                                   pair.jnp.asarray(nb["tokens"]), memory)
    got = W.decode_train(pair.params, pair.cfg, torch.from_numpy(nb["tokens"]),
                         torch.from_numpy(np.array(memory)))
    _close(got.numpy(), want)
    _close(W.forward(pair.params, pair.cfg, _torch(nb)).numpy(), want)


def test_prefill_matches_reference(pair):
    """Logits and every cache leaf: the self KV of the prompt's length, the
    cross KV of the frames'."""
    nb = _inputs(pair.cfg, seed=2, frames=12)
    want_logits, want_cache = pair.ref_api.prefill(pair.ref_params, _jax(pair, nb))
    got_logits, got_cache = pair.api.prefill(pair.params, _torch(nb))
    _close(got_logits.numpy(), want_logits)
    _close_cache(pair, got_cache, want_cache)
    assert got_cache["self_k"].shape[2] == PLEN and got_cache["cross_k"].shape[2] == 12


def test_four_decode_steps_match_reference(pair):
    """Four tokens after a prefill, from the reference's cache grown to CAP
    positions with zeros (the cross cache too, as the static engine grows
    it): logits and every cache leaf after each step."""
    nb = _inputs(pair.cfg, seed=3)
    _, cache = pair.ref_api.prefill(pair.ref_params, _jax(pair, nb))

    def pad(a):
        a = np.asarray(a)
        width = [(0, 0)] * a.ndim
        width[2] = (0, CAP - a.shape[2])
        return np.pad(a, width)

    np_cache = {k: pad(v) for k, v in cache.items()}
    jcache = {k: pair.jnp.asarray(v) for k, v in np_cache.items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in np_cache.items()}
    step = pair.jax.jit(pair.ref_api.decode_step)
    toks = np.random.default_rng(4).integers(0, pair.cfg.vocab_size, (4, B, 1), dtype=np.int32)
    for i in range(4):
        want_logits, jcache = step(pair.ref_params, pair.jnp.asarray(toks[i]), jcache,
                                   pair.jnp.int32(PLEN + i))
        got_logits, cache = pair.api.decode_step(pair.params, torch.from_numpy(toks[i]), cache,
                                                 PLEN + i)
        _close(got_logits.numpy(), want_logits, msg=f"step {i}")
        _close_cache(pair, cache, jcache)


def test_train_loss_and_every_gradient_match_the_reference(pair):
    """The loss (rtol 1e-5) and every gradient leaf against ``jax.grad``
    (rtol 1e-4; atol 1e-4 of the leaf's largest magnitude).  With no rotary
    positions a key bias shifts every key of a query by one constant, which
    the softmax drops: ``bk``'s gradient is zero in exact arithmetic and
    round-off on both sides, so its atol is 1e-4 of the same block's
    ``wk`` gradient's largest magnitude."""
    nb = _inputs(pair.cfg, seed=5, frames=12)
    nb["labels"] = np.random.default_rng(6).integers(0, pair.cfg.vocab_size, (B, PLEN),
                                                     dtype=np.int32)
    loss, grads = pair.jax.value_and_grad(pair.ref_api.train_loss)(pair.ref_params,
                                                                   _jax(pair, nb))
    live = [t.detach().requires_grad_() for t in leaves(pair.params)]
    params = unflatten(pair.params, live)
    got = pair.api.train_loss(params, _torch(nb))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got_grads = dict(leaves_with_paths(unflatten(params, torch.autograd.grad(got, live))))
    want = dict(leaves_with_paths(
        convert.from_reference(pair.jax.tree.map(np.asarray, grads), device="cpu")))
    assert sorted(got_grads, key=str) == sorted(want, key=str)
    for path, w in want.items():
        scale = want[path[:-1] + ("wk",)] if path[-1] == "bk" else w
        _close(got_grads[path].numpy(), w.numpy(), rtol=1e-4,
               atol=1e-4 * float(scale.abs().max()), msg=str(path))


def test_remat_gives_the_same_loss_and_gradients(pair):
    """Every encoder and decoder layer under ``torch.utils.checkpoint``
    (``remat="block"``) gives the loss and gradients of the plain run."""
    nb = _inputs(pair.cfg, seed=7)
    nb["labels"] = nb["tokens"][:, ::-1].copy()
    out = []
    for remat in ("none", "block"):
        live = [t.detach().clone().requires_grad_() for t in leaves(pair.params)]
        loss = W.train_loss(unflatten(pair.params, live), pair.cfg.scaled(remat=remat),
                            _torch(nb))
        out.append((loss, torch.autograd.grad(loss, live)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        _close(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------------
# The reference's own properties, on the port's side.
# ----------------------------------------------------------------------------

def test_decode_matches_forward():
    """Token-by-token decode after a one-token prefill reproduces the
    teacher-forced decoder (the reference's ``test_decode_matches_forward``
    for Whisper, at its tolerance), the cross cache unpadded."""
    cfg = get_smoke_config("whisper-medium")
    api = registry.build(cfg)
    params = api.init(0, device="cpu")
    nb = _torch(_inputs(cfg, seed=8, plen=16, frames=16))
    toks = nb["tokens"]
    full = L.unembed(params["embedding"], cfg, W.forward(params, cfg, nb))
    _, cache = api.prefill(params, {"frames": nb["frames"], "tokens": toks[:, :1]})
    cache = grow_cache(api, cache, B, toks.shape[1])
    assert cache["cross_k"].shape[2] == 16
    for t in range(1, toks.shape[1]):
        logits, cache = api.decode_step(params, toks[:, t : t + 1], cache, t)
    _close(logits.numpy(), full[:, -1].numpy(), rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_flash_attention_equals_sdpa(part, monkeypatch):
    """``attn_impl="flash"`` (the kernel's plain version on the CPU) against
    ``"sdpa"``: the encoder's non-causal self-attention, the decoder's causal
    one; loss and gradients.  Every encoder layer calls the kernel wrapper
    non-causally, every decoder layer causally."""
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, causal=True, scale=None):
        calls.append(causal)
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(fa, "flash_attention", spy)
    cfg = get_smoke_config("whisper-medium")
    params = registry.build(cfg).init(0, device="cpu")
    nb = _torch(_inputs(cfg, seed=9, plen=16, frames=24))
    if part == "encoder":
        got = W.encode(params, cfg.scaled(attn_impl="flash"), nb["frames"])
        want = W.encode(params, cfg.scaled(attn_impl="sdpa"), nb["frames"])
        assert calls == [False] * cfg.encoder_layers
        _close(got.numpy(), want.numpy())
        return
    nb["labels"] = nb["tokens"].flip(1)
    memory = W.encode(params, cfg, nb["frames"])
    calls.clear()
    got = W.decode_train(params, cfg.scaled(attn_impl="flash"), nb["tokens"], memory)
    assert calls == [True] * cfg.num_layers
    _close(got.numpy(), W.decode_train(params, cfg.scaled(attn_impl="sdpa"), nb["tokens"],
                                       memory).numpy())
    grads = []
    for impl in ("flash", "sdpa"):
        live = [t.detach().requires_grad_() for t in leaves(params)]
        loss = W.train_loss(unflatten(params, live), cfg.scaled(attn_impl=impl), nb)
        grads.append((loss, torch.autograd.grad(loss, live)))
    np.testing.assert_allclose(grads[0][0].item(), grads[1][0].item(), rtol=1e-5)
    for a, b in zip(grads[0][1], grads[1][1]):
        _close(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_flash_at_a_ragged_length_matches_reference(pair, monkeypatch):
    """``attn_impl="flash"`` on both sides at 100 frames: a length that is
    not a multiple of 64 (or of the reference's 128) and the smoke config's
    head dim of 16, so the reference's gate takes its plain path and the
    port's wrapper (on the card: masked tiles, a padded head dim; here its
    plain version) is called once an encoder layer.  Prefill logits and
    every cache leaf, and the static engine's greedy tokens, equal the
    reference's."""
    from repro.models import registry as ref_registry

    frames, new = 100, 6
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, causal=True, scale=None):
        calls.append((tuple(q.shape), causal))
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(fa, "flash_attention", spy)
    cfg = pair.cfg.scaled(attn_impl="flash")
    ref_api = ref_registry.build(pair.ref_api.cfg.scaled(attn_impl="flash"))
    api = registry.build(cfg)
    nb = _inputs(cfg, seed=13, frames=frames)
    want_logits, want_cache = ref_api.prefill(pair.ref_params, _jax(pair, nb))
    got_logits, got_cache = api.prefill(pair.params, _torch(nb))
    hd = cfg.d_model // cfg.num_heads
    assert calls == [((B, cfg.num_heads, frames, hd), False)] * cfg.encoder_layers
    _close(got_logits.numpy(), want_logits)
    _close_cache(pair, got_cache, want_cache)

    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, PLEN, dtype=np.int32) for _ in range(B)]
    extra = {"frames": nb["frames"]}
    want = [pair.Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
    got = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
    cap = frames + new + 1
    pair.ServeEngine(ref_api, batch_size=B, capacity=cap).generate(
        pair.ref_params, want, extra_inputs=extra)
    ServeEngine(api, batch_size=B, capacity=cap, device="cpu").generate(
        pair.params, got, extra_inputs=extra)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == new for r in got)


# ----------------------------------------------------------------------------
# The data pipeline, the engines and the launchers.
# ----------------------------------------------------------------------------

def test_batch_iterator_frames_equal_the_reference():
    """``make_batch_iterator`` for Whisper: frames ``[B, S, d]`` from the
    reference's per-step generator, bit for bit, beside its tokens and
    labels."""
    pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.configs.base import ShapeSpec as RefShapeSpec
    from repro.data.pipeline import make_batch_iterator as ref_iterator

    cfg = get_smoke_config("whisper-medium")
    want = ref_iterator(ref_smoke("whisper-medium"), RefShapeSpec("t", 24, 4, "train"), seed=3,
                        start_step=2)
    got = make_batch_iterator(cfg, ShapeSpec("t", 24, 4, "train"), seed=3, start_step=2)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(g) == sorted(w) == ["frames", "labels", "tokens"]
        assert g["tokens"].shape == (4, 24) and g["frames"].shape == (4, 24, cfg.d_model)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def _engine_pair(pair, frames: int, cap: int, new: int = 6):
    """Four requests through both packages' static engines at batch B with
    ``frames`` frame rows a request; the port's decode positions recorded."""
    rng = np.random.default_rng(10 + frames)
    prompts = [rng.integers(0, pair.cfg.vocab_size, PLEN, dtype=np.int32) for _ in range(4)]
    extra = {"frames": rng.standard_normal((B, frames, pair.cfg.d_model)).astype(np.float32)}
    want = [pair.Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
    got = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
    positions = []
    real = pair.api.decode_step

    def decode_step(params, tokens, cache, pos):
        positions.append(pos)
        return real(params, tokens, cache, pos)

    se = pair.ServeEngine(pair.ref_api, batch_size=B, capacity=cap)
    ours = ServeEngine(dataclasses.replace(pair.api, decode_step=decode_step), batch_size=B,
                       capacity=cap, device="cpu")
    for i in range(0, 4, B):
        se.generate(pair.ref_params, want[i : i + B], extra_inputs=extra)
        ours.generate(pair.params, got[i : i + B], extra_inputs=extra)
    return got, want, positions


def test_static_engine_matches_reference_over_a_zero_padded_cross_cache(pair):
    """Parity 1: the static engine grows the cross cache from the frames'
    length to ``capacity`` with zeros, and decode attends over those rows
    (no length mask on cross-attention, as in the reference).  The greedy
    tokens equal the reference engine's, and the padded rows do move the
    logits against a decode over the unpadded cross cache."""
    got, want, positions = _engine_pair(pair, frames=PLEN, cap=CAP)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 6 for r in got)
    assert positions == list(range(PLEN, PLEN + 5)) * 2

    nb = _torch(_inputs(pair.cfg, seed=11))
    logits, cache = pair.api.prefill(pair.params, nb)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    grown = grow_cache(pair.api, {k: v.clone() for k, v in cache.items()}, B, CAP)
    unpadded = dict(grown, cross_k=cache["cross_k"], cross_v=cache["cross_v"])
    padded_logits, _ = pair.api.decode_step(pair.params, tok, grown, PLEN)
    exact_logits, _ = pair.api.decode_step(pair.params, tok, unpadded, PLEN)
    assert grown["cross_k"].shape[2] == CAP and not torch.allclose(padded_logits, exact_logits)


@pytest.mark.parametrize("frames", [12, 5])
def test_static_engine_starts_decode_at_the_frames_length(pair, frames):
    """Parity 2: decode starts where the reference reads it, the position
    axis of its first sorted cache leaf (``cross_k``): the frames' length,
    longer or shorter than the prompt.  The greedy tokens equal the
    reference engine's."""
    got, want, positions = _engine_pair(pair, frames=frames, cap=CAP)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert positions == list(range(frames, frames + 5)) * 2


def test_continuous_engine_refuses_encdec(pair):
    """Whisper has no per-slot decode, in either package."""
    from repro.serve import ContinuousEngine as RefContinuousEngine

    assert pair.api.decode_step_slots is None
    with pytest.raises(NotImplementedError, match="decode_step_slots") as got:
        ContinuousEngine(pair.api, batch_size=B, capacity=CAP, device="cpu")
    with pytest.raises(NotImplementedError, match="decode_step_slots") as want:
        RefContinuousEngine(pair.ref_api, batch_size=B, capacity=CAP)
    assert str(got.value) == str(want.value)


def test_the_full_config_builds():
    cfg = get_config("whisper-medium")
    assert (cfg.family, cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.num_heads,
            cfg.vocab_size) == ("encdec", 24, 24, 1024, 16, 51_865)
    api = registry.build(cfg)
    cache = api.init_cache(4, 1600, device="meta")
    assert sorted(cache) == ["cross_k", "cross_v", "self_k", "self_v"]
    assert all(tuple(c.shape) == (24, 4, 1600, 16, 64) for c in cache.values())
    assert 0.75e9 < cfg.param_count() < 0.85e9


def test_train_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    state, last = main(["--arch", "whisper-medium", "--smoke", "--steps", "3", "--seq-len", "16",
                        "--batch", "2", "--log-every", "1"], device="cpu")
    out = capsys.readouterr().out
    assert int(state.step) == 3 and np.isfinite(last["loss"])
    assert "step     3" in out and "done" in out


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "whisper-medium", "--smoke", "--requests", "4", "--batch", "2",
          "--prompt-len", "8", "--max-new", "4"], device="cpu")
    out = capsys.readouterr().out
    assert "static: 4 requests, 16 tokens" in out
    with pytest.raises(NotImplementedError, match="decode_step_slots"):
        main(["--arch", "whisper-medium", "--smoke", "--continuous", "--requests", "4",
              "--batch", "2", "--prompt-len", "8", "--max-new", "4"], device="cpu")


# ----------------------------------------------------------------------------
# On the card.
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_at_the_encoder_shape_matches_plain_version(cuda_device):
    """The encoder's self-attention on the card: B=8, H=KH=16, S=2,048,
    D=64, non-causal, bf16, one launch counted in both keys."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((8, 16, 2048, 64), generator=gen, device=cuda_device).bfloat16()
               for _ in range(3))
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=False)
    want = kref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention[noncausal]": 1,
                           "flash_attention[ragged]": 0}
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
