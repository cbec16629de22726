"""The port's Mamba2-1.3B and Zamba2-7B (smoke configs, f32) against the JAX
package.

The reference's params (from ``jax.random``) go through
:mod:`repro_torch.models.convert`; prompts are made with numpy from a seed.
``prefill``, a run of ``decode_step``s, ``forward`` and ``train_loss`` must
give the reference's logits, caches and values within ``rtol=1e-4,
atol=1e-5`` (f32 sums in another order); the static engine's greedy tokens
must be equal.  Every Mamba2 layer of a prefill goes through
``ops.ssd_scan`` (its plain version on the CPU).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import convert, registry
from repro_torch.serve import ContinuousEngine, Request, ServeEngine, grow_cache
from repro_torch.tree import leaves_with_paths

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["mamba2-1.3b", "zamba2-7b"]
B, PLEN, CAP = 2, 16, 24  # PLEN: two of the smoke configs' 8-token chunks


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The reference's smoke model and params, and the port's with the
    reference's params."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.serve import Request as RefRequest
    from repro.serve import ServeEngine as RefServeEngine

    arch = request.param
    ref_api = ref_registry.build(ref_smoke(arch))
    ref_params = ref_api.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    api = registry.build(get_smoke_config(arch))
    module = __import__(f"repro.models.{'mamba2' if arch.startswith('mamba') else 'zamba2'}",
                        fromlist=["forward"])
    return types.SimpleNamespace(
        arch=arch, jax=jax, jnp=jax.numpy, ref_api=ref_api, ref_params=ref_params,
        ref_module=module, np_params=np_params, Request=RefRequest, ServeEngine=RefServeEngine,
        api=api, params=convert.from_reference(np_params, device="cpu"),
    )


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _ref_leaves(jax, tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close_cache(pair, got, want):
    want = _ref_leaves(pair.jax, want)
    got = {tuple(str(k) for k in path): v for path, v in leaves_with_paths(got)}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        _close(got[key].numpy(), w)


def _prompts(vocab, seed=0, n=B, plen=PLEN):
    return np.random.default_rng(seed).integers(0, vocab, (n, plen), dtype=np.int32)


def test_converter_keeps_every_leaf(pair):
    n_ref = sum(a.size for a in pair.jax.tree.leaves(pair.np_params))
    n_port = sum(t.numel() for _, t in leaves_with_paths(pair.params))
    assert n_port == n_ref


def test_prefill_matches_reference(pair, monkeypatch):
    """Logits and every cache leaf; one ``ops.ssd_scan`` call per Mamba2
    layer."""
    calls = []
    real = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    tokens = _prompts(pair.api.cfg.vocab_size)
    want_logits, want_cache = pair.ref_api.prefill(pair.ref_params,
                                                   {"tokens": pair.jnp.asarray(tokens)})
    got_logits, got_cache = pair.api.prefill(pair.params, {"tokens": torch.from_numpy(tokens)})
    assert len(calls) == pair.api.cfg.num_layers
    _close(got_logits.numpy(), want_logits)
    _close_cache(pair, got_cache, want_cache)


def test_prefill_cache_holds_no_view_of_the_projection(pair):
    """Each cache leaf owns its storage: a conv window kept as a view of the
    layer's ``[B, S, proj]`` projection would hold every layer's projection
    in memory until the prefill ends (26.8 GB at Mamba2-1.3B's 32 k prompt)."""
    from repro_torch.models import mamba2 as MB

    tokens = torch.from_numpy(_prompts(pair.api.cfg.vocab_size))
    h = pair.params["embedding"]["table"][tokens]
    layer = (pair.params["layers"] if "layers" in pair.params else pair.params["tail"])[0]
    _, st = MB.layer_prefill(layer, pair.api.cfg, h)
    for leaf in st.values():
        assert leaf.untyped_storage().nbytes() == leaf.numel() * leaf.element_size()


def test_decode_steps_match_reference(pair):
    """Four decode steps after a prefill, from the reference's cache grown
    to CAP positions, logits and every cache leaf after each step."""
    jax, jnp = pair.jax, pair.jnp
    tokens = _prompts(pair.api.cfg.vocab_size, seed=1)
    _, ref_cache = pair.ref_api.prefill(pair.ref_params, {"tokens": jnp.asarray(tokens)})
    template = jax.eval_shape(lambda: pair.ref_api.init_cache(B, CAP))
    ref_cache = jax.tree.map(
        lambda a, t: jnp.pad(a, [(0, w - h) for h, w in zip(a.shape, t.shape)]), ref_cache,
        template)
    port_cache = grow_cache(pair.api, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), ref_cache), B, CAP)
    steps = np.random.default_rng(2).integers(0, pair.api.cfg.vocab_size, (4, B, 1), dtype=np.int32)
    for i, step in enumerate(steps):
        pos = PLEN + i
        want_logits, ref_cache = pair.ref_api.decode_step(
            pair.ref_params, jnp.asarray(step), ref_cache, jnp.int32(pos))
        got_logits, port_cache = pair.api.decode_step(
            pair.params, torch.from_numpy(step), port_cache, pos)
        _close(got_logits.numpy(), want_logits)
        _close_cache(pair, port_cache, ref_cache)


def test_forward_and_train_loss_match_reference(pair):
    jnp = pair.jnp
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, pair.api.cfg.vocab_size, (B, 24), dtype=np.int32),
             "labels": rng.integers(0, pair.api.cfg.vocab_size, (B, 24), dtype=np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_h = pair.ref_module.forward(pair.ref_params, pair.ref_api.cfg, jbatch)
    _close(pair.api.forward(pair.params, tbatch).numpy(), want_h)
    want = float(pair.ref_api.train_loss(pair.ref_params, jbatch))
    got = float(pair.api.train_loss(pair.params, tbatch))
    assert got == pytest.approx(want, rel=RTOL)


def test_static_greedy_tokens_match_reference(pair):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, pair.api.cfg.vocab_size, PLEN, dtype=np.int32) for _ in range(3)]
    want = [pair.Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    pair.ServeEngine(pair.ref_api, batch_size=4, capacity=32).generate(pair.ref_params, want)
    got = [Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    engine = ServeEngine(pair.api, batch_size=4, capacity=32, device="cpu")
    engine.generate(pair.params, got)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert engine.stats["decode_steps"] == 5


def test_prefill_equals_prefill_then_decode(pair):
    """The check ``chip_smoke.py`` makes at full width: a prefill of 32
    tokens against a prefill of the first 24 and 8 decode steps.  The chunked
    scan and the token-by-token recurrence are two computations of one
    function; f32 rounding is all that tells them apart."""
    api, params = pair.api, pair.params
    tokens = torch.from_numpy(_prompts(api.cfg.vocab_size, seed=5, plen=32))
    want_logits, want_cache = api.prefill(params, {"tokens": tokens})
    _, cache = api.prefill(params, {"tokens": tokens[:, :24]})
    cache = grow_cache(api, cache, B, 32)
    for pos in range(24, 32):
        logits, cache = api.decode_step(params, tokens[:, pos : pos + 1], cache, pos)
    torch.testing.assert_close(logits, want_logits, rtol=1e-4, atol=1e-4)
    for (path, got), (_, want) in zip(leaves_with_paths(cache), leaves_with_paths(want_cache)):
        if "ssm" in path:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--smoke", "--requests", "4", "--batch", "2", "--prompt-len", "16",
          "--max-new", "4"], device="cpu")
    out = capsys.readouterr().out
    assert "static: 4 requests, 16 tokens" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_the_full_configs_build_and_refuse_continuous_batching(arch):
    cfg = get_config(arch)
    assert (cfg.family, cfg.num_layers) == {"mamba2-1.3b": ("ssm", 48),
                                            "zamba2-7b": ("hybrid", 81)}[arch]
    api = registry.build(cfg)
    assert api.decode_step_slots is None
    cache = api.init_cache(8, 4096, device="meta")
    ssm = cache["ssm"] if cfg.family == "ssm" else cache["groups"]["ssm"]
    assert tuple(ssm.shape[-4:]) == (
        8, cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state)
    with pytest.raises(NotImplementedError, match="decode_step_slots"):
        ContinuousEngine(registry.build(get_smoke_config(arch)), 2, 8, device="cpu")


# ---------------------------------------------------------------------------
# On the card: the scan on a tensor-parallel process's heads.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,dtype", [
    # a rank's heads in the four-card probe's 8 x 2,048 prefills (Mamba2-1.3B's
    # 16 of 64, Zamba2-7B's 28 of 112), and chip_smoke.py phase 9d's (32 and 56
    # over 2 processes, f32)
    (8, 2048, 16, 64, 128, torch.bfloat16),
    (8, 2048, 28, 64, 64, torch.bfloat16),
    (4, 512, 32, 64, 128, torch.float32),
    (2, 512, 56, 64, 64, torch.float32),
])
def test_cuda_ssd_scan_on_a_process_heads_matches_plain_version(cuda_device, B, L, H, P, N,
                                                                dtype):
    """``x``, ``dt``, ``B`` and ``C`` cut from one projection ``[B, L, 2 H P
    + 2 N + H]`` as the head-aligned block cuts them (views, not contiguous),
    through ``mamba2.ssd_chunked``: one launch, within the plain scan's
    tolerance."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.models import mamba2 as MB

    gen = torch.Generator(device=cuda_device).manual_seed(H * L + N)
    proj = torch.randn((B, L, 2 * H * P + 2 * N + H), generator=gen, device=cuda_device)
    proj = proj.to(dtype)
    _, xs, Bm, Cm, dt_raw = torch.split(proj, [H * P, H * P, N, N, H], dim=-1)
    x = xs.reshape(B, L, H, P)
    Bm, Cm = Bm.reshape(B, L, 1, N), Cm.reshape(B, L, 1, N)
    assert not (x.is_contiguous() or Bm.is_contiguous() or dt_raw.is_contiguous())
    dt = torch.nn.functional.softplus(dt_raw.float() - 4.0)
    A = -torch.rand((H,), generator=gen, device=cuda_device) * 15 - 1
    sk.reset_launch_counts()
    y, s = MB.ssd_chunked(x, dt, A, Bm, Cm, 256)
    want_y, want_s = kref.ssd_scan_ref(x, dt, A, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, want_s, rtol=2e-4, atol=2e-4)
