"""The port's SSM training path (Mamba2-1.3B, Zamba2-7B) against the JAX package.

The differentiable scan ``models.mamba2.ssd_chunked`` (``_SSDScan``: the
wrapper forward, a backward through the plain scan) is held to ``jax.grad``
through the reference's ``ssd_chunked(..., use_kernel=False)``, the plain scan
the reference trains through, with a loss that reads both ``y`` and the
final state: f32 at rtol/atol 1e-4, bf16 x, B and C at 2e-2 (one bf16
rounding of values that agree in f32).  At the smoke configs (the
reference's params through :mod:`repro_torch.models.convert`, tokens from
numpy) the loss is held within rtol 1e-5 and every gradient leaf at 1e-4;
three AdamW steps (params and ``loss``/``grad_norm``/``lr``) within 1e-5,
and three updates from the reference's gradients within 1e-6, weight decay
included; remat, microbatching and the CLI's checkpoint resume within their
own tolerances below.
"""

import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import convert, registry
from repro_torch.models import mamba2 as MB
from repro_torch.train import AdamWConfig, TrainState, make_train_step
from repro_torch.train.optim import _decays
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

ARCHS = ["mamba2-1.3b", "zamba2-7b"]
B, S = 2, 32  # S: four of the smoke configs' 8-token chunks


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    from repro.models import mamba2 as ref_mamba2

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, mamba2=ref_mamba2)


# ----------------------------------------------------------------------------
# The scan's gradient.
# ----------------------------------------------------------------------------

def _scan_inputs(seed, Bz, L, H, P, N, G, initial_state):
    """Inputs with the distributions of ``tests/test_torch_ssd.py``, and the
    loss's weights on y and on the final state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bz, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((Bz, L, G, N), dtype=np.float32)
    Cm = rng.standard_normal((Bz, L, G, N), dtype=np.float32)
    s0 = rng.standard_normal((Bz, H, P, N), dtype=np.float32) if initial_state else None
    wy = rng.standard_normal((Bz, L, H, P), dtype=np.float32) / L
    ws = rng.standard_normal((Bz, H, P, N), dtype=np.float32)
    return [x, dt, A, Bm, Cm, s0], wy, ws


SCAN_CASES = [(G, init, chunk, dtype) for G in (1, 2) for init in (False, True)
              for chunk in (8, 12) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("G,init,chunk,dtype", SCAN_CASES)
def test_ssd_scan_gradients_match_the_reference(jax_mods, G, init, chunk, dtype):
    """Chunks of 8 and of 12 (not a power of two) over 48 tokens; G 1 and 2;
    with and without an initial state; f32 and bf16 x, B, C."""
    jax, jnp = jax_mods.jax, jax_mods.jnp
    Bz, L, H, P, N = 2, 48, 4, 8, 16
    arrays, wy, ws = _scan_inputs(G * 100 + chunk + init, Bz, L, H, P, N, G, init)
    low = (0, 3, 4)  # x, Bm, Cm in the compute dtype; dt, A, the state f32
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def ref_loss(*args):
        full = [None] * 6
        for i, a in zip(idx, args):
            full[i] = a.astype(dtype) if i in low else a
        y, s = jax_mods.mamba2.ssd_chunked(*full[:5], chunk, full[5], use_kernel=False)
        return (y.astype(jnp.float32) * wy).sum() + (s * ws).sum()

    want = jax.grad(ref_loss, argnums=tuple(range(len(idx))))(
        *[jnp.asarray(arrays[i]) for i in idx])

    tdt = getattr(torch, dtype)
    ins = [None if a is None else torch.from_numpy(a) for a in arrays]
    ins = [t if t is None or i not in low else t.to(tdt) for i, t in enumerate(ins)]
    live = [None if t is None else t.requires_grad_() for t in ins]
    y, s = MB.ssd_chunked(*live[:5], chunk, live[5])
    assert y.dtype == tdt and s.dtype == torch.float32
    loss = (y.float() * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum()
    got = torch.autograd.grad(loss, [live[i] for i in idx])
    tol = 1e-4 if dtype == "float32" else 2e-2
    for i, g, w in zip(idx, got, want):
        assert g.dtype == live[i].dtype
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"input {i}")


def test_ssd_scan_backward_reads_only_what_it_is_given():
    """The final state's gradient may be absent (training reads y only) and
    y's too (a loss on the state alone: C then gets no gradient); both match
    autograd through the plain scan; no grad mode, no graph."""
    from repro_torch.kernels import ref

    arrays, _, _ = _scan_inputs(5, 1, 16, 4, 8, 16, 1, True)
    ins = [torch.from_numpy(a) for a in arrays]
    for which in ("y", "state"):
        live = [t.clone().requires_grad_() for t in ins]
        plain = [t.clone().requires_grad_() for t in ins]
        out = MB.ssd_chunked(*live[:5], 8, live[5])
        want = ref.ssd_scan_ref(*plain[:5], 8, plain[5])
        k = 0 if which == "y" else 1
        out[k].sum().backward()
        want[k].sum().backward()
        for a, b in zip(live, plain):
            assert (a.grad is None) == (b.grad is None)
            if a.grad is not None:
                torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    assert live[4].grad is None  # C does not reach the state
    with torch.no_grad():
        y, s = MB.ssd_chunked(*[t.requires_grad_() for t in ins[:5]], 8, ins[5])
    assert y.grad_fn is None and s.grad_fn is None
    with torch.inference_mode():
        y, _ = MB.ssd_chunked(*ins[:5], 8)
    assert y.grad_fn is None


# ----------------------------------------------------------------------------
# The models at their smoke configs.
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def jref(request):
    """The reference's smoke model, its params, one batch, its loss and
    gradients, and three of its train steps."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import make_train_step as ref_make_train_step
    from repro.train.step import TrainState as RefTrainState

    arch = request.param
    cfg = ref_smoke(arch)
    api = ref_registry.build(cfg)
    state = RefTrainState.create(api, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(api.train_loss)(state.params, jbatch)
    step = jax.jit(ref_make_train_step(api, RefAdamW()))
    steps, s = [], state
    for _ in range(3):
        s, m = step(s, jbatch)
        steps.append(({k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, s.params)))
    return types.SimpleNamespace(
        arch=arch, jax=jax, cfg=cfg, params=jax.tree.map(np.asarray, state.params),
        batch=batch, loss=float(loss), grads=jax.tree.map(np.asarray, grads), steps=steps,
    )


def _port(jref, **over):
    api = registry.build(get_smoke_config(jref.arch).scaled(**over))
    batch = {k: torch.from_numpy(v) for k, v in jref.batch.items()}
    return api, TrainState.from_params(convert.from_reference(jref.params, device="cpu")), batch


def _loss_and_grads(api, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = api.train_loss(live, batch)
    return loss, unflatten(live, torch.autograd.grad(loss, leaves(live)))


def _assert_trees_close(got, want, rtol, atol):
    """Leaf for leaf, matched by path; ``want`` is a reference tree."""
    got = dict(leaves_with_paths(got))
    want = dict(leaves_with_paths(convert.from_reference(want, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].detach().numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=str(path))


def _count_wrapper_calls(monkeypatch) -> list:
    calls = []
    real = sk.ssd_scan
    monkeypatch.setattr(sk, "ssd_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_train_loss_and_every_gradient_match_the_reference(jref, monkeypatch):
    api, state, batch = _port(jref)
    calls = _count_wrapper_calls(monkeypatch)
    loss, grads = _loss_and_grads(api, state.params, batch)
    assert len(calls) == jref.cfg.num_layers, "the scan wrapper runs in every Mamba2 layer"
    np.testing.assert_allclose(loss.item(), jref.loss, rtol=1e-5)
    _assert_trees_close(grads, jref.grads, rtol=1e-4, atol=1e-4)


def test_three_train_steps_match_the_reference(jref):
    api, state, batch = _port(jref)
    step = make_train_step(api, AdamWConfig())
    for i, (want_m, want_p) in enumerate(jref.steps):
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), want_m[k], rtol=1e-5, err_msg=f"step {i} {k}")
        _assert_trees_close(state.params, want_p, rtol=1e-5, atol=1e-5)
    assert int(state.step) == 3


def test_adamw_update_on_the_reference_gradients_matches_the_reference(jref):
    """Three updates from the reference's gradients (no model in between) at
    lr 1e-2, where weight decay moves a leaf of magnitude 1 by 1e-3 a step:
    every SSM leaf, decayed or not, and the moments, at the tolerances of
    ``tests/test_torch_train.py``'s check on train100m.  (Through the model,
    at the three-step check's lr of 3e-6 to 9e-6, decay moves no leaf by
    its tolerance; and at lr 3e-4 a gradient element of ~1e-7, f32 rounding
    apart between the frameworks, moves Adam's normalised step by more.)"""
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import adamw_init as ref_init
    from repro.train import adamw_update as ref_update
    from repro_torch.train import adamw_init, adamw_update

    jax = jref.jax
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
    params = jax.tree.map(jax.numpy.asarray, jref.params)
    grads = jax.tree.map(jax.numpy.asarray, jref.grads)
    ropt = ref_init(params)
    mine = convert.from_reference(jref.params, device="cpu")
    my_grads = convert.from_reference(jref.grads, device="cpu")
    opt = adamw_init(mine)
    for _ in range(3):
        params, ropt, rm = ref_update(RefAdamW(**kw), grads, ropt, params)
        mine, opt, m = adamw_update(AdamWConfig(**kw), my_grads, opt, mine)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
    _assert_trees_close(mine, jax.tree.map(np.asarray, params), rtol=1e-6, atol=1e-7)
    _assert_trees_close(opt["m"], jax.tree.map(np.asarray, ropt["m"]), rtol=1e-6, atol=1e-9)
    _assert_trees_close(opt["v"], jax.tree.map(np.asarray, ropt["v"]), rtol=1e-5, atol=1e-12)


def test_weight_decay_takes_the_reference_leaves(jref):
    """The reference decays a leaf of 2 or more dims, counting its stacked
    ``layers``, ``groups`` and ``tail`` leaves' layer dims: every Mamba2 leaf
    (``A_log``, ``D``, ``dt_bias``, ``conv_w``, ``conv_b``, ``gate_norm``
    too), the shared block's matrices and the embedding; not the shared
    block's or the final norms."""
    stacked = {path: np.ndim(v) >= 2 for path, v in leaves_with_paths(jref.params)}
    want = {}
    for path, p in leaves_with_paths(convert.from_reference(jref.params, device="cpu")):
        ref_path = tuple(k for k in path if not isinstance(k, int))
        want[path] = stacked[ref_path]
        assert _decays(path, p) == want[path], path
    mamba = [d for path, d in want.items() if "mamba" in path]
    assert mamba and all(mamba)
    assert not want[("final_norm", "scale")]
    if jref.arch.startswith("zamba"):
        assert not want[("shared", "ln1", "scale")] and want[("shared", "mlp", "w_up")]


def test_remat_gives_the_same_loss_grads_and_twice_the_scans(jref, monkeypatch):
    """``remat="block"`` checkpoints each Mamba2 layer (Zamba2: each group
    with the shared block, whose weights it closes over, and each tail
    layer); the backward re-runs the forward, so the wrapper runs twice a
    layer, and nothing else changes: the loss and every gradient equal the
    unrematted ones, and the reference's."""
    api, state, batch = _port(jref)
    loss, grads = _loss_and_grads(api, state.params, batch)
    api_r, _, _ = _port(jref, remat="block")
    calls = _count_wrapper_calls(monkeypatch)
    loss_r, grads_r = _loss_and_grads(api_r, state.params, batch)
    assert len(calls) == 2 * jref.cfg.num_layers
    torch.testing.assert_close(loss_r, loss, rtol=1e-6, atol=0)
    for (path, g), (_, gr) in zip(leaves_with_paths(grads), leaves_with_paths(grads_r)):
        torch.testing.assert_close(gr, g, rtol=1e-6, atol=1e-7, msg=str(path))
    _assert_trees_close(grads_r, jref.grads, rtol=1e-4, atol=1e-4)


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


# ----------------------------------------------------------------------------
# The CLI.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_and_resumes_on_the_cpu(arch, capsys):
    from repro_torch.launch.train import main

    common = ["--arch", arch, "--smoke", "--seq-len", "32", "--batch", "2", "--log-every", "1",
              "--seed", "4"]
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d2:
        main(common + ["--steps", "3", "--ckpt-dir", d, "--ckpt-every", "2"], device="cpu")
        assert latest_step(d) == 2
        resumed, last = main(common + ["--steps", "5", "--ckpt-dir", d, "--ckpt-every", "2"],
                             device="cpu")
        assert "resumed from checkpoint at step 2" in capsys.readouterr().out
        straight, last2 = main(common + ["--steps", "5", "--ckpt-dir", d2], device="cpu")
    assert int(resumed.step) == 5 and np.isfinite(last["loss"]) and last == last2
    for (path, a), (_, b) in zip(leaves_with_paths(resumed), leaves_with_paths(straight)):
        assert torch.equal(a, b), path
