"""The port's Mamba2 SSD chunk scan against the JAX package.

Inputs are made with numpy from a seed, with the reference test's
distributions (x, B, C standard normal; dt a softplus of a normal; A minus
the exponential of a normal), and handed to both sides.  On the CPU
``ops.ssd_scan`` runs its plain version; it must match the reference's
Pallas ``ssd_scan`` (interpret mode) and its ``ssd_chunked`` within 2e-4,
the reference test's tolerance (f32 sums in another order).  In bf16, y is
held within 2e-2 (one bf16 rounding of values that agree in f32) and the f32
state within 2e-4.  The CUDA kernel is held to the plain version on the card
by the ``gpu``-marked tests, and so are the gradients of ``mamba2.ssd_chunked``
(the kernel forward, a backward through the plain scan).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import mamba2 as MB

# (B, L, H, P, N, chunk, hb): the reference's SSD_CASES (tests/test_kernels.py);
# hb is the Pallas kernel's head block.
SSD_CASES = [
    (2, 32, 8, 16, 32, 8, 4),
    (1, 64, 16, 8, 16, 16, 8),
    (2, 16, 4, 32, 64, 16, 4),
    (1, 128, 8, 64, 128, 32, 8),
]
TOL = 2e-4


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from repro.kernels.ssd_scan import ssd_scan as ref_kernel
    from repro.models import mamba2 as ref_mamba2

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, kernel=ref_kernel, mamba2=ref_mamba2)


def _inputs(seed, B, L, H, P, N, G=1, initial_state=False):
    """``(x, dt, A, Bm, Cm, s0)`` as f32 numpy arrays (``s0`` may be None)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N), dtype=np.float32)
    Cm = rng.standard_normal((B, L, G, N), dtype=np.float32)
    s0 = rng.standard_normal((B, H, P, N), dtype=np.float32) if initial_state else None
    return x, dt, A, Bm, Cm, s0


def _torch(arrays, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_the_pallas_kernel_and_ssd_chunked(jref, case):
    B, L, H, P, N, chunk, hb = case
    arrays = _inputs(sum(case), B, L, H, P, N)
    jx = [jref.jnp.asarray(a) for a in arrays[:5]]
    want_y, want_s = jref.kernel(*jx, chunk=chunk, head_block=hb)  # interpret mode
    chunked_y, chunked_s = jref.mamba2.ssd_chunked(*jx, chunk)
    sk.reset_launch_counts()
    y, s = ops.ssd_scan(*_torch(arrays[:5]), chunk)
    assert sk.LAUNCHES["ssd_scan"] == 0, "a CPU tensor takes the plain version"
    assert y.dtype == torch.float32 and y.shape == (B, L, H, P) and s.shape == (B, H, P, N)
    for wy, ws in ((want_y, want_s), (chunked_y, chunked_s)):
        _close(y.numpy(), wy)
        _close(s.numpy(), ws)


def test_state_chaining_equals_the_whole(jref):
    """Half, then the other half from the first half's state, equals one
    scan of the whole (the reference's chaining test), and both halves equal
    the reference's kernel chained the same way."""
    B, L, H, P, N = 2, 32, 4, 16, 32
    x, dt, A, Bm, Cm, _ = _torch(_inputs(5, B, L, H, P, N))
    y_all, s_all = ops.ssd_scan(x, dt, A, Bm, Cm, 8)
    _, s_half = ops.ssd_scan(x[:, :16], dt[:, :16], A, Bm[:, :16], Cm[:, :16], 8)
    y2, s2 = ops.ssd_scan(x[:, 16:], dt[:, 16:], A, Bm[:, 16:], Cm[:, 16:], 8, s_half)
    _close(y2.numpy(), y_all[:, 16:].numpy())
    _close(s2.numpy(), s_all.numpy())
    jnp = jref.jnp
    jx = [jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm)]
    _, js_half = jref.kernel(*(a[:, :16] if a.ndim > 1 else a for a in jx), chunk=8, head_block=4)
    jy2, js2 = jref.kernel(*(a[:, 16:] if a.ndim > 1 else a for a in jx), chunk=8, head_block=4,
                           initial_state=js_half)
    _close(y2.numpy(), jy2)
    _close(s2.numpy(), js2)


@pytest.mark.parametrize("G,chunk", [(2, 8), (4, 16)])
def test_groups_match_ssd_chunked(jref, G, chunk):
    """Head ``h`` reads group ``h // (H / G)``; the reference's Pallas kernel
    takes G=1 only, so ``ssd_chunked`` is the yardstick."""
    B, L, H, P, N = 2, 32, 8, 8, 16
    arrays = _inputs(7 + G, B, L, H, P, N, G=G, initial_state=True)
    want_y, want_s = jref.mamba2.ssd_chunked(*(jref.jnp.asarray(a) for a in arrays[:5]), chunk,
                                             jref.jnp.asarray(arrays[5]))
    y, s = ops.ssd_scan(*_torch(arrays[:5]), chunk, torch.from_numpy(arrays[5]))
    _close(y.numpy(), want_y)
    _close(s.numpy(), want_s)


def test_bf16_inputs_match_ssd_chunked(jref):
    """x, B and C in bf16 (cast to f32 inside, y back to bf16), dt, A and the
    state in f32, on both sides."""
    jnp = jref.jnp
    B, L, H, P, N, chunk = 2, 64, 8, 16, 32, 16
    x, dt, A, Bm, Cm, _ = _inputs(11, B, L, H, P, N)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, Bm, Cm)]
    want_y, want_s = jref.mamba2.ssd_chunked(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf[:1]),
        jnp.asarray(dt), jnp.asarray(A),
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf[1:]), chunk)
    y, s = ops.ssd_scan(bf[0], torch.from_numpy(dt), torch.from_numpy(A), bf[1], bf[2], chunk)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(y.float().numpy(), np.asarray(want_y.astype(jnp.float32)), tol=2e-2)
    _close(s.numpy(), want_s)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_matches_reference(jref, G):
    B, H, P, N = 3, 8, 16, 32
    rng = np.random.default_rng(13 + G)
    x = rng.standard_normal((B, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, G, N), dtype=np.float32)
    Cm = rng.standard_normal((B, G, N), dtype=np.float32)
    state = rng.standard_normal((B, H, P, N), dtype=np.float32)
    arrays = (x, dt, A, Bm, Cm, state)
    want_y, want_s = jref.mamba2.ssd_step(*(jref.jnp.asarray(a) for a in arrays))
    y, s = MB.ssd_step(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_one_step_scans_equal_the_recurrence():
    """A scan with chunk 1 is the recurrence itself: ``ssd_step`` token by
    token gives the same y and state (the consistency ``chip_smoke.py``
    checks at full width, prefill against decode)."""
    B, L, H, P, N = 2, 12, 4, 8, 16
    x, dt, A, Bm, Cm, s0 = _torch(_inputs(17, B, L, H, P, N, initial_state=True))
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, 4, s0)
    state, ys = s0, []
    for t in range(L):
        yt, state = MB.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], state)
        ys.append(yt)
    _close(torch.stack(ys, 1).numpy(), y.numpy())
    _close(state.numpy(), s.numpy())


def test_views_of_the_projection_are_taken():
    """The model hands slices of one projection (not contiguous); the entry
    point copies them as the kernel needs and gives the contiguous result."""
    B, L, H, P, N = 1, 16, 4, 8, 16
    x, dt, A, Bm, Cm, _ = _torch(_inputs(19, B, L, H, P, N))
    packed = torch.cat([x.reshape(B, L, H * P), Bm.reshape(B, L, N), Cm.reshape(B, L, N)], -1)
    xv, bv, cv = torch.split(packed, [H * P, N, N], dim=-1)
    y, s = ops.ssd_scan(xv.reshape(B, L, H, P), dt, A, bv.reshape(B, L, 1, N),
                        cv.reshape(B, L, 1, N), 8)
    y2, s2 = ops.ssd_scan(x, dt, A, Bm, Cm, 8)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_a_chunk_that_does_not_divide_the_length_raises():
    x, dt, A, Bm, Cm, _ = _torch(_inputs(23, 1, 24, 4, 8, 16))
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd_scan(x, dt, A, Bm, Cm, 16)


# (B, L, H, P, N, chunk, G, initial state): the three-stage decomposition of
# the CUDA kernels, with one and two groups, with and without an entering
# state, and chunks that are not multiples of the kernels' 64-row tiles.
STAGED_CASES = [
    (2, 64, 8, 16, 32, 16, 1, False),
    (1, 192, 4, 8, 16, 96, 1, True),
    (2, 96, 8, 8, 16, 32, 2, False),
    (2, 192, 4, 16, 32, 96, 2, True),
]


@pytest.mark.parametrize("case", STAGED_CASES)
def test_staged_scan_matches_the_plain_version_and_the_reference(jref, case):
    """``ref.ssd_scan_staged_ref`` (chunk states, state passing, chunk outputs:
    the kernels' decomposition) equals the chunk-by-chunk plain version and
    the reference: its Pallas ``ssd_scan`` (interpret mode) for one group and
    ``ssd_chunked`` always, within 2e-4."""
    B, L, H, P, N, chunk, G, init = case
    arrays = _inputs(sum(case[:7]), B, L, H, P, N, G, init)
    t = _torch(arrays)
    y, s = kref.ssd_scan_staged_ref(*t[:5], chunk, t[5])
    want_y, want_s = kref.ssd_scan_ref(*t[:5], chunk, t[5])
    _close(y.numpy(), want_y.numpy())
    _close(s.numpy(), want_s.numpy())
    jx = [None if a is None else jref.jnp.asarray(a) for a in arrays]
    refs = [jref.mamba2.ssd_chunked(*jx[:5], chunk, jx[5])]
    if G == 1:
        refs.append(jref.kernel(*jx[:5], chunk=chunk, initial_state=jx[5], head_block=4))
    for wy, ws in refs:
        _close(y.numpy(), wy)
        _close(s.numpy(), ws)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # (B, L, H, P, N, chunk, G, dtype, initial state)
    *[(B, L, H, P, N, chunk, 1, torch.float32, False) for B, L, H, P, N, chunk, _ in SSD_CASES],
    (2, 192, 4, 64, 128, 96, 1, torch.float32, True),      # a ragged 64-row tile
    (2, 512, 8, 64, 64, 256, 2, torch.float32, True),      # groups, chained
    (8, 2048, 64, 64, 128, 256, 1, torch.bfloat16, False),  # Mamba2-1.3B prefill
    (8, 2048, 64, 64, 128, 256, 1, torch.float32, False),
    (4, 2048, 112, 64, 64, 256, 1, torch.bfloat16, False),  # Zamba2-7B prefill
    (1, 32768, 64, 64, 128, 256, 1, torch.bfloat16, False),  # Mamba2-1.3B, one long prompt
    (1, 8192, 8, 64, 128, 256, 2, torch.float32, True),    # many chunks at batch 1, groups
    (1, 8192, 8, 64, 128, 256, 2, torch.bfloat16, True),
    (1, 8256, 8, 32, 64, 96, 2, torch.float32, True),      # 86 chunks of 96 rows
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk,G,dtype,init", GPU_CASES)
def test_cuda_ssd_scan_matches_plain_version(cuda_device, B, L, H, P, N, chunk, G, dtype, init):
    x, dt, A, Bm, Cm, s0 = _torch(_inputs(L + N, B, L, H, P, N, G, init), cuda_device)
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    sk.reset_launch_counts()
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk, s0)
    want_y, want_s = kref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, s0)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1
    tol = TOL if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, want_s, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_cuda_ssd_scan_raises_outside_its_limits(cuda_device):
    """A CUDA tensor never takes the plain version: outside the kernel's
    limits, in another dtype, not contiguous or under autograd it raises,
    with no launch."""
    def inputs(B=1, L=64, H=4, P=16, N=32):
        return _torch(_inputs(29, B, L, H, P, N), cuda_device)[:5]

    sk.reset_launch_counts()
    with pytest.raises(ValueError, match="P in"):
        sk.ssd_scan(*inputs(P=128), 16)
    with pytest.raises(ValueError, match="N in"):
        sk.ssd_scan(*inputs(N=256), 16)
    with pytest.raises(ValueError, match="chunk in"):
        sk.ssd_scan(*inputs(L=512), 512)
    with pytest.raises(ValueError, match="chunk in"):
        sk.ssd_scan(*inputs(L=48), 32)
    x, dt, A, Bm, Cm = inputs()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sk.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, 16)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_scan(x.requires_grad_(), dt, A, Bm, Cm, 16)
    with torch.no_grad():
        ops.ssd_scan(x, dt, A, Bm, Cm, 16)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1


# (B, L, H, P, N, chunk, dtype, initial state): Mamba2-1.3B's and Zamba2-7B's
# scans at B=2 over 1,024 tokens
GPU_GRAD_CASES = [
    (2, 1024, 64, 64, 128, 256, torch.float32, False),
    (2, 1024, 64, 64, 128, 256, torch.bfloat16, False),
    (2, 1024, 112, 64, 64, 256, torch.float32, True),
    (2, 1024, 112, 64, 64, 256, torch.bfloat16, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk,dtype,init", GPU_GRAD_CASES)
def test_cuda_ssd_chunked_gradients_equal_autograd_through_the_plain_scan(
        cuda_device, B, L, H, P, N, chunk, dtype, init):
    """``mamba2.ssd_chunked`` on the card: one kernel launch a forward (and
    none in the backward), y and the state as the plain version's, and the
    gradients of every input equal to autograd through ``ref.ssd_scan_ref``
    on the same inputs, with a loss on both outputs: f32 within 1e-5, bf16
    within 2e-2."""
    arrays = _torch(_inputs(L + H, B, L, H, P, N, 1, init), cuda_device)
    arrays = [t if t is None or i not in (0, 3, 4) else t.to(dtype) for i, t in enumerate(arrays)]
    gen = torch.Generator(device=cuda_device).manual_seed(H)
    wy = torch.randn((B, L, H, P), generator=gen, device=cuda_device) / L
    ws = torch.randn((B, H, P, N), generator=gen, device=cuda_device)

    def grads(fn):
        live = [None if t is None else t.clone().requires_grad_() for t in arrays]
        y, s = fn(*live[:5], chunk, live[5])
        ((y.float() * wy).sum() + (s * ws).sum()).backward()
        return y, s, [t.grad for t in live if t is not None]

    sk.reset_launch_counts()
    y, s, got = grads(MB.ssd_chunked)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1
    want_y, want_s, want = grads(kref.ssd_scan_ref)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=max(tol, TOL), atol=max(tol, TOL))
    torch.testing.assert_close(s, want_s, rtol=TOL, atol=TOL)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
