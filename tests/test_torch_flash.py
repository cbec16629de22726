"""The port's flash attention against the JAX package.

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU the port's wrapper runs its plain version; it must match the
reference's Pallas kernel (interpret mode) at the reference's own
tolerances, 2e-5 in f32 and 2e-2 in bf16, and the gradients of
``layers.flash_attention_vjp`` must match the reference's ``custom_vjp``
(Pallas forward, chunked backward) at 1e-4, as the reference holds its own
to ``sdpa``.  The CUDA kernel is held to the plain version on the card by
the ``gpu``-marked tests.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers

# (B, H, KH, Sq, Sk, D, causal, bq, bk): the reference's FLASH_CASES
# (tests/test_kernels.py); bq and bk are the Pallas kernel's block sizes.
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, 128, 128),
    (1, 8, 8, 128, 128, 32, True, 64, 64),
    (2, 4, 1, 128, 256, 64, False, 64, 128),
    (1, 2, 2, 512, 512, 128, True, 128, 128),
    (1, 12, 4, 128, 128, 64, True, 128, 128),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref
    from repro.kernels.flash_attention import flash_attention as ref_kernel

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ops=ref_ops, ref=ref_ref,
                                 kernel=ref_kernel)


def _qkv(seed, B, H, KH, Sq, Sk, D):
    """Model-layout inputs ``[B, S, heads, D]`` as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, KH, D), dtype=np.float32),
            rng.standard_normal((B, Sk, KH, D), dtype=np.float32))


def _count_kernel_calls(monkeypatch):
    """Record the wrapper calls ``ops`` makes (shapes of q), passing through."""
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, causal=True, scale=None):
        calls.append(tuple(q.shape))
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(fa, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_pallas_kernel(jref, monkeypatch, case, dtype):
    B, H, KH, Sq, Sk, D, causal, bq, bk = case
    jnp = jref.jnp
    q, k, v = _qkv(sum(case[:6]), B, H, KH, Sq, Sk, D)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype)).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    want = jref.kernel(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)  # interpret mode
    calls = _count_kernel_calls(monkeypatch)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert calls == [(B, H, Sq, D)], "inside the gate the wrapper must be called once"
    assert got.dtype == tq.dtype and got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3),
        rtol=TOL[dtype], atol=TOL[dtype],
    )
    # the kernel-layout wrapper on a CPU tensor is the plain version
    kl = fa.flash_attention(*(x.transpose(1, 2).contiguous() for x in (tq, tk, tv)), causal=causal)
    assert torch.equal(kl.transpose(1, 2), got)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_vjp_grads_match_reference(jref, causal):
    B, S, H, KH, D = 2, 256, 4, 2, 64
    jax, jnp = jref.jax, jref.jnp
    q, k, v = _qkv(3, B, H, KH, S, S, D)
    w = np.random.default_rng(4).standard_normal((B, S, H, D), dtype=np.float32)
    want = jax.grad(lambda q, k, v: (jref.ops.flash_attention_vjp(q, k, v, causal)
                                     * jnp.asarray(w)).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = layers.flash_attention_vjp(tq, tk, tv, causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4, atol=1e-4)


# (B, H, KH, Sq, Sk, D, causal): every head dim the f32 kernel takes, causal
# and not, Sq < Sk and Sq > Sk, GQA ratios 1, 3 and 4.
TF32_CASES = [
    (1, 4, 4, 128, 128, 32, True),
    (1, 3, 1, 64, 192, 32, False),
    (2, 4, 1, 128, 128, 64, True),
    (1, 6, 2, 192, 128, 64, True),
    (1, 2, 2, 128, 256, 128, False),
    (1, 4, 1, 128, 64, 128, True),
    (1, 3, 1, 128, 128, 256, True),
    (1, 4, 4, 64, 128, 256, False),
]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", TF32_CASES)
def test_3xtf32_emulation_holds_f32_accuracy(jref, B, H, KH, Sq, Sk, D, causal):
    """The f32 kernel's arithmetic (``ref.flash_attention_3xtf32_ref``: tf32
    halves by bit arithmetic, three products a matmul) against the plain
    version and the reference's Pallas kernel (interpret mode) at the f32
    tolerance, 2e-5; one tf32 pass misses it."""
    jnp = jref.jnp
    q, k, v = _qkv(B * Sq + Sk + D, B, H, KH, Sq, Sk, D)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).contiguous() for x in (q, k, v))
    got = kref.flash_attention_3xtf32_ref(tq, tk, tv, causal=causal)
    plain = kref.flash_attention_ref(tq, tk, tv, causal=causal)
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    want = jref.kernel(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
                       causal=causal, block_q=64, block_k=64)  # interpret mode
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # the hi halves alone (one tf32 pass) are a different result
    hi = kref.flash_attention_ref(*(kref.tf32_round(x) for x in (tq, tk, tv)), causal=causal)
    assert float((hi - plain).abs().max()) > 2e-5


OUTSIDE_THE_GATE = [
    # (B, H, KH, Sq, Sk, D): the reference's gate sends these to its oracle
    # (Sq, Sk not multiples of 128; D not a kernel size)
    (1, 4, 2, 96, 96, 64),
    (2, 4, 2, 128, 192, 32),
    (1, 4, 4, 128, 128, 48),
]


@pytest.mark.parametrize("shape", OUTSIDE_THE_GATE)
def test_shapes_outside_the_gate_take_the_plain_version(jref, monkeypatch, shape):
    """The reference's gate sends these shapes to its oracle; on a CPU tensor
    the port's wrapper runs its plain version at any shape and launches
    nothing (on the card it launches the kernel: see
    ``test_cuda_shapes_outside_the_gate_launch_the_kernel``)."""
    B, H, KH, Sq, Sk, D = shape
    jnp = jref.jnp
    q, k, v = _qkv(5, *shape)
    calls = _count_kernel_calls(monkeypatch)
    fa.reset_launch_counts()
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert calls == [(B, H, Sq, D)] and fa.LAUNCHES["flash_attention"] == 0
    want = jref.ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("D", [8, 16, 48, 96, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_zero_padded_head_dims_give_the_same_attention(D, causal):
    """What the wrapper does on the card for a head dim outside the
    kernel's: q, k, v zero-padded to ``kernel_head_dim(D)``, scaled by ``1 /
    sqrt(D)`` of the unpadded ``D``, the output sliced back, equals attention
    at ``D`` (here through the plain version, at 2e-6)."""
    Dk = fa.kernel_head_dim(D)
    assert Dk in fa.HEAD_DIMS and Dk >= D and (Dk == 32 or Dk // 2 < D)
    q, k, v = (torch.from_numpy(x).transpose(1, 2).contiguous()
               for x in _qkv(D, 1, 4, 2, 70, 45, D))
    padded = (torch.nn.functional.pad(x, (0, Dk - D)) for x in (q, k, v))
    got = kref.flash_attention_ref(*padded, causal=causal, scale=D ** -0.5)[..., :D]
    torch.testing.assert_close(got, kref.flash_attention_ref(q, k, v, causal=causal),
                               rtol=2e-6, atol=2e-6)


def test_wrapper_on_the_cpu_counts_no_launch():
    fa.reset_launch_counts()
    q = torch.zeros((1, 2, 128, 32))
    fa.flash_attention(q, q[:, :1], q[:, :1])
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal,dtype", [
    (8, 12, 4, 2048, 2048, 64, True, torch.float32),
    (8, 12, 4, 2048, 2048, 64, True, torch.bfloat16),
    (2, 4, 1, 128, 256, 64, False, torch.float32),
    (2, 4, 2, 256, 128, 32, True, torch.float32),
    (1, 2, 2, 512, 512, 128, True, torch.bfloat16),
    (1, 4, 2, 256, 256, 256, True, torch.float32),
    (1, 4, 2, 256, 256, 256, False, torch.bfloat16),
    # f32 (3xTF32) at every head dim, causal and not, GQA ratios 1, 3 and 4,
    # Sq < Sk and Sq > Sk, q lengths that are not multiples of 128 rows
    (2, 4, 4, 192, 320, 32, False, torch.float32),
    (1, 6, 2, 320, 128, 32, True, torch.float32),
    (2, 12, 4, 256, 256, 64, True, torch.float32),
    (1, 3, 1, 192, 448, 64, True, torch.float32),
    (1, 8, 2, 320, 192, 64, False, torch.float32),
    (1, 4, 1, 128, 384, 128, False, torch.float32),
    (1, 6, 2, 192, 128, 128, True, torch.float32),
    (1, 3, 1, 256, 128, 256, True, torch.float32),
    (1, 4, 4, 128, 320, 256, False, torch.float32),
])
def test_cuda_flash_attention_matches_plain_version(cuda_device, B, H, KH, Sq, Sk, D, causal,
                                                     dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + D)
    q = torch.randn((B, H, Sq, D), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((B, KH, Sk, D), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((B, KH, Sk, D), generator=gen, device=cuda_device).to(dtype)
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    want = kref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    wide = torch.zeros((B, H, Sq, 272), device=cuda_device, dtype=dtype)  # D > 256
    kv_wide = torch.zeros((B, KH, Sk, 272), device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError, match="0 < D <= 256"):
        fa.flash_attention(wide, kv_wide, kv_wide)
    assert fa.LAUNCHES["flash_attention"] == 1


# (B, H, KH, Sq, Sk, D, causal): bf16 on the tensor cores at every head dim,
# causal and not, GQA ratios 1, 3 and 4, Sq < Sk and Sq > Sk, and query
# lengths that are not multiples of the kernel's 128-row blocks.
BF16_CASES = [
    (2, 4, 4, 128, 128, 32, True),
    (1, 6, 2, 192, 320, 32, False),
    (2, 12, 4, 256, 256, 64, True),
    (1, 8, 2, 320, 128, 64, True),
    (1, 4, 1, 128, 384, 128, False),
    (1, 4, 4, 192, 448, 128, True),
    (1, 3, 1, 256, 128, 256, True),
    (1, 4, 4, 128, 256, 256, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", BF16_CASES)
def test_cuda_bf16_flash_attention_matches_plain_version(cuda_device, B, H, KH, Sq, Sk, D,
                                                          causal):
    gen = torch.Generator(device=cuda_device).manual_seed(B * Sq + Sk + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).bfloat16()
               for shape in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D)))
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    want = kref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1 and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,D,dtype", [
    # a process's heads in tensor-parallel serving (the four-card probe's
    # prefills at 8 x 2,048: DeepSeek-67B's 16 q and 2 kv heads, Qwen1.5-32B's
    # 10 and 10, OLMoE-1B-7B's 4 and 4, Zamba2-7B's shared block's 8 and 8 at
    # D = 112, which the wrapper pads to 128), and chip_smoke.py phase 9b's (32
    # and 4 over 2 processes, f32), 9c's (OLMoE's 8 and 8, f32) and 9d's
    # (Zamba2-7B's 16 and 16 at D = 112, f32)
    (8, 16, 2, 2048, 128, torch.bfloat16),
    (8, 10, 10, 2048, 128, torch.bfloat16),
    (8, 4, 4, 2048, 128, torch.bfloat16),
    (8, 8, 8, 2048, 112, torch.bfloat16),
    (4, 32, 4, 256, 128, torch.float32),
    (8, 8, 8, 256, 128, torch.float32),
    (2, 16, 16, 512, 112, torch.float32),
])
def test_cuda_tensor_parallel_prefill_shapes_match_plain_version(cuda_device, B, H, KH, S, D,
                                                                 dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(H * S + KH)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D)))
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=True)
    want = kref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    # full tiles: the wrapper counts a padded head dim under "[ragged]" too
    padded = int(fa.kernel_head_dim(D) != D)
    assert fa.LAUNCHES["flash_attention"] == 1 and fa.LAUNCHES["flash_attention[ragged]"] == padded
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4, 2, 96, 96, 320), (1, 4, 4, 128, 0, 64)])
def test_cuda_wrapper_raises_for_shapes_the_kernel_cannot_take(cuda_device, shape):
    """On the card the model-layout wrapper never gives way to the plain
    version: a head dim above 256, or no key, raises with no launch."""
    q, k, v = (torch.from_numpy(x).to(cuda_device) for x in _qkv(6, *shape))
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="the kernel takes 0 < D <= 256"):
        ops.flash_attention(q, k, v, causal=True)
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", OUTSIDE_THE_GATE)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_shapes_outside_the_gate_launch_the_kernel(cuda_device, shape, causal):
    """The shapes the reference's gate sends to its oracle launch the kernel
    once through the model-layout wrapper (masked tiles, a padded head
    dim) and match the plain version at 2e-5."""
    q, k, v = (torch.from_numpy(x).to(cuda_device) for x in _qkv(7, *shape))
    fa.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    want = kref.flash_attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                                    causal=causal).transpose(1, 2)
    torch.cuda.synchronize()
    B, H, KH, Sq, Sk, D = shape
    ragged = bool(Sq % 64 or Sk % 64 or D not in fa.HEAD_DIMS)  # (not 128, the reference's)
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.LAUNCHES["flash_attention[ragged]"] == int(ragged)
    assert got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# (B, H, KH, Sq, Sk, D, causal, dtype): lengths that are not multiples of 64
# (partial q and key tiles: Whisper's 1,500 frames, one query, 65 queries,
# Sq > Sk causal, one key) and head dims the wrapper pads (48, 96, 16).
RAGGED_CASES = [
    (4, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    (1, 8, 2, 1, 1500, 64, True, torch.float32),
    (1, 8, 2, 1, 1500, 64, False, torch.bfloat16),
    (1, 8, 2, 65, 1500, 64, True, torch.bfloat16),
    (1, 8, 2, 65, 1500, 64, False, torch.float32),
    (1, 4, 1, 1500, 1500, 64, True, torch.float32),
    (1, 4, 1, 1500, 448, 64, True, torch.float32),
    (1, 4, 1, 1500, 448, 64, True, torch.bfloat16),
    (1, 8, 2, 333, 517, 128, True, torch.float32),
    (1, 8, 2, 333, 517, 128, False, torch.bfloat16),
    (2, 3, 1, 70, 33, 32, True, torch.float32),
    (1, 2, 1, 97, 130, 256, True, torch.float32),
    (1, 2, 2, 97, 130, 256, False, torch.bfloat16),
    (1, 2, 2, 17, 1, 64, True, torch.bfloat16),
    (1, 4, 2, 192, 192, 48, True, torch.float32),
    (1, 4, 4, 100, 77, 48, False, torch.bfloat16),
    (2, 4, 2, 100, 77, 96, False, torch.float32),
    (1, 4, 1, 130, 200, 96, True, torch.bfloat16),
    (2, 4, 4, 1500, 1500, 16, False, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal,dtype", RAGGED_CASES)
def test_cuda_ragged_shapes_match_plain_version(cuda_device, B, H, KH, Sq, Sk, D, causal,
                                                dtype):
    """Partial tiles and padded head dims: one launch, within 2e-5 (f32)
    and 2e-2 (bf16) of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * Sq + Sk + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D)))
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    want = kref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == fa.LAUNCHES["flash_attention[ragged]"] == 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
