"""Mamba2-1.3B's ``long_500k`` cell (one prompt of 524,288 tokens, 2,048
chunks of 256) at the sizes the CPU can check.

The smoke config's chunk is 8, so a prompt of 16,384 tokens has the cell's
2,048 chunks: there the port's prefill must give the JAX package's logits
and every cache leaf (the reference's params through
:mod:`repro_torch.models.convert`, ``tests/test_torch_ssm.py``'s
tolerances), and a prefill must equal a prefill of 16,128 tokens and 256
``decode_step``\\ s, the gate ``chip_smoke.py`` holds at full size.  At full
size, counted on ``meta`` by the dry run's counter: the 524,288-token
prefill and the cell's decode step fit an 80 GB card in bf16 and in f32
compute, and the decode step counted directly equals the dry run's count.
The Mamba2 block, which drops each long buffer after its last use to fit
that prefill in f32, equals the formula it replaced bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun, op_cost
from repro_torch.models import convert, registry
from repro_torch.models import layers as LY
from repro_torch.models import mamba2 as MB
from repro_torch.serve import grow_cache
from repro_torch.tree import leaves, leaves_with_paths, tree_map

RTOL, ATOL = 1e-4, 1e-5
GATE_TOL = 1e-4
CARD_BYTES = 80e9
ARCH = "mamba2-1.3b"
PLEN = 16_384  # 2,048 chunks of the smoke config's 8 tokens
SPLIT = PLEN - 256


@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke model and params, the port's with them, and
    one prompt of ``PLEN`` tokens made with numpy from a seed."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry

    ref_api = ref_registry.build(ref_smoke(ARCH))
    ref_params = ref_api.init(jax.random.PRNGKey(0))
    api = registry.build(get_smoke_config(ARCH))
    assert PLEN // api.cfg.ssm_chunk == SHAPES["long_500k"].seq_len // get_config(ARCH).ssm_chunk
    params = convert.from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, api.cfg.vocab_size, (1, PLEN), dtype=np.int32)
    return jax, ref_api, ref_params, api, params, tokens


def test_prefill_over_2048_chunks_matches_reference(smoke):
    """Logits and every cache leaf of one prefill of 2,048 chunks."""
    jax, ref_api, ref_params, api, params, tokens = smoke
    want_logits, want_cache = ref_api.prefill(ref_params, {"tokens": jax.numpy.asarray(tokens)})
    got_logits, got_cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want_cache)}
    got = {tuple(str(k) for k in path): v for path, v in leaves_with_paths(got_cache)}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=RTOL, atol=ATOL, err_msg=str(key))


def test_prefill_equals_prefill_then_256_decode_steps(smoke):
    """The phase-7 gate at the cell's chunk count: a prefill of 16,384
    tokens against a prefill of 16,128 and 256 decode steps, the last at
    position 16,383; the logits and every layer's SSM state."""
    _, _, _, api, params, tokens = smoke
    tokens = torch.from_numpy(tokens)
    want_logits, want_cache = api.prefill(params, {"tokens": tokens})
    _, cache = api.prefill(params, {"tokens": tokens[:, :SPLIT]})
    cache = grow_cache(api, cache, 1, PLEN)
    for pos in range(SPLIT, PLEN):
        logits, cache = api.decode_step(params, tokens[:, pos : pos + 1], cache, pos)
    torch.testing.assert_close(logits, want_logits, rtol=GATE_TOL, atol=GATE_TOL)
    states = [(path, got) for path, got in leaves_with_paths(cache) if "ssm" in path]
    assert states
    want = dict(leaves_with_paths(want_cache))
    for path, got in states:
        torch.testing.assert_close(got, want[path], rtol=GATE_TOL, atol=GATE_TOL)


def _param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(params))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_long_500k_prefill_fits_a_card_on_meta(dtype):
    """Mamba2-1.3B at full size, one prompt of 524,288 tokens: the params
    (f32) plus the prefill's peak live bytes under 80 GB; every layer's scan
    one ``ssd_scan`` call."""
    cfg = get_config(ARCH).scaled(dtype=dtype)
    params, _ = registry.param_shape_specs(cfg)
    tokens = torch.empty((1, SHAPES["long_500k"].seq_len), dtype=torch.int32, device="meta")
    with torch.no_grad():
        res = op_cost.analyze(registry.build(cfg).prefill, params, {"tokens": tokens})
    assert res["kernels"]["ssd_scan"]["calls"] == cfg.num_layers
    assert 0 < _param_bytes(params) + res["peak_live_bytes"] < CARD_BYTES


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_long_500k_decode_cell_fits_and_equals_the_dry_run(dtype):
    """The cell the dry run counts (``decode_step`` at position 524,287 on
    one row's cache): under 80 GB, and counted directly equal to
    ``count_cell``'s flops and peak."""
    cfg = get_config(ARCH).scaled(dtype=dtype)
    shape = SHAPES["long_500k"]
    cell = dryrun.count_cell(cfg, shape, 1, 8)
    api = registry.build(cfg)
    params, _ = registry.param_shape_specs(cfg)
    cache = api.init_cache(1, shape.seq_len, device="meta")
    token = torch.empty((1, 1), dtype=torch.int32, device="meta")
    with torch.no_grad():
        res = op_cost.analyze(api.decode_step, params, token, cache, shape.seq_len - 1)
    assert (res["flops"], res["peak_live_bytes"]) == (cell["flops"], cell["peak_live_bytes"])
    assert res["flops"] > 0 and res["kernels"] == {}  # the one-token recurrence, no scan kernel
    assert cell["argument_bytes"] > _param_bytes(params)
    assert cell["argument_bytes"] + cell["peak_live_bytes"] < CARD_BYTES


def _block_before_the_trim(params, cfg, x, initial_state=None):
    """``mamba2.mamba_block`` with ``return_state`` as it was written before
    it dropped its buffers early: every sum out of place, the projection
    held to the end."""
    d_inner, H, _ = MB.dims(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_head_dim
    dtype = x.dtype
    B_, Lq, _ = x.shape
    zxbcdt = x @ params["in_proj"].to(dtype)
    z, xBC, dt_raw = MB._split_proj(cfg, zxbcdt)
    w, b = params["conv_w"].to(dtype), params["conv_b"].to(dtype)
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:Lq] * w[0]
    for k in range(1, K):
        out = out + pad[:, k : k + Lq] * w[k]
    xBC = F.silu(out + b)
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, Lq, H, P)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final = MB.ssd_chunked(xs, dt, A, Bm.reshape(B_, Lq, G, N), Cm.reshape(B_, Lq, G, N),
                              cfg.ssm_chunk, initial_state)
    y = y + params["D"].to(dtype)[None, None, :, None] * xs
    y = y.reshape(B_, Lq, d_inner)
    y = LY.rmsnorm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    _, conv_state, _ = MB._split_proj(cfg, zxbcdt[:, -(K - 1):])
    return y @ params["out_proj"].to(dtype), {"ssm": final, "conv": conv_state.clone()}


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_block_equals_the_formula_before_the_trim(dtype, with_state):
    """The smoke config's block (f32, and cast to f64 and bf16), from a zero
    and from a given initial state: the output, the final SSM state and the
    conv state equal the old formula's bit for bit, and without
    ``return_state`` the output alone."""
    cfg = get_smoke_config(ARCH).scaled(dtype=dtype)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    params = tree_map(lambda t: t.to(dt) if t.dtype == torch.float32 and t.ndim > 1 else t,
                      MB.init_mamba_block(gen, cfg))
    _, H, _ = MB.dims(cfg)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model))).to(dt)
    s0 = None
    if with_state:
        s0 = torch.from_numpy(rng.standard_normal(
            (2, H, cfg.ssm_head_dim, cfg.ssm_state))).float()
    want_out, want_state = _block_before_the_trim(params, cfg, x, s0)
    got_out, got_state = MB.mamba_block(params, cfg, x, s0, return_state=True)
    assert got_out.dtype == dt
    assert torch.equal(got_out, want_out)
    assert torch.equal(got_state["ssm"], want_state["ssm"])
    assert torch.equal(got_state["conv"], want_state["conv"])
    assert torch.equal(MB.mamba_block(params, cfg, x, s0), want_out)
