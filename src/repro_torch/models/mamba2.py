"""Mamba2 (SSD, state-space duality) blocks and the pure-SSM LM (port of
``repro.models.mamba2``).

The SSD chunked algorithm ("Transformers are SSMs", arXiv:2405.21060): the
sequence is cut into chunks of ``Q``; within a chunk the recurrence is a
masked attention-like quadratic form, across chunks a linear recurrence
carries the ``[H, P, N]`` state.  :func:`ssd_chunked` always goes through
``kernels.ops.ssd_scan``: on the card the CUDA kernel, on the CPU its plain
version; its backward differentiates the plain scan, which the reference
trains through.  The reference's ``use_kernel`` flag has no counterpart.
Decode is the single-token recurrence :func:`ssd_step`, plain PyTorch as in
the reference.

Tensor names follow the paper: x ``[B, L, H, P]`` values, dt ``[B, L, H]``
step sizes, A ``[H]`` (negative) decay rates, B/C ``[B, L, G, N]``
input/output projections (G groups broadcast over H heads).

Layers are a list of per-layer dicts (the reference stacks them and scans);
the cache keeps the reference's stacked layout, ``{"ssm": [L, B, H, P, N]
f32, "conv": [L, B, K-1, ch]}``, and :func:`decode_step` writes layer ``l``'s
slice in place.  :func:`specs` and :func:`cache_specs` are the reference's
logical axes letter for letter.

Under the tensor table (:func:`~repro_torch.distributed.sharding.tensor_rules`)
a block splits by SSM heads where the process count ``R`` divides ``H``
(:func:`tensor_heads`; elsewhere it stays whole on every process).  The
reference's ``conv_dim`` cut of ``in_proj`` runs over the concatenated
``[z | x | B | C | dt]`` columns in equal runs, which a process that computes
locally cannot use, so the port cuts by sections (:func:`tensor_index`):
each process holds its ``H / R`` heads' columns of ``z``, ``x`` and ``dt``,
every ``B``/``C`` column, the conv channels of its ``x`` and of ``B``/``C``,
its heads' ``dt_bias``, ``A_log`` and ``D``, and its ``d_inner / R`` rows of
``out_proj``; ``gate_norm``'s scale stays whole.  The block scans its heads
against the one ``B``/``C`` group (the cut takes ``G = 1``, as every config
has), normalises over the whole ``d_inner`` with one all-reduce of the f32
sum of squares, and all-reduces ``out_proj``'s partial sums: two
all-reduces a layer.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import tensor_context, tensor_shared_sum, tensor_split
from ..kernels import ops, ref
from . import layers as L


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, nheads, conv_ch


# ----------------------------------------------------------------------------
# The tensor table's head-aligned cut.
# ----------------------------------------------------------------------------

def tensor_heads(cfg: ModelConfig, ctx=None) -> tuple[int, int]:
    """``(R, r)``: into how many runs of SSM heads the tensor table cuts a
    Mamba block, and which run this process holds; ``(1, 0)`` off the
    table or where the processes do not divide the heads (the whole block
    then stays whole on every process).  The cut takes one ``B``/``C``
    group: with more, raises ``NotImplementedError``."""
    ctx = ctx or tensor_context()
    R = tensor_split(dims(cfg)[1], "ssm_heads", ctx)
    if R == 1:
        return 1, 0
    if cfg.ssm_ngroups != 1:
        raise NotImplementedError(
            f"the tensor table's head cut of {cfg.name} takes one B/C group, not "
            f"{cfg.ssm_ngroups}")
    return R, ctx.mesh.process_index


def local_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """:func:`dims` of this process's slice: ``(d_inner / R, H / R, d_inner /
    R + 2 G N)``, the whole dims where the block stays whole."""
    d_inner, H, conv_ch = dims(cfg)
    R, _ = tensor_heads(cfg)
    return d_inner // R, H // R, conv_ch - d_inner + d_inner // R


def tensor_index(cfg: ModelConfig, width: int, ctx) -> torch.Tensor | None:
    """This process's indices along a Mamba dim of ``width`` entries named
    ``conv_dim`` or ``ssm_heads``, in order, by the section the width names:
    ``in_proj``'s columns (its heads' ``z``, ``x``, every ``B``/``C``, its
    heads' ``dt``), the conv's channels (its ``x``, every ``B``/``C``),
    ``out_proj``'s rows and ``gate_norm``'s ``d_inner`` (its ``x``), or the
    heads; ``None`` where the block stays whole."""
    R, r = tensor_heads(cfg, ctx)
    if R == 1:
        return None
    d_inner, H, conv_ch = dims(cfg)
    GN2 = conv_ch - d_inner
    dl, Hl = d_inner // R, H // R
    mine = torch.arange(r * dl, (r + 1) * dl)
    bc = torch.arange(GN2)
    heads = torch.arange(r * Hl, (r + 1) * Hl)
    sections = {
        2 * d_inner + GN2 + H: [mine, d_inner + mine, 2 * d_inner + bc, 2 * d_inner + GN2 + heads],
        conv_ch: [mine, d_inner + bc],
        d_inner: [mine],
        H: [heads],
    }
    if width not in sections:
        raise ValueError(f"no Mamba section of width {width} in {cfg.name}")
    return torch.cat(sections[width])


# ----------------------------------------------------------------------------
# Params.
# ----------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return L.rand(gen, shape) * (hi - lo) + lo


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> Any:
    """The reference's distributions: ``dt_bias`` the inverse softplus of a
    log-uniform draw in [1e-3, 1e-1], ``A_log`` the log of a uniform draw in
    [1, 16], ``D`` ones, ``conv_b`` zeros."""
    d = cfg.d_model
    d_inner, H, conv_ch = dims(cfg)
    N, G, K = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_conv
    dt = L.pdtype(cfg)
    dev = gen.device
    proj_out = 2 * d_inner + 2 * G * N + H  # z, x, B, C, dt
    u = _uniform(gen, (H,), math.log(1e-3), math.log(1e-1))
    return {
        "in_proj": L.he_init(gen, (d, proj_out), d, dt),
        "conv_w": L._normal(gen, (K, conv_ch), 1.0 / math.sqrt(K), dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "A_log": torch.log(_uniform(gen, (H,), 1.0, 16.0)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "gate_norm": L.init_rmsnorm(d_inner, dt, dev),
        "out_proj": L.he_init(gen, (d_inner, d), d_inner, dt),
    }


def specs_mamba_block(cfg: ModelConfig) -> Any:
    del cfg
    return {
        "in_proj": ("fsdp", "conv_dim"),
        "conv_w": (None, "conv_dim"),
        "conv_b": ("conv_dim",),
        "dt_bias": ("ssm_heads",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "gate_norm": L.specs_rmsnorm(),
        "out_proj": ("conv_dim", "fsdp"),
    }


# ----------------------------------------------------------------------------
# The SSD scan (prefill/training) and its single-token step (decode).
# ----------------------------------------------------------------------------

class _SSDScan(torch.autograd.Function):
    """Kernel forward; backward recomputes the scan with
    ``ref.ssd_scan_ref`` (the body of the reference's ``ssd_chunked``) and
    differentiates that, so the gradient is the reference's own (it trains
    through its plain scan; there is no backward kernel)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, initial_state):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        return ops.ssd_scan(x, dt, A, Bm, Cm, chunk, initial_state)

    @staticmethod
    def backward(ctx, g_y, g_state):
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = ref.ssd_scan_ref(*ins[:5], ctx.chunk, ins[5])
            # training reads y only: the final state's gradient is None, and left out
            outs, gs = zip(*((o, g) for o, g in zip(outs, (g_y, g_state)) if g is not None))
            wrt = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad(outs, wrt, gs, allow_unused=True))
        dx, ddt, dA, dB, dC, ds0 = (None if t is None else next(grads) for t in ins)
        return dx, ddt, dA, dB, dC, None, ds0


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """``(y [B, L, H, P], final_state [B, H, P, N] f32)``, through
    ``ops.ssd_scan``: one kernel launch on the card.  Differentiable: the
    backward recomputes the plain scan (:class:`_SSDScan`)."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk, initial_state)


def ssd_step(
    x: torch.Tensor,   # [B, H, P]
    dt: torch.Tensor,  # [B, H]
    A: torch.Tensor,   # [H]
    Bm: torch.Tensor,  # [B, G, N]
    Cm: torch.Tensor,  # [B, G, N]
    state: torch.Tensor,  # [B, H, P, N] f32
):
    """Single-token recurrence (decode): O(1) in context length."""
    B_, H, P = x.shape
    G = Bm.shape[1]
    R = H // G
    N = state.shape[-1]
    xg = x.reshape(B_, G, R, P).float()
    dtg = dt.reshape(B_, G, R).float()
    dec = torch.exp(dtg * A.reshape(G, R))
    sg = state.reshape(B_, G, R, P, N)
    upd = (dtg[..., None] * xg)[..., None] * Bm.float()[:, :, None, None, :]
    sg = sg * dec[..., None, None] + upd
    y = torch.einsum("bgn,bgrpn->bgrp", Cm.float(), sg)
    return y.reshape(B_, H, P).to(x.dtype), sg.reshape(B_, H, P, N)


# ----------------------------------------------------------------------------
# Conv + block plumbing.
# ----------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """``(z, xBC, dt)`` of a projection, at this process's widths."""
    d_inner, H, conv_ch = local_dims(cfg)
    return torch.split(zxbcdt, [d_inner, conv_ch, H], dim=-1)


def _gate_norm(params: Any, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """``gate_norm`` over ``y [..., d_inner / R]``: :func:`layers.rmsnorm`
    where the block is whole; under the head cut the f32 sum of squares is
    all-reduced over the processes (:func:`tensor_shared_sum`: each process
    normalises only its heads with it, so its gradient is summed too) and
    divided by the whole ``d_inner``, and the process scales by its columns
    of the whole scale."""
    R, r = tensor_heads(cfg)
    if R == 1:
        return L.rmsnorm(params, y, cfg.norm_eps)
    dt, dl = y.dtype, y.shape[-1]
    h = y.float()
    ss = tensor_shared_sum(h.square().sum(-1, keepdim=True), tensor_context())
    h = h * torch.rsqrt(ss / (dl * R) + cfg.norm_eps)
    return (h * params["scale"].narrow(0, r * dl, dl).float()).to(dt)


def _out_proj(params: Any, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """``out_proj``, row-parallel under the head cut: one all-reduce."""
    return L._row_parallel(y @ params["out_proj"].to(y.dtype), "ssm_heads", dims(cfg)[1])


def _causal_conv(w: torch.Tensor, b: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv with kernel ``[K, ch]`` over ``pad [B, K-1+Lq,
    ch]``, the input after K-1 zero rows, summed over the taps in the
    reference's order -> ``[B, Lq, ch]``.  Each tap is added in place
    (``out += t`` rounds as ``out = out + t`` does), so the sum holds one
    buffer, not two."""
    K = w.shape[0]
    Lq = pad.shape[1] - (K - 1)
    out = pad[:, 0:Lq] * w[0]
    for k in range(1, K):
        out += pad[:, k : k + Lq] * w[k]
    out += b
    return F.silu(out)


def mamba_block(params: Any, cfg: ModelConfig, x: torch.Tensor, initial_state=None,
                return_state: bool = False):
    """Full-sequence Mamba2 block (train/prefill): ``x [B, Lq, d_model]``;
    with ``return_state``, also ``{"ssm": final state, "conv": the last K-1
    pre-conv inputs}``.  Under the head cut, on this process's heads (and
    its slices of ``params``), with the two all-reduces of the module
    docstring.

    Each ``[B, Lq, *]`` buffer is dropped as soon as its last use is done
    (the projection once the gate, ``dt``, the conv state and the conv's
    padded input are taken from it; the conv's output once the skip term is
    taken from it), which bounds a long prefill's peak (Mamba2-1.3B's
    524,288-token prompt); the values are the same, bit for bit."""
    d_inner, H, _ = local_dims(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_head_dim
    dtype = x.dtype
    B_, Lq, _ = x.shape

    zxbcdt = x @ params["in_proj"].to(dtype)
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    gate = F.silu(z)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    conv_state = None
    if return_state and cfg.ssm_conv > 1:
        # a copy: a view would keep the whole [B, Lq, proj] projection alive
        conv_state = xBC[:, -(cfg.ssm_conv - 1):].clone()
    pad = F.pad(xBC, (0, 0, cfg.ssm_conv - 1, 0))
    del zxbcdt, z, xBC, dt_raw
    xBC = _causal_conv(params["conv_w"].to(dtype), params["conv_b"].to(dtype), pad)
    del pad
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, Lq, H, P)
    Bm = Bm.reshape(B_, Lq, G, N)
    Cm = Cm.reshape(B_, Lq, G, N)
    A = -torch.exp(params["A_log"])

    y, final = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk, initial_state)
    skip = params["D"].to(dtype)[None, None, :, None] * xs
    del xBC, xs, Bm, Cm
    y = y + skip
    del skip
    y = y.reshape(B_, Lq, d_inner)
    y = _gate_norm(params["gate_norm"], cfg, y * gate)
    out = _out_proj(params, cfg, y)
    if return_state:
        return out, {"ssm": final, "conv": conv_state}
    return out


def mamba_block_step(params: Any, cfg: ModelConfig, x: torch.Tensor, state: Any):
    """Single-token step: ``x [B, 1, d_model]``, state ``{"ssm", "conv"}`` ->
    ``(out [B, 1, d_model], new state)``; under the head cut on this
    process's heads, as :func:`mamba_block`."""
    d_inner, H, _ = local_dims(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_head_dim
    dtype = x.dtype
    B_ = x.shape[0]

    zxbcdt = (x @ params["in_proj"].to(dtype))[:, 0]
    z, xBC_new, dt_raw = _split_proj(cfg, zxbcdt)
    # the conv over the rolling window [B, K-1, ch] and the new input
    window = torch.cat([state["conv"], xBC_new[:, None, :]], dim=1)  # [B, K, ch]
    w = params["conv_w"].to(dtype)
    xBC = F.silu((window * w).sum(1) + params["conv_b"].to(dtype))
    new_conv = window[:, 1:, :]

    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, new_ssm = ssd_step(xs.reshape(B_, H, P), dt, A, Bm.reshape(B_, G, N),
                          Cm.reshape(B_, G, N), state["ssm"])
    y = y + params["D"].to(dtype)[None, :, None] * xs.reshape(B_, H, P)
    y = y.reshape(B_, d_inner)
    y = _gate_norm(params["gate_norm"], cfg, y * F.silu(z))
    out = _out_proj(params, cfg, y)[:, None, :]
    return out, {"ssm": new_ssm, "conv": new_conv}


# ----------------------------------------------------------------------------
# The pure-SSM LM (mamba2-1.3b): embed -> [norm -> mamba] x L -> norm -> logits.
# ----------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig) -> Any:
    return {"norm": L.init_rmsnorm(cfg.d_model, L.pdtype(cfg), gen.device),
            "mamba": init_mamba_block(gen, cfg)}


def specs_layer(cfg: ModelConfig) -> Any:
    return {"norm": L.specs_rmsnorm(), "mamba": specs_mamba_block(cfg)}


def init(seed: int, cfg: ModelConfig, device="cuda", place=None) -> Any:
    """Random params from ``seed`` on ``device``, with the reference's
    distributions (its numbers come only through
    :mod:`repro_torch.models.convert`); on ``"meta"``, shapes only.  The
    embedding and each layer go through ``place(path, sub) -> sub`` as they
    are drawn (paths ``("embedding",)`` and ``("layers", l)``), as in
    :func:`repro_torch.models.transformer.init`."""
    keep = place or (lambda path, sub: sub)
    gen = L.make_generator(seed, device)
    return {
        "embedding": keep(("embedding",), L.init_embedding(gen, cfg)),
        "layers": [keep(("layers", l), init_layer(gen, cfg)) for l in range(cfg.num_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, L.pdtype(cfg), gen.device),
    }


def specs(cfg: ModelConfig) -> Any:
    return {
        "embedding": L.specs_embedding(cfg),
        "layers": [specs_layer(cfg) for _ in range(cfg.num_layers)],
        "final_norm": L.specs_rmsnorm(),
    }


def layer_fwd(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """One residual Mamba2 layer (forward only)."""
    return x + mamba_block(p["mamba"], cfg, L.rmsnorm(p["norm"], x, cfg.norm_eps))


def layer_prefill(p, cfg: ModelConfig, x: torch.Tensor):
    """One residual Mamba2 layer and its final ``{"ssm", "conv"}`` state."""
    o, st = mamba_block(p["mamba"], cfg, L.rmsnorm(p["norm"], x, cfg.norm_eps),
                        return_state=True)
    return x + o, st


def layer_step(p, cfg: ModelConfig, x: torch.Tensor, ssm: torch.Tensor, conv: torch.Tensor):
    """One residual Mamba2 layer for one token; writes the layer's new state
    into ``ssm`` and ``conv`` (cache slices) in place."""
    o, st = mamba_block_step(p["mamba"], cfg, L.rmsnorm(p["norm"], x, cfg.norm_eps),
                             {"ssm": ssm, "conv": conv})
    ssm.copy_(st["ssm"])
    conv.copy_(st["conv"])
    return x + o


def forward(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence forward -> final-normed hidden states ``[B, S, d]``."""
    from .transformer import _maybe_remat

    x = L.embed(params["embedding"], cfg, batch["tokens"])
    body = _maybe_remat(lambda h, p: layer_fwd(p, cfg, h), cfg)
    for p in params["layers"]:
        x = body(x, p)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    logits = L.unembed(params["embedding"], cfg, forward(params, cfg, batch))
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


def mamba_state(cfg: ModelConfig, n: int, batch_size: int, dtype, device) -> dict:
    """Zero ``{"ssm": [n, B, H, P, N] f32, "conv": [n, B, K-1, ch]}``, of
    this process's heads and conv channels under the head cut."""
    _, H, conv_ch = local_dims(cfg)
    return {
        "ssm": torch.zeros((n, batch_size, H, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n, batch_size, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int, dtype=None,
               device="cuda") -> Any:
    """The SSM cache is O(1) in context length: ``capacity`` is unused."""
    del capacity
    return mamba_state(cfg, cfg.num_layers, batch_size, dtype or L.cdtype(cfg), device)


def cache_specs(cfg: ModelConfig) -> Any:
    del cfg
    return {
        "ssm": (None, "batch", "ssm_heads", None, None),
        "conv": (None, "batch", None, "conv_dim"),
    }


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int):
    """One token for every stream: tokens ``[B, 1]`` -> ``(logits [B,
    vocab], cache)``; the cache is updated in place.  ``pos`` is unused: the
    state carries the context."""
    del pos
    x = L.embed(params["embedding"], cfg, tokens)
    for l, p in enumerate(params["layers"]):
        x = layer_step(p, cfg, x, cache["ssm"][l], cache["conv"][l])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embedding"], cfg, x)[:, 0], cache


def prefill(params, cfg: ModelConfig, batch, capacity: int | None = None):
    """Run the prompts through the chunked scan, keeping every layer's final
    state: ``(last-token logits [B, vocab], cache)``.  The state has no
    positions, so the engine's ``capacity`` leaves it as it is."""
    x = L.embed(params["embedding"], cfg, batch["tokens"])
    states = []
    for p in params["layers"]:
        x, st = layer_prefill(p, cfg, x)
        states.append(st)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embedding"], cfg, x[:, -1:])
    cache = {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}
    return logits[:, 0], cache


__all__ = [
    "dims",
    "tensor_heads",
    "local_dims",
    "tensor_index",
    "init_mamba_block",
    "specs_mamba_block",
    "ssd_chunked",
    "ssd_step",
    "mamba_block",
    "mamba_block_step",
    "init_layer",
    "specs_layer",
    "layer_fwd",
    "layer_prefill",
    "layer_step",
    "mamba_state",
    "init",
    "specs",
    "forward",
    "train_loss",
    "init_cache",
    "cache_specs",
    "decode_step",
    "prefill",
]
