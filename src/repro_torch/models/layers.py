"""Shared neural layers: norms, RoPE/M-RoPE, GQA and MLA attention, MLPs
(port of ``repro.models.layers``).

Conventions, as in the reference:

* params are plain dicts of tensors, in the reference's layouts (``wq`` is
  ``[d, H, Dh]``, ``wo`` is ``[H, Dh, d]``), so that
  :mod:`repro_torch.models.convert` copies the reference's arrays as they are;
* activations are ``[batch, seq, d_model]``; attention heads ``[B, S, H, Dh]``;
* ``positions`` are int ``[B, S]`` (RoPE) or ``[3, B, S]`` (M-RoPE: one
  stream each for time, height and width);
* master params keep ``cfg.param_dtype`` and are cast to the compute dtype
  where they are used, as the reference casts them.

Serving calls :func:`sdpa` (GQA) or :func:`_mla_attend` (MLA) directly; the
full-sequence :func:`attention_block` (training) picks its core with
``cfg.attn_impl`` (:func:`attention_core`), whose ``flash`` branch runs the
CUDA kernel.  MLA is plain matrix products, as in the reference, which runs
it outside any Pallas kernel.

The port's own init draws the reference's distributions (truncated normal at
±2σ, He scale) from an explicit ``torch.Generator`` (:func:`make_generator`);
it cannot reproduce ``jax.random``'s numbers.

Each ``init_*`` has a ``specs_*`` beside it: the logical axis names of every
leaf (:mod:`repro_torch.distributed.sharding`), the reference's tree for
tree.

Under the tensor table (:func:`~repro_torch.distributed.sharding.tensor_rules`)
each process holds its slices of the heads, ``d_ff`` and vocab dims that
the process count divides: q/k/v (and their biases) are column-parallel and
each process attends with its own heads (with the kv heads they read, where
the kv heads stay whole); :func:`attention_out` and the MLP's down
projection are row-parallel, each followed by one all-reduce (so is MLA's
``wo``, once a call after every query block, :func:`_mla_attend`); :func:`embed`
looks up the process's vocab rows and all-reduces, and :func:`unembed`
all-gathers its logits to the full vocab.  A dim that stays whole needs no
collective.  Each collective carries its backward, so training runs through
them: a row-parallel exit passes its gradient through, and where a
replicated activation enters a split projection (:func:`_column_entry`:
q/k/v, the MLP's up projections, the logits) its gradient is summed over
the processes, as is that of the whole kv leaves a process reads only in
part (:func:`attention_qkv`).  The forward is the same either way.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import (
    tensor_all_gather,
    tensor_all_reduce,
    tensor_context,
    tensor_entry,
    tensor_split,
)
from ..kernels import ops

Params = Any  # nested dict[str, torch.Tensor]
Specs = Any  # the params' structure with a tuple of logical axis names a leaf

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ----------------------------------------------------------------------------
# Init.
# ----------------------------------------------------------------------------

_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))
_TRUNC_HI = math.erf(2.0 / math.sqrt(2.0))


class _ShapesOnly:
    """The generator of a ``meta`` init: it has a device and draws nothing
    (``torch.Generator`` refuses the ``meta`` device)."""

    def __init__(self, device: torch.device):
        self.device = device


def make_generator(seed: int, device) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device`` (the card unless the
    caller asks for the CPU); on ``"meta"`` one that only carries shapes,
    which is how :func:`repro_torch.models.registry.param_count` builds a
    model without allocating it."""
    from ..relational.table import resolve_device

    dev = resolve_device(device)
    if dev.type == "meta":
        return _ShapesOnly(dev)
    return torch.Generator(device=dev).manual_seed(seed)


def rand(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform ``[0, 1)`` f32 draws from ``gen`` (none on ``meta``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale`` x a standard normal truncated to ``[-2, 2]``, by inverting
    the CDF of a uniform draw (as ``jax.random.truncated_normal`` does)."""
    u = rand(gen, shape)
    u.mul_(_TRUNC_HI - _TRUNC_LO).add_(_TRUNC_LO)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(scale).to(dtype)


def he_init(gen: torch.Generator, shape, fan_in: int, dtype: torch.dtype) -> torch.Tensor:
    return _normal(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype)


# ----------------------------------------------------------------------------
# Norms.
# ----------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def specs_rmsnorm() -> Specs:
    return {"scale": (None,)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * params["scale"].float()).to(dt)


def init_layernorm(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def specs_layernorm() -> Specs:
    return {"scale": (None,), "bias": (None,)}


def layernorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Mean and biased variance in f32, then scale and bias in f32."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


# ----------------------------------------------------------------------------
# RoPE / M-RoPE.
# ----------------------------------------------------------------------------

def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[..., head_dim/2]`` for int positions ``[...]``."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.full((), theta, dtype=torch.float32, device=positions.device) ** exponent
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, S, H, Dh]`` with cos/sin ``[B, S, Dh/2]`` (half-split
    layout)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def mrope_angles(
    positions: torch.Tensor, head_dim: int, theta: float, sections: tuple[int, int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's multimodal RoPE: three position streams (t, h, w) feed
    disjoint runs of the rotary half.  ``positions [3, B, S]`` -> cos/sin
    ``[B, S, half]``, frequency ``i`` taken from the stream whose section
    holds it."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim / 2 = {half}")
    cos_t, sin_t = rope_angles(positions, head_dim, theta)  # [3, B, S, half]
    bounds = [0, sections[0], sections[0] + sections[1], half]
    cos = torch.cat([cos_t[j, ..., bounds[j]:bounds[j + 1]] for j in range(3)], dim=-1)
    sin = torch.cat([sin_t[j, ..., bounds[j]:bounds[j + 1]] for j in range(3)], dim=-1)
    return cos, sin


def positions_for(cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The batch's ``positions``, else ``0 .. S-1`` for every row, ``S``
    counting a VLM's patch rows before its tokens (the same for all three
    streams under M-RoPE)."""
    if "positions" in batch:
        return batch["positions"]
    tokens = batch["tokens"]
    B, S = tokens.shape
    if "patches" in batch:
        S += batch["patches"].shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :].repeat(B, 1)
    if cfg.rope_kind == "mrope":
        pos = pos[None].expand(3, B, S)
    return pos


def rope_tables(cfg: ModelConfig, positions: torch.Tensor, head_dim: int):
    if cfg.rope_kind == "mrope":
        return mrope_angles(positions, head_dim, cfg.rope_theta, cfg.mrope_sections)
    return rope_angles(positions, head_dim, cfg.rope_theta)


def rotate_qk(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, cos, sin):
    """``q`` and ``k`` rotated when the config has rotary positions (RoPE or
    M-RoPE); as they are otherwise."""
    if cfg.rope_kind in ("rope", "mrope"):
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k


# ----------------------------------------------------------------------------
# Scaled-dot-product attention core (masked, GQA-aware).
# ----------------------------------------------------------------------------

def sdpa(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, KH, Dh]
    v: torch.Tensor,  # [B, Sk, KH, Dv]
    *,
    causal: bool,
    q_offset: int = 0,
    kv_valid_len: torch.Tensor | int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The reference's attention: GQA query heads grouped over ``KH``, the
    logits in the compute dtype then f32, an f32 softmax.

    ``kv_valid_len`` masks k/v positions at or past it: a scalar (one fill
    level for the batch, the static decode) or a ``[B]`` tensor (per-slot
    fill levels, the continuous decode).  Both build the same mask values,
    so the two decodes agree bit for bit when every slot sits at the same
    position.
    """
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, KH, G, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = kpos[None, :] <= qpos
    bmask = mask[None, None, None]  # broadcast over [B, KH, G, ...]
    if isinstance(kv_valid_len, torch.Tensor) and kv_valid_len.ndim == 1:
        valid = kpos[None, :] < kv_valid_len[:, None]  # per-slot lengths [B, Sk]
        bmask = bmask & valid[:, None, None, None, :]
    elif kv_valid_len is not None:
        bmask = bmask & (kpos[None, :] < kv_valid_len)[None, None, None]
    logits = torch.where(bmask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """The serving prefill's causal attention: the CUDA kernel under
    ``attn_impl="flash"`` (its plain version on the CPU), plain :func:`sdpa`
    otherwise.  The reference's prefill runs ``sdpa`` whatever
    ``attn_impl`` says; the kernel computes the same function."""
    if cfg.attn_impl == "flash":
        return ops.flash_attention(q, k, v, causal=True)
    return sdpa(q, k, v, causal=True)


def _sdpa_block(qi, k, v, causal, q_offset, scale):
    return sdpa(qi, k, v, causal=causal, q_offset=q_offset, scale=scale)


def chunked_sdpa(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, KH, Dh]
    v: torch.Tensor,
    *,
    causal: bool,
    q_block: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """Query-block-chunked attention: ``[bq, S]`` live logits a block.

    Each block is one :func:`sdpa` at its ``q_offset``, under
    ``torch.utils.checkpoint``, so the backward pass recomputes each block's
    logits instead of storing all ``S^2`` (the reference checkpoints its scan
    body).  A ``q_block`` that does not divide ``S`` gives plain :func:`sdpa`.
    """
    S = q.shape[1]
    bq = min(q_block, S)
    if S % bq != 0:
        return sdpa(q, k, v, causal=causal, scale=scale)
    outs = [
        checkpoint(_sdpa_block, q[:, i : i + bq], k, v, causal, i, scale, use_reentrant=False)
        for i in range(0, S, bq)
    ]
    return torch.cat(outs, dim=1)


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward recomputes attention with
    :func:`chunked_sdpa` and differentiates that (no backward kernel, as in
    the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return ops.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            out = chunked_sdpa(q, k, v, causal=ctx.causal, q_block=min(512, q.shape[1]))
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention_vjp(q, k, v, causal: bool = True) -> torch.Tensor:
    """Differentiable ``ops.flash_attention`` (model layout ``[B, S, H, D]``)."""
    return _FlashAttention.apply(q, k, v, causal)


def attention_core(
    cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
) -> torch.Tensor:
    """The attention implementation ``cfg.attn_impl`` names.

    ``auto``: plain :func:`sdpa` up to 1,024 tokens, query-chunked beyond.
    ``flash``: the CUDA kernel forward (its plain version on the CPU), the
    backward a recompute through :func:`chunked_sdpa`.
    """
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "sdpa" if q.shape[1] <= 1024 else "chunked"
    if impl == "flash":
        return flash_attention_vjp(q, k, v, causal)
    if impl == "chunked":
        return chunked_sdpa(q, k, v, causal=causal, q_block=cfg.attn_q_block)
    return sdpa(q, k, v, causal=causal)


# ----------------------------------------------------------------------------
# GQA attention block.
# ----------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = pdtype(cfg)
    p = {
        "wq": he_init(gen, (d, H, Dh), d, dt),
        "wk": he_init(gen, (d, KH, Dh), d, dt),
        "wv": he_init(gen, (d, KH, Dh), d, dt),
        "wo": he_init(gen, (H, Dh, d), H * Dh, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, Dh), dtype=dt, device=gen.device)
        p["bk"] = torch.zeros((KH, Dh), dtype=dt, device=gen.device)
        p["bv"] = torch.zeros((KH, Dh), dtype=dt, device=gen.device)
    return p


def specs_attention(cfg: ModelConfig) -> Specs:
    s = {
        "wq": ("fsdp", "heads", None),
        "wk": ("fsdp", "kv_heads", None),
        "wv": ("fsdp", "kv_heads", None),
        "wo": ("heads", None, "fsdp"),
    }
    if cfg.qkv_bias:
        s["bq"] = ("heads", None)
        s["bk"] = ("kv_heads", None)
        s["bv"] = ("kv_heads", None)
    return s


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    B, S, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).reshape(B, S, *w.shape[1:])


def kv_heads_read(cfg: ModelConfig) -> list[int] | None:
    """Under the tensor table, where the query heads split over the
    processes and the kv heads stay whole (the process count does not
    divide them), the kv heads this process's query heads read, query head
    ``h`` reading ``h // (H / KH)``: each once where the process's heads
    fall in one group, else one a query head (a group of 1).  ``None``
    otherwise: the process reads every kv head it holds."""
    ctx = tensor_context()
    H, KH = cfg.num_heads, cfg.num_kv_heads
    if ctx is None or tensor_split(H, "heads", ctx) == 1 or tensor_split(KH, "kv_heads", ctx) > 1:
        return None
    R, r = ctx.mesh.num_processes, ctx.mesh.process_index
    Hl, G = H // R, H // KH
    heads = [(r * Hl + j) // G for j in range(Hl)]
    return sorted(set(heads)) if G % Hl == 0 else heads


def local_kv_heads(cfg: ModelConfig) -> int:
    """The kv heads this process attends with (and caches): all of them
    off the tensor table."""
    read = kv_heads_read(cfg)
    if read is not None:
        return len(read)
    return cfg.num_kv_heads // tensor_split(cfg.num_kv_heads, "kv_heads")


def attention_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """Project to q/k/v (+ bias) in the compute dtype; under the tensor
    table the process's heads, and of whole kv heads those it reads
    (:func:`kv_heads_read`).

    Whole kv heads are projected on every process, but each process's
    attention reads only some of them, so its gradient of ``wk``, ``wv``,
    ``bk`` and ``bv`` covers only its query heads' share: those four leaves
    enter through :func:`tensor_entry`, which sums their gradient over the
    processes (kv heads that split need no sum: each process's are its
    own)."""
    x = _column_entry(x, "heads", cfg.num_heads)
    read = kv_heads_read(cfg)
    names = ("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv")
    if read is not None:
        params = {**params, **{n: tensor_entry(params[n], tensor_context()) for n in names}}
    q, k, v = _project(x, params["wq"]), _project(x, params["wk"]), _project(x, params["wv"])
    if cfg.qkv_bias:
        dt = x.dtype
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if read is not None:
        k, v = k[:, :, read], v[:, :, read]
    return q, k, v


def attention_out(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The output projection; row-parallel under the tensor table (the
    process's heads' partial sum, then one all-reduce)."""
    B, S, H, Dh = x.shape
    y = x.reshape(B, S, H * Dh) @ params["wo"].to(x.dtype).reshape(H * Dh, -1)
    return _row_parallel(y, "heads", cfg.num_heads)


def _column_entry(x: torch.Tensor, name: str, dim: int) -> torch.Tensor:
    """``x``, replicated on every process, entering a product split along a
    dim of ``dim`` entries named ``name``: where the tensor table splits
    it, :func:`tensor_entry` (the gradient summed over the processes in the
    backward); as it is otherwise."""
    ctx = tensor_context()
    if ctx is None or tensor_split(dim, name, ctx) == 1:
        return x
    return tensor_entry(x, ctx)


def _row_parallel(y: torch.Tensor, name: str, dim: int) -> torch.Tensor:
    """A product contracted over a dim of ``dim`` entries named ``name``:
    summed over the processes where the tensor table split it."""
    ctx = tensor_context()
    if ctx is None or tensor_split(dim, name, ctx) == 1:
        return y
    return tensor_all_reduce(y, ctx)


def attention_block(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence (training) GQA attention."""
    q, k, v = attention_qkv(params, cfg, x)
    q, k = rotate_qk(cfg, q, k, cos, sin)
    return attention_out(params, cfg, attention_core(cfg, q, k, v, causal=causal))


def attention_decode(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    cache_k: torch.Tensor,  # [B, S, KH, Dh]
    cache_v: torch.Tensor,
    pos: int,  # write position / context length, the same for every row
    cos: torch.Tensor,
    sin: torch.Tensor,
):
    """One decode step; returns ``(out, cache_k, cache_v)``.  The cache is
    updated in place (the reference returns updated copies): the step
    writes one position of it and reads the rest."""
    q, k, v = attention_qkv(params, cfg, x)
    q, k = rotate_qk(cfg, q, k, cos, sin)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    o = sdpa(q, cache_k, cache_v, causal=False, kv_valid_len=pos + 1)
    return attention_out(params, cfg, o), cache_k, cache_v


def attention_decode_slots(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    cache_k: torch.Tensor,  # [B, S, KH, Dh]
    cache_v: torch.Tensor,
    positions: torch.Tensor,  # [B] per-slot write position / context length
    cos: torch.Tensor,
    sin: torch.Tensor,
):
    """One decode step with a per-slot position vector (continuous
    batching), updating the cache in place.  With every slot at the same
    position it writes the same bytes and builds the same mask as
    :func:`attention_decode`."""
    q, k, v = attention_qkv(params, cfg, x)
    q, k = rotate_qk(cfg, q, k, cos, sin)
    b = torch.arange(x.shape[0], device=x.device)
    cache_k[b, positions] = k[:, 0].to(cache_k.dtype)
    cache_v[b, positions] = v[:, 0].to(cache_v.dtype)
    o = sdpa(q, cache_k, cache_v, causal=False, kv_valid_len=positions + 1)
    return attention_out(params, cfg, o), cache_k, cache_v


# ----------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): a low-rank compressed KV cache.
# ----------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = pdtype(cfg)
    return {
        # queries: full rank (V2-Lite has no query compression)
        "wq": he_init(gen, (d, H, dn + dr), d, dt),
        # keys and values: compressed to r (+ the shared rope dims), then per head
        "wkv_a": he_init(gen, (d, r + dr), d, dt),
        "kv_norm": init_rmsnorm(r, dt, gen.device),
        "wk_b": he_init(gen, (r, H, dn), r, dt),
        "wv_b": he_init(gen, (r, H, dv), r, dt),
        "wo": he_init(gen, (H, dv, d), H * dv, dt),
    }


def specs_mla(cfg: ModelConfig) -> Specs:
    return {
        "wq": ("fsdp", "heads", None),
        "wkv_a": ("fsdp", None),
        "kv_norm": specs_rmsnorm(),
        "wk_b": ("fsdp", "heads", None),
        "wv_b": ("fsdp", "heads", None),
        "wo": ("heads", None, "fsdp"),
    }


def _mla_qk(params: Params, cfg: ModelConfig, x: torch.Tensor, cos, sin):
    """The query path and the compressed key/value path (training, prefill
    and decode): ``(q_nope [B, S, H, dn], q_rope [B, S, H, dr], c [B, S, r],
    k_rope [B, S, dr])``, the rope parts rotated."""
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = _project(x, params["wq"])
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
    ckv = x @ params["wkv_a"].to(x.dtype)
    c = rmsnorm(params["kv_norm"], ckv[..., :r], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., None, r:], cos, sin)[:, :, 0]  # one rope head, shared
    return q_nope, q_rope, c, k_rope


def _mla_attend_block(params: Params, cfg: ModelConfig, q_nope, q_rope, c, k_rope, *,
                      causal: bool, q_offset: int = 0, kv_valid_len=None) -> torch.Tensor:
    """Attention in the compressed space, ``wk_b`` absorbed into the query:
    ``scores = (q_nope @ wk_b^T) . c + q_rope . k_rope``, so the cache stays
    ``[B, S, r]``.  The logits in f32, masked with ``-1e30``, scaled by
    ``1 / sqrt(qk_nope + qk_rope)``; the values read ``c`` and expand
    through ``wv_b`` after the softmax: ``[B, S, H, dv]``, before ``wo``
    (:func:`_mla_attend`).  Every product here is per head, so under the
    tensor table it runs on the process's heads with no collective."""
    dt = q_nope.dtype
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, params["wk_b"].to(dt))
    logits = torch.einsum("bshr,btr->bhst", q_abs, c)
    logits = logits + torch.einsum("bshk,btk->bhst", q_rope, k_rope)
    logits = logits.float() * scale
    Sq, Sk = logits.shape[2], logits.shape[3]
    kpos = torch.arange(Sk, device=logits.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=logits.device)
    if causal:
        mask = kpos[None, :] <= (torch.arange(Sq, device=logits.device)[:, None] + q_offset)
    bmask = mask[None, None]  # broadcast over [B, H, ...]
    if isinstance(kv_valid_len, torch.Tensor) and kv_valid_len.ndim == 1:
        bmask = bmask & (kpos[None, :] < kv_valid_len[:, None])[:, None, None, :]
    elif kv_valid_len is not None:
        bmask = bmask & (kpos[None, :] < kv_valid_len)[None, None]
    logits = torch.where(bmask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(dt)
    o_c = torch.einsum("bhst,btr->bshr", w, c)  # attend over the compressed values
    return torch.einsum("bshr,rhv->bshv", o_c, params["wv_b"].to(dt))


def _mla_attend(params: Params, cfg: ModelConfig, q_nope, q_rope, c, k_rope, *,
                causal: bool, q_offset: int = 0, kv_valid_len=None) -> torch.Tensor:
    """Query-block-chunked MLA attention, as the reference chunks it: one
    block unless ``cfg.attn_impl`` asks for chunks or (``"auto"``) the
    queries pass ``max(attn_q_block, 1024)``; each block of
    ``attn_q_block`` queries under ``torch.utils.checkpoint``.  Then the
    output projection ``wo`` over every block at once, row-parallel under
    the tensor table (the process's heads' partial sum and one all-reduce a
    call, not one a block)."""
    Sq = q_nope.shape[1]
    bq = cfg.attn_q_block
    if (cfg.attn_impl == "sdpa" or Sq % bq != 0 or Sq == bq
            or (cfg.attn_impl == "auto" and Sq <= max(bq, 1024))):
        o = _mla_attend_block(params, cfg, q_nope, q_rope, c, k_rope, causal=causal,
                              q_offset=q_offset, kv_valid_len=kv_valid_len)
    else:
        o = torch.cat([
            checkpoint(
                lambda qn, qr, i=i: _mla_attend_block(
                    params, cfg, qn, qr, c, k_rope, causal=causal, q_offset=i + q_offset,
                    kv_valid_len=kv_valid_len),
                q_nope[:, i : i + bq], q_rope[:, i : i + bq], use_reentrant=False)
            for i in range(0, Sq, bq)
        ], dim=1)
    B, S, H, dv = o.shape
    y = o.reshape(B, S, H * dv) @ params["wo"].to(o.dtype).reshape(H * dv, -1)
    return _row_parallel(y, "heads", cfg.num_heads)


def mla_block(params: Params, cfg: ModelConfig, x: torch.Tensor, cos, sin, *,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence (training) MLA attention."""
    q_nope, q_rope, c, k_rope = _mla_qk(params, cfg, x, cos, sin)
    return _mla_attend(params, cfg, q_nope, q_rope, c, k_rope, causal=causal)


def mla_decode(params: Params, cfg: ModelConfig, x: torch.Tensor, cache_c: torch.Tensor,
               cache_kr: torch.Tensor, pos: int, cos, sin):
    """One decode step against the compressed cache (``c [B, S, r]``,
    ``k_rope [B, S, dr]``), updated in place; returns ``(out, cache_c,
    cache_kr)``."""
    q_nope, q_rope, c_new, kr_new = _mla_qk(params, cfg, x, cos, sin)
    cache_c[:, pos] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[:, pos] = kr_new[:, 0].to(cache_kr.dtype)
    out = _mla_attend(params, cfg, q_nope, q_rope, cache_c, cache_kr,
                      causal=False, kv_valid_len=pos + 1)
    return out, cache_c, cache_kr


def mla_decode_slots(params: Params, cfg: ModelConfig, x: torch.Tensor, cache_c: torch.Tensor,
                     cache_kr: torch.Tensor, positions: torch.Tensor, cos, sin):
    """MLA decode at per-slot positions ``[B]`` (continuous batching), the
    cache updated in place."""
    q_nope, q_rope, c_new, kr_new = _mla_qk(params, cfg, x, cos, sin)
    b = torch.arange(x.shape[0], device=x.device)
    cache_c[b, positions] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[b, positions] = kr_new[:, 0].to(cache_kr.dtype)
    out = _mla_attend(params, cfg, q_nope, q_rope, cache_c, cache_kr,
                      causal=False, kv_valid_len=positions + 1)
    return out, cache_c, cache_kr


# ----------------------------------------------------------------------------
# MLPs.
# ----------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = pdtype(cfg)
    if cfg.act == "gelu":
        return {
            "w_in": he_init(gen, (d, f), d, dt),
            "b_in": torch.zeros((f,), dtype=dt, device=gen.device),
            "w_out": he_init(gen, (f, d), f, dt),
            "b_out": torch.zeros((d,), dtype=dt, device=gen.device),
        }
    return {
        "w_gate": he_init(gen, (d, f), d, dt),
        "w_up": he_init(gen, (d, f), d, dt),
        "w_down": he_init(gen, (f, d), f, dt),
    }


def specs_mlp(cfg: ModelConfig) -> Specs:
    if cfg.act == "gelu":
        return {
            "w_in": ("fsdp", "d_ff"),
            "b_in": ("d_ff",),
            "w_out": ("d_ff", "fsdp"),
            "b_out": (None,),
        }
    return {
        "w_gate": ("fsdp", "d_ff"),
        "w_up": ("fsdp", "d_ff"),
        "w_down": ("d_ff", "fsdp"),
    }


def mlp_block(params: Params, cfg: ModelConfig, x: torch.Tensor,
              d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU, or a GELU MLP with biases (``jax.nn.gelu``'s tanh form), of
    width ``d_ff`` (default ``cfg.d_ff``; :func:`init_mlp`'s).  Under the
    tensor table the up projections are column-parallel and the down
    projection row-parallel: one all-reduce, before ``b_out``."""
    dt = x.dtype
    f = d_ff or cfg.d_ff
    x = _column_entry(x, "d_ff", f)
    if cfg.act == "gelu":
        h = x @ params["w_in"].to(dt) + params["b_in"].to(dt)
        h = torch.nn.functional.gelu(h, approximate="tanh")
        y = _row_parallel(h @ params["w_out"].to(dt), "d_ff", f)
        return y + params["b_out"].to(dt)
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return _row_parallel((torch.nn.functional.silu(g) * u) @ params["w_down"].to(dt), "d_ff", f)


# ----------------------------------------------------------------------------
# Embedding / unembedding / loss.
# ----------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The table; an ``unembed`` matrix too unless the embeddings are tied."""
    dt = pdtype(cfg)
    p = {"table": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = he_init(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, dt)
    return p


def specs_embedding(cfg: ModelConfig) -> Specs:
    s = {"table": ("vocab", "fsdp")}
    if not cfg.tie_embeddings:
        s["unembed"] = ("fsdp", "vocab")
    return s


def scale_as(x: torch.Tensor, scale: float) -> float:
    """``scale`` rounded to ``x``'s dtype, as a host number: the reference's
    ``jnp.asarray(scale, x.dtype)`` without a copy to the card (a copy from
    host memory waits for the card to drain)."""
    return torch.tensor(scale, dtype=x.dtype).item()


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Gather rows, then cast (the reference casts the table first: the
    same values, without a compute-dtype copy of the whole table).  Under
    the tensor table with the vocab split, each process looks up the ids in
    its rows (zeros elsewhere) and one all-reduce puts every row together,
    exactly."""
    table = params["table"]
    ctx = tensor_context()
    if ctx is None or tensor_split(cfg.vocab_size, "vocab", ctx) == 1:
        x = table[tokens].to(cdtype(cfg))
    else:
        n = table.shape[0]
        local = tokens - ctx.mesh.process_index * n
        mine = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)].to(cdtype(cfg))
        x = tensor_all_reduce(torch.where(mine[..., None], rows, 0), ctx)
    return x * scale_as(x, cfg.emb_scale)


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ unembed``, or ``x @ table.T`` with tied embeddings;
    under the tensor table with the vocab split, the process's columns
    all-gathered to the full vocab on every process."""
    x = _column_entry(x * scale_as(x, cfg.logits_scale), "vocab", cfg.vocab_size)
    if cfg.tie_embeddings:
        logits = x @ params["table"].to(x.dtype).T
    else:
        logits = x @ params["unembed"].to(x.dtype)
    ctx = tensor_context()
    if ctx is None or tensor_split(cfg.vocab_size, "vocab", ctx) == 1:
        return logits
    return tensor_all_gather(logits, ctx)


def xent_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean next-token cross entropy in f32 (log-sum-exp); with ``mask``,
    the mean over the masked-in positions."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


__all__ = [
    "cdtype",
    "pdtype",
    "make_generator",
    "rand",
    "he_init",
    "init_rmsnorm",
    "specs_rmsnorm",
    "rmsnorm",
    "init_layernorm",
    "specs_layernorm",
    "layernorm",
    "rope_angles",
    "mrope_angles",
    "positions_for",
    "apply_rope",
    "rope_tables",
    "rotate_qk",
    "sdpa",
    "prefill_attention",
    "chunked_sdpa",
    "attention_core",
    "scale_as",
    "init_attention",
    "specs_attention",
    "kv_heads_read",
    "local_kv_heads",
    "attention_qkv",
    "attention_out",
    "attention_block",
    "attention_decode",
    "attention_decode_slots",
    "init_mla",
    "specs_mla",
    "mla_block",
    "mla_decode",
    "mla_decode_slots",
    "init_mlp",
    "specs_mlp",
    "mlp_block",
    "init_embedding",
    "specs_embedding",
    "embed",
    "unembed",
    "xent_loss",
]
