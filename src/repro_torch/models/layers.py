"""Shared neural layers for GQA transformers (port of ``repro.models.layers``).

Conventions, as in the reference:

* params are plain dicts of tensors, in the reference's layouts (``wq`` is
  ``[d, H, Dh]``, ``wo`` is ``[H, Dh, d]``), so that
  :mod:`repro_torch.models.convert` copies the reference's arrays as they are;
* activations are ``[batch, seq, d_model]``; attention heads ``[B, S, H, Dh]``;
* ``positions`` are int ``[B, S]``;
* master params keep ``cfg.param_dtype`` and are cast to the compute dtype
  where they are used, as the reference casts them.

What the port leaves to later slices: MLA, M-RoPE, layernorm, q/k/v
biases, tied embeddings, the MLPs of dense layers, the query-chunked and
flash attention paths (``attention_core``; serving calls :func:`sdpa`
directly) and the loss.

The port's own init draws the reference's distributions (truncated normal at
±2σ, He scale) from an explicit ``torch.Generator``; it cannot reproduce
``jax.random``'s numbers.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig

Params = Any  # nested dict[str, torch.Tensor]

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


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale`` x a standard normal truncated to ``[-2, 2]``, by inverting
    the CDF of a uniform draw (as ``jax.random.truncated_normal`` does)."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
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


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * params["scale"].float()).to(dt)


# ----------------------------------------------------------------------------
# RoPE.
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


def rope_tables(cfg: ModelConfig, positions: torch.Tensor, head_dim: int):
    return rope_angles(positions, head_dim, cfg.rope_theta)


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


# ----------------------------------------------------------------------------
# GQA attention block.
# ----------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = pdtype(cfg)
    return {
        "wq": he_init(gen, (d, H, Dh), d, dt),
        "wk": he_init(gen, (d, KH, Dh), d, dt),
        "wv": he_init(gen, (d, KH, Dh), d, dt),
        "wo": he_init(gen, (H, Dh, d), H * Dh, dt),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    B, S, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).reshape(B, S, *w.shape[1:])


def attention_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """Project to q/k/v in the compute dtype."""
    return _project(x, params["wq"]), _project(x, params["wk"]), _project(x, params["wv"])


def attention_out(params: Params, x: torch.Tensor) -> torch.Tensor:
    B, S, H, Dh = x.shape
    return x.reshape(B, S, H * Dh) @ params["wo"].to(x.dtype).reshape(H * Dh, -1)


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
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    o = sdpa(q, cache_k, cache_v, causal=False, kv_valid_len=pos + 1)
    return attention_out(params, o), cache_k, cache_v


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
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    b = torch.arange(x.shape[0], device=x.device)
    cache_k[b, positions] = k[:, 0].to(cache_k.dtype)
    cache_v[b, positions] = v[:, 0].to(cache_v.dtype)
    o = sdpa(q, cache_k, cache_v, causal=False, kv_valid_len=positions + 1)
    return attention_out(params, o), cache_k, cache_v


# ----------------------------------------------------------------------------
# Embedding / unembedding.
# ----------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = pdtype(cfg)
    return {
        "table": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "unembed": he_init(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, dt),
    }


def scale_as(x: torch.Tensor, scale: float) -> float:
    """``scale`` rounded to ``x``'s dtype, as a host number: the reference's
    ``jnp.asarray(scale, x.dtype)`` without a copy to the card (a copy from
    host memory waits for the card to drain)."""
    return torch.tensor(scale, dtype=x.dtype).item()


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Gather rows, then cast (the reference casts the table first: the
    same values, without a compute-dtype copy of the whole table)."""
    x = params["table"][tokens].to(cdtype(cfg))
    return x * scale_as(x, cfg.emb_scale)


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = x * scale_as(x, cfg.logits_scale)
    return x @ params["unembed"].to(x.dtype)


__all__ = [
    "cdtype",
    "pdtype",
    "he_init",
    "init_rmsnorm",
    "rmsnorm",
    "rope_angles",
    "apply_rope",
    "rope_tables",
    "sdpa",
    "scale_as",
    "init_attention",
    "attention_qkv",
    "attention_out",
    "attention_decode",
    "attention_decode_slots",
    "init_embedding",
    "embed",
    "unembed",
]
