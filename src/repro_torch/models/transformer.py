"""Decoder-only transformer stack for GQA dense and MoE models (port of
``repro.models.transformer``).

The reference stacks each run of identical layers (a *segment*) and scans
over it with ``lax.scan``; here a segment is a list of per-layer param dicts
and the scan is a loop.  Caches keep the reference's stacked layout
(``cache["seg0"]["k"]`` is ``[L, B, S, KH, Dh]``), so they compare with the
reference's leaf for leaf; decode writes layer ``l``'s slice in place.

Training runs :func:`forward` / :func:`train_loss`; with ``cfg.remat`` other
than ``"none"`` each layer runs under ``torch.utils.checkpoint`` and is
recomputed in the backward pass.

What the port leaves to later slices: MLA, M-RoPE, q/k/v biases and the VLM
patch prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import layers as L
from . import moe as M


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str  # "dense" | "moe"
    count: int


def segments_for(cfg: ModelConfig) -> list[Segment]:
    if cfg.num_experts == 0:
        return [Segment("dense", cfg.num_layers)]
    segs = []
    if cfg.first_dense_layers:
        segs.append(Segment("dense", cfg.first_dense_layers))
    segs.append(Segment("moe", cfg.num_layers - cfg.first_dense_layers))
    return segs


def check_supported(cfg: ModelConfig) -> None:
    """Raise on what this slice does not build (``registry.build`` calls it)."""
    unported = {
        "MLA (attn_kind='mla')": cfg.attn_kind != "gqa",
        f"rope_kind={cfg.rope_kind!r}": cfg.rope_kind != "rope",
        "q/k/v biases": cfg.qkv_bias,
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet; it comes with the dense-model slice (ROADMAP A.12)"
            )


# ----------------------------------------------------------------------------
# Params.
# ----------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Any:
    dt = L.pdtype(cfg)
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, gen.device),
        "attn": L.init_attention(gen, cfg),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, gen.device),
        "ffn": M.init_moe_layer(gen, cfg) if kind == "moe" else L.init_mlp(gen, cfg),
    }


def init(seed: int, cfg: ModelConfig, device="cuda") -> Any:
    """Random params from ``seed`` on ``device``, with the reference's
    distributions (its numbers come only through
    :mod:`repro_torch.models.convert`)."""
    from ..relational.table import resolve_device

    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    params: dict[str, Any] = {"embedding": L.init_embedding(gen, cfg)}
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, L.pdtype(cfg), gen.device)
    for i, seg in enumerate(segments_for(cfg)):
        params[f"seg{i}"] = [_init_layer(gen, cfg, seg.kind) for _ in range(seg.count)]
    return params


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int, dtype=None,
               device="cuda") -> Any:
    dtype = dtype or L.cdtype(cfg)
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache: dict[str, Any] = {}
    for i, seg in enumerate(segments_for(cfg)):
        shape = (seg.count, batch_size, capacity, kh, hd)
        cache[f"seg{i}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    return cache


# ----------------------------------------------------------------------------
# Layer bodies.
# ----------------------------------------------------------------------------

def _ffn_block(p, cfg: ModelConfig, kind: str, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    f = M.moe_ffn(p["ffn"], cfg, h) if kind == "moe" else L.mlp_block(p["ffn"], cfg, h)
    return x + L.scale_as(x, cfg.residual_scale) * f


def _layer_fwd(p, cfg: ModelConfig, kind: str, x, cos, sin):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a = L.attention_block(p["attn"], cfg, h, cos, sin, causal=True)
    x = x + L.scale_as(x, cfg.residual_scale) * a
    return _ffn_block(p, cfg, kind, x)


def _maybe_remat(fn, cfg: ModelConfig):
    """``"block"`` and ``"full"``: the layer under ``torch.utils.checkpoint``,
    its activations recomputed in the backward pass; ``"none"``: as it is.
    The reference's ``"block"`` policy keeps the matrix products and
    recomputes the rest; here both recompute the whole layer, which changes
    the recompute's cost and not a value."""
    if cfg.remat == "none":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _run_segments(params, cfg: ModelConfig, x, cos, sin):
    for i, seg in enumerate(segments_for(cfg)):
        body = _maybe_remat(
            lambda h, p, kind=seg.kind: _layer_fwd(p, cfg, kind, h, cos, sin), cfg
        )
        for p in params[f"seg{i}"]:
            x = body(x, p)
    return x


def _embed_inputs(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embedding and positions (given, or ``0 .. S-1`` for every row)."""
    if "patches" in batch:
        raise NotImplementedError("the VLM patch prefix comes with the dense-model slice "
                                  "(ROADMAP A.12)")
    x = L.embed(params["embedding"], cfg, batch["tokens"])
    pos = batch.get("positions")
    if pos is None:
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].repeat(B, 1)
    return x, pos


def forward(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence causal forward -> final-normed hidden states ``[B, S, d]``."""
    x, pos = _embed_inputs(params, cfg, batch)
    cos, sin = L.rope_tables(cfg, pos, cfg.resolved_head_dim)
    x = _run_segments(params, cfg, x, cos, sin)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["labels"]`` (optionally
    masked by ``batch["loss_mask"]``)."""
    logits = L.unembed(params["embedding"], cfg, forward(params, cfg, batch))
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


def _decode_layers(params, cfg: ModelConfig, x, cache, attend):
    """Run every layer of every segment for one decode step; ``attend``
    does one layer's attention against its cache slice, in place."""
    for i, seg in enumerate(segments_for(cfg)):
        c = cache[f"seg{i}"]
        for l, p in enumerate(params[f"seg{i}"]):
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            a, _, _ = attend(p["attn"], h, c["k"][l], c["v"][l])
            x = x + L.scale_as(x, cfg.residual_scale) * a
            x = _ffn_block(p, cfg, seg.kind, x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embedding"], cfg, x)[:, 0]


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int):
    """One token for every stream at the same position: tokens ``[B, 1]``
    -> ``(logits [B, vocab], cache)``; the cache is updated in place."""
    x = L.embed(params["embedding"], cfg, tokens)
    B = x.shape[0]
    p = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = L.rope_tables(cfg, p, cfg.resolved_head_dim)
    logits = _decode_layers(
        params, cfg, x, cache,
        lambda pa, h, ck, cv: L.attention_decode(pa, cfg, h, ck, cv, pos, cos, sin),
    )
    return logits, cache


def decode_step_slots(params, cfg: ModelConfig, tokens, cache, positions):
    """One token per SLOT at per-slot positions (the continuous-batching
    step): tokens ``[B, 1]``, positions ``[B]`` -> ``(logits [B, vocab],
    cache)``.  With every position equal it gives :func:`decode_step`'s
    bits: the same embed, rope, cache write, mask and unembed."""
    x = L.embed(params["embedding"], cfg, tokens)
    positions = positions.to(device=x.device, dtype=torch.long)
    cos, sin = L.rope_tables(cfg, positions[:, None], cfg.resolved_head_dim)
    logits = _decode_layers(
        params, cfg, x, cache,
        lambda pa, h, ck, cv: L.attention_decode_slots(pa, cfg, h, ck, cv, positions, cos, sin),
    )
    return logits, cache


def prefill(params, cfg: ModelConfig, batch):
    """Process whole prompts: ``batch["tokens"] [B, S]`` -> ``(last-token
    logits [B, vocab], cache)`` with a cache of exactly ``S`` positions."""
    if "patches" in batch:
        raise NotImplementedError("the VLM patch prefix comes with the dense-model slice")
    x = L.embed(params["embedding"], cfg, batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].repeat(B, 1)
    cos, sin = L.rope_tables(cfg, pos, cfg.resolved_head_dim)

    cache = {}
    for i, seg in enumerate(segments_for(cfg)):
        ks, vs = [], []
        for p in params[f"seg{i}"]:
            hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = L.attention_qkv(p["attn"], cfg, hn)
            q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
            a = L.attention_out(p["attn"], L.sdpa(q, k, v, causal=True))
            x = x + L.scale_as(x, cfg.residual_scale) * a
            x = _ffn_block(p, cfg, seg.kind, x)
            ks.append(k)
            vs.append(v)
        cache[f"seg{i}"] = {"k": torch.stack(ks), "v": torch.stack(vs)}

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embedding"], cfg, x[:, -1:])
    return logits[:, 0], cache


__all__ = [
    "check_supported",
    "Segment",
    "segments_for",
    "init",
    "init_cache",
    "forward",
    "train_loss",
    "decode_step",
    "decode_step_slots",
    "prefill",
]
