"""Decoder-only transformer stack (port of ``repro.models.transformer``).

One implementation serves the dense models (MiniCPM, Qwen2.5, Qwen1.5,
DeepSeek-67B), the MoE models (OLMoE, all-MoE; DeepSeek-V2-Lite, MLA with a
dense first layer) and the Qwen2-VL backbone (M-RoPE and a prefix of patch
embeddings).

The reference stacks each run of identical layers (a *segment*) and scans
over it with ``lax.scan``; here a segment is a list of per-layer param dicts
and the scan is a loop.  Caches keep the reference's stacked layout
(``cache["seg0"]["k"]`` is ``[L, B, S, KH, Dh]``; under MLA ``"c"`` is
``[L, B, S, r]`` and ``"kr"`` ``[L, B, S, dr]``), so they compare with the
reference's leaf for leaf; decode writes layer ``l``'s slice in place.

Training runs :func:`forward` / :func:`train_loss`; with ``cfg.remat`` other
than ``"none"`` each layer runs under ``torch.utils.checkpoint`` and is
recomputed in the backward pass.

A VLM batch's ``patches [B, P, d]`` are prepended to the token embeddings:
prefill's cache then holds ``P + S`` positions and decode continues after
them; the loss reads the text positions only.

Under the tensor table (:func:`~repro_torch.distributed.sharding.tensor_rules`)
the params are a process's slices (``init(..., place=tensor_place(specs(cfg),
ctx))`` or :func:`~repro_torch.models.convert.tensor_params`) and the same
code runs on the process's heads and experts: :mod:`.layers` and :mod:`.moe`
add the collectives.  Under MLA a process holds its heads of ``wq``,
``wk_b``, ``wv_b`` and ``wo`` (the reference's ``specs_mla``) and the whole
of ``wkv_a``, ``kv_norm`` and the compressed ``c``/``kr`` cache, which carry
no head dim: the absorbed products run on its heads, and ``wo`` all-reduces
once a layer.

On a ``data x model`` grid of processes (training) a process holds its
model row's slices of each leaf, further split along the leaf's ``fsdp`` dim
over its data column: each layer gathers its leaves whole over the column
as it runs (:func:`~repro_torch.distributed.sharding.fsdp_gather`, inside
the remat region, so the recompute gathers again and no step holds the
whole model gathered), and so do the embedding's lookup and the logits.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.multiplexer import current_multiplexer, use_multiplexer
from ..distributed.sharding import current_mesh_context, fsdp_gather, mesh_context
from . import layers as L
from . import moe as M
from . import registry


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


# ----------------------------------------------------------------------------
# Params.
# ----------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Any:
    dt = L.pdtype(cfg)
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, gen.device),
        "attn": (L.init_mla if cfg.attn_kind == "mla" else L.init_attention)(gen, cfg),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, gen.device),
        "ffn": M.init_moe_layer(gen, cfg) if kind == "moe" else L.init_mlp(gen, cfg),
    }


def _specs_layer(cfg: ModelConfig, kind: str) -> Any:
    attn = (L.specs_mla if cfg.attn_kind == "mla" else L.specs_attention)(cfg)
    return {
        "ln1": L.specs_rmsnorm(),
        "attn": attn,
        "ln2": L.specs_rmsnorm(),
        "ffn": M.specs_moe_layer(cfg) if kind == "moe" else L.specs_mlp(cfg),
    }


def init(seed: int, cfg: ModelConfig, device="cuda", place=None) -> Any:
    """Random params from ``seed`` on ``device``, with the reference's
    distributions (its numbers come only through
    :mod:`repro_torch.models.convert`); on ``"meta"``, shapes only.  The
    embedding and each layer go through ``place(path, sub) -> sub`` as they
    are drawn (paths ``("embedding",)`` and ``("seg<i>", l)``), which may
    keep a slice of each leaf and free the rest: the sharded train state's
    experts, a tensor-parallel process's slices
    (:func:`~repro_torch.distributed.sharding.tensor_place`)."""
    keep = place or (lambda path, layer: layer)
    gen = L.make_generator(seed, device)
    params: dict[str, Any] = {"embedding": keep(("embedding",), L.init_embedding(gen, cfg))}
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, L.pdtype(cfg), gen.device)
    for i, seg in enumerate(segments_for(cfg)):
        params[f"seg{i}"] = [keep((f"seg{i}", l), _init_layer(gen, cfg, seg.kind))
                             for l in range(seg.count)]
    return params


def specs(cfg: ModelConfig) -> Any:
    """Every param leaf's logical axes, in :func:`init`'s structure (a list
    entry a layer, where the reference stacks layers under a leading
    ``None``)."""
    s: dict[str, Any] = {
        "embedding": L.specs_embedding(cfg),
        "final_norm": L.specs_rmsnorm(),
    }
    for i, seg in enumerate(segments_for(cfg)):
        s[f"seg{i}"] = [_specs_layer(cfg, seg.kind) for _ in range(seg.count)]
    return s


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int, dtype=None,
               device="cuda") -> Any:
    """Zeroed caches; under the tensor table a GQA cache holds the kv
    heads this process attends with (:func:`layers.local_kv_heads`)."""
    dtype = dtype or L.cdtype(cfg)
    cache: dict[str, Any] = {}
    for i, seg in enumerate(segments_for(cfg)):
        lead = (seg.count, batch_size, capacity)
        if cfg.attn_kind == "mla":
            shapes = {"c": lead + (cfg.kv_lora_rank,), "kr": lead + (cfg.qk_rope_head_dim,)}
        else:
            kv = lead + (L.local_kv_heads(cfg), cfg.resolved_head_dim)
            shapes = {"k": kv, "v": kv}
        cache[f"seg{i}"] = {name: torch.zeros(shape, dtype=dtype, device=device)
                            for name, shape in shapes.items()}
    return cache


def cache_specs(cfg: ModelConfig) -> Any:
    """Logical axes for each cache leaf (leading layer dim replicated), the
    reference's letter for letter.  The tensor table places the cache by
    its kv heads instead (:func:`init_cache`)."""
    out: dict[str, Any] = {}
    for i, _seg in enumerate(segments_for(cfg)):
        if cfg.attn_kind == "mla":
            out[f"seg{i}"] = {
                "c": (None, "batch", "kv_seq", None),
                "kr": (None, "batch", "kv_seq", None),
            }
        else:
            out[f"seg{i}"] = {
                "k": (None, "batch", "kv_seq", None, None),
                "v": (None, "batch", "kv_seq", None, None),
            }
    return out


# ----------------------------------------------------------------------------
# Layer bodies.
# ----------------------------------------------------------------------------

def _ffn_block(p, cfg: ModelConfig, kind: str, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    f = M.moe_ffn(p["ffn"], cfg, h) if kind == "moe" else L.mlp_block(p["ffn"], cfg, h)
    return x + L.scale_as(x, cfg.residual_scale) * f


def _gathered(p, cfg: ModelConfig, seg: int | None, key: str | None = None):
    """``p`` (a layer of segment ``seg``, or with ``None`` the embedding;
    with ``key``, only that leaf of it, in a dict of one) with its FSDP
    leaves gathered whole over a grid's data column; as it is off a grid."""
    if key is not None:
        p = {key: p[key]}
    ctx = current_mesh_context()
    if ctx is None or ctx.data is None:
        return p
    whole = registry.whole_params(cfg)
    if seg is None:
        specs, shapes = L.specs_embedding(cfg), whole["embedding"]
    else:
        specs, shapes = _specs_layer(cfg, segments_for(cfg)[seg].kind), whole[f"seg{seg}"][0]
    if key is not None:
        specs, shapes = {key: specs[key]}, {key: shapes[key]}
    return fsdp_gather(p, specs, shapes, ctx)


def _layer_fwd(p, cfg: ModelConfig, seg: int, kind: str, x, cos, sin):
    p = _gathered(p, cfg, seg)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a = L.mla_block(p["attn"], cfg, h, cos, sin, causal=True)
    else:
        a = L.attention_block(p["attn"], cfg, h, cos, sin, causal=True)
    x = x + L.scale_as(x, cfg.residual_scale) * a
    return _ffn_block(p, cfg, kind, x)


def _ambient():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs under
    the mesh context and multiplexer the forward saw.  On the card the
    backward, and so the recompute, runs on an autograd worker thread, where
    the context variables that hold them are not set."""
    ctx, mux = current_mesh_context(), current_multiplexer()

    @contextlib.contextmanager
    def recompute():
        with mesh_context(ctx), use_multiplexer(mux):
            yield

    return contextlib.nullcontext(), recompute()


def _maybe_remat(fn, cfg: ModelConfig):
    """``"block"`` and ``"full"``: the layer under ``torch.utils.checkpoint``,
    its activations recomputed in the backward pass; ``"none"``: as it is.
    The reference's ``"block"`` policy keeps the matrix products and
    recomputes the rest; here both recompute the whole layer, which changes
    the recompute's cost and not a value."""
    if cfg.remat == "none":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=_ambient)


def _run_segments(params, cfg: ModelConfig, x, cos, sin):
    for i, seg in enumerate(segments_for(cfg)):
        body = _maybe_remat(
            lambda h, p, i=i, kind=seg.kind: _layer_fwd(p, cfg, i, kind, h, cos, sin), cfg
        )
        for p in params[f"seg{i}"]:
            x = body(x, p)
    return x


def _embed_inputs(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embedding, after the VLM patch prefix when the batch has one,
    and positions (given, or ``0 .. P+S-1`` for every row, the same for the
    three M-RoPE streams)."""
    x = L.embed(_gathered(params["embedding"], cfg, None, "table"), cfg, batch["tokens"])
    if "patches" in batch:  # Qwen2-VL's stub frontend: precomputed embeddings
        x = torch.cat([batch["patches"].to(device=x.device, dtype=x.dtype), x], dim=1)
    return x, L.positions_for(cfg, batch)


def _rope_dim(cfg: ModelConfig) -> int:
    """The width the rotary tables cover: MLA rotates only its rope dims."""
    if cfg.attn_kind == "mla":
        return cfg.qk_rope_head_dim
    return cfg.resolved_head_dim


def _step_positions(cfg: ModelConfig, p: torch.Tensor) -> torch.Tensor:
    """Decode positions ``[B, 1]``, as ``[3, B, 1]`` under M-RoPE (every
    stream at the token's position)."""
    if cfg.rope_kind == "mrope":
        return p[None].expand(3, *p.shape)
    return p


def forward(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence causal forward -> final-normed hidden states ``[B, S, d]``
    (``S`` counts the patch prefix)."""
    x, pos = _embed_inputs(params, cfg, batch)
    cos, sin = L.rope_tables(cfg, pos, _rope_dim(cfg))
    x = _run_segments(params, cfg, x, cos, sin)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["labels"]`` (optionally
    masked by ``batch["loss_mask"]``) over the text positions: a VLM's
    patch prefix is not scored."""
    h = forward(params, cfg, batch)
    h = h[:, h.shape[1] - batch["tokens"].shape[1]:]
    key = "table" if cfg.tie_embeddings else "unembed"
    logits = L.unembed(_gathered(params["embedding"], cfg, None, key), cfg, h)
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


def _decode_layers(params, cfg: ModelConfig, x, cache, attend):
    """Run every layer of every segment for one decode step; ``attend``
    does one layer's attention against its own cache leaves (``{"k", "v"}``
    or, under MLA, ``{"c", "kr"}``, each layer ``l``'s slice), in place."""
    for i, seg in enumerate(segments_for(cfg)):
        c = cache[f"seg{i}"]
        for l, p in enumerate(params[f"seg{i}"]):
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            a = attend(p["attn"], h, {name: leaf[l] for name, leaf in c.items()})
            x = x + L.scale_as(x, cfg.residual_scale) * a
            x = _ffn_block(p, cfg, seg.kind, x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embedding"], cfg, x)[:, 0]


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int):
    """One token for every stream at the same position: tokens ``[B, 1]``
    -> ``(logits [B, vocab], cache)``; the cache is updated in place."""
    x = L.embed(params["embedding"], cfg, tokens)
    B = x.shape[0]
    p = _step_positions(cfg, torch.full((B, 1), pos, dtype=torch.int32, device=x.device))
    cos, sin = L.rope_tables(cfg, p, _rope_dim(cfg))
    if cfg.attn_kind == "mla":
        def attend(pa, h, cl):
            return L.mla_decode(pa, cfg, h, cl["c"], cl["kr"], pos, cos, sin)[0]
    else:
        def attend(pa, h, cl):
            return L.attention_decode(pa, cfg, h, cl["k"], cl["v"], pos, cos, sin)[0]
    return _decode_layers(params, cfg, x, cache, attend), cache


def decode_step_slots(params, cfg: ModelConfig, tokens, cache, positions):
    """One token per SLOT at per-slot positions (the continuous-batching
    step): tokens ``[B, 1]``, positions ``[B]`` -> ``(logits [B, vocab],
    cache)``.  With every position equal it gives :func:`decode_step`'s
    bits: the same embed, rope, cache write, mask and unembed."""
    x = L.embed(params["embedding"], cfg, tokens)
    positions = positions.to(device=x.device, dtype=torch.long)
    cos, sin = L.rope_tables(cfg, _step_positions(cfg, positions[:, None]), _rope_dim(cfg))
    if cfg.attn_kind == "mla":
        def attend(pa, h, cl):
            return L.mla_decode_slots(pa, cfg, h, cl["c"], cl["kr"], positions, cos, sin)[0]
    else:
        def attend(pa, h, cl):
            return L.attention_decode_slots(pa, cfg, h, cl["k"], cl["v"], positions, cos,
                                            sin)[0]
    return _decode_layers(params, cfg, x, cache, attend), cache


def prefill(params, cfg: ModelConfig, batch, capacity: int | None = None):
    """Process whole prompts: ``batch["tokens"] [B, S]`` (after
    ``batch["patches"] [B, P, d]`` for a VLM) -> ``(last-token logits [B,
    vocab], cache)`` with a cache of exactly ``P + S`` positions, whatever
    the engine's ``capacity`` (``serve.engine.grow_cache`` pads it).  GQA
    attends through :func:`layers.prefill_attention` (the kernel under
    ``attn_impl="flash"``)."""
    x, pos = _embed_inputs(params, cfg, batch)
    cos, sin = L.rope_tables(cfg, pos, _rope_dim(cfg))

    cache = {}
    for i, seg in enumerate(segments_for(cfg)):
        rows: dict[str, list] = {}
        for p in params[f"seg{i}"]:
            hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            if cfg.attn_kind == "mla":
                q_nope, q_rope, c, kr = L._mla_qk(p["attn"], cfg, hn, cos, sin)
                a = L._mla_attend(p["attn"], cfg, q_nope, q_rope, c, kr, causal=True)
                kept = {"c": c, "kr": kr}
            else:
                q, k, v = L.attention_qkv(p["attn"], cfg, hn)
                q, k = L.rotate_qk(cfg, q, k, cos, sin)
                a = L.attention_out(p["attn"], cfg, L.prefill_attention(cfg, q, k, v))
                kept = {"k": k, "v": v}
            x = x + L.scale_as(x, cfg.residual_scale) * a
            x = _ffn_block(p, cfg, seg.kind, x)
            for name, leaf in kept.items():
                rows.setdefault(name, []).append(leaf)
        cache[f"seg{i}"] = {name: torch.stack(leaves) for name, leaves in rows.items()}

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embedding"], cfg, x[:, -1:])
    return logits[:, 0], cache


__all__ = [
    "Segment",
    "segments_for",
    "init",
    "specs",
    "init_cache",
    "cache_specs",
    "forward",
    "train_loss",
    "decode_step",
    "decode_step_slots",
    "prefill",
]
