"""Zamba2-style hybrid: a Mamba2 backbone with a *shared* attention block
(port of ``repro.models.zamba2``).

The config (81 layers, d_model 3584, 32 heads, d_ff 14336, ssm_state 64) is
13 groups of ``attn_every=6`` Mamba2 layers, each group followed by ONE
shared transformer block (its weights reused by all 13 invocations), plus a
3-layer Mamba2 tail (13 * 6 + 3 = 81).  Every Mamba2 layer of a prefill or a
training step runs the ``ssd_scan`` kernel on the card.

As in the reference, the real Zamba2's concatenation of the original
embedding at each shared-block invocation and its per-invocation LoRA
deltas are left out: the shared block acts on the residual stream.

Params: ``groups`` is a list of ``ng`` lists of ``gs`` per-layer dicts,
``tail`` a list, ``shared`` one block.  The cache keeps the reference's
layout: ``groups`` ``{"ssm": [ng, gs, B, H, P, N], "conv": [ng, gs, B, K-1,
ch]}``, ``attn`` ``{"k", "v": [ng, B, S, kh, hd]}`` and ``tail``; decode
writes it in place.

Under the tensor table each Mamba2 layer splits by SSM heads
(:mod:`.mamba2`) and the shared block by attention heads, ``d_ff`` and
vocab as a transformer layer does (:mod:`.layers`); the cache holds the
process's SSM heads, conv channels and kv heads.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import mamba2 as MB
from .transformer import _maybe_remat


def layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(num_groups, group_size, tail) with groups * size + tail = num_layers."""
    g = cfg.attn_every
    return cfg.num_layers // g, g, cfg.num_layers % g


def init(seed: int, cfg: ModelConfig, device="cuda", place=None) -> Any:
    """Random params from ``seed`` on ``device``, with the reference's
    distributions; on ``"meta"``, shapes only.  The embedding, each Mamba2
    layer and the shared block go through ``place(path, sub) -> sub`` as
    they are drawn (paths ``("embedding",)``, ``("groups", g, l)``,
    ``("shared",)``, ``("tail", l)``), as in
    :func:`repro_torch.models.transformer.init`."""
    keep = place or (lambda path, sub: sub)
    ng, gs, tail = layout(cfg)
    gen = L.make_generator(seed, device)
    dt = L.pdtype(cfg)
    p = {
        "embedding": keep(("embedding",), L.init_embedding(gen, cfg)),
        "groups": [[keep(("groups", g, l), MB.init_layer(gen, cfg)) for l in range(gs)]
                   for g in range(ng)],
        "shared": keep(("shared",), {
            "ln1": L.init_rmsnorm(cfg.d_model, dt, gen.device),
            "attn": L.init_attention(gen, cfg),
            "ln2": L.init_rmsnorm(cfg.d_model, dt, gen.device),
            "mlp": L.init_mlp(gen, cfg),
        }),
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, gen.device),
    }
    if tail:
        p["tail"] = [keep(("tail", l), MB.init_layer(gen, cfg)) for l in range(tail)]
    return p


def specs(cfg: ModelConfig) -> Any:
    ng, gs, tail = layout(cfg)
    s = {
        "embedding": L.specs_embedding(cfg),
        "groups": [[MB.specs_layer(cfg) for _ in range(gs)] for _ in range(ng)],
        "shared": {
            "ln1": L.specs_rmsnorm(),
            "attn": L.specs_attention(cfg),
            "ln2": L.specs_rmsnorm(),
            "mlp": L.specs_mlp(cfg),
        },
        "final_norm": L.specs_rmsnorm(),
    }
    if tail:
        s["tail"] = [MB.specs_layer(cfg) for _ in range(tail)]
    return s


def _mlp_residual(shared, cfg: ModelConfig, x):
    return x + L.mlp_block(shared["mlp"], cfg, L.rmsnorm(shared["ln2"], x, cfg.norm_eps))


def _shared_block(p, cfg: ModelConfig, x, cos, sin):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(p["attn"], cfg, h, cos, sin, causal=True)
    return _mlp_residual(p, cfg, x)


def _rope(cfg: ModelConfig, x: torch.Tensor):
    B, S = x.shape[0], x.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].repeat(B, 1)
    return L.rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)


def forward(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence forward -> final-normed hidden states ``[B, S, d]``."""
    x = L.embed(params["embedding"], cfg, batch["tokens"])
    cos, sin = _rope(cfg, x)

    def group_body(x, group):
        for p in group:
            x = MB.layer_fwd(p, cfg, x)
        return _shared_block(params["shared"], cfg, x, cos, sin)

    group_body = _maybe_remat(group_body, cfg)
    for group in params["groups"]:
        x = group_body(x, group)
    tail_body = _maybe_remat(lambda x, p: MB.layer_fwd(p, cfg, x), cfg)
    for p in params.get("tail", []):
        x = tail_body(x, p)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    logits = L.unembed(params["embedding"], cfg, forward(params, cfg, batch))
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int, dtype=None,
               device="cuda") -> Any:
    """Hybrid cache: O(1) Mamba2 states and one KV cache per shared-block
    invocation; under the tensor table of the process's SSM heads, conv
    channels and kv heads (:func:`layers.local_kv_heads`)."""
    dtype = dtype or L.cdtype(cfg)
    ng, gs, tail = layout(cfg)
    kh, hd = L.local_kv_heads(cfg), cfg.resolved_head_dim
    groups = MB.mamba_state(cfg, ng * gs, batch_size, dtype, device)
    kv = (ng, batch_size, capacity, kh, hd)
    cache = {
        "groups": {k: v.reshape((ng, gs) + v.shape[1:]) for k, v in groups.items()},
        "attn": {"k": torch.zeros(kv, dtype=dtype, device=device),
                 "v": torch.zeros(kv, dtype=dtype, device=device)},
    }
    if tail:
        cache["tail"] = MB.mamba_state(cfg, tail, batch_size, dtype, device)
    return cache


def cache_specs(cfg: ModelConfig) -> Any:
    _ng, _gs, tail = layout(cfg)
    s = {
        "groups": {
            "ssm": (None, None, "batch", "ssm_heads", None, None),
            "conv": (None, None, "batch", None, "conv_dim"),
        },
        "attn": {
            "k": (None, "batch", "kv_seq", None, None),
            "v": (None, "batch", "kv_seq", None, None),
        },
    }
    if tail:
        s["tail"] = MB.cache_specs(cfg)
    return s


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int):
    """One token for every stream at the same position: tokens ``[B, 1]`` ->
    ``(logits [B, vocab], cache)``; the cache is updated in place."""
    x = L.embed(params["embedding"], cfg, tokens)
    B = x.shape[0]
    p_ids = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = L.rope_angles(p_ids, cfg.resolved_head_dim, cfg.rope_theta)
    shared = params["shared"]
    gc, kv = cache["groups"], cache["attn"]
    for gi, group in enumerate(params["groups"]):
        for li, p in enumerate(group):
            x = MB.layer_step(p, cfg, x, gc["ssm"][gi, li], gc["conv"][gi, li])
        h = L.rmsnorm(shared["ln1"], x, cfg.norm_eps)
        a, _, _ = L.attention_decode(shared["attn"], cfg, h, kv["k"][gi], kv["v"][gi], pos,
                                     cos, sin)
        x = _mlp_residual(shared, cfg, x + a)
    for l, p in enumerate(params.get("tail", [])):
        x = MB.layer_step(p, cfg, x, cache["tail"]["ssm"][l], cache["tail"]["conv"][l])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embedding"], cfg, x)[:, 0], cache


def _stack_states(states: list[dict]) -> dict:
    return {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}


def prefill(params, cfg: ModelConfig, batch, capacity: int | None = None):
    """Process whole prompts ``[B, S]``: ``(last-token logits [B, vocab],
    cache)`` with a KV cache of ``capacity`` positions (default ``S``), each
    group's k/v written into it as the group is done, so the cache is
    allocated once (the positions past ``S`` zero: the reference's stacked
    cache grown by the engine, bit for bit).  The shared block attends
    through :func:`~repro_torch.models.layers.prefill_attention`: the kernel
    under ``attn_impl="flash"`` (head_dim 112 padded to 128), ``sdpa``
    otherwise, where the reference's prefill runs ``sdpa`` whatever
    ``attn_impl`` says."""
    x = L.embed(params["embedding"], cfg, batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    capacity = capacity or S
    if capacity < S:
        raise ValueError(f"a KV cache of {capacity} positions cannot hold a {S}-token prompt")
    cos, sin = _rope(cfg, x)
    shared = params["shared"]
    ng, _, _ = layout(cfg)
    kv = {name: torch.zeros((ng, B, capacity, L.local_kv_heads(cfg), cfg.resolved_head_dim),
                            dtype=x.dtype, device=x.device) for name in ("k", "v")}
    group_states = []
    for gi, group in enumerate(params["groups"]):
        states = []
        for p in group:
            x, st = MB.layer_prefill(p, cfg, x)
            states.append(st)
        group_states.append(_stack_states(states))
        h = L.rmsnorm(shared["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(shared["attn"], cfg, h)
        del h
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
        kv["k"][gi, :, :S] = k
        kv["v"][gi, :, :S] = v
        a = L.prefill_attention(cfg, q, k, v)
        del q, k, v
        x = x + L.attention_out(shared["attn"], cfg, a)
        del a
        x = _mlp_residual(shared, cfg, x)
    cache = {"groups": _stack_states(group_states), "attn": kv}
    tail_states = []
    for p in params.get("tail", []):
        x, st = MB.layer_prefill(p, cfg, x)
        tail_states.append(st)
    if tail_states:
        cache["tail"] = _stack_states(tail_states)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embedding"], cfg, x[:, -1:])
    return logits[:, 0], cache


# the tensor table's cut of the Mamba2 layers (``ModelApi.tensor_index``)
tensor_index = MB.tensor_index

__all__ = ["layout", "init", "specs", "forward", "train_loss", "init_cache", "cache_specs",
           "decode_step", "prefill", "tensor_index"]
