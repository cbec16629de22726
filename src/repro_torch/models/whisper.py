"""Whisper-medium backbone: a transformer encoder-decoder with cross-attention
(port of ``repro.models.whisper``).

The conv/mel frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``frames [B, S, d_model]`` (what the two conv
layers would produce).  Sinusoidal positions are added to both streams (the
reference's unbounded form, not Whisper's learned decoder positions);
LayerNorm and a GELU MLP, as in the original.

The reference stacks each stack's layers and scans over them; here
``encoder`` and ``decoder`` are lists of per-layer param dicts and the scan
is a loop.  The cache keeps the reference's stacked layout (``self_k``,
``self_v``, ``cross_k``, ``cross_v``, each ``[L, B, S, KH, Dh]``), so it
compares with the reference's leaf for leaf; :func:`decode_step` writes
layer ``l``'s slice of the self-attention cache in place.

The encoder's self-attention is :func:`~.layers.attention_block` with
``causal=False``, so ``cfg.attn_impl`` picks its core (``"flash"``: the CUDA
kernel's non-causal branch).  Cross-attention is plain :func:`~.layers.sdpa`
with no length mask, as in the reference: a cross cache grown with zero rows
(the static engine grows every leaf to its capacity) is attended over in
full.  With ``cfg.remat`` other than ``"none"`` each layer of
:func:`encode` and :func:`decode_train` runs under
``torch.utils.checkpoint``.  There is no per-slot decode: the reference has
none, so the continuous engine refuses this family.

Under the tensor table (:func:`~repro_torch.distributed.sharding.tensor_rules`)
every leaf takes the dense specs: the encoder's self-attention, the
decoder's self- and cross-attention and both GELU MLPs split like a dense
layer (q/k/v column-parallel, ``wo`` and ``w_out`` row-parallel, ``b_out``
added after the all-reduce), the cross K/V are the process's kv heads, and
so are the cache's (:func:`init_cache`); the encoder's attention kernel runs
on the process's heads.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .transformer import _maybe_remat


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Classic transformer sinusoids: int ``[B, S]`` -> ``[B, S, d]`` f32,
    with the reference's ``/(half - 1)`` in the frequency exponent."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / (half - 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :].repeat(B, 1)


# ----------------------------------------------------------------------------
# Params.
# ----------------------------------------------------------------------------

def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Any:
    dt = L.pdtype(cfg)
    return {
        "ln1": L.init_layernorm(cfg.d_model, dt, gen.device),
        "attn": L.init_attention(gen, cfg),
        "ln2": L.init_layernorm(cfg.d_model, dt, gen.device),
        "mlp": L.init_mlp(gen, cfg),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Any:
    dt = L.pdtype(cfg)
    return {
        "ln1": L.init_layernorm(cfg.d_model, dt, gen.device),
        "self_attn": L.init_attention(gen, cfg),
        "ln2": L.init_layernorm(cfg.d_model, dt, gen.device),
        "cross_attn": L.init_attention(gen, cfg),
        "ln3": L.init_layernorm(cfg.d_model, dt, gen.device),
        "mlp": L.init_mlp(gen, cfg),
    }


def _enc_layer_specs(cfg: ModelConfig) -> Any:
    return {
        "ln1": L.specs_layernorm(),
        "attn": L.specs_attention(cfg),
        "ln2": L.specs_layernorm(),
        "mlp": L.specs_mlp(cfg),
    }


def _dec_layer_specs(cfg: ModelConfig) -> Any:
    return {
        "ln1": L.specs_layernorm(),
        "self_attn": L.specs_attention(cfg),
        "ln2": L.specs_layernorm(),
        "cross_attn": L.specs_attention(cfg),
        "ln3": L.specs_layernorm(),
        "mlp": L.specs_mlp(cfg),
    }


def init(seed: int, cfg: ModelConfig, device="cuda", place=None) -> Any:
    """Random params from ``seed`` on ``device``, with the reference's
    distributions (its numbers come only through
    :mod:`repro_torch.models.convert`); on ``"meta"``, shapes only.  The
    embedding and each layer go through ``place(path, sub) -> sub`` as they
    are drawn (paths ``("embedding",)``, ``("encoder", l)`` and
    ``("decoder", l)``), as :func:`~.transformer.init`'s do: a
    tensor-parallel process keeps its slices
    (:func:`~repro_torch.distributed.sharding.tensor_place`)."""
    keep = place or (lambda path, sub: sub)
    gen = L.make_generator(seed, device)
    dt = L.pdtype(cfg)
    return {
        "embedding": keep(("embedding",), L.init_embedding(gen, cfg)),
        "encoder": [keep(("encoder", l), _enc_layer_init(gen, cfg))
                    for l in range(cfg.encoder_layers)],
        "enc_norm": L.init_layernorm(cfg.d_model, dt, gen.device),
        "decoder": [keep(("decoder", l), _dec_layer_init(gen, cfg))
                    for l in range(cfg.num_layers)],
        "dec_norm": L.init_layernorm(cfg.d_model, dt, gen.device),
    }


def specs(cfg: ModelConfig) -> Any:
    return {
        "embedding": L.specs_embedding(cfg),
        "encoder": [_enc_layer_specs(cfg) for _ in range(cfg.encoder_layers)],
        "enc_norm": L.specs_layernorm(),
        "decoder": [_dec_layer_specs(cfg) for _ in range(cfg.num_layers)],
        "dec_norm": L.specs_layernorm(),
    }


# ----------------------------------------------------------------------------
# Encoder.
# ----------------------------------------------------------------------------

def _enc_layer(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.layernorm(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(p["attn"], cfg, h, None, None, causal=False)
    h = L.layernorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], cfg, h)


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames ``[B, S, d_model]`` (the stub frontend's output) -> memory
    ``[B, S, d_model]`` in the compute dtype."""
    B, S, _ = frames.shape
    dt = L.cdtype(cfg)
    x = frames.to(dt) + sinusoidal(_positions(B, S, frames.device), cfg.d_model).to(dt)
    body = _maybe_remat(lambda h, p: _enc_layer(p, cfg, h), cfg)
    for p in params["encoder"]:
        x = body(x, p)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


# ----------------------------------------------------------------------------
# Decoder.
# ----------------------------------------------------------------------------

def _cross_attend(p, cfg: ModelConfig, h, mem_k, mem_v) -> torch.Tensor:
    q = L._project(h, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
    return L.attention_out(p, cfg, L.sdpa(q, mem_k, mem_v, causal=False))


def _memory_kv(p, cfg: ModelConfig, memory):
    """The cross-attention keys and values of the encoder's ``memory``;
    under the tensor table of the kv heads this process's query heads read
    (:func:`~.layers.kv_heads_read`), as :func:`~.layers.attention_qkv`
    cuts them."""
    k, v = L._project(memory, p["wk"]), L._project(memory, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(memory.dtype)
        v = v + p["bv"].to(memory.dtype)
    read = L.kv_heads_read(cfg)
    if read is not None:
        k, v = k[:, :, read], v[:, :, read]
    return k, v


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor, positions: torch.Tensor):
    x = L.embed(params["embedding"], cfg, tokens)
    return x + sinusoidal(positions, cfg.d_model).to(x.dtype)


def _dec_layer(p, cfg: ModelConfig, x, memory):
    h = L.layernorm(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(p["self_attn"], cfg, h, None, None, causal=True)
    h = L.layernorm(p["ln2"], x, cfg.norm_eps)
    mk, mv = _memory_kv(p["cross_attn"], cfg, memory)
    x = x + _cross_attend(p["cross_attn"], cfg, h, mk, mv)
    h = L.layernorm(p["ln3"], x, cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], cfg, h)


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder over ``memory`` -> final-normed hidden states
    ``[B, S, d]``; its self-attention core is ``cfg.attn_impl``'s, causal."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, _positions(B, S, tokens.device))
    body = _maybe_remat(lambda h, m, p: _dec_layer(p, cfg, h, m), cfg)
    for p in params["decoder"]:
        x = body(x, memory, p)
    return L.layernorm(params["dec_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The decoder's hidden states over the encoded frames."""
    return decode_train(params, cfg, batch["tokens"], encode(params, cfg, batch["frames"]))


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    h = forward(params, cfg, batch)
    logits = L.unembed(params["embedding"], cfg, h)
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


# ----------------------------------------------------------------------------
# Serving.
# ----------------------------------------------------------------------------

CACHE_KEYS = ("self_k", "self_v", "cross_k", "cross_v")


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int, dtype=None,
               device="cuda") -> Any:
    """Self-attention KV per decoder layer and the cross KV (filled at
    prefill), each ``[L, B, capacity, KH, Dh]``; under the tensor table
    ``KH`` is the kv heads this process attends with
    (:func:`~.layers.local_kv_heads`), as in :func:`~.transformer.init_cache`."""
    dtype = dtype or L.cdtype(cfg)
    shape = (cfg.num_layers, batch_size, capacity, L.local_kv_heads(cfg),
             cfg.resolved_head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device) for name in CACHE_KEYS}


def cache_specs(cfg: ModelConfig) -> Any:
    """The reference's letter for letter; the tensor table places the
    cache by its kv heads instead (:func:`init_cache`)."""
    del cfg
    kv = (None, "batch", "kv_seq", None, None)
    return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv}


def prefill(params, cfg: ModelConfig, batch, capacity: int | None = None):
    """Encode ``batch["frames"]`` and run the decoder over the prompt
    ``batch["tokens"] [B, S]`` -> ``(last-token logits [B, vocab], cache)``:
    the self KV of ``S`` positions, whatever the engine's ``capacity``
    (``serve.engine.grow_cache`` pads it), and the cross KV of the frames'
    length.
    The decoder's self-attention is plain :func:`~.layers.sdpa`, as the
    reference's."""
    memory = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, _positions(B, S, tokens.device))
    rows: dict[str, list] = {name: [] for name in CACHE_KEYS}
    for p in params["decoder"]:
        h = L.layernorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(p["self_attn"], cfg, h)
        x = x + L.attention_out(p["self_attn"], cfg, L.sdpa(q, k, v, causal=True))
        h = L.layernorm(p["ln2"], x, cfg.norm_eps)
        mk, mv = _memory_kv(p["cross_attn"], cfg, memory)
        x = x + _cross_attend(p["cross_attn"], cfg, h, mk, mv)
        h = L.layernorm(p["ln3"], x, cfg.norm_eps)
        x = x + L.mlp_block(p["mlp"], cfg, h)
        for name, leaf in zip(CACHE_KEYS, (k, v, mk, mv)):
            rows[name].append(leaf)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embedding"], cfg, x[:, -1:])
    return logits[:, 0], {name: torch.stack(leaves) for name, leaves in rows.items()}


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int):
    """One token for every stream at position ``pos``: tokens ``[B, 1]`` ->
    ``(logits [B, vocab], cache)``; the self-attention cache is updated in
    place, the cross cache read in full."""
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens,
               torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device))
    for l, p in enumerate(params["decoder"]):
        h = L.layernorm(p["ln1"], x, cfg.norm_eps)
        a, _, _ = L.attention_decode(p["self_attn"], cfg, h, cache["self_k"][l],
                                     cache["self_v"][l], pos, None, None)
        x = x + a
        h = L.layernorm(p["ln2"], x, cfg.norm_eps)
        x = x + _cross_attend(p["cross_attn"], cfg, h, cache["cross_k"][l], cache["cross_v"][l])
        h = L.layernorm(p["ln3"], x, cfg.norm_eps)
        x = x + L.mlp_block(p["mlp"], cfg, h)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return L.unembed(params["embedding"], cfg, x)[:, 0], cache


__all__ = [
    "sinusoidal", "init", "specs", "encode", "decode_train", "forward", "train_loss",
    "init_cache", "cache_specs", "prefill", "decode_step",
]
