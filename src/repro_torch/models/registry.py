"""Uniform functional API over the port's models (port of ``repro.models.registry``).

``build(cfg)`` returns a :class:`ModelApi` whose members close over ``cfg``.
The port builds every family of the reference: the transformer families,
dense, MoE and VLM (:mod:`.transformer`: GQA or MLA attention, RoPE or
M-RoPE), the pure-SSM family (:mod:`.mamba2`), the hybrid family
(:mod:`.zamba2`) and the encoder-decoder family (:mod:`.whisper`).
``decode_step_slots`` is ``None`` for the SSM, hybrid and encoder-decoder
families, whose caches are not per-position KV maps, as in the reference.
``forward`` (the final-normed hidden states) is the port's addition.
``param_specs`` and ``cache_spec_fn()`` give every param and cache leaf's
logical axes (:mod:`repro_torch.distributed.sharding`) in the port's own
structure: a list entry a layer where the reference stacks layers.
:func:`param_count` counts the leaves of ``init(..., device="meta")``.  The
reference's input and shape specs for the dry-run have no counterpart yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..tree import leaves_with_paths

# Image-patch positions the VLM stub prepends (Qwen2-VL's dynamic resolution
# becomes a fixed budget; the vision frontend itself is out of scope).
VLM_PATCHES = 1024


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    # (seed, device="cuda") -> params; the transformer families also take
    # place= (see transformer.init)
    init: Callable[..., Any]
    forward: Callable[[Any, dict], torch.Tensor]  # -> hidden states [B, S, d]
    train_loss: Callable[[Any, dict], torch.Tensor]
    prefill: Callable[[Any, dict], tuple[torch.Tensor, Any]]
    decode_step: Callable[[Any, torch.Tensor, Any, int], tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]  # (batch_size, capacity, device="cuda") -> cache
    param_specs: Any  # tree of logical-axis tuples (matches init)
    cache_spec_fn: Callable[[], Any]
    # Per-slot decode (continuous batching): (params, tokens [B, 1], cache,
    # positions [B]) -> (logits, cache); None for the SSM, hybrid and
    # encoder-decoder families.
    decode_step_slots: Callable[[Any, torch.Tensor, Any, torch.Tensor], tuple[torch.Tensor, Any]] | None = None


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "ssm":
        from . import mamba2 as m
    elif cfg.family == "hybrid":
        from . import zamba2 as m
    elif cfg.family == "encdec":
        from . import whisper as m
    else:  # dense / moe / vlm share the transformer stack
        from . import transformer as m
    slots = getattr(m, "decode_step_slots", None)
    return ModelApi(
        cfg=cfg,
        init=lambda seed, device="cuda", **kw: m.init(seed, cfg, device=device, **kw),
        forward=lambda params, batch: m.forward(params, cfg, batch),
        train_loss=lambda params, batch: m.train_loss(params, cfg, batch),
        prefill=lambda params, batch: m.prefill(params, cfg, batch),
        decode_step=lambda params, tokens, cache, pos: m.decode_step(params, cfg, tokens, cache, pos),
        init_cache=lambda bs, cap, device="cuda": m.init_cache(cfg, bs, cap, device=device),
        param_specs=m.specs(cfg),
        cache_spec_fn=lambda: m.cache_specs(cfg),
        decode_step_slots=None if slots is None else (
            lambda params, tokens, cache, positions: slots(params, cfg, tokens, cache, positions)
        ),
    )


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """The model's parameters, counted on ``init(..., device="meta")`` (no
    memory).  With ``active_only`` an MoE layer's ``ffn`` matrices count
    ``top_k / num_experts`` of their size, as the reference counts them:
    per stacked leaf (every layer of a segment together, rounded down
    once), the shared experts' and a dense first layer's ``ffn`` included."""
    stacked: dict[tuple, int] = {}
    for path, leaf in leaves_with_paths(build(cfg).init(0, device="meta")):
        key = tuple(k for k in path if not isinstance(k, int))  # layers stack
        stacked[key] = stacked.get(key, 0) + leaf.numel()
    total = 0
    for key, n in stacked.items():
        if active_only and cfg.num_experts and "ffn" in key and \
                any(k in ("w_gate", "w_up", "w_down") for k in key):
            n = n * cfg.top_k // cfg.num_experts
        total += n
    return total


__all__ = ["ModelApi", "VLM_PATCHES", "build", "param_count"]
