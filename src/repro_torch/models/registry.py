"""Uniform functional API over the port's models (port of ``repro.models.registry``).

``build(cfg)`` returns a :class:`ModelApi` whose members close over ``cfg``.
The port builds the GQA transformer families, dense and MoE
(:mod:`.transformer`), the pure-SSM family (:mod:`.mamba2`) and the hybrid
family (:mod:`.zamba2`); the VLM and encoder-decoder families raise and name
the slice that brings them.  ``decode_step_slots`` is ``None`` for the SSM
and hybrid families, whose caches are not per-position KV maps, as in the
reference.  ``forward`` (the final-normed hidden states) is the port's
addition.  The reference's param specs and its input and shape specs for
the dry-run have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig

_LATER_SLICES = {
    "vlm": "the dense-model slice (ROADMAP A.12)",
    "encdec": "the Whisper slice (ROADMAP A.15)",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]  # (seed, device="cuda") -> params
    forward: Callable[[Any, dict], torch.Tensor]  # -> hidden states [B, S, d]
    train_loss: Callable[[Any, dict], torch.Tensor]
    prefill: Callable[[Any, dict], tuple[torch.Tensor, Any]]
    decode_step: Callable[[Any, torch.Tensor, Any, int], tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]  # (batch_size, capacity, device="cuda") -> cache
    # Per-slot decode (continuous batching): (params, tokens [B, 1], cache,
    # positions [B]) -> (logits, cache); None for the SSM and hybrid families.
    decode_step_slots: Callable[[Any, torch.Tensor, Any, torch.Tensor], tuple[torch.Tensor, Any]] | None = None


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family in _LATER_SLICES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with {_LATER_SLICES[cfg.family]}"
        )
    if cfg.family == "ssm":
        from . import mamba2 as m
    elif cfg.family == "hybrid":
        from . import zamba2 as m
    else:
        from . import transformer as m

        m.check_supported(cfg)
    slots = getattr(m, "decode_step_slots", None)
    return ModelApi(
        cfg=cfg,
        init=lambda seed, device="cuda": m.init(seed, cfg, device=device),
        forward=lambda params, batch: m.forward(params, cfg, batch),
        train_loss=lambda params, batch: m.train_loss(params, cfg, batch),
        prefill=lambda params, batch: m.prefill(params, cfg, batch),
        decode_step=lambda params, tokens, cache, pos: m.decode_step(params, cfg, tokens, cache, pos),
        init_cache=lambda bs, cap, device="cuda": m.init_cache(cfg, bs, cap, device=device),
        decode_step_slots=None if slots is None else (
            lambda params, tokens, cache, positions: slots(params, cfg, tokens, cache, positions)
        ),
    )


__all__ = ["ModelApi", "build"]
