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
:func:`param_count` counts the leaves of ``init(..., device="meta")``.
:func:`input_specs`, :func:`cache_shape_specs` and :func:`param_shape_specs`
give the dry run (:mod:`repro_torch.launch.dryrun`) its arguments: trees of
``meta`` tensors, the port's stand-in for the reference's
``ShapeDtypeStruct``s, beside their logical axes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeSpec
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
    # (params, batch, capacity=None) -> (logits, cache); the hybrid family
    # writes its KV cache at capacity positions at once (see zamba2.prefill),
    # the others return it at the prompt's length for grow_cache
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode_step: Callable[[Any, torch.Tensor, Any, int], tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]  # (batch_size, capacity, device="cuda") -> cache
    param_specs: Any  # tree of logical-axis tuples (matches init)
    cache_spec_fn: Callable[[], Any]
    # Per-slot decode (continuous batching): (params, tokens [B, 1], cache,
    # positions [B]) -> (logits, cache); None for the SSM, hybrid and
    # encoder-decoder families.
    decode_step_slots: Callable[[Any, torch.Tensor, Any, torch.Tensor], tuple[torch.Tensor, Any]] | None = None
    # The tensor table's cut of a Mamba block, (width, ctx) -> indices or
    # None, for sharding.tensor_place / tensor_slices (mamba2.tensor_index);
    # None for the families without one.
    tensor_index: Callable[[int, Any], torch.Tensor | None] | None = None


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
    index = getattr(m, "tensor_index", None)
    return ModelApi(
        cfg=cfg,
        init=lambda seed, device="cuda", **kw: m.init(seed, cfg, device=device, **kw),
        forward=lambda params, batch: m.forward(params, cfg, batch),
        train_loss=lambda params, batch: m.train_loss(params, cfg, batch),
        prefill=lambda params, batch, capacity=None: m.prefill(params, cfg, batch,
                                                               capacity=capacity),
        decode_step=lambda params, tokens, cache, pos: m.decode_step(params, cfg, tokens, cache, pos),
        init_cache=lambda bs, cap, device="cuda": m.init_cache(cfg, bs, cap, device=device),
        param_specs=m.specs(cfg),
        cache_spec_fn=lambda: m.cache_specs(cfg),
        decode_step_slots=None if slots is None else (
            lambda params, tokens, cache, positions: slots(params, cfg, tokens, cache, positions)
        ),
        tensor_index=None if index is None else functools.partial(index, cfg),
    )


@functools.lru_cache(maxsize=16)
def whole_params(cfg: ModelConfig) -> Any:
    """Every param leaf drawn on ``meta``, in ``init``'s structure: the
    whole shapes, which a train state's shardings and a grid's FSDP gather
    resolve against."""
    return build(cfg).init(0, device="meta")


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


# ----------------------------------------------------------------------------
# Input specs (``meta`` tensors) per (arch x shape).
# ----------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    """(``meta`` tensors, logical axes) for the batch argument of the step."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            specs = {
                "frames": _meta((B, S, cfg.d_model), act),
                "tokens": _meta((B, S), i32),
            }
            axes = {
                "frames": ("batch", "seq", "d_model"),
                "tokens": ("batch", "seq"),
            }
        elif cfg.family == "vlm":
            P = min(VLM_PATCHES, S // 2)
            specs = {
                "tokens": _meta((B, S - P), i32),
                "patches": _meta((B, P, cfg.d_model), act),
            }
            axes = {
                "tokens": ("batch", "seq"),
                "patches": ("batch", "seq", "d_model"),
            }
        else:
            specs = {"tokens": _meta((B, S), i32)}
            axes = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            n_text = specs["tokens"].shape[1]
            specs["labels"] = _meta((B, n_text), i32)
            axes["labels"] = ("batch", "seq")
        return specs, axes

    # decode: one new token per stream against a cache of length S
    specs = {"tokens": _meta((B, 1), i32)}
    axes = {"tokens": ("batch", None)}
    return specs, axes


def cache_shape_specs(cfg: ModelConfig, shape: ShapeSpec) -> tuple[Any, Any]:
    """(``meta`` tree, logical axes tree) for the decode cache."""
    api = build(cfg)
    return api.init_cache(shape.global_batch, shape.seq_len, device="meta"), api.cache_spec_fn()


def param_shape_specs(cfg: ModelConfig) -> tuple[Any, Any]:
    """(``meta`` tree, logical axes tree) for the params, in the port's
    list-a-layer structure."""
    api = build(cfg)
    return api.init(0, device="meta"), api.param_specs


__all__ = ["ModelApi", "VLM_PATCHES", "build", "param_count",
           "input_specs", "cache_shape_specs", "param_shape_specs"]
