"""The train step: microbatched gradient accumulation + AdamW (port of
``repro.train.step``).

``make_train_step(api, opt)`` returns ``step(state, batch) -> (state,
metrics)``.  PyTorch runs it eagerly; there is nothing to ``jit``.  The step
is functional: it returns a new :class:`TrainState` and leaves the old one
as it was, so one state can be stepped twice (with two configs, say) and
compared.

The reference's ``train_state_specs``, ``state_shardings`` and the
gradient pinning ``_pin`` lay the state out over a device mesh for ``jit``;
on one device they have no counterpart.  Its explicit two-level gradient
sync (``grad_sync="hierarchical"`` on a mesh with a pod axis) needs the
psum trees of ROADMAP A.5 and raises until they land.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..distributed.sharding import current_mesh_context
from ..models import registry
from ..tree import leaves, tree_map, unflatten
from .optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor  # int32 scalar, on the params' device

    @staticmethod
    def create(api: registry.ModelApi, seed: int, device="cuda") -> "TrainState":
        params = api.init(seed, device=device)
        return TrainState.from_params(params)

    @staticmethod
    def from_params(params: Any) -> "TrainState":
        """Step 0 with fresh optimizer state around given params."""
        opt = adamw_init(params)
        return TrainState(params=params, opt=opt, step=torch.zeros_like(opt["count"]))


def _microbatches(batch: dict, num: int) -> list[dict]:
    """``num`` consecutive row slices of every batch entry."""
    B = next(iter(batch.values())).shape[0]
    if B % num:
        raise ValueError(f"batch {B} not divisible by {num} microbatches")
    n = B // num
    return [{k: v[i * n : (i + 1) * n] for k, v in batch.items()} for i in range(num)]


def make_train_step(
    api: registry.ModelApi,
    opt_cfg: AdamWConfig,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Builds ``step(state, batch) -> (state, metrics)``; ``metrics`` holds
    device scalars ``loss``, ``grad_norm`` and ``lr``.

    Microbatching: the batch is split into ``cfg.num_microbatches`` row
    slices run one after another, gradients accumulated in f32.  With remat
    the live activation set is one microbatch x one layer.
    """
    cfg = api.cfg
    num_mb = max(cfg.num_microbatches, 1)

    def loss_and_grads(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = api.train_loss(live, mb)
        grads = torch.autograd.grad(loss, leaves(live))
        return loss.detach(), unflatten(params, grads)

    def step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        if cfg.grad_sync == "hierarchical":
            ctx = current_mesh_context()
            if ctx is not None and ctx.pod_axis is not None:
                raise NotImplementedError(
                    "grad_sync='hierarchical' over a pod axis needs the psum trees "
                    "(hierarchical_psum_tree), which come with ROADMAP A.5"
                )
        if num_mb == 1:
            loss, grads = loss_and_grads(state.params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                             state.params)
            for mb in _microbatches(batch, num_mb):
                mb_loss, mb_grads = loss_and_grads(state.params, mb)
                grads = tree_map(lambda a, g: a + g.float(), grads, mb_grads)
                loss = loss + mb_loss
            loss = loss / num_mb
            grads = tree_map(lambda g: g / num_mb, grads)

        new_params, new_opt, metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step


__all__ = ["TrainState", "make_train_step"]
