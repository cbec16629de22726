"""The train step: microbatched gradient accumulation + AdamW (port of
``repro.train.step``).

``make_train_step(api, opt)`` returns ``step(state, batch) -> (state,
metrics)``.  PyTorch runs it eagerly; there is nothing to ``jit``.  The step
is functional: it returns a new :class:`TrainState` and leaves the old one
as it was, so one state can be stepped twice (with two configs, say) and
compared.  Its gradient half is :func:`make_grad_fn`.

What the step computes depends on the active mesh context:

* no mesh, or a mesh that lives in one process: the one copy of the params
  sees the whole batch, so the backward's own sum is the data-parallel
  reduction (under ``grad_sync="auto"``, the reference's lowered one);
* a mesh that spans processes (``mesh.num_processes = R > 1``): ``batch``
  is this process's contiguous slice of the global batch
  (:func:`local_rows`), and the step returns, on every process, the loss
  and gradient of the whole global batch, so every process takes the same
  AdamW update.  Under ``"auto"`` each process computes the gradient of its
  rows and one all-reduce a leaf crosses the processes
  (:func:`process_mean`);
* ``grad_sync="hierarchical"`` on a mesh with a pod axis, in one process or
  across several: the reference's explicit two-level sync on per-unit
  gradients.  Each of the process's units takes its contiguous share of the
  process's rows, the per-unit gradients are stacked ``[local_units, ...]``
  and summed by the multiplexer's ``psum_tree`` (reduce-scatter in memory,
  only each unit's reduced block over the pod hop, all-gather), then
  divided by the global unit count (:func:`unit_mean`).

Every form equals the no-mesh step on the global batch.  The reference's
explicit sync instead sums the gradient its ``jax.value_and_grad`` already
took over the whole global batch, replicated on every device, so its
``"hierarchical"`` gradient is the ``"auto"`` one times the number of
data-parallel devices: a deliberate difference (ROADMAP §C).  The mean over
slices weights each slice alike, as the microbatch loop does, which is the
global mean when every slice scores the same number of tokens (no
``loss_mask``).  The MoE family does not train over a mesh that spans
processes (its expert dispatch crosses them through ``torch.distributed``,
which autograd cannot differentiate): that is ROADMAP queue A item 3(b).

The reference's ``train_state_specs``, ``state_shardings`` and the
gradient pinning ``_pin`` lay the state out over a device mesh for ``jit``;
here every process holds the whole state (item 3(b) ports the sharding).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core import exchange
from ..core.exchange import POD_AXIS, Mesh
from ..core.multiplexer import make_multiplexer
from ..distributed.sharding import MeshContext, current_mesh_context
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


def _slices(batch: dict, num: int, what: str) -> list[dict]:
    """``num`` consecutive row slices of every batch entry."""
    B = next(iter(batch.values())).shape[0]
    if B % num:
        raise ValueError(f"batch {B} not divisible by {num} {what}")
    n = B // num
    return [{k: v[i * n : (i + 1) * n] for k, v in batch.items()} for i in range(num)]


def local_rows(batch: dict, mesh: Mesh) -> dict:
    """This process's contiguous slice of a global batch: rows
    ``[rank * B / R, (rank + 1) * B / R)`` on a mesh over ``R`` processes
    (the whole batch on a mesh in one process)."""
    return _slices(batch, mesh.num_processes, "processes")[mesh.process_index]


def process_mean(tree: Any, mesh: Mesh) -> Any:
    """The mean over the processes of a tree of tensors, in f32, on every
    process: one all-reduce a leaf over the pod axis of a one-unit-a-pod
    view of ``mesh``, so each process puts each leaf's bytes on the pod hop
    once."""
    R = mesh.num_processes
    view = Mesh(R, 1, R, mesh.process_index, mesh.group)
    total = exchange.flat_psum_tree(tree_map(lambda t: t.float()[None], tree), view, (POD_AXIS,))
    return tree_map(lambda t: t[0] / R, total)


def unit_mean(stacked: Any, mesh: Mesh) -> Any:
    """The mean over all ``mesh.num_units`` units of a tree of per-unit
    ``[local_units, ...]`` tensors, on every process: the multiplexer's
    two-level ``psum_tree`` (reduce-scatter in the pod, all-reduce of each
    unit's reduced ``1 / n`` block over the pod axis, all-gather in the pod),
    then row 0 over the unit count."""
    total = make_multiplexer(mesh).psum_tree(stacked, MeshContext(mesh).data_axes)
    return tree_map(lambda t: t[0] / mesh.num_units, total)


def make_grad_fn(api: registry.ModelApi) -> Callable[[Any, Any], tuple[torch.Tensor, Any]]:
    """Builds ``grad_fn(params, batch) -> (loss, grads)``, the gradient half
    of the train step under the active mesh context (see the module
    docstring): the mean loss and f32 gradients of the global batch, synced
    where the mesh asks for it.

    Microbatching: ``batch`` (on a mesh over processes, this process's
    rows; under the per-unit sync, each unit's) is split into
    ``cfg.num_microbatches`` row slices run one after another, gradients
    accumulated in f32.  With remat the live activation set is one
    microbatch x one layer.
    """
    cfg = api.cfg
    num_mb = max(cfg.num_microbatches, 1)

    def loss_and_grads(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = api.train_loss(live, mb)
        grads = torch.autograd.grad(loss, leaves(live))
        return loss.detach(), unflatten(params, grads)

    def rows_loss_and_grads(params, batch):
        if num_mb == 1:
            return loss_and_grads(params, batch)
        loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        for mb in _slices(batch, num_mb, "microbatches"):
            mb_loss, mb_grads = loss_and_grads(params, mb)
            grads = tree_map(lambda a, g: a + g.float(), grads, mb_grads)
            loss = loss + mb_loss
        return loss / num_mb, tree_map(lambda g: g / num_mb, grads)

    def per_unit(params, batch, mesh):
        S = mesh.local_units
        stacked = {"loss": torch.empty((S,), dtype=torch.float32, device=leaves(params)[0].device),
                   "grads": tree_map(lambda p: torch.empty((S,) + tuple(p.shape),
                                                           dtype=torch.float32, device=p.device),
                                     params)}
        for u, rows in enumerate(_slices(batch, S, "units")):
            loss, grads = rows_loss_and_grads(params, rows)
            stacked["loss"][u] = loss
            tree_map(lambda buf, g: buf[u].copy_(g), stacked["grads"], grads)
        mean = unit_mean(stacked, mesh)
        return mean["loss"], mean["grads"]

    def grad_fn(params, batch):
        ctx = current_mesh_context()
        mesh = ctx.mesh if ctx is not None else None
        spans = mesh is not None and mesh.num_processes > 1
        if spans and cfg.family == "moe":
            raise NotImplementedError(
                "training the MoE family over a mesh that spans processes (its expert "
                "dispatch crosses them through torch.distributed, which autograd cannot "
                "differentiate) is ROADMAP queue A item 3(b)"
            )
        if cfg.grad_sync == "hierarchical" and ctx is not None and ctx.pod_axis is not None:
            return per_unit(params, batch, mesh)
        loss, grads = rows_loss_and_grads(params, batch)
        if spans:
            mean = process_mean({"loss": loss, "grads": grads}, mesh)
            return mean["loss"], mean["grads"]
        return loss, grads

    return grad_fn


def make_train_step(
    api: registry.ModelApi,
    opt_cfg: AdamWConfig,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Builds ``step(state, batch) -> (state, metrics)``; ``metrics`` holds
    device scalars ``loss``, ``grad_norm`` (of the synced gradient, so the
    same on every process) and ``lr``.  The gradient comes from
    :func:`make_grad_fn`."""
    grad_fn = make_grad_fn(api)

    def step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        loss, grads = grad_fn(state.params, batch)
        new_params, new_opt, metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step


__all__ = ["TrainState", "make_train_step", "make_grad_fn", "local_rows", "process_mean",
           "unit_mean"]
