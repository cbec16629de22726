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
``loss_mask``).

**Sharded state.**  :func:`train_state_specs` is the reference's tree of
logical axes over the state; :func:`state_shardings` resolves it with the
context's rules (the port's :func:`~repro_torch.distributed.sharding.
unit_rules` put the experts dim of the MoE weights over the joint unit
axis) into the :class:`Shard` each process holds, on a mesh that spans
processes.  ``TrainState.create(..., shardings=...)`` then draws the state
layer by layer and keeps only this process's experts (in params, ``m`` and
``v``).  The MoE family trains across processes under ``"auto"``: the
step feeds the expert-parallel layer this process's rows (the context's
``moe_tokens="local"``), the pod hop's backward brings every process's
tokens' gradient to the experts' owner, so an expert leaf's gradient is
divided by ``R`` and never all-reduced, the replicated leaves take
:func:`process_mean`, and the clipping norm adds every process's expert
shards through one scalar all-reduce, so every process clips alike and the
replicated params stay bit-identical.  ``"hierarchical"`` with the MoE
family across processes raises: the per-unit passes cannot run the
expert-parallel layer unit by unit (ROADMAP §C).  The reference's gradient
pinning ``_pin`` places gradients for ``jit``; it has no counterpart.

**The tensor table and the ``data x model`` grid** (the dense family; the
others refuse, :func:`refuse_tensor_table`).  Under the tensor table every
process of the model row sees the whole batch and holds its slices of the
heads, ``d_ff`` and vocab dims; the layers' collectives carry the backward
(:mod:`repro_torch.models.layers`), so each leaf's gradient is complete
where it is held and nothing is synced.  On a grid (the reference's
``default_rules(False)``: those names over the model row, every ``fsdp``
dim and the batch over the data column) each data column takes its rows of
the global batch, and the sync is:

* a leaf split over the data column: its gradient was reduce-scattered
  over the column in the backward (the FSDP gather's rule), so it is
  divided by ``D``;
* a leaf whole over the column: the mean over the column
  (:func:`process_mean` on the column, not over every process);
* over the model row nothing: a split leaf's gradient is the process's
  own, a replicated one the same on every process of the row.

The clipping norm counts each piece of each leaf once over the grid: the
process with index 0 along every axis a leaf is replicated over adds its
squares, and one scalar all-reduce over every process sums them
(:func:`grid_pieces`).  A leaf split over both axes is held as a
:class:`Shard` of two dims (``also``), and the checkpoint saves and
assembles along both; each piece is written once, by that same process
(:func:`state_owners`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from ..core import exchange
from ..core.exchange import POD_AXIS, Mesh, live_processes
from ..core.multiplexer import make_multiplexer
from ..distributed.sharding import (
    MeshContext,
    _axes,
    _slices,
    build_shardings,
    current_mesh_context,
    local_rows,
    mesh_context,
)
from ..models import registry
from ..obs import cost
from ..tree import leaves, tree_map, unflatten
from .optim import AdamWConfig, adamw_init, adamw_update


class Shard(NamedTuple):
    """The part of a leaf one process holds: rows ``[start, stop)`` of its
    dim ``dim``, whose whole size is ``size``; ``also``, the same for each
    further dim it is split along (a leaf split over both axes of a ``data
    x model`` grid), in dim order."""

    dim: int
    start: int
    stop: int
    size: int
    also: tuple = ()

    def dims(self) -> tuple["Shard", ...]:
        """Every split dim as a one-dim :class:`Shard`, in dim order."""
        return (self._replace(also=()),) + tuple(self.also)


def _keep(t: torch.Tensor, held: Shard | None) -> torch.Tensor:
    """``t``'s held rows as a tensor of their own (the rest freed), or ``t``
    when it is whole on this process or already the slice; along every dim
    ``held`` names, each cut where ``t`` is still whole along it."""
    if held is None:
        return t
    cut = t
    for h in held.dims():
        if cut.shape[h.dim] == h.size:
            cut = cut.narrow(h.dim, h.start, h.stop - h.start)
    return t if cut is t else cut.clone()


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor  # int32 scalar, on the params' device

    @staticmethod
    def create(api: registry.ModelApi, seed: int, device="cuda",
               shardings: "TrainState | None" = None) -> "TrainState":
        """Step 0 from ``seed``.  With ``shardings`` (:func:`state_shardings`)
        every leaf keeps only the rows this process holds: each layer is
        drawn whole from the seed and cut as it is drawn, so the peak is one
        layer, and the result equals the whole state sliced.  Only the
        transformer families' init takes that cut (the MoE family's experts
        are the only leaves the rules split)."""
        if shardings is None or all(h is None for h in leaves(shardings.params)):
            return TrainState.from_params(api.init(seed, device=device))
        held = shardings.params

        def place(path, layer):
            sub = held
            for key in path:
                sub = sub[key]
            return tree_map(_keep, layer, sub)

        params = tree_map(_keep, api.init(seed, device=device, place=place), held)
        return TrainState.from_params(params)

    @staticmethod
    def from_params(params: Any) -> "TrainState":
        """Step 0 with fresh optimizer state around given params."""
        opt = adamw_init(params)
        return TrainState(params=params, opt=opt, step=torch.zeros_like(opt["count"]))


def process_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the processes of one tensor, on every process: one
    all-reduce over the pod axis of a one-unit-a-pod view of ``mesh``, so
    each process puts the tensor's bytes on the pod hop once."""
    R = mesh.num_processes
    view = Mesh(R, 1, R, mesh.process_index, mesh.group, mesh.label)
    return exchange.psum(t[None], view, POD_AXIS)[0]


def process_mean(tree: Any, mesh: Mesh) -> Any:
    """The mean over the processes of a tree of tensors, in f32, on every
    process: :func:`process_sum` a leaf."""
    return tree_map(lambda t: process_sum(t.float(), mesh) / mesh.num_processes, tree)


def unit_mean(stacked: Any, mesh: Mesh) -> Any:
    """The mean over all ``mesh.num_units`` units of a tree of per-unit
    ``[local_units, ...]`` tensors, on every process: the multiplexer's
    two-level ``psum_tree`` (reduce-scatter in the pod, all-reduce of each
    unit's reduced ``1 / n`` block over the pod axis, all-gather in the pod),
    then row 0 over the unit count."""
    total = make_multiplexer(mesh).psum_tree(stacked, MeshContext(mesh).data_axes)
    return tree_map(lambda t: t[0] / mesh.num_units, total)


def train_state_specs(api: registry.ModelApi) -> TrainState:
    """The logical-axis tree of a :class:`TrainState` (for its shardings and
    checkpoints)."""
    p = api.param_specs
    return TrainState(params=p, opt={"m": p, "v": p, "count": ()}, step=())


@functools.lru_cache(maxsize=16)
def _state_shapes(cfg) -> TrainState:
    """A state of ``meta`` tensors: every leaf's whole shape."""
    return TrainState.from_params(registry.whole_params(cfg))


def _held(shape: tuple, spec: tuple, mesh: Mesh) -> Shard | None:
    """The rows of a leaf of ``shape``, resolved to ``spec``, that this
    process holds; ``None`` when no dim is split over the processes.  The
    units along a dim's mesh axes run in mesh order, so a process's units
    (whole pods) hold one contiguous run of rows."""
    Lp = mesh.pods_per_process
    for dim, axes in enumerate(spec):
        axes = (axes,) if isinstance(axes, str) else (axes or ())
        if POD_AXIS not in axes:
            continue
        lo, hi, k = 0, 1, 1
        for a in axes:
            n = mesh.size(a)
            a_lo, a_hi = ((mesh.process_index * Lp, (mesh.process_index + 1) * Lp)
                          if a == POD_AXIS else (0, n))
            if hi - lo > 1 and (a_lo, a_hi) != (0, n):
                raise ValueError(f"spec {spec}: this process's units are not one run of rows")
            lo, hi, k = lo * n + a_lo, (hi - 1) * n + a_hi, k * n
        rows = shape[dim] // k
        return Shard(dim, lo * rows, hi * rows, shape[dim])
    return None


def _grid_held(shape: tuple, spec: tuple, ctx: MeshContext) -> Shard | None:
    """The part of a leaf of ``shape``, resolved to ``spec``, that this
    process of a grid holds: along each dim on a grid axis, its run of that
    axis's equal runs; ``None`` when no dim is split."""
    coords = {"model": (ctx.mesh.num_processes, ctx.mesh.process_index),
              "data": (ctx.data.num_processes, ctx.data.process_index)}
    parts = []
    for dim, axes in enumerate(spec):
        on = [a for a in _axes(axes) if a in coords]
        if len(on) > 1:
            raise ValueError(f"spec {spec}: dim {dim} on two grid axes {on}")
        if on:
            n, i = coords[on[0]]
            rows = shape[dim] // n
            parts.append(Shard(dim, i * rows, (i + 1) * rows, shape[dim]))
    return parts[0]._replace(also=tuple(parts[1:])) if parts else None


def state_shardings(api: registry.ModelApi, ctx: MeshContext | None = None) -> TrainState | None:
    """For every leaf of the train state, the :class:`Shard` this process
    holds, or ``None`` where it holds the whole leaf (the resolved specs of
    :func:`train_state_specs` under the context's rules, strict).  ``None``
    off-mesh and on a mesh inside one process, which holds everything.  On
    a ``data x model`` grid a leaf may be split along a dim over each
    axis."""
    ctx = ctx or current_mesh_context()
    if ctx is None or (ctx.data is None and ctx.mesh.num_processes == 1):
        return None
    shapes = _state_shapes(api.cfg)
    resolved = build_shardings(train_state_specs(api), shapes, ctx)
    if ctx.data is not None:
        return tree_map(lambda spec, shp: _grid_held(tuple(shp.shape), spec, ctx), resolved,
                        shapes)
    return tree_map(lambda spec, shp: _held(tuple(shp.shape), spec, ctx.mesh), resolved, shapes)


def _splits(spec: tuple, ctx: MeshContext) -> tuple[bool, bool]:
    """Whether a leaf resolved to ``spec`` is split over the data column
    and over the model row."""
    on = {a for axes in spec for a in _axes(axes)}
    return "data" in on, ctx.model_axis in on


def _owns(split_data: bool, split_model: bool, ctx: MeshContext) -> bool:
    """Does this process stand for its piece of a leaf: index 0 along every
    axis the leaf is replicated over?"""
    d = ctx.data.process_index if ctx.data is not None else 0
    return (split_data or d == 0) and (split_model or ctx.mesh.process_index == 0)


def grid_pieces(api: registry.ModelApi, ctx: MeshContext) -> list[tuple[bool, bool, bool]]:
    """For every param leaf under the tensor table or a grid: whether it is
    split over the data column, over the model row, and whether this
    process stands for its piece (:func:`_owns`: it adds the piece's squares
    to the clipping norm)."""
    shapes = _state_shapes(api.cfg).params
    out = []
    for spec in leaves(build_shardings(api.param_specs, shapes, ctx)):
        over_data, over_model = _splits(spec, ctx)
        out.append((over_data, over_model, _owns(over_data, over_model, ctx)))
    return out


def state_owners(api: registry.ModelApi, ctx: MeshContext | None = None) -> TrainState | None:
    """For every leaf of the train state under the tensor table or a grid,
    whether this process writes its piece to a checkpoint (each piece once,
    by the process that stands for it, :func:`_owns`); ``None`` elsewhere,
    where a checkpoint writes split leaves on every process and whole ones
    on process 0."""
    ctx = ctx or current_mesh_context()
    if ctx is None or not ctx.tensor:
        return None
    shapes = _state_shapes(api.cfg)
    resolved = build_shardings(train_state_specs(api), shapes, ctx)
    return tree_map(lambda spec: _owns(*_splits(spec, ctx), ctx), resolved)


def grid_world(ctx: MeshContext) -> Mesh:
    """Every process of the context (a grid's ``D x M``, the tensor
    table's row) as a one-unit-a-pod :class:`Mesh` labelled ``"grid"``:
    the clipping norm's scalar all-reduce runs over it."""
    if ctx.data is None:
        m = ctx.mesh
        return Mesh(m.num_processes, 1, m.num_processes, m.process_index, m.group, "grid")
    P, rank, group = live_processes()
    return Mesh(P, 1, P, rank, group, "grid")


def _sharded(api: registry.ModelApi, params: Any, ctx: MeshContext | None) -> list[bool] | None:
    """Per param leaf, whether this process holds only its shard of it (a
    shape that is not the whole leaf's); ``None`` when it holds every leaf
    whole.  Only the MoE family's expert leaves are ever split, so every
    other family, and a mesh inside one process, return at once."""
    if ctx is None or ctx.mesh.num_processes == 1 or api.cfg.family != "moe":
        return None
    whole = leaves(_state_shapes(api.cfg).params)
    mask = [p.shape != w.shape for p, w in zip(leaves(params), whole)]
    return mask if any(mask) else None


#: The families that train under the tensor table and on a grid.
GRID_FAMILIES = ("dense",)


def refuse_tensor_table(ctx: MeshContext | None, cfg) -> None:
    """Raise ``NotImplementedError`` for a family other than the dense one
    under the tensor table or on a grid: MoE's experts, MLA's whole
    compressed path, the SSM and hybrid blocks, the VLM's patches and the
    encoder-decoder have no gradient sync there yet (ROADMAP queue A item
    9(d)(ii))."""
    if ctx is not None and ctx.tensor and cfg.family not in GRID_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family!r} family under the tensor table or on a data x model "
            "grid is not ported yet; only the dense family trains there (ROADMAP queue A, "
            "item 9(d)(ii): the other families' training under the tensor table and the "
            "FSDP rules)")


def make_grad_fn(api: registry.ModelApi) -> Callable[[Any, Any], tuple[torch.Tensor, Any]]:
    """Builds ``grad_fn(params, batch) -> (loss, grads)``, the gradient half
    of the train step under the active mesh context (see the module
    docstring): the mean loss and f32 gradients of the global batch, synced
    where the mesh asks for it.

    Microbatching: ``batch`` (on a mesh over processes, this process's
    rows; under the per-unit sync, each unit's) is split into
    ``cfg.num_microbatches`` row slices run one after another, gradients
    accumulated in f32.  With remat the live activation set is one
    microbatch x one layer.  On a mesh over processes the MoE family's
    expert leaves may be this process's shards (their gradients too).
    Under the tensor table and on a grid each leaf is this process's piece
    (the module docstring's sync); a family other than the dense one raises
    there (:func:`refuse_tensor_table`).
    """
    cfg = api.cfg
    num_mb = max(cfg.num_microbatches, 1)

    def loss_and_grads(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = api.train_loss(live, mb)
        grads = torch.autograd.grad(loss, leaves(live))
        return loss.detach(), unflatten(params, grads)

    def rows_loss_and_grads(params, batch):
        # Each microbatch's work runs in the op counter's "microbatch" region
        # (obs/cost.py), which the dry run multiplies by the microbatch count.
        if num_mb == 1:
            with cost.region("microbatch"):
                return loss_and_grads(params, batch)
        loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        for mb in _slices(batch, num_mb, "microbatches"):
            with cost.region("microbatch"):
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

    def grid_sync(params, batch, ctx):
        loss, grads = rows_loss_and_grads(params, batch)
        if ctx.data is None:  # the tensor table: every held gradient is whole already
            return loss, grads
        # A leaf split over the data column was reduce-scattered over it in the
        # backward (its FSDP gather's rule): divide.  The rest: the column's mean.
        flat = leaves(grads)
        over_data = [p[0] for p in grid_pieces(api, ctx)]
        mean = process_mean({"loss": loss, "grads": [g for g, s in zip(flat, over_data) if not s]},
                            ctx.data)
        rest = iter(mean["grads"])
        D = ctx.data.num_processes
        return mean["loss"], unflatten(grads, [g.float() / D if s else next(rest)
                                               for g, s in zip(flat, over_data)])

    def grad_fn(params, batch):
        ctx = current_mesh_context()
        refuse_tensor_table(ctx, cfg)
        if ctx is not None and ctx.tensor:
            if cfg.grad_sync == "hierarchical":
                raise NotImplementedError(
                    'grad_sync="hierarchical" under the tensor table or on a grid: the sync '
                    'there is the grid\'s (module docstring); use grad_sync="auto"')
            return grid_sync(params, batch, ctx)
        mesh = ctx.mesh if ctx is not None else None
        spans = mesh is not None and mesh.num_processes > 1
        moe = spans and cfg.family == "moe"
        if cfg.grad_sync == "hierarchical" and ctx is not None and ctx.pod_axis is not None:
            if moe:
                raise NotImplementedError(
                    'grad_sync="hierarchical" with the MoE family over a mesh that spans '
                    "processes: the per-unit passes cannot run the expert-parallel layer unit "
                    'by unit (ROADMAP §C); use grad_sync="auto"'
                )
            return per_unit(params, batch, mesh)
        if not spans:
            return rows_loss_and_grads(params, batch)
        if not moe:
            loss, grads = rows_loss_and_grads(params, batch)
            mean = process_mean({"loss": loss, "grads": grads}, mesh)
            return mean["loss"], mean["grads"]
        with mesh_context(dataclasses.replace(ctx, moe_tokens="local")):
            loss, grads = rows_loss_and_grads(params, batch)
        # An expert shard's gradient already sums every process's tokens (the
        # pod hop's backward brings them to the owner): divide, no all-reduce.
        flat = leaves(grads)
        sharded = _sharded(api, params, ctx) or [False] * len(flat)
        mean = process_mean({"loss": loss, "grads": [g for g, s in zip(flat, sharded) if not s]},
                            mesh)
        rest = iter(mean["grads"])
        R = mesh.num_processes
        return mean["loss"], unflatten(grads, [g.float() / R if s else next(rest)
                                               for g, s in zip(flat, sharded)])

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
        ctx = current_mesh_context()
        if ctx is not None and ctx.tensor:  # each piece once over the grid: one scalar sum
            sharded = [True if owns else None for _, _, owns in grid_pieces(api, ctx)]
            mesh = grid_world(ctx)
        else:
            sharded = _sharded(api, state.params, ctx)
            mesh = ctx.mesh if ctx is not None else None
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, state.opt, state.params, sharded=sharded,
            process_sum=None if sharded is None else functools.partial(process_sum, mesh=mesh))
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step


__all__ = ["Shard", "TrainState", "train_state_specs", "state_shardings", "state_owners",
           "grid_pieces", "grid_world", "make_train_step", "make_grad_fn", "refuse_tensor_table",
           "GRID_FAMILIES", "local_rows", "process_sum", "process_mean", "unit_mean"]
