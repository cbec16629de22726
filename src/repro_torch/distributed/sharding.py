"""Logical-axis sharding rules and the mesh context the model code reads
(port of ``repro.distributed.sharding``).

Model code never names mesh axes.  Parameter and cache leaves carry
*logical* axis names (``"batch"``, ``"heads"``, ``"experts"``, ...), the
models' ``specs`` and ``cache_specs``; an :class:`AxisRules` table maps
logical names onto mesh axes, and :func:`logical_sharding` resolves a
shape's names against a context's axis sizes with the reference's rules:
the leftmost logical name wins a mesh axis, a dim that its mesh factor does
not divide drops the axis (``allow_uneven`` keeps it while every shard gets
a row, except under ``strict``), and off-mesh there is nothing to resolve.

The reference resolves to a ``NamedSharding`` for GSPMD.  The port runs
every parallel unit as a slice of a tensor's leading dim and a process is
one device, so :func:`logical_sharding` returns the resolved per-dim tuple
(the reference's ``NamedSharding.spec``), :func:`shard` is an identity that
checks the names against the tensor's rank, and the port places from the
rules in two places: the train state's experts (:func:`repro_torch.train.
step.state_shardings`) and, under :func:`tensor_rules`, a served model's
matrices (:func:`tensor_place`: each process keeps its slices of the heads,
``d_ff``, vocab, experts and SSM heads dims, and the layers reduce or
gather over the processes where the reference's GSPMD would).  The context wraps the
:class:`~repro_torch.core.exchange.Mesh` (``num_pods x n`` units,
pod-major, possibly spanning processes); its rules default to
:func:`unit_rules`, and ``axis_sizes`` lets a context resolve against
another mesh's axes (the reference's ``data x model``, say) for
comparison.  The expert-parallel MoE layer reads the context to lay tokens
and experts out over the units.  The batch follows the reference's
``"batch" -> (pod, data)``: on a mesh that spans processes each process
holds its contiguous rows (:func:`local_rows`, where :func:`split_rows`
holds; the trainer and the static serving engine), and :func:`gather_rows`
puts them back together on every process.

**Training on a ``data x model`` grid of processes** (the reference's
``(data, model)`` mesh under :func:`default_rules`): the context's ``mesh``
is this process's model row, whose processes are the tensor table's pods as
in serving, and ``data`` its data column.  Heads, ``d_ff`` and vocab split
over the row; every ``fsdp`` dim, and the batch, over the column.  The
collectives carry their backward (:func:`tensor_all_reduce`,
:func:`tensor_entry`, :func:`tensor_all_gather`, :func:`fsdp_gather`), so
the model trains through them; ``launch.mesh.make_grid_context`` builds the
groups.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Literal, Mapping, Sequence

import torch

from ..core import exchange
from ..core.exchange import POD_AXIS, SHUFFLE_AXIS, Mesh
from ..tree import tree_map

# Logical dimension names used across the model zoo.
LOGICAL_AXES = (
    "batch",      # global batch                      -> (pod, data)
    "seq",        # sequence (attention q/k/v)        -> None
    "seq_sp",     # residual-stream seq (Megatron SP)  -> None | model
    "kv_seq",     # KV-cache sequence at decode       -> model (flash-decode)
    "d_model",    # residual stream                   -> None
    "heads",      # attention query heads             -> model
    "kv_heads",   # attention kv heads                -> model (if divisible)
    "d_ff",       # MLP hidden                        -> model
    "experts",    # MoE expert dim                    -> model (EP)
    "vocab",      # embedding/logits vocab            -> model
    "fsdp",       # parameter FSDP dim                -> data
    "expert_fsdp",# expert-weight inner dims           -> data (or model)
    "conv_dim",   # mamba conv channels               -> model
    "ssm_heads",  # mamba value heads                 -> model
)

Axes = tuple[str, ...] | str | None


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> mesh axis (or tuple of axes, or None).

    ``allow_uneven``: keep an axis even when the dimension is not divisible
    by the mesh factor, as long as every shard gets a row (the reference's
    GSPMD pads); never for ``strict`` resolution.
    """

    table: Mapping[str, Axes]
    allow_uneven: bool = False

    def spec_for(self, *names: str | None) -> tuple[Axes, ...]:
        return tuple(self.table.get(n) if n else None for n in names)

    def replace(self, **kw) -> "AxisRules":
        uneven = kw.pop("allow_uneven", self.allow_uneven)
        t = dict(self.table)
        t.update(kw)
        return AxisRules(t, allow_uneven=uneven)


def default_rules(multi_pod: bool) -> AxisRules:
    """The reference's table for its ``(pod,) data x model`` meshes."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return AxisRules(
        {
            "batch": batch,
            "seq": None,
            "seq_sp": None,
            "kv_seq": "model",
            "d_model": None,
            "heads": "model",
            "kv_heads": "model",
            "d_ff": "model",
            "experts": "model",
            "vocab": "model",
            "fsdp": "data",
            "expert_fsdp": "data",
            "conv_dim": "model",
            "ssm_heads": "model",
        }
    )


#: The logical names :func:`tensor_rules` splits over the processes.
TENSOR_AXES = ("heads", "kv_heads", "d_ff", "vocab", "ssm_heads", "conv_dim")
#: The Mamba block's names, which the tensor table cuts by the model's
#: head-aligned sections (``ModelApi.tensor_index``), not in equal runs.
SSM_AXES = ("ssm_heads", "conv_dim")


def tensor_rules() -> AxisRules:
    """The port's tensor-parallel serving table: the names that the
    reference's :func:`default_rules` put on ``model`` and that a dense
    layer's or a Mamba block's matrices carry (``heads``, ``kv_heads``,
    ``d_ff``, ``vocab``, ``ssm_heads``, ``conv_dim``) over the pod axis,
    which spans the processes one pod each and stands for the reference's
    ``model``; and ``experts`` over the joint unit
    axis ``(pod, q)``, as :func:`unit_rules` puts it, where the
    expert-parallel layer consumes the expert weights (the reference's
    ``default_rules`` put it on the same ``model`` axis as the heads), so a
    process holds its units' ``E / R`` contiguous experts.  ``batch``,
    ``fsdp``, ``seq`` and the rest stay whole (serving keeps no FSDP), and
    so does every dim that its axes do not divide (no ``allow_uneven``): a
    count of experts that the units do not divide stays whole."""
    table = {name: POD_AXIS if name in TENSOR_AXES else None for name in LOGICAL_AXES}
    table["experts"] = (POD_AXIS, SHUFFLE_AXIS)
    return AxisRules(table)


def unit_rules(multi_pod: bool) -> AxisRules:
    """The port's table on its own ``(pod, q)`` mesh: the experts dim over
    the joint unit axis, where the expert-parallel layer consumes the
    expert weights (the reference's ``shard_map`` takes them as ``P(unit,
    None, None)``); every other name replicated, as the port has no FSDP
    (tensor-parallel serving takes :func:`tensor_rules` instead)."""
    unit = (POD_AXIS, SHUFFLE_AXIS) if multi_pod else (SHUFFLE_AXIS,)
    return AxisRules({name: unit if name == "experts" else None for name in LOGICAL_AXES})


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """What the model code needs to know about the machine: the mesh, the
    axis its exchanges run over (the in-pod axis) and, on a two-level mesh,
    the pod axis; the sharding ``rules`` (default :func:`unit_rules`) and
    the ``axis_sizes`` they resolve against (default the mesh's own).
    Transports come from the model config or from an ambient multiplexer,
    never from here.

    ``moe_tokens`` is the expert-parallel layer's token contract on a mesh
    that spans processes: ``"global"`` (serving) has every process hold all
    ``T`` tokens and gather every unit's output; ``"local"`` (training, set
    by the train step) has each process feed its own rows and get back only
    theirs.

    ``data``: on a ``data x model`` grid of processes, this process's data
    column (a one-unit-a-pod :class:`Mesh` over the ``D`` processes that
    hold the same model slices, label ``"data"``), and ``mesh`` its model
    row (``M`` processes a pod each, label ``"model"``); the rules then
    name the reference's axes (:func:`default_rules`, ``axis_sizes``
    ``{"data": D, "model": M}``).  ``None`` off a grid."""

    mesh: Mesh
    rules: AxisRules | None = None
    axis_sizes: Mapping[str, int] | None = None
    moe_tokens: Literal["global", "local"] = "global"
    data: Mesh | None = None

    def __post_init__(self):
        if self.data is not None and (
                dict(self.axis_sizes or {}) != {"data": self.data.num_processes,
                                                "model": self.mesh.num_processes}
                or self.data.num_processes < 2):
            raise ValueError(
                f"a grid context names the axes ('data', 'model') with the column's and the row's "
                f"process counts, got axis_sizes {self.axis_sizes} for a column of "
                f"{self.data.num_processes} and a row of {self.mesh.num_processes}")
        if self.rules is None:
            object.__setattr__(self, "rules", unit_rules(self.mesh.num_pods > 1))
        if self.axis_sizes is None:
            object.__setattr__(self, "axis_sizes",
                               dict(zip(self.mesh.axis_names, self.mesh.shape)))
        if self.moe_tokens not in ("global", "local"):
            raise ValueError(f"unknown moe_tokens {self.moe_tokens!r}")
        m = self.mesh
        if self.tensor and not (m.num_processes > 1 and m.pods_per_process == 1):
            raise ValueError(
                f"the tensor table splits heads, d_ff, vocab, experts and SSM heads over the "
                f"processes, "
                f"a pod each; a mesh of {m.num_pods} pod(s) over {m.num_processes} process(es) "
                "has no such axis (launch under `python -m repro_torch.launch.cluster` and "
                "make the mesh with one pod a process)")

    @property
    def model_axis(self) -> str:
        """The axis the processes of ``mesh`` span as the tensor table's
        pods: ``"model"`` on a grid, the pod axis otherwise."""
        return "model" if self.data is not None else POD_AXIS

    @property
    def tensor(self) -> bool:
        """Do the rules split a layer's matrices over the model axis (the
        tensor table, or a grid's rows)?  Only the names of
        :data:`TENSOR_AXES` count (a dense layer's and a Mamba block's):
        ``experts`` lies on the pod axis under :func:`unit_rules` too."""
        return any(self.model_axis in _axes(self.rules.table.get(n)) for n in TENSOR_AXES)

    @property
    def exchange_axis(self) -> str:
        return SHUFFLE_AXIS

    @property
    def pod_axis(self) -> str | None:
        return POD_AXIS if self.mesh.num_pods > 1 else None

    @property
    def exchange_size(self) -> int:
        return self.mesh.size(SHUFFLE_AXIS)

    @property
    def data_axes(self) -> tuple[str, ...]:
        """The axes gradients sync over: the pod axis (when there is one)
        and the in-pod axis, which stands for the reference's ``data``."""
        return (POD_AXIS, SHUFFLE_AXIS) if self.pod_axis else (SHUFFLE_AXIS,)


_CTX: contextvars.ContextVar[MeshContext | None] = contextvars.ContextVar(
    "repro_torch_mesh_context", default=None
)


def current_mesh_context() -> MeshContext | None:
    return _CTX.get()


@contextlib.contextmanager
def mesh_context(ctx: MeshContext | None) -> Iterator[MeshContext | None]:
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def _axes(a: Axes) -> tuple[str, ...]:
    return (a,) if isinstance(a, str) else tuple(a or ())


def _divisible(dim: int, sizes: Mapping[str, int], axes: tuple[str, ...],
               allow_uneven: bool) -> bool:
    k = 1
    for a in axes:
        k *= sizes[a]
    if dim % k == 0:
        return True
    # uneven mode: keep the axis as long as every shard gets >= 1 row
    return allow_uneven and dim >= k


def logical_sharding(
    shape: Sequence[int],
    *names: str | None,
    ctx: MeshContext | None = None,
    strict: bool = False,
) -> tuple[Axes, ...] | None:
    """The resolved per-dim spec of a logical-tagged shape (the reference's
    ``NamedSharding.spec``); ``None`` when no mesh context.

    Drops any logical axis whose mesh factor does not divide the dimension
    unless ``ctx.rules.allow_uneven``; ``strict=True`` always requires
    exact divisibility.  A mesh axis shards at most one dim: the leftmost
    logical name wins.
    """
    ctx = ctx or current_mesh_context()
    if ctx is None:
        return None
    assert len(shape) == len(names), (shape, names)
    uneven = ctx.rules.allow_uneven and not strict
    resolved: list[Axes] = []
    used: set[str] = set()
    for dim, name in zip(shape, names):
        axes = ctx.rules.table.get(name) if name else None
        if isinstance(axes, str):
            axes = (axes,)
        if axes:
            axes = tuple(a for a in axes if a not in used)
        if not axes:
            resolved.append(None)
            continue
        if _divisible(dim, ctx.axis_sizes, axes, uneven):
            used.update(axes)
            resolved.append(axes if len(axes) > 1 else axes[0])
        else:
            resolved.append(None)
    return tuple(resolved)


def is_spec_leaf(x) -> bool:
    """Spec trees use tuples of logical-axis names as leaves."""
    return isinstance(x, tuple) and (
        len(x) == 0 or all(n is None or isinstance(n, str) for n in x)
    )


def build_shardings(spec_tree, shape_tree, ctx: MeshContext | None = None):
    """The resolved spec of every leaf of ``shape_tree`` (tensors, ``meta``
    ones included) from its logical spec in ``spec_tree``, with strict
    divisibility; ``None`` off-mesh."""
    ctx = ctx or current_mesh_context()
    if ctx is None:
        return None
    return tree_map(
        lambda spec, shp: logical_sharding(tuple(shp.shape), *spec, ctx=ctx, strict=True),
        spec_tree, shape_tree,
    )


def shard(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Tag an activation with logical axes: an identity here (a process is
    one device, so there is no constraint to place), after checking that
    the names match ``x``'s rank."""
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} logical names {names} for a rank-{x.ndim} tensor")
    return x


# ----------------------------------------------------------------------------
# Tensor parallelism: a process's slices of the layers' matrices.
# ----------------------------------------------------------------------------

def tensor_context() -> MeshContext | None:
    """The active context when its rules are the tensor table, else None."""
    ctx = current_mesh_context()
    return ctx if ctx is not None and ctx.tensor else None


def tensor_split(dim: int, name: str, ctx: MeshContext | None = None) -> int:
    """Into how many parts across the processes the tensor table cuts a dim
    of ``dim`` entries named ``name``: the process count where it resolves
    onto the pod axis (alone, or with the in-process axis as ``experts``
    does), 1 otherwise (no tensor table, or a count that its axes do not
    divide)."""
    ctx = ctx or tensor_context()
    if ctx is None or not ctx.tensor:
        return 1
    if ctx.model_axis not in _axes(logical_sharding((dim,), name, ctx=ctx)[0]):
        return 1
    return ctx.mesh.num_processes


def tensor_slice(t: torch.Tensor, spec: tuple, ctx: MeshContext, index=None) -> torch.Tensor:
    """This process's slice of a whole leaf ``t`` with logical axes
    ``spec``: along each dim that resolves onto the pod axis, the ``i``-th
    of ``R`` equal runs for process ``i`` (under ``(pod, q)``, one pod a
    process, its units' runs are that one run); along a Mamba block's dim
    (:data:`SSM_AXES`) the indices ``index(width, ctx)`` that the model
    hands in (its head-aligned sections, e.g.
    ``functools.partial(mamba2.tensor_index, cfg)``; ``None`` keeps the dim
    whole).  On a grid only the model axis's dims are cut (the ``fsdp`` dim
    is the train state's, ``train.step.state_shardings``).  In storage of
    its own, so the whole leaf can be freed."""
    R, i = ctx.mesh.num_processes, ctx.mesh.process_index
    cut = False
    for d, name in enumerate(spec):
        if name not in SSM_AXES:
            continue
        if index is None:
            raise ValueError(f"cutting a Mamba leaf ({name!r}) needs the model's index function")
        idx = index(t.shape[d], ctx)
        if idx is not None:
            t = t.index_select(d, idx.to(t.device))
    plain = tuple(None if name in SSM_AXES else name for name in spec)
    for d, axes in enumerate(logical_sharding(tuple(t.shape), *plain, ctx=ctx)):
        if ctx.model_axis in _axes(axes):
            n = t.shape[d] // R
            t, cut = t.narrow(d, i * n, n), True
    return t.clone() if cut else t


def tensor_slices(tree, spec_tree, ctx: MeshContext, index=None):
    """:func:`tensor_slice` of every leaf of ``tree`` by its spec (``index``:
    the model's cut of a Mamba block, ``ModelApi.tensor_index``)."""
    return tree_map(lambda t, spec: tensor_slice(t, spec, ctx, index), tree, spec_tree)


def tensor_place(spec_tree, ctx: MeshContext, index=None):
    """The ``place(path, sub) -> sub`` hook of a model's ``init`` that keeps
    this process's slices of each layer (and of the embedding) as it is
    drawn, so no process ever holds the whole tree (``index``: the model's
    cut of a Mamba block, ``ModelApi.tensor_index``)."""
    def place(path, sub):
        specs = spec_tree
        for key in path:
            specs = specs[key]
        return tensor_slices(sub, specs, ctx, index)

    return place


class _AllReduceExit(torch.autograd.Function):
    """The row-parallel exit: the sum over the processes in the forward,
    the gradient as it is in the backward (every process's output is the
    same sum, so its gradient is every process's own)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return exchange._all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceShared(torch.autograd.Function):
    """A sum over the processes that each process then uses only for its
    own slice (a norm's sum of squares over split heads): the sum in the
    forward, and the gradient summed in the backward too, since each
    process's slice gives only its part of the sum's gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return exchange._all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return exchange._all_reduce(ctx.mesh, g), None


class _GradSumEntry(torch.autograd.Function):
    """The column-parallel entry: the input as it is in the forward, its
    gradient summed over the processes in the backward (each process's
    slice of the product gives only its part of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return exchange._all_reduce(ctx.mesh, g), None


class _GatherColumns(torch.autograd.Function):
    """The gathered logits: every process's columns in the forward; in the
    backward this process's columns of the gradient, not summed (every
    process computes the same loss from the whole logits, so the incoming
    gradient is the same everywhere)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.cols = (mesh.process_index * x.shape[-1], x.shape[-1])
        return torch.cat(exchange._all_gather(mesh, x).unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, *ctx.cols), None


def tensor_all_reduce(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """The sum of every process's ``x`` (a row-parallel product's partial
    sums), on every process: one all-reduce over the pod hop; the gradient
    passes through as it is.  That backward holds only where what follows
    is replicated over the processes; a sum that each process goes on to
    use for its own slice takes :func:`tensor_shared_sum`."""
    return _AllReduceExit.apply(x, ctx.mesh)


def tensor_shared_sum(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """The sum of every process's ``x`` on every process, as
    :func:`tensor_all_reduce`, where each process then uses it only for its
    own slice: the backward sums the gradient over the processes too (one
    all-reduce each way)."""
    return _AllReduceShared.apply(x, ctx.mesh)


def tensor_entry(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """``x`` as it is, where a replicated tensor enters the process's slice
    of a split computation; its gradient is summed over the processes in
    the backward (one all-reduce).  The forward moves no byte."""
    return _GradSumEntry.apply(x, ctx.mesh)


def tensor_all_gather(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Every process's ``x [..., n]`` joined along the last dim in process
    order (``[..., R * n]``), on every process: one all-gather over the pod
    hop; in the backward this process's ``n`` columns of the gradient."""
    return _GatherColumns.apply(x, ctx.mesh)


# ----------------------------------------------------------------------------
# FSDP: a grid's leaves split over its data column.
# ----------------------------------------------------------------------------

class _FSDPGather(torch.autograd.Function):
    """A leaf held split along ``dim`` over the data column: gathered whole
    in the forward; its gradient reduce-scattered back to this process's
    block in the backward, which also sums the column's gradients (the
    data-parallel sum; the train step divides by the column's size)."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return torch.cat(exchange._all_gather(mesh, t).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        block = exchange._reduce_scatter(ctx.mesh, g.movedim(ctx.dim, 0).contiguous())
        return block.movedim(0, ctx.dim), None, None


def fsdp_gather(tree, spec_tree, shape_tree, ctx: MeshContext | None = None):
    """``tree`` (one layer's params, say) with every leaf that the grid
    holds split over its data column gathered whole, as an autograd rule
    whose backward reduce-scatters; the tree as it is off a grid.  Which dim
    a leaf is split along comes from its logical axes in ``spec_tree`` and
    its whole shape in ``shape_tree`` (strict resolution: a dim the column
    does not divide stays whole).  The gathered copies live as long as the
    caller's graph keeps them: under remat, one layer's."""
    ctx = ctx or current_mesh_context()
    if ctx is None or ctx.data is None:
        return tree

    def one(t, spec, whole):
        resolved = logical_sharding(tuple(whole.shape), *spec, ctx=ctx, strict=True)
        dim = next((d for d, axes in enumerate(resolved) if "data" in _axes(axes)), None)
        if dim is None:
            return t
        return _FSDPGather.apply(t, dim, ctx.data)

    return tree_map(one, tree, spec_tree, shape_tree)


# ----------------------------------------------------------------------------
# A process's rows of a batch (the logical ``"batch"`` axis over the pods).
# ----------------------------------------------------------------------------

def _slices(batch: dict, num: int, what: str) -> list[dict]:
    """``num`` consecutive row slices of every batch entry."""
    B = next(iter(batch.values())).shape[0]
    if B % num:
        raise ValueError(f"batch {B} not divisible by {num} {what}")
    n = B // num
    return [{k: v[i * n : (i + 1) * n] for k, v in batch.items()} for i in range(num)]


def split_rows(n: int, mesh: Mesh) -> bool:
    """Do ``mesh``'s ``R`` processes divide a batch of ``n`` rows?  Where
    they do not, the batch stays whole on every process, as the reference
    drops a mesh axis that does not divide a dim."""
    return n % mesh.num_processes == 0


def local_rows(batch: dict, mesh: Mesh) -> dict:
    """This process's contiguous slice of a global batch: rows
    ``[rank * B / R, (rank + 1) * B / R)`` on a mesh over ``R`` processes
    (the whole batch on a mesh in one process)."""
    return _slices(batch, mesh.num_processes, "processes")[mesh.process_index]


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole ``[B, ...]`` tensor on every process from each process's
    ``[B / R, ...]`` rows (:func:`local_rows`' inverse): one all-gather over
    the pod hop (``exchange.POD_HOP``, kind ``"all-gather"``)."""
    if mesh.num_processes == 1:
        return t
    return exchange._all_gather(mesh, t).reshape((-1,) + tuple(t.shape[1:]))


__all__ = [
    "LOGICAL_AXES",
    "AxisRules",
    "default_rules",
    "unit_rules",
    "TENSOR_AXES",
    "SSM_AXES",
    "tensor_rules",
    "MeshContext",
    "current_mesh_context",
    "mesh_context",
    "logical_sharding",
    "is_spec_leaf",
    "build_shardings",
    "shard",
    "tensor_context",
    "tensor_split",
    "tensor_slice",
    "tensor_slices",
    "tensor_place",
    "tensor_all_reduce",
    "tensor_shared_sum",
    "tensor_entry",
    "tensor_all_gather",
    "fsdp_gather",
    "split_rows",
    "local_rows",
    "gather_rows",
]
