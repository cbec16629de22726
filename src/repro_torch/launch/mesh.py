"""Mesh construction from the live process topology (port of
``repro.launch.mesh``).

The reference's production mesh is ``(pod, data, model)`` and its pod
meshes name the in-pod axis ``q``, ``data`` or ``model``.  The port's
:class:`~repro_torch.core.exchange.Mesh` has two axes, ``pod`` (the network
in the large) and ``q`` (the in-pod network in the small), and plans,
traces, plan-cache keys and tests key on ``q``.  So this module maps every
in-pod name of the reference onto ``q``: a production mesh's in-pod axis
holds the ``data x model`` units of the reference's squarest split, and
``make_pod_mesh(axes=("pod", "data"))`` gives the same ``(pod, q)`` mesh as
``axes=("pod", "q")``.

The unit count is the live process count times the units each process
holds (:func:`repro_torch.launch.cluster.local_unit_count`); one pod a
process by default, so the in-pod axis never leaves a process.

:func:`make_grid_context` lays the live processes out as the reference's
``data x model`` training mesh: a ``torch.distributed`` group for each model
row and one for each data column.
"""

from __future__ import annotations

import torch.distributed as dist

from ..core.exchange import POD_AXIS, SHUFFLE_AXIS, Mesh, live_processes, make_mesh
from ..distributed.sharding import AxisRules, MeshContext, default_rules, tensor_rules
from .cluster import local_unit_count

#: The reference's in-pod axis names; each maps onto the port's ``q``.
IN_POD_AXES = (SHUFFLE_AXIS, "data", "model")


def _squarest_factors(n: int) -> tuple[int, int]:
    """``(d, m)`` with ``d * m == n`` and ``d <= m``, as square as possible."""
    d = int(n**0.5)
    while d > 1 and n % d:
        d -= 1
    return d, n // d


def _process_count() -> int:
    return live_processes()[0]


def _unit_count() -> int:
    return _process_count() * local_unit_count()


def make_production_mesh(*, multi_pod: bool = False, num_pods: int | None = None) -> Mesh:
    """Mesh shaped from the LIVE topology, not hardcoded constants.

    Single-level: one pod of every unit (the reference's ``(data, model)``
    squarest split, both on the in-pod axis).  Multi-pod: ``num_pods``
    defaults to the live process count, one pod a process (launch under
    ``python -m repro_torch.launch.cluster`` first).  Every combination
    that does not factor fails with what to fix.
    """
    total = _unit_count()
    if not multi_pod:
        return make_mesh(total, 1)
    pods = num_pods if num_pods is not None else _process_count()
    if pods <= 1:
        raise ValueError(
            "make_production_mesh(multi_pod=True) needs a real process "
            f"topology, but the process count is {_process_count()} and no "
            "num_pods override was given.  Launch under `python -m "
            "repro_torch.launch.cluster --processes N ...`, or pass num_pods= "
            "explicitly to fake pods on a single process."
        )
    if total % pods:
        raise ValueError(
            f"{total} units do not split across {pods} pods ({total} % {pods} "
            "!= 0).  Use a pod count that divides the unit count, or adjust "
            "--local-units so every process contributes the same number of units."
        )
    per_pod = total // pods
    if per_pod < 2:
        raise ValueError(
            f"{per_pod} unit(s) per pod cannot form a (data, model) in-pod "
            "mesh: each pod needs at least 2 units.  Raise --local-units (or "
            "lower the pod count)."
        )
    return make_mesh(total, pods)


def make_test_mesh(shape=None, axes=None) -> Mesh:
    """Small mesh for the tests.

    Single-process, the reference's ``(2, 4)`` over ``(data, model)``: one
    pod of 8 units.  Multi-process, one pod a process (``(process count,
    local units)`` over ``(pod, model)``), so the same scenario code sees a
    genuine two-level mesh under the launcher.  An explicit shape whose
    first axis is ``pod`` gives that many pods; otherwise one pod.
    """
    if shape is None and axes is None and _process_count() > 1:
        return make_mesh(_unit_count(), _process_count())
    shape = tuple(shape or (2, 4))
    axes = tuple(axes or ("data", "model"))
    for a in axes:
        if a != POD_AXIS and a not in IN_POD_AXES:
            raise ValueError(f"unknown mesh axis {a!r}; the port's axes are pod and q")
    units = 1
    for s in shape:
        units *= int(s)
    pods = int(shape[0]) if axes[0] == POD_AXIS else 1
    return make_mesh(units, pods)


def make_pod_mesh(num_pods: int | None = None, axes=(POD_AXIS, SHUFFLE_AXIS)) -> Mesh:
    """Two-level ``(pod, q)`` mesh for the relational engine and the
    pod-axis scenarios.

    ``num_pods`` defaults to the live process count (one pod a process:
    the in-pod axis is then pure fast network); pass it explicitly to carve
    pods out of one process's units.  ``axes`` is ``("pod", name)`` with
    ``name`` any of the reference's in-pod names, all mapped onto ``q``.
    """
    if len(axes) != 2 or axes[0] != POD_AXIS or axes[1] not in IN_POD_AXES:
        raise ValueError(f"pod mesh axes must be ('pod', one of {IN_POD_AXES}), got {axes!r}")
    total = _unit_count()
    pods = num_pods if num_pods is not None else _process_count()
    if pods < 1 or total % pods:
        raise ValueError(
            f"cannot split {total} units into {pods} pods; pick a pod count "
            "dividing the unit count (launch via repro_torch.launch.cluster "
            "to control both)"
        )
    return make_mesh(total, pods)


def make_context(
    *,
    multi_pod: bool = False,
    num_pods: int | None = None,
    mesh: Mesh | None = None,
    rules: AxisRules | None = None,
) -> MeshContext:
    """The model code's :class:`MeshContext` over the production mesh (or
    ``mesh``), with ``rules`` (default the port's
    :func:`~repro_torch.distributed.sharding.unit_rules`; tensor-parallel
    serving passes :func:`~repro_torch.distributed.sharding.tensor_rules`,
    with ``multi_pod=True`` for one pod a process, and raises on a mesh
    inside one process).  The reference's ``exchange_impl`` has no
    counterpart here."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, num_pods=num_pods)
    return MeshContext(mesh, rules=rules)


def make_grid_context(data: int, model: int) -> MeshContext:
    """The live ``data * model`` processes as the reference's ``(data,
    model)`` mesh under its ``default_rules(False)``: process ``rank`` sits
    at row ``rank // model``, column ``rank % model``.  Every process makes
    every row's and every column's group, in the same order (``new_group``
    hangs otherwise); its context's ``mesh`` is its model row (the tensor
    table's pods, label ``"model"``) and ``data`` its data column (label
    ``"data"``).  ``data = 1`` gives the tensor table over the processes,
    exactly; ``model = 1`` the data-parallel mesh, one pod a process."""
    procs, rank, _ = live_processes()
    if data < 1 or model < 1 or data * model != procs:
        raise ValueError(f"a {data} x {model} grid needs {data * model} processes, the launch "
                         f"has {procs} (launch under `python -m repro_torch.launch.cluster "
                         f"--processes {data * model}`)")
    units = local_unit_count()
    if data == 1:
        return MeshContext(make_mesh(procs * units, procs), rules=tensor_rules())
    if model == 1:
        return MeshContext(make_mesh(procs * units, procs))
    d, m = divmod(rank, model)
    rows = [dist.new_group(list(range(i * model, (i + 1) * model))) for i in range(data)]
    cols = [dist.new_group(list(range(j, procs, model))) for j in range(model)]
    return MeshContext(Mesh(model, units, model, m, rows[d], "model"),
                       rules=default_rules(False), axis_sizes={"data": data, "model": model},
                       data=Mesh(data, 1, data, d, cols[m], "data"))


def parse_grid(text: str) -> tuple[int, int]:
    """``"DxM"`` -> ``(D, M)``."""
    try:
        data, model = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"a grid is DxM (data x model processes), got {text!r}") from None
    return data, model


__all__ = [
    "make_grid_context",
    "parse_grid",
    "make_production_mesh",
    "make_test_mesh",
    "make_pod_mesh",
    "make_context",
]
