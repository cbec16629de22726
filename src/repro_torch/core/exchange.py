"""Decoupled exchange operators on a simulated fabric (paper §3.2).

Port of ``repro.core.exchange``.  The reference runs a per-device body under
``shard_map`` and moves data with collectives; here every tensor carries an
explicit leading shard dim ``S`` and the collectives are tensor operations
in one card's memory.  On a two-level mesh ``S = P * n`` in mesh device
order (pod-major), so ``x.view(P, n, ...)`` gives back the pod and in-pod
axes.  Inside one process the fabric moves bytes through the card's
memory, not over a network: it reproduces the reference's per-device
results, not its network.

In a launched cluster (:mod:`repro_torch.launch.cluster`) the pods split
evenly over the processes and each process holds only its own pods' units
(the leading-dim slice ``[unit_offset, unit_offset + local_units)`` of
every sharded tensor, same pod-major order).  The in-pod axis never leaves
a process; every operation over the pod axis crosses the process boundary
through ``torch.distributed`` (the process fabric, below): ``psum`` is an
``all_reduce``, the ``"xla"`` all-to-all an ``all_to_all_single``, each
phase of a scheduled all-to-all one ``batch_isend_irecv``, the ring
all-gather a ring of sends and the ``"xla"`` broadcast an ``all_gather``.

=====================================  =======================================
reference (per device)                 here (all shards at once)
=====================================  =======================================
``lax.all_to_all`` (``"xla"`` impl)    one transpose: ``y[i, j] = x[j, i]``
                                       within each axis group
scheduled transports                   ``n - 1`` phase gathers, following
                                       ``schedule``'s phases and chunk splits
``ring_all_gather``                    ``n - 1`` ring shifts
``lax.psum``                           a sum over the axis group
``lax.axis_index``                     ``arange(S)``
=====================================  =======================================

The scheduled transports keep their phase structure in both fabrics.  The
pod-axis all-to-all is differentiable: its backward is the same hop on the
gradient (``_PodAllToAll``), so every route built on it (``all_to_all``,
:func:`dispatch_two_level`, :func:`combine_two_level`, the multiplexer's
``dispatch`` and ``combine``) trains across processes.

The partition hot path has two implementations, selected by ``pack_impl``:
``"torch"`` (a ``[rows, num_dest + 1]`` one-hot + cumsum, the reference's
``"xla"`` pack) and ``"cuda"`` (the hand-written kernels of
:mod:`repro_torch.kernels.hash_partition`, the reference's ``"pallas"``
pack), both bit-identical.  Packing is capacity-bounded: rows beyond a
destination's capacity are counted in ``dropped``, never shipped, and the
relational layer raises on any nonzero count.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, Literal

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..kernels import ops as kernel_ops
from ..kernels.ref import fibonacci_hash, partition_pack_ref
from ..obs import cost
from ..tree import tree_map
from .schedule import make_schedule

AllToAllImpl = Literal["xla", "round_robin", "one_factorization"]
PackImpl = Literal["torch", "cuda"]

SHUFFLE_AXIS = "q"  # the in-pod (fast network) exchange axis
POD_AXIS = "pod"  # the network in the large


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh: ``num_pods x n`` units, pod-major.

    ``num_processes > 1``: the pods split evenly over that many processes
    of ``group``; this process (``process_index``) holds pods
    ``[process_index * pods_per_process, ...)``, i.e. units
    ``[unit_offset, unit_offset + local_units)``, and tensors on this mesh
    have ``local_units`` rows in their leading dim.  ``shape`` and
    ``size()`` stay global.

    ``label`` names what the processes of ``group`` stand for, as the pod
    hop's bytes are kept by it (:data:`POD_HOP_GROUPS`): ``"pod"``, or on a
    ``data x model`` grid of processes ``"model"`` (a row, the tensor
    table's processes) and ``"data"`` (a column, the FSDP processes).
    """

    num_pods: int
    n: int
    num_processes: int = 1
    process_index: int = 0
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    label: str = dataclasses.field(default=POD_AXIS, compare=False, repr=False)

    @property
    def num_units(self) -> int:
        return self.num_pods * self.n

    @property
    def pods_per_process(self) -> int:
        return self.num_pods // self.num_processes

    @property
    def local_units(self) -> int:
        """Units (leading-dim rows) this process holds."""
        return self.pods_per_process * self.n

    @property
    def unit_offset(self) -> int:
        """Global index of this process's first unit."""
        return self.process_index * self.local_units

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (POD_AXIS, SHUFFLE_AXIS) if self.num_pods > 1 else (SHUFFLE_AXIS,)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.num_pods, self.n) if self.num_pods > 1 else (self.n,)

    def size(self, axis: str) -> int:
        if axis == SHUFFLE_AXIS:
            return self.n
        if axis == POD_AXIS:
            return self.num_pods
        raise ValueError(f"unknown mesh axis {axis!r}")


def live_processes() -> tuple[int, int, Any]:
    """``(process count, this process's rank, group)`` of the initialized
    default ``torch.distributed`` process group, ``(1, 0, None)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def make_mesh(num_shards: int, num_pods: int = 1) -> Mesh:
    """The ``num_pods x (num_shards / num_pods)`` mesh.

    In one process it lives whole in this process.  Inside a launched
    cluster (an initialized default process group of ``R > 1`` ranks) a
    two-level mesh spans the processes, ``num_pods / R`` whole pods each;
    a one-pod mesh has no pod axis to cross and every process holds its
    own whole copy.
    """
    if num_shards % num_pods:
        raise ValueError(
            f"num_shards={num_shards} does not split across num_pods={num_pods}"
        )
    procs, rank, group = live_processes()
    if procs > 1 and num_pods > 1:
        if num_pods % procs:
            raise ValueError(
                f"num_pods={num_pods} do not split over {procs} processes: "
                "each process owns whole pods; pick a pod count that the "
                "process count divides"
            )
        return Mesh(num_pods, num_shards // num_pods, procs, rank, group)
    return Mesh(num_pods, num_shards // num_pods)


def _spans(mesh: Mesh, axis: str) -> bool:
    """Does ``axis`` cross the process boundary on this mesh?"""
    return axis == POD_AXIS and mesh.num_processes > 1


def _group(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``[S, ...]`` -> ``[G, A, ...]``: ``A`` units of each axis group."""
    assert not _spans(mesh, axis), "the pod axis spans processes here"
    v = x.reshape((mesh.pods_per_process, mesh.n) + tuple(x.shape[1:]))
    return v if axis == SHUFFLE_AXIS else v.transpose(0, 1)


def _ungroup(y: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if axis == POD_AXIS:
        y = y.transpose(0, 1)
    return y.reshape((mesh.local_units,) + tuple(y.shape[2:]))


def axis_index(mesh: Mesh, axis: str, device=None) -> torch.Tensor:
    """``lax.axis_index``: each local unit's index along ``axis``, ``[S]``."""
    unit = torch.arange(mesh.local_units, device=device) + mesh.unit_offset
    return unit % mesh.n if axis == SHUFFLE_AXIS else unit // mesh.n


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over the axis group; every member receives the total."""
    if _spans(mesh, axis):
        return _pod_psum(x, mesh)
    g = _group(x, mesh, axis)
    return _ungroup(g.sum(1, keepdim=True, dtype=x.dtype).expand_as(g), mesh, axis)


# ----------------------------------------------------------------------------
# All-to-all.
# ----------------------------------------------------------------------------

def xla_all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The monolithic all-to-all: ``x[s, j]`` is unit ``s``'s chunk for unit
    ``j`` of its axis group; ``y[s, j]`` is the chunk received from ``j``."""
    A = mesh.size(axis)
    assert x.shape[1] == A, f"message dim {x.shape[1]} != axis size {A}"
    if _spans(mesh, axis):
        return _PodAllToAll.apply(x, mesh, "xla", 1)
    return _ungroup(_group(x, mesh, axis).transpose(1, 2), mesh, axis)


@functools.lru_cache(maxsize=64)
def _source_index(n: int, schedule: str, device: torch.device) -> torch.Tensor:
    """``[phases, n]``: per phase, the unit each unit receives from, built
    once per (axis size, schedule, device): a copy from host memory in
    every phase would make the host wait for the card each time."""
    table = []
    for phase in make_schedule(n, schedule).phases:
        src = [0] * n
        for a, b in phase:
            src[b] = a
        table.append(src)
    return torch.tensor(table, device=device)


def scheduled_all_to_all(
    x: torch.Tensor,
    mesh: Mesh,
    axis: str,
    schedule: str = "shift",
    num_chunks: int = 1,
) -> torch.Tensor:
    """The paper's phased round-robin all-to-all (Fig 10a).

    Same contract as :func:`xla_all_to_all`, decomposed into the schedule's
    ``n - 1`` conflict-free phases; in phase ``k`` each unit receives one
    message from its phase source.  ``num_chunks > 1`` ships each phase's
    message as that many sub-messages split along the message's second dim.
    """
    A = mesh.size(axis)
    assert x.shape[1] == A, f"message dim {x.shape[1]} != axis size {A}"
    if A == 1:
        return x
    if num_chunks > 1:
        assert x.ndim >= 3 and x.shape[2] % num_chunks == 0, (
            f"num_chunks={num_chunks} must divide message dim "
            f"{x.shape[2] if x.ndim >= 3 else None}"
        )
    if _spans(mesh, axis):
        return _PodAllToAll.apply(x, mesh, schedule, num_chunks)
    g = _group(x, mesh, axis)  # [G, A (sender), A (receiver), ...]
    y = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    dev = torch.arange(A, device=x.device)
    y[:, dev, dev] = g[:, dev, dev]  # own chunk stays put
    sub = x.shape[2] // num_chunks if num_chunks > 1 else 0
    for src in _source_index(A, schedule, x.device):
        if num_chunks == 1:
            y[:, dev, src] = g[:, src, dev]
        else:
            for c in range(num_chunks):
                sl = slice(c * sub, (c + 1) * sub)
                y[:, dev, src, sl] = g[:, src, dev, sl]
    return _ungroup(y, mesh, axis)


def all_to_all(
    x: torch.Tensor,
    mesh: Mesh,
    axis: str,
    impl: AllToAllImpl = "round_robin",
    num_chunks: int = 1,
) -> torch.Tensor:
    """The multiplexer's shuffle entry point; ``num_chunks`` only affects the
    scheduled transports."""
    if impl == "xla":
        return xla_all_to_all(x, mesh, axis)
    if impl == "round_robin":
        return scheduled_all_to_all(x, mesh, axis, "shift", num_chunks)
    if impl == "one_factorization":
        return scheduled_all_to_all(x, mesh, axis, "one_factorization", num_chunks)
    raise ValueError(f"unknown all_to_all impl {impl!r}")


def scheduled_all_to_all_consume(
    x: torch.Tensor,
    mesh: Mesh,
    axis: str,
    consume: Callable[[Any, torch.Tensor, torch.Tensor], Any],
    init: Any,
    schedule: str = "shift",
) -> Any:
    """Streaming shuffle: fold each message as it arrives (paper §3.2 steps
    5-7).

    ``consume(acc, chunk, src) -> acc`` is applied to every unit's own
    chunk first (``chunk [S, ...]`` = ``x[s, me]``, ``src [S]`` = each
    unit's own axis index), then to the chunk each unit receives in each
    phase of the schedule, with ``src`` the sender's axis index.  The
    receive buffer is one chunk deep: the ``[S, A, ...]`` result of
    :func:`scheduled_all_to_all` never materializes.
    """
    A = mesh.size(axis)
    assert x.shape[1] == A, f"message dim {x.shape[1]} != axis size {A}"
    me = axis_index(mesh, axis, x.device)
    unit = torch.arange(x.shape[0], device=x.device)
    acc = consume(init, x[unit, me], me)
    if A == 1:
        return acc
    if _spans(mesh, axis):
        for got, src in _pod_phases(x, mesh, schedule):
            acc = consume(acc, got, src)
        return acc
    g = _group(x, mesh, axis)  # [G, A (sender), A (receiver), ...]
    dev = torch.arange(A, device=x.device)
    for src in _source_index(A, schedule, x.device):
        got = _ungroup(g[:, src, dev], mesh, axis)
        acc = consume(acc, got, _ungroup(src.expand(g.shape[0], A), mesh, axis))
    return acc


# ----------------------------------------------------------------------------
# Broadcast exchange (paper §3.1: broadcast joins).
# ----------------------------------------------------------------------------

def ring_all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every unit ends with all ``A`` chunks of its axis group, over ``A - 1``
    single-shift ring phases: ``[S, ...]`` -> ``[S, A, ...]``, where
    ``y[s, j]`` is unit ``j``'s chunk."""
    if _spans(mesh, axis):
        return _pod_ring_all_gather(x, mesh)
    A = mesh.size(axis)
    g = _group(x, mesh, axis)  # [G, A, ...]
    y = g.new_zeros((g.shape[0], A, A) + tuple(g.shape[2:]))
    dev = torch.arange(A, device=x.device)
    y[:, dev, dev] = g
    cur = g
    for k in range(1, A):
        cur = torch.roll(cur, 1, dims=1)  # unit i sends to i + 1
        y[:, dev, (dev - k) % A] = cur  # after k hops unit d holds d - k's chunk
    return _ungroup(y, mesh, axis)


def broadcast_exchange(
    x: torch.Tensor, mesh: Mesh, axis: str, impl: str = "ring"
) -> torch.Tensor:
    if impl == "ring":
        return ring_all_gather(x, mesh, axis)
    if impl == "xla":
        if _spans(mesh, axis):
            return _pod_all_gather(x, mesh)
        g = _group(x, mesh, axis)
        A = mesh.size(axis)
        return _ungroup(g[:, None].expand((g.shape[0], A) + tuple(g.shape[1:])), mesh, axis)
    raise ValueError(f"unknown broadcast impl {impl!r}")


# ----------------------------------------------------------------------------
# Hierarchical collectives (hybrid parallelism for gradient sync).
# ----------------------------------------------------------------------------

def hierarchical_psum(
    x: torch.Tensor, mesh: Mesh, inner_axis: str, outer_axis: str
) -> torch.Tensor:
    """Two-level all-reduce of ``x [S, L, ...]``: RS(inner) -> AR(outer) ->
    AG(inner).

    The bandwidth-hungry reduce-scatter and all-gather stay on the inner
    (fast) network; only each unit's reduced ``1 / inner_size`` block
    crosses the outer one.  ``L`` must be divisible by the inner axis size
    (:func:`hierarchical_psum_tree` pads arbitrary tensors), and the inner
    axis must not span processes: a pod lives in one process, so the
    reduce-scatter is a sum in its memory and the pod hop carries the
    reduced blocks.
    """
    A = mesh.size(inner_axis)
    L = x.shape[1]
    assert L % A == 0, f"dim 1 ({L}) must be divisible by the {inner_axis} size {A}"
    g = _group(x, mesh, inner_axis)  # [G, A, L, ...]
    blocks = g.reshape(g.shape[:2] + (A, L // A) + tuple(g.shape[3:]))
    rs = _ungroup(blocks.sum(1, dtype=x.dtype), mesh, inner_axis)  # unit j: block j
    shard = psum(rs, mesh, outer_axis)
    return broadcast_exchange(shard, mesh, inner_axis, impl="xla").reshape(x.shape)


def hierarchical_psum_tree(tree: Any, mesh: Mesh, inner_axis: str, outer_axis: str) -> Any:
    """Hierarchical all-reduce of a tree of ``[S, ...]`` tensors
    (flatten, pad to the inner axis size, reduce, cut, reshape)."""
    A = mesh.size(inner_axis)

    def one(leaf: torch.Tensor) -> torch.Tensor:
        flat = leaf.reshape(leaf.shape[0], -1)
        m = flat.shape[1]
        pad = (-m) % A
        if pad:
            flat = torch.cat([flat, flat.new_zeros((flat.shape[0], pad))], dim=1)
        return hierarchical_psum(flat, mesh, inner_axis, outer_axis)[:, :m].reshape(leaf.shape)

    return tree_map(one, tree)


def flat_psum_tree(tree: Any, mesh: Mesh, axis_names: tuple[str, ...]) -> Any:
    """Baseline: one flat all-reduce over all of ``axis_names``."""
    return tree_map(
        lambda g: functools.reduce(lambda acc, ax: psum(acc, mesh, ax), axis_names, g),
        tree,
    )


# ----------------------------------------------------------------------------
# The process fabric: the pod axis across processes.
# ----------------------------------------------------------------------------
#
# A process holds ``Lp = pods_per_process`` whole pods; ``v = x.view(Lp, n,
# ...)``.  Messages go on the wire as raw bytes (any dtype, bool included),
# sums in their own dtype.  Gloo carries host memory: under it a CUDA
# tensor's message is staged through a pinned host buffer and copied back
# to the card on arrival, which is what a TCP network costs.  NCCL sends
# from and into the card's memory.

#: What this process has handed to the process fabric since the last
#: :func:`reset_pod_hop`: ``messages`` (each collective's buffer, each sent
#: message) and their ``bytes``.
POD_HOP = {"messages": 0, "bytes": 0}
#: The same bytes by the group's :attr:`Mesh.label` and kind, ``{label:
#: {kind: bytes}}``.  The kinds are the reference's names: ``all-reduce``
#: (:func:`_all_reduce`), ``all-gather`` (:func:`_all_gather`), ``all-to-all``
#: (:func:`_all_to_all`), ``collective-permute`` (the sends of :func:`_p2p`)
#: and ``reduce-scatter`` (:func:`_reduce_scatter`, the FSDP gradient's).
#: Each is also reported to an active op counter (:mod:`repro_torch.obs.cost`),
#: and each runs inside a ``torch.profiler.record_function("exchange.<kind>")``
#: span.
POD_HOP_GROUPS: dict[str, dict[str, int]] = {}


def pod_hop_kinds() -> dict[str, int]:
    """:data:`POD_HOP_GROUPS`' bytes by kind, over every group."""
    out: dict[str, int] = {}
    for by_kind in POD_HOP_GROUPS.values():
        for kind, nbytes in by_kind.items():
            out[kind] = out.get(kind, 0) + nbytes
    return out


def reset_pod_hop() -> None:
    POD_HOP.update(messages=0, bytes=0)
    POD_HOP_GROUPS.clear()


def _hop(t: torch.Tensor, kind: str, label: str = POD_AXIS) -> torch.Tensor:
    nbytes = t.numel() * t.element_size()
    POD_HOP["messages"] += 1
    POD_HOP["bytes"] += nbytes
    by_kind = POD_HOP_GROUPS.setdefault(label, {})
    by_kind[kind] = by_kind.get(kind, 0) + nbytes
    cost.collective(kind, nbytes)
    return t


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, flat and contiguous, where the backend reads them."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    return _host(b) if _staged(mesh, t) else b


def _wire_empty(mesh: Mesh, like: torch.Tensor, copies: int = 1) -> torch.Tensor:
    nbytes = like.numel() * like.element_size()
    if _staged(mesh, like):
        return torch.empty((copies, nbytes), dtype=torch.uint8, pin_memory=True)
    return torch.empty((copies, nbytes), dtype=torch.uint8, device=like.device)


def _unwire(b: torch.Tensor, like: torch.Tensor, lead: tuple = ()) -> torch.Tensor:
    """Bytes back into ``like``'s dtype, shape (after ``lead``) and device."""
    return b.to(like.device).view(like.dtype).reshape(lead + tuple(like.shape))


def _peer(mesh: Mesh, process: int) -> int:
    return dist.get_global_rank(mesh.group, process)


def _all_reduce(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    with record_function("exchange.all-reduce"):
        w = _host(t) if _staged(mesh, t) else t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(_hop(w, "all-reduce", mesh.label), op=op, group=mesh.group)
        return w.to(t.device)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``[R, *t.shape]``: every process's ``t``, in process order."""
    with record_function("exchange.all-gather"):
        out = _wire_empty(mesh, t, mesh.num_processes)
        dist.all_gather(list(out), _hop(_wire(mesh, t), "all-gather", mesh.label),
                        group=mesh.group)
        return _unwire(out, t, (mesh.num_processes,))


def _reduce_scatter(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t [R * m, ...]`` summed over the processes (in its own dtype),
    this process's ``m`` leading rows of the sum: one ``reduce_scatter``."""
    with record_function("exchange.reduce-scatter"):
        R = mesh.num_processes
        w = _host(t) if _staged(mesh, t) else t.contiguous()
        out = torch.empty((t.shape[0] // R,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=w.device, pin_memory=_staged(mesh, t))
        dist.reduce_scatter_tensor(out, _hop(w, "reduce-scatter", mesh.label), group=mesh.group)
        return out.to(t.device)


def _all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t [R, ...]``: row ``r`` goes to process ``r``; row ``r`` of the
    result came from process ``r``."""
    with record_function("exchange.all-to-all"):
        out = _wire_empty(mesh, t)[0]
        dist.all_to_all_single(out, _hop(_wire(mesh, t), "all-to-all"), group=mesh.group)
        return _unwire(out, t)


def _p2p(mesh: Mesh, sends: list, recvs: list) -> None:
    """One ``batch_isend_irecv``: ``sends`` are ``(process, tag, tensor)``,
    ``recvs`` ``(process, tag, destination view)``; each received message
    is copied into its view.  ``meta`` messages (the dry run, under a fake
    process group) go one op at a time: ``batch_isend_irecv`` asks the group
    for a backend of the tensors' device, which no group has for ``meta``."""
    with record_function("exchange.collective-permute"):
        ops, bufs = [], []
        for proc, tag, t in sends:
            ops.append(dist.P2POp(dist.isend, _hop(_wire(mesh, t), "collective-permute"),
                                  _peer(mesh, proc), mesh.group, tag))
        for proc, tag, dst in recvs:
            buf = _wire_empty(mesh, dst)[0]
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, _peer(mesh, proc), mesh.group, tag))
        if any(op.tensor.is_meta for op in ops):
            reqs = [op.op(op.tensor, op.peer, op.group, op.tag) for op in ops]
        else:
            reqs = dist.batch_isend_irecv(ops) if ops else []
        for req in reqs:
            req.wait()
        for (_proc, _tag, dst), buf in zip(recvs, bufs):
            dst.copy_(_unwire(buf, dst))


def _pod_view(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.reshape((mesh.pods_per_process, mesh.n) + tuple(x.shape[1:]))


def _pod_psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    v = _pod_view(x, mesh)
    total = _all_reduce(mesh, v.sum(0, dtype=x.dtype))  # [n, ...]
    return total.unsqueeze(0).expand_as(v).reshape(x.shape)


def _pod_all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The monolithic pod-axis all-to-all: one ``all_to_all_single``."""
    R, Lp = mesh.num_processes, mesh.pods_per_process
    rest = tuple(range(4, x.ndim + 2))
    v = x.reshape((Lp, mesh.n, R, Lp) + tuple(x.shape[2:]))
    got = _all_to_all(mesh, v.permute((2, 0, 1, 3) + rest))  # [R, Lp src, n, Lp dst]
    return got.permute((3, 2, 0, 1) + rest).reshape(x.shape)


def _pieces(t: torch.Tensor, num_chunks: int) -> list[torch.Tensor]:
    """A pod message ``[n, m, ...]`` as ``num_chunks`` sub-messages along
    ``m``."""
    if num_chunks == 1:
        return [t]
    sub = t.shape[1] // num_chunks
    return [t[:, c * sub:(c + 1) * sub] for c in range(num_chunks)]


def _pod_phases(
    x: torch.Tensor, mesh: Mesh, schedule: str, num_chunks: int = 1
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Per phase of ``make_schedule(num_pods, schedule)``, one
    ``batch_isend_irecv``: yields ``(got [S, ...], src [S])``, the chunk
    each local unit received from its phase source and that source's pod.
    A pair inside this process is a copy."""
    R, Lp, n, P = mesh.num_processes, mesh.pods_per_process, mesh.n, mesh.num_pods
    me, base = mesh.process_index, mesh.process_index * Lp
    v = x.reshape((Lp, n, P) + tuple(x.shape[2:]))
    for phase in make_schedule(P, schedule).phases:
        target = dict(phase)
        source = {b: a for a, b in phase}
        got = v.new_empty((Lp, n) + tuple(x.shape[2:]))
        sends, recvs = [], []
        for p in range(Lp):
            b = target[base + p]
            if b // Lp != me:
                sends += [(b // Lp, p * num_chunks + c, piece)
                          for c, piece in enumerate(_pieces(v[p, :, b], num_chunks))]
            a = source[base + p]
            if a // Lp == me:
                got[p] = v[a - base, :, base + p]
            else:
                recvs += [(a // Lp, (a % Lp) * num_chunks + c, piece)
                          for c, piece in enumerate(_pieces(got[p], num_chunks))]
        _p2p(mesh, sends, recvs)
        src = torch.tensor([source[base + p] for p in range(Lp)], device=x.device)
        yield got.reshape((Lp * n,) + tuple(x.shape[2:])), src.repeat_interleave(n)


def _pod_scheduled_all_to_all(
    x: torch.Tensor, mesh: Mesh, schedule: str, num_chunks: int
) -> torch.Tensor:
    y = torch.empty_like(x)
    unit = torch.arange(x.shape[0], device=x.device)
    own = axis_index(mesh, POD_AXIS, x.device)
    y[unit, own] = x[unit, own]  # own chunk stays put
    for got, src in _pod_phases(x, mesh, schedule, num_chunks):
        y[unit, src] = got
    return y


def _pod_hop(x: torch.Tensor, mesh: Mesh, schedule: str, num_chunks: int) -> torch.Tensor:
    """The pod-axis all-to-all over the process fabric: one
    ``all_to_all_single`` (``schedule="xla"``) or the schedule's phases."""
    if schedule == "xla":
        return _pod_all_to_all(x, mesh)
    return _pod_scheduled_all_to_all(x, mesh, schedule, num_chunks)


class _PodAllToAll(torch.autograd.Function):
    """The pod-axis all-to-all as an autograd op.  An all-to-all is its own
    adjoint (the message matrix transposes: ``y[s, j] = x_j[s]`` gives
    ``dx_j[s] = dy[s, j]``), so the backward is the same hop, over the same
    transport, on the gradient.  Every process runs the same graph, so the
    backward's collectives come in the same order on every process; a
    remat recompute issues the forward's again."""

    @staticmethod
    def forward(ctx, x, mesh, schedule, num_chunks):
        ctx.hop = (mesh, schedule, num_chunks)
        return _pod_hop(x, mesh, schedule, num_chunks)

    @staticmethod
    def backward(ctx, dy):
        return _pod_hop(dy.contiguous(), *ctx.hop), None, None, None


def _pod_ring_all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``num_pods - 1`` ring steps; in each, this process's last pod sends
    its current chunk to the next process's first pod."""
    R, Lp, P = mesh.num_processes, mesh.pods_per_process, mesh.num_pods
    me, base = mesh.process_index, mesh.process_index * Lp
    cur = _pod_view(x, mesh)
    y = cur.new_empty((Lp, mesh.n, P) + tuple(x.shape[1:]))
    for p in range(Lp):
        y[p, :, base + p] = cur[p]
    for k in range(1, P):
        first = torch.empty_like(cur[0])
        _p2p(mesh, [((me + 1) % R, 0, cur[Lp - 1])], [((me - 1) % R, 0, first)])
        cur = torch.cat([first[None], cur[:-1]])
        for p in range(Lp):
            y[p, :, (base + p - k) % P] = cur[p]  # after k hops: pod p - k's chunk
    return y.reshape((mesh.local_units, P) + tuple(x.shape[1:]))


def _pod_all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    g = _all_gather(mesh, _pod_view(x, mesh))  # [R, Lp, n, ...]
    g = g.reshape((mesh.num_pods, mesh.n) + tuple(x.shape[1:])).transpose(0, 1)
    lp = mesh.pods_per_process
    return g.unsqueeze(0).expand((lp,) + tuple(g.shape)).reshape(
        (mesh.local_units, mesh.num_pods) + tuple(x.shape[1:])
    )


def gather_units(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every unit's row of ``x [local_units, ...]``, ``[num_units, ...]`` in
    global unit order, on every process."""
    if mesh.num_processes == 1:
        return x
    return _all_gather(mesh, x).reshape((mesh.num_units,) + tuple(x.shape[1:]))


def unit_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x [local_units, ...]`` over ALL units, on every
    process: the same additions in the same order as one process holding
    the whole mesh."""
    return gather_units(x, mesh).sum(0, dtype=x.dtype)


# ----------------------------------------------------------------------------
# Hash shuffle: the decoupled exchange operator proper (paper §3.2 steps 1-7).
# ----------------------------------------------------------------------------

def _scatter_pack(
    dest: torch.Tensor,
    my_rank: torch.Tensor,
    counts_all: torch.Tensor,
    rows: torch.Tensor,
    num_dest: int,
    capacity: int,
    valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Within-destination ranks -> message buffers ``[S, num_dest, capacity,
    row...]``, counts ``[S, num_dest]`` and per-shard drops ``[S]``.

    Rows that are not kept all write zeros to one dump slot past the
    buffers, so the value left there does not depend on write order.
    """
    S, T = dest.shape
    row_shape = tuple(rows.shape[2:])
    per = num_dest * capacity
    counts = counts_all[:, :num_dest].clamp(max=capacity).to(torch.int32)
    keep = (my_rank < capacity) & valid & (dest < num_dest)
    shard = torch.arange(S, device=dest.device)[:, None]
    slot = torch.where(
        keep, shard * per + dest.long() * capacity + my_rank.long(), S * per
    )
    kept_rows = torch.where(keep.reshape((S, T) + (1,) * len(row_shape)), rows, 0)
    flat = rows.new_zeros((S * per + 1,) + row_shape)
    flat[slot.reshape(-1)] = kept_rows.reshape((S * T,) + row_shape)
    buffers = flat[:-1].view((S, num_dest, capacity) + row_shape)
    dropped = (valid & (dest < num_dest)).sum(1, dtype=torch.int32) - keep.sum(
        1, dtype=torch.int32
    )
    return buffers, counts, dropped


def _rank_by_destination(
    dest: torch.Tensor, num_dest: int, impl: PackImpl
) -> tuple[torch.Tensor, torch.Tensor]:
    """Arrival-order rank within each destination bin ``[S, T]`` + per-bin
    totals ``[S, num_dest + 1]``; invalid rows must already sit in the
    overflow bin ``num_dest``."""
    if impl == "cuda":
        return kernel_ops.partition_ranks(dest, num_dest + 1)
    if impl == "torch":
        # one block spanning all rows: block-local ranks are the global ranks
        hist, my_rank = partition_pack_ref(dest, num_dest + 1, block=dest.shape[1])
        return my_rank, hist[:, 0]
    raise ValueError(f"unknown pack impl {impl!r}")


def pack_by_destination(
    dest: torch.Tensor,
    rows: torch.Tensor,
    num_dest: int,
    capacity: int,
    valid: torch.Tensor | None = None,
    impl: PackImpl = "torch",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partition ``rows`` ``[S, T, ...]`` into per-destination message
    buffers (paper step 2): ``(buffers, counts, dropped)``."""
    if valid is None:
        valid = torch.ones(dest.shape, dtype=torch.bool, device=dest.device)
    dest = torch.where(valid, dest, num_dest).to(torch.int32)
    my_rank, counts_all = _rank_by_destination(dest, num_dest, impl)
    return _scatter_pack(dest, my_rank, counts_all, rows, num_dest, capacity, valid)


def hash_shuffle(
    keys: torch.Tensor,
    rows: torch.Tensor,
    mesh: Mesh,
    axis: str,
    capacity: int,
    impl: AllToAllImpl = "round_robin",
    valid: torch.Tensor | None = None,
    pack_impl: PackImpl = "torch",
    num_chunks: int = 1,
    transport_chunks: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partition by key hash, shuffle, reassemble, on every shard at once.

    ``keys`` ``[S, T]``, ``rows`` ``[S, T, ...]``.  Afterwards unit ``j`` of
    each axis group holds exactly the rows with ``hash(key) % n == j``.
    Returns ``(rows_out [S, n * capacity, ...], valid_out [S, n * capacity],
    dropped [S])`` with ``dropped`` summed over the axis group.

    ``num_chunks > 1`` splits the rows into that many chunks, each with
    ``capacity / num_chunks`` slots per destination, and packs chunk
    ``k + 1`` before chunk ``k`` ships; padding then sits at each chunk
    boundary.  ``transport_chunks`` splits each scheduled phase's message.
    With ``pack_impl="cuda"`` each chunk's pack is ONE kernel launch over
    all shards.
    """
    n = mesh.size(axis)
    S, T = keys.shape
    if valid is None:
        valid = torch.ones((S, T), dtype=torch.bool, device=keys.device)
    assert T % num_chunks == 0 and capacity % num_chunks == 0, (
        f"num_chunks={num_chunks} must divide rows={T} and capacity={capacity}"
    )
    cap_c = capacity // num_chunks
    assert cap_c % transport_chunks == 0, (
        f"transport_chunks={transport_chunks} must divide per-chunk capacity {cap_c}"
    )
    rows_c = T // num_chunks
    row_shape = tuple(rows.shape[2:])

    def pack(c: int):
        sl = slice(c * rows_c, (c + 1) * rows_c)
        keys_c, data_c, valid_c = keys[:, sl], rows[:, sl], valid[:, sl]
        if pack_impl == "cuda":
            dest, my_rank, counts_all = kernel_ops.hash_partition_ranks(
                keys_c, valid_c.to(torch.int32), n
            )
            return _scatter_pack(dest, my_rank, counts_all, data_c, n, cap_c, valid_c)
        dest = (fibonacci_hash(keys_c) % n).to(torch.int32)
        return pack_by_destination(dest, data_c, n, cap_c, valid=valid_c, impl=pack_impl)

    packed = pack(0)
    shuffled_chunks, counts_chunks = [], []
    dropped = torch.zeros(S, dtype=torch.int32, device=keys.device)
    for c in range(num_chunks):
        bufs, counts, dropped_c = packed
        if c + 1 < num_chunks:
            packed = pack(c + 1)
        shuffled_chunks.append(
            all_to_all(bufs, mesh, axis, impl=impl, num_chunks=transport_chunks)
        )
        counts_chunks.append(
            all_to_all(counts.reshape(S, n, 1), mesh, axis, impl=impl).reshape(S, n)
        )
        dropped = dropped + dropped_c

    slots = torch.arange(cap_c, device=keys.device)
    if num_chunks == 1:
        rows_out = shuffled_chunks[0].reshape((S, n * capacity) + row_shape)
        valid_out = (slots < counts_chunks[0][:, :, None]).reshape(S, n * capacity)
    else:
        stacked = torch.stack(shuffled_chunks, dim=2)  # [S, n, C, cap_c, row...]
        rows_out = stacked.reshape((S, n * capacity) + row_shape)
        counts_in = torch.stack(counts_chunks, dim=2)  # [S, n, C]
        valid_out = (slots < counts_in[..., None]).reshape(S, n * capacity)
    return rows_out, valid_out, psum(dropped, mesh, axis)


def hash_shuffle_spill(
    keys: torch.Tensor,
    rows: torch.Tensor,
    mesh: Mesh,
    axis: str,
    capacity: int,
    impl: AllToAllImpl = "round_robin",
    valid: torch.Tensor | None = None,
    pack_impl: PackImpl = "torch",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exchange that reports overflow instead of dropping it.

    Same wire layout as single-chunk :func:`hash_shuffle`, but a row whose
    within-destination arrival rank reaches ``capacity`` is withheld on the
    sender: the third return value is a sender-local ``spilled [S, T]``
    mask.  The caller parks those rows in a host-memory overflow partition
    and re-offers them later, so every valid row is either delivered or
    flagged, never neither.  The rank pass runs on the sender before any
    data moves (paper §3.2 step 2), so ``rank >= capacity`` is exactly the
    overflow the fixed-size message pool would hit.  With
    ``pack_impl="cuda"`` the ranks come from one ``hash_partition_pack``
    launch over all shards.  Returns ``(rows_out [S, n * capacity, ...],
    valid_out [S, n * capacity], spilled [S, T])``.
    """
    n = mesh.size(axis)
    S, T = keys.shape
    if valid is None:
        valid = torch.ones((S, T), dtype=torch.bool, device=keys.device)
    if pack_impl == "cuda":
        dest, my_rank, counts_all = kernel_ops.hash_partition_ranks(
            keys, valid.to(torch.int32), n
        )
    else:
        dest = (fibonacci_hash(keys) % n).to(torch.int32)
        dest = torch.where(valid, dest, n).to(torch.int32)
        my_rank, counts_all = _rank_by_destination(dest, n, pack_impl)
    spilled = valid & (my_rank >= capacity)
    deliver = valid & ~spilled
    bufs, counts, _ = _scatter_pack(dest, my_rank, counts_all, rows, n, capacity, deliver)
    shuffled = all_to_all(bufs, mesh, axis, impl=impl)
    counts_in = all_to_all(counts.reshape(S, n, 1), mesh, axis, impl=impl).reshape(S, n)
    rows_out = shuffled.reshape((S, n * capacity) + tuple(rows.shape[2:]))
    slots = torch.arange(capacity, device=keys.device)
    valid_out = (slots < counts_in[:, :, None]).reshape(S, n * capacity)
    return rows_out, valid_out, spilled


# ----------------------------------------------------------------------------
# Two-level exchange: coarse cross-pod hop + fine in-pod shuffle (paper §3.1).
# ----------------------------------------------------------------------------

def hash_shuffle_two_level(
    keys: torch.Tensor,
    rows: torch.Tensor,
    mesh: Mesh,
    inner_axis: str,
    outer_axis: str,
    capacity: int,
    impl: AllToAllImpl = "round_robin",
    valid: torch.Tensor | None = None,
    pack_impl: PackImpl = "torch",
    num_chunks: int = 1,
    transport_chunks: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Globally repartition by key hash over a two-level (pod x inner) mesh.

    Hop 1 packs rows by destination POD (``hash % (P * n) // n``) and ships
    one coarse message per peer pod over ``outer_axis``; with
    ``pack_impl="cuda"`` its rank is one ``partition_pack`` launch over all
    shards.  Hop 2 is an ordinary :func:`hash_shuffle` over ``inner_axis``
    (``n`` divides ``P * n``, so ``hash % n`` is the in-pod owner).  Each row
    lands on the unit a flat ``hash % (P * n)`` shuffle would pick.
    ``capacity`` has flat-shuffle semantics; the output is ``[S, n * P *
    capacity]`` rows and ``dropped`` is a global count.
    """
    P = mesh.size(outer_axis)
    if P == 1:
        out_rows, out_valid, dropped = hash_shuffle(
            keys, rows, mesh, inner_axis, capacity, impl=impl, valid=valid,
            pack_impl=pack_impl, num_chunks=num_chunks,
            transport_chunks=transport_chunks,
        )
        return out_rows, out_valid, psum(dropped, mesh, outer_axis)
    n = mesh.size(inner_axis)
    N = P * n
    S, T = keys.shape
    if valid is None:
        valid = torch.ones((S, T), dtype=torch.bool, device=keys.device)

    # Hop 1: pack by destination pod, one rank computation for keys + rows.
    gdest = (fibonacci_hash(keys) % N).to(torch.int32)
    dest_pod = torch.where(valid, gdest // n, P).to(torch.int32)
    my_rank, counts_all = _rank_by_destination(dest_pod, P, pack_impl)
    # Scheduled transports use the shift schedule on the coarse hop (valid
    # for every P); "xla" keeps the monolithic baseline.
    hop1 = "xla" if impl == "xla" else "round_robin"
    if rows.ndim == 3 and rows.dtype == keys.dtype:
        # Keys ride as an extra leading column: one phase sequence over the
        # slow network instead of two.
        aug = torch.cat([keys[..., None], rows], dim=2)
        aug_bufs, counts, drop1 = _scatter_pack(
            dest_pod, my_rank, counts_all, aug, P, T, valid
        )
        aug_in = all_to_all(aug_bufs, mesh, outer_axis, impl=hop1)
        keys_in, rows_in = aug_in[..., 0], aug_in[..., 1:]
    else:
        key_bufs, counts, drop1 = _scatter_pack(
            dest_pod, my_rank, counts_all, keys, P, T, valid
        )
        row_bufs, _, _ = _scatter_pack(
            dest_pod, my_rank, counts_all, rows, P, T, valid
        )
        keys_in = all_to_all(key_bufs, mesh, outer_axis, impl=hop1)
        rows_in = all_to_all(row_bufs, mesh, outer_axis, impl=hop1)
    counts_in = all_to_all(counts.reshape(S, P, 1), mesh, outer_axis, impl=hop1)
    valid_in = (
        torch.arange(T, device=keys.device) < counts_in.reshape(S, P)[:, :, None]
    ).reshape(S, P * T)

    # Hop 2: ordinary in-pod shuffle.
    out_rows, out_valid, drop2 = hash_shuffle(
        keys_in.reshape(S, P * T),
        rows_in.reshape((S, P * T) + tuple(rows_in.shape[3:])),
        mesh,
        inner_axis,
        capacity * P,
        impl=impl,
        valid=valid_in,
        pack_impl=pack_impl,
        num_chunks=num_chunks,
        transport_chunks=transport_chunks,
    )
    # drop2 is already summed over the inner axis; lift both to global.
    dropped = psum(psum(drop1, mesh, inner_axis), mesh, outer_axis)
    dropped = dropped + psum(drop2, mesh, outer_axis)
    return out_rows, out_valid, dropped


# ----------------------------------------------------------------------------
# Generic two-level dispatch/combine: the token-routing fabric (paper §3.1).
# ----------------------------------------------------------------------------

def _hop1_impl(impl: AllToAllImpl) -> AllToAllImpl:
    """Coarse-hop transport: shift phases are valid for every pod count
    (one_factorization needs even n), xla keeps the monolithic baseline."""
    return "xla" if impl == "xla" else "round_robin"


def dispatch_two_level(
    x: torch.Tensor,
    mesh: Mesh,
    inner_axis: str,
    outer_axis: str,
    impl: AllToAllImpl = "round_robin",
    num_chunks: int = 1,
) -> torch.Tensor:
    """All-to-all over the JOINT ``(outer, inner)`` axis, as two hops.

    ``x [S, N, ...]`` with ``N = P * n``: ``x[s, q * n + j]`` is unit
    ``s``'s chunk for pod ``q``'s unit ``j``; the result's ``[s, q * n + j]``
    is the chunk ``s`` received from that unit, the contract of a flat
    all-to-all over the joint axis.  Hop 1 ships ONE coarse message per peer
    pod over ``outer_axis``; hop 2 delivers each sub-chunk to its in-pod
    owner over ``inner_axis`` (``num_chunks`` splits hop 2's flattened
    messages).  Both hops are pure permutations, so the result is
    bit-identical to the flat route for every dtype.
    """
    P = mesh.size(outer_axis)
    n = mesh.size(inner_axis)
    if P == 1:
        return all_to_all(x, mesh, inner_axis, impl=impl, num_chunks=num_chunks)
    S, N = x.shape[:2]
    assert N == P * n, f"message dim {N} != joint axis size {P} * {n}"
    rest = tuple(x.shape[2:])
    # Hop 1 (coarse): everything destined for pod q, contiguous.
    h = all_to_all(x.reshape((S, P, n) + rest), mesh, outer_axis, impl=_hop1_impl(impl))
    # h[s, q, j] = chunk from pod q (same inner index) for (my pod, j).
    h2 = h.transpose(1, 2).reshape(S, n, -1)
    # Hop 2 (fine): deliver to the in-pod owner j.
    g = all_to_all(h2, mesh, inner_axis, impl=impl, num_chunks=num_chunks)
    # g[s, j, q] = chunk from (q, j) for me; restore the flat (q, j) order.
    return g.reshape((S, n, P) + rest).transpose(1, 2).reshape((S, N) + rest)


def combine_two_level(
    x: torch.Tensor,
    mesh: Mesh,
    inner_axis: str,
    outer_axis: str,
    impl: AllToAllImpl = "round_robin",
    num_chunks: int = 1,
) -> torch.Tensor:
    """The return trip of :func:`dispatch_two_level` (same flat all-to-all
    contract) with the hops mirrored: fine in-pod first, then ONE coarse
    message per peer pod.  Also a pure permutation."""
    P = mesh.size(outer_axis)
    n = mesh.size(inner_axis)
    if P == 1:
        return all_to_all(x, mesh, inner_axis, impl=impl, num_chunks=num_chunks)
    S, N = x.shape[:2]
    assert N == P * n, f"message dim {N} != joint axis size {P} * {n}"
    rest = tuple(x.shape[2:])
    # Hop 1 (fine): group by destination inner index, shuffle in-pod.
    x3 = x.reshape((S, P, n) + rest).transpose(1, 2).reshape(S, n, -1)
    g = all_to_all(x3, mesh, inner_axis, impl=impl, num_chunks=num_chunks)
    # g[s, j, q] -> h[s, q, j]: everything destined for pod q, contiguous.
    h = g.reshape((S, n, P) + rest).transpose(1, 2)
    # Hop 2 (coarse): one message per peer pod.
    out = all_to_all(h, mesh, outer_axis, impl=_hop1_impl(impl))
    return out.reshape((S, N) + rest)


__all__ = [
    "AllToAllImpl",
    "PackImpl",
    "SHUFFLE_AXIS",
    "POD_AXIS",
    "Mesh",
    "live_processes",
    "make_mesh",
    "axis_index",
    "psum",
    "xla_all_to_all",
    "scheduled_all_to_all",
    "scheduled_all_to_all_consume",
    "all_to_all",
    "ring_all_gather",
    "broadcast_exchange",
    "hierarchical_psum",
    "hierarchical_psum_tree",
    "flat_psum_tree",
    "gather_units",
    "unit_sum",
    "POD_HOP",
    "POD_HOP_GROUPS",
    "pod_hop_kinds",
    "reset_pod_hop",
    "fibonacci_hash",
    "pack_by_destination",
    "hash_shuffle",
    "hash_shuffle_spill",
    "hash_shuffle_two_level",
    "dispatch_two_level",
    "combine_two_level",
]
