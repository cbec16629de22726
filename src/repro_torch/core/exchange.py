"""Decoupled exchange operators on a simulated fabric (paper §3.2).

Port of ``repro.core.exchange``.  The reference runs a per-device body under
``shard_map`` and moves data with collectives; here every tensor carries an
explicit leading shard dim ``S`` and the collectives are tensor operations
in one card's memory.  On a two-level mesh ``S = P * n`` in mesh device
order (pod-major), so ``x.view(P, n, ...)`` gives back the pod and in-pod
axes.  The fabric moves bytes through the card's memory, not over a
network: it reproduces the reference's per-device results, not its network.

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

The scheduled transports keep their phase structure, so a later
``torch.distributed`` backend can fill each phase with real sends.

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
from typing import Literal

import torch

from ..kernels import ops as kernel_ops
from ..kernels.ref import fibonacci_hash, partition_pack_ref
from .schedule import make_schedule

AllToAllImpl = Literal["xla", "round_robin", "one_factorization"]
PackImpl = Literal["torch", "cuda"]

SHUFFLE_AXIS = "q"  # the in-pod (fast network) exchange axis
POD_AXIS = "pod"  # the network in the large


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The simulated mesh: ``num_pods x n`` units, pod-major."""

    num_pods: int
    n: int

    @property
    def num_units(self) -> int:
        return self.num_pods * self.n

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


def make_mesh(num_shards: int, num_pods: int = 1) -> Mesh:
    if num_shards % num_pods:
        raise ValueError(
            f"num_shards={num_shards} does not split across num_pods={num_pods}"
        )
    return Mesh(num_pods, num_shards // num_pods)


def _group(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``[S, ...]`` -> ``[G, A, ...]``: ``A`` units of each axis group."""
    v = x.reshape((mesh.num_pods, mesh.n) + tuple(x.shape[1:]))
    return v if axis == SHUFFLE_AXIS else v.transpose(0, 1)


def _ungroup(y: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if axis == POD_AXIS:
        y = y.transpose(0, 1)
    return y.reshape((mesh.num_units,) + tuple(y.shape[2:]))


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over the axis group; every member receives the total."""
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


# ----------------------------------------------------------------------------
# Broadcast exchange (paper §3.1: broadcast joins).
# ----------------------------------------------------------------------------

def ring_all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every unit ends with all ``A`` chunks of its axis group, over ``A - 1``
    single-shift ring phases: ``[S, ...]`` -> ``[S, A, ...]``, where
    ``y[s, j]`` is unit ``j``'s chunk."""
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
        g = _group(x, mesh, axis)
        A = mesh.size(axis)
        return _ungroup(g[:, None].expand((g.shape[0], A) + tuple(g.shape[1:])), mesh, axis)
    raise ValueError(f"unknown broadcast impl {impl!r}")


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
    "make_mesh",
    "psum",
    "xla_all_to_all",
    "scheduled_all_to_all",
    "all_to_all",
    "ring_all_gather",
    "broadcast_exchange",
    "fibonacci_hash",
    "pack_by_destination",
    "hash_shuffle",
    "hash_shuffle_spill",
    "hash_shuffle_two_level",
    "dispatch_two_level",
    "combine_two_level",
]
