"""The communication multiplexer (paper §3.2.2); port of ``repro.core.multiplexer``.

A thin object carrying the per-mesh communication policy — which schedule,
which pack, how the shuffle is chunked — so that the relational engine never
chooses transports itself (its exchange operators are "decoupled": they see
only this interface).  Knob values come from the plan-time tuner
(:func:`repro_torch.core.autotune.tune_config`) or from the caller.

* ``impl`` — ``"round_robin"`` (scheduled shift phases),
  ``"one_factorization"`` (bidirectional pairing) or ``"xla"`` (the
  monolithic all-to-all baseline).
* ``pack_impl`` — ``"torch"`` (plain one-hot/cumsum) or ``"cuda"`` (the
  hand-written pack kernels); bit-identical buffers, counts and drops.
* ``pipeline_chunks`` / ``transport_chunks`` — must divide the shuffle's
  rows and capacity (per-chunk capacity); a shuffle they do not divide runs
  unchunked, with a warning.

None of the knobs changes what is delivered, only how it is packed and
phased.  :meth:`CommMultiplexer.dispatch` / :meth:`~CommMultiplexer.combine`
carry the MoE layer's token routing over the same fabric,
:meth:`CommMultiplexer.hash_shuffle_spill` is the capacity-bounded exchange
of out-of-core streaming, and :func:`use_multiplexer` makes a multiplexer
ambient for code that cannot take one as an argument (the MoE layer inside
a model step).  :meth:`CommMultiplexer.shuffle_consume` folds a shuffle's
messages as they arrive and :meth:`CommMultiplexer.psum_tree` syncs
gradients, hierarchically on a two-level mesh.  On a mesh that spans
processes every pod-axis hop goes through ``torch.distributed`` (see
:mod:`repro_torch.core.exchange`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import warnings
from typing import Any, Callable, Iterator, Sequence

import torch

from . import exchange
from .exchange import Mesh
from .hybrid import HybridPlan, plan_for_mesh
from .schedule import make_schedule, verify_schedule
from .topology import ChipSpec, V5E


@dataclasses.dataclass(frozen=True)
class CommMultiplexer:
    """Per-mesh communication policy object."""

    plan: HybridPlan
    mesh: Mesh
    impl: exchange.AllToAllImpl = "round_robin"
    pack_impl: exchange.PackImpl = "torch"
    pipeline_chunks: int = 1
    transport_chunks: int = 1
    # Two-level meshes: how broadcast-style build sides cross the pod axis.
    cross_pod: str = "broadcast"

    def describe(self) -> dict:
        """JSON-able knob summary — what actually carries the traffic."""
        return dict(
            impl=str(self.impl),
            pack_impl=str(self.pack_impl),
            pipeline_chunks=int(self.pipeline_chunks),
            transport_chunks=int(self.transport_chunks),
            cross_pod=str(self.cross_pod),
            small_axes=list(self.plan.small_axes),
            large_axes=list(self.plan.large_axes),
            num_pods=int(self.plan.num_pods),
        )

    # -- token routing: the one exchange fabric -----------------------------

    def all_to_all(self, x: torch.Tensor, axis_name: str) -> torch.Tensor:
        """Flat all-to-all of ``x [S, A, m, ...]`` over ``axis_name`` under
        this policy's transport; ``transport_chunks`` splits dim 2."""
        self.plan.validate_axis_for_alltoall(axis_name)
        transport = self._resolve_transport(x.shape[2] if x.ndim >= 3 else 1)
        return exchange.all_to_all(x, self.mesh, axis_name, impl=self.impl, num_chunks=transport)

    def _resolve_transport(self, message_dim: int) -> int:
        """Transport sub-chunking that divides ``message_dim`` (else 1)."""
        transport = self.transport_chunks
        if transport > 1 and message_dim % transport:
            warnings.warn(
                f"transport_chunks={transport} does not divide message dim "
                f"{message_dim}; shipping whole messages",
                stacklevel=4,
            )
            transport = 1
        return transport

    def _route(self, two_level, x: torch.Tensor, axis_name: str) -> torch.Tensor:
        pod = self.plan.pod_axis
        if pod is None:
            return self.all_to_all(x, axis_name)
        self.plan.validate_axis_for_alltoall(axis_name)
        transport = self._resolve_transport(self.plan.num_pods * math.prod(x.shape[2:]))
        return two_level(x, self.mesh, axis_name, pod, impl=self.impl, num_chunks=transport)

    def dispatch(self, x: torch.Tensor, axis_name: str) -> torch.Tensor:
        """All-to-all token dispatch over the WHOLE mesh, pod axis included:
        :meth:`all_to_all` on a single-level mesh; on a two-level mesh
        ``x [S, N, ...]`` spans the joint ``(pod, axis_name)`` axis and takes
        :func:`~repro_torch.core.exchange.dispatch_two_level` (one coarse
        message per peer pod, then the fine in-pod all-to-all), bit-identical
        to the flat route."""
        return self._route(exchange.dispatch_two_level, x, axis_name)

    def combine(self, x: torch.Tensor, axis_name: str) -> torch.Tensor:
        """The return trip of :meth:`dispatch` (fine in-pod hop first, then
        one coarse message per peer pod); same contract."""
        return self._route(exchange.combine_two_level, x, axis_name)

    def shuffle_consume(
        self,
        x: torch.Tensor,
        axis_name: str,
        consume: Callable[[Any, torch.Tensor, torch.Tensor], Any],
        init: Any,
    ) -> Any:
        """Streaming shuffle: fold each message into ``consume(acc, chunk
        [S, ...], src [S])`` as its phase delivers it (see
        :func:`~repro_torch.core.exchange.scheduled_all_to_all_consume`);
        the ``"xla"`` transport has no phases, so it ships everything and
        then folds the chunks of sources ``0 .. A - 1`` in order."""
        self.plan.validate_axis_for_alltoall(axis_name)
        if self.impl == "xla":
            y = exchange.xla_all_to_all(x, self.mesh, axis_name)
            acc = init
            for j in range(x.shape[1]):
                acc = consume(acc, y[:, j], torch.full((x.shape[0],), j, device=x.device))
            return acc
        sched = "shift" if self.impl == "round_robin" else self.impl
        return exchange.scheduled_all_to_all_consume(
            x, self.mesh, axis_name, consume, init, schedule=sched
        )

    def _resolve_chunks(self, rows: int, capacity: int) -> tuple[int, int]:
        """Chunk knobs that actually divide this shuffle's shapes, warning
        and falling back (unchunked / whole messages) where they do not."""
        chunks = self.pipeline_chunks
        if chunks > 1 and (rows % chunks or capacity % chunks):
            warnings.warn(
                f"pipeline_chunks={chunks} does not divide rows={rows} / "
                f"capacity={capacity}; running this shuffle unchunked",
                stacklevel=3,
            )
            chunks = 1
        transport = self.transport_chunks
        if transport > 1 and (capacity // chunks) % transport:
            warnings.warn(
                f"transport_chunks={transport} does not divide per-chunk "
                f"capacity {capacity // chunks}; shipping whole messages",
                stacklevel=3,
            )
            transport = 1
        return chunks, transport

    def hash_shuffle(
        self,
        keys: torch.Tensor,
        rows: torch.Tensor,
        axis_name: str,
        capacity: int,
        valid: torch.Tensor | None = None,
    ):
        self.plan.validate_axis_for_alltoall(axis_name)
        chunks, transport = self._resolve_chunks(keys.shape[1], capacity)
        return exchange.hash_shuffle(
            keys, rows, self.mesh, axis_name, capacity, impl=self.impl,
            valid=valid, pack_impl=self.pack_impl, num_chunks=chunks,
            transport_chunks=transport,
        )

    def hash_shuffle_spill(
        self,
        keys: torch.Tensor,
        rows: torch.Tensor,
        axis_name: str,
        capacity: int,
        valid: torch.Tensor | None = None,
    ):
        """Capacity-bounded exchange that flags overflow instead of dropping.

        Returns ``(rows_out, valid_out, spilled)`` with ``spilled`` a
        sender-local ``[S, T]`` mask; the caller parks those rows in a
        host-memory overflow partition and drains them later
        (``relational.planner.stream``).  Single-level meshes only: on a pod
        mesh the streamed executor sizes messages for zero drop instead,
        because the two-level hop re-packs rows mid-flight and the sender
        can no longer name its spilled rows.
        """
        if self.plan.pod_axis is not None:
            raise NotImplementedError(
                "spill-capable exchange is single-level only; pod meshes "
                "must size streamed exchanges for zero drop"
            )
        self.plan.validate_axis_for_alltoall(axis_name)
        return exchange.hash_shuffle_spill(
            keys, rows, self.mesh, axis_name, capacity, impl=self.impl,
            valid=valid, pack_impl=self.pack_impl,
        )

    def broadcast(self, x: torch.Tensor, axis_name: str) -> torch.Tensor:
        impl = "xla" if self.impl == "xla" else "ring"
        return exchange.broadcast_exchange(x, self.mesh, axis_name, impl=impl)

    def hash_shuffle_global(
        self,
        keys: torch.Tensor,
        rows: torch.Tensor,
        axis_name: str,
        capacity: int,
        valid: torch.Tensor | None = None,
    ):
        """Repartition by key hash over the WHOLE mesh, pod axis included:
        :meth:`hash_shuffle` on a single-level mesh, the coarse-cross-pod +
        fine-in-pod route of :func:`~repro_torch.core.exchange.hash_shuffle_two_level`
        on a two-level one."""
        pod = self.plan.pod_axis
        if pod is None:
            return self.hash_shuffle(keys, rows, axis_name, capacity, valid)
        self.plan.validate_axis_for_alltoall(axis_name)
        chunks, transport = self._resolve_chunks(
            keys.shape[1] * self.plan.num_pods, capacity * self.plan.num_pods
        )
        return exchange.hash_shuffle_two_level(
            keys, rows, self.mesh, axis_name, pod, capacity, impl=self.impl,
            valid=valid, pack_impl=self.pack_impl, num_chunks=chunks,
            transport_chunks=transport,
        )

    def broadcast_global(self, x: torch.Tensor, axis_name: str) -> torch.Tensor:
        """Every unit ends with every unit's chunk, pods included: in-pod
        ring all-gather first, then one coarse all-gather over the pod axis.
        Result dims after the shard dim are ``[num_pods, n]`` on a two-level
        mesh, ``[n]`` otherwise (global unit order when flattened)."""
        y = self.broadcast(x, axis_name)
        pod = self.plan.pod_axis
        if pod is None:
            return y
        impl = "xla" if self.impl == "xla" else "ring"
        return exchange.broadcast_exchange(y, self.mesh, pod, impl=impl)

    # -- gradient sync (hybrid two-level vs flat) ---------------------------

    def psum_tree(self, tree: Any, data_axes: tuple[str, ...]) -> Any:
        """All-reduce a tree of ``[S, ...]`` gradients over the
        data-parallel axes: hierarchical (reduce-scatter in-pod, all-reduce
        across pods, all-gather in-pod) when the plan has a large-network
        axis among them, flat otherwise."""
        if self.plan.grad_sync == "hierarchical" and len(data_axes) >= 2:
            outer = [a for a in data_axes if a in self.plan.large_axes]
            inner = [a for a in data_axes if a not in self.plan.large_axes]
            if outer and inner:
                return exchange.hierarchical_psum_tree(tree, self.mesh, inner[0], outer[0])
        return exchange.flat_psum_tree(tree, self.mesh, data_axes)


# one_factorization->shift downgrade warnings already issued, keyed by the
# offending axis sizes.
_warned_odd_axis_sizes: set[tuple[int, ...]] = set()


def resolve_schedule_impl(
    impl: exchange.AllToAllImpl, small_axis_sizes: Sequence[int]
) -> exchange.AllToAllImpl:
    """Downgrade ``one_factorization`` (even axis sizes only) to the shift
    schedule on a mesh with an odd-sized shuffle axis, warning once per
    distinct set of odd sizes."""
    if impl == "one_factorization" and any(
        s > 1 and s % 2 for s in small_axis_sizes
    ):
        odd = tuple(s for s in small_axis_sizes if s > 1 and s % 2)
        if odd not in _warned_odd_axis_sizes:
            _warned_odd_axis_sizes.add(odd)
            warnings.warn(
                f"one_factorization schedules need even axis sizes, got "
                f"{list(odd)}; falling back to the round_robin (shift) "
                "schedule",
                stacklevel=3,
            )
        return "round_robin"
    return impl


def make_multiplexer(
    mesh: Mesh,
    impl: exchange.AllToAllImpl = "round_robin",
    pack_impl: exchange.PackImpl = "torch",
    pipeline_chunks: int = 1,
    transport_chunks: int = 1,
    cross_pod: str = "broadcast",
    auto: bool = False,
    table_stats=None,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    refine: bool = False,
    broadcast_stats=None,
) -> CommMultiplexer:
    """Build the multiplexer for a mesh; verifies every shuffle-axis
    schedule once (the paper's connection setup before query processing).

    With ``auto=True`` every knob, and on a two-level mesh the
    ``cross_pod`` build-side strategy, comes from
    :func:`repro_torch.core.autotune.tune_multiplexer` for ``table_stats``
    (one :class:`~repro_torch.core.autotune.TableStats` per exchange the
    multiplexer will carry) instead of from the arguments.
    ``broadcast_stats`` describes a broadcast-style join's build side, so
    the tuner can price cross-pod broadcast against reshard; ``chip`` and
    ``topology`` select the hardware model, and ``refine=True`` also times
    the best modeled candidates on the card.
    """
    if auto:
        from .autotune import tune_multiplexer

        if table_stats is None:
            raise ValueError(
                "make_multiplexer(auto=True) needs table_stats: the "
                "rows/row_bytes of the exchanges this multiplexer will carry"
            )
        tuned = tune_multiplexer(
            mesh, table_stats, chip=chip, topology=topology, refine=refine,
            broadcast_stats=broadcast_stats,
        )
        impl = tuned.impl
        pack_impl = tuned.pack_impl
        pipeline_chunks = tuned.pipeline_chunks
        transport_chunks = tuned.transport_chunks
        if tuned.cross_pod is not None:
            cross_pod = tuned.cross_pod
    plan = plan_for_mesh(
        mesh.axis_names, mesh.shape,
        exchange="xla" if impl == "xla" else "round_robin",
    )
    small_sizes = [
        size for ax, size in zip(mesh.axis_names, mesh.shape)
        if ax not in plan.large_axes
    ]
    impl = resolve_schedule_impl(impl, small_sizes)
    if impl != "xla":
        kind = "shift" if impl == "round_robin" else impl
        for size in small_sizes:
            if size > 1:
                verify_schedule(make_schedule(size, kind))
    if pack_impl not in ("torch", "cuda"):
        raise ValueError(f"unknown pack impl {pack_impl!r}")
    if cross_pod not in ("broadcast", "reshard"):
        raise ValueError(f"unknown cross_pod strategy {cross_pod!r}")
    return CommMultiplexer(
        plan=plan,
        mesh=mesh,
        impl=impl,
        pack_impl=pack_impl,
        pipeline_chunks=pipeline_chunks,
        transport_chunks=transport_chunks,
        cross_pod=cross_pod,
    )


# ----------------------------------------------------------------------------
# Ambient multiplexer: code that cannot take a mux argument (the MoE layer
# inside a model step) routes its exchanges through the session's policy.
# ----------------------------------------------------------------------------

_ACTIVE_MUX: contextvars.ContextVar[CommMultiplexer | None] = contextvars.ContextVar(
    "repro_torch_multiplexer", default=None
)


@contextlib.contextmanager
def use_multiplexer(mux: CommMultiplexer) -> Iterator[CommMultiplexer]:
    """Make ``mux`` the ambient multiplexer inside the with-block; the
    serving engine wraps admission and decode in it."""
    token = _ACTIVE_MUX.set(mux)
    try:
        yield mux
    finally:
        _ACTIVE_MUX.reset(token)


def current_multiplexer() -> CommMultiplexer | None:
    """The innermost :func:`use_multiplexer` mux, or None."""
    return _ACTIVE_MUX.get()


def donate_buffers(fn: Callable, argnums: tuple[int, ...]) -> Callable:
    """Message-pool discipline: reuse communication buffers across calls.

    The paper registers RDMA memory regions once and recycles them through
    a pool; the reference's analogue is XLA buffer donation.  PyTorch has
    no donation (a tensor lives while anything refers to it), so here the
    donation is explicit: each tensor result of ``fn`` is written into the
    storage of the first donated argument (in ``argnums`` order) with the
    same shape, dtype and device, and that argument is returned in its
    place.  Steady-state calls thus carry their results in the caller's
    buffers, and ``fn``'s transient outputs go back to the caching
    allocator's pool, which plays the registered message pool.  As under
    JAX, the caller must not read a donated argument after the call except
    through the result.
    """

    def donated(*args, **kwargs):
        out = fn(*args, **kwargs)
        free = [args[i] for i in argnums if isinstance(args[i], torch.Tensor)]

        def land(t):
            if not isinstance(t, torch.Tensor):
                return t
            for k, buf in enumerate(free):
                if (buf.shape, buf.dtype, buf.device) == (t.shape, t.dtype, t.device):
                    del free[k]
                    return buf.copy_(t)
            return t

        if isinstance(out, (tuple, list)):
            return type(out)(land(t) for t in out)
        return land(out)

    return donated


__all__ = [
    "CommMultiplexer",
    "make_multiplexer",
    "resolve_schedule_impl",
    "use_multiplexer",
    "current_multiplexer",
    "donate_buffers",
]
