"""The mesh context the model code reads (port of ``repro.distributed.sharding``).

The reference's :class:`MeshContext` wraps a JAX device mesh with logical-
axis sharding rules, and ``shard()`` tags activations for GSPMD.  The port
runs every parallel unit as a slice of a tensor's leading dim, so its
context wraps the :class:`~repro_torch.core.exchange.Mesh` (``num_pods x
n`` units, pod-major, possibly spanning processes) and names the exchange
axis, the pod axis and the data-parallel axes; the sharding rules,
``shard()`` and the context's ``exchange_impl`` (which no model code reads)
have no counterpart.  The expert-parallel MoE
layer reads the context to lay tokens and experts out over the units.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator

from ..core.exchange import POD_AXIS, SHUFFLE_AXIS, Mesh


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """What the model code needs to know about the simulated machine: the
    mesh, the axis its exchanges run over (the in-pod axis) and, on a
    two-level mesh, the pod axis.  Transports come from the model config or
    from an ambient multiplexer, never from here."""

    mesh: Mesh

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


__all__ = ["MeshContext", "current_mesh_context", "mesh_context"]
