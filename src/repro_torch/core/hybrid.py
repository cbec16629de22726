"""Hybrid-parallelism planner (paper §3.1-3.2); a verbatim port of
``repro.core.hybrid`` — pure Python, no tensors.

Encodes the paper's quantitative case for distinguishing the *network in the
small* from the *network in the large*, and decides — per mesh — which
collective strategy each model/relational component uses.

Paper cost model (n servers, t threads each):

===============================  ====================  ==================
quantity                          classic exchange      hybrid (this work)
===============================  ====================  ==================
parallel units                    ``n * t``             ``n``
connections in the cluster        ``n^2 t^2 - t``       ``n (n - 1)``
buffers per exchange operator     ``n t - 1``           ``n - 1``
broadcast-join threshold          ``n t - 1`` (239x)    ``n - 1`` (5x)
===============================  ====================  ==================

On TPU: "server" -> pod (or, single-pod, the device row along the `data`
axis), "thread" -> per-chip lanes.  The planner's job is to keep fine-grained
parallelism (TP/morsels) strictly inside the fast network level and run the
shuffle between coarse units only.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from .topology import ClusterSpec, V5E


# ----------------------------------------------------------------------------
# Paper §3.1 cost model — exact formulas, reproduced in bench_connections.
# ----------------------------------------------------------------------------

def classic_parallel_units(n: int, t: int) -> int:
    return n * t


def hybrid_parallel_units(n: int, t: int) -> int:
    del t
    return n


def classic_connections(n: int, t: int) -> int:
    """Every exchange operator connects to every other: n^2 t^2 - t.

    (The paper counts, for each of the ``n*t`` operators, ``n*t - 1`` peer
    connections but de-duplicates only the self-server loopback term,
    yielding exactly ``n^2 t^2 - t`` = 57,560 for n=6, t=40.)
    """
    return n * n * t * t - t


def hybrid_connections(n: int, t: int) -> int:
    """Only multiplexers are connected: n (n - 1) = 30 for n=6."""
    del t
    return n * (n - 1)


def classic_buffers_per_operator(n: int, t: int) -> int:
    return n * t - 1


def hybrid_buffers_per_operator(n: int, t: int) -> int:
    del t
    return n - 1


def broadcast_threshold(n: int, t: int, hybrid: bool) -> int:
    """Max size ratio (small:large input) at which broadcast still wins.

    A broadcast join sends the small side once to each peer *unit*; hybrid
    parallelism has n-1 peers instead of n*t-1, so broadcast applies to much
    less lopsided joins (5x vs 239x on the paper's cluster).
    """
    return (n - 1) if hybrid else (n * t - 1)


# ----------------------------------------------------------------------------
# Two-level mesh policy.
# ----------------------------------------------------------------------------

CollectiveStrategy = Literal["flat", "hierarchical"]
ExchangeStrategy = Literal["xla", "round_robin"]


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """Which network level carries which traffic class.

    - ``small_axes``: mesh axes inside the fast network (ICI) — TP, EP,
      sequence parallelism, relational shuffles live here.
    - ``large_axes``: mesh axes across the slow network (DCI) — only
      coarse-grained, bandwidth-frugal traffic (DP gradient sync) crosses it.
    """

    small_axes: tuple[str, ...]
    large_axes: tuple[str, ...]
    grad_sync: CollectiveStrategy
    exchange: ExchangeStrategy
    cluster: ClusterSpec

    @property
    def pod_axis(self) -> str | None:
        """The mesh axis crossing the slow network, if any."""
        return self.large_axes[0] if self.large_axes else None

    @property
    def num_pods(self) -> int:
        return self.cluster.num_pods

    def validate_axis_for_alltoall(self, axis: str) -> None:
        """Fine-grained shuffles must never cross the network in the large.

        Cross-pod traffic is only legal at coarse granularity — one message
        per pod pair (the two-level exchange's first hop, hierarchical
        gradient sync, broadcast of small build sides).  Routing a
        per-destination-device shuffle over a ``large_axes`` member would
        re-create the classic exchange's ``n^2 t^2`` connection blow-up on
        the slowest network, so it is rejected at plan level.
        """
        if axis in self.large_axes:
            raise ValueError(
                f"all-to-all over large-network axis {axis!r}: the hybrid plan "
                "forbids fine-grained shuffles across the slow network "
                "(paper §3.2: exchanges run between coarse units only; use "
                "the two-level hash_shuffle_global for a global repartition)"
            )


def plan_for_mesh(
    axis_names: tuple[str, ...],
    axis_sizes: tuple[int, ...],
    exchange: ExchangeStrategy = "round_robin",
) -> HybridPlan:
    """Derive the hybrid plan from mesh axis names.

    Convention (launch/mesh.py): a leading ``pod`` axis is the network in the
    large; everything else (``data``, ``model``) is in the small.  Single-pod
    meshes have no large axis and gradient sync stays flat (pure ICI).
    """
    names = tuple(axis_names)
    large = tuple(a for a in names if a == "pod")
    small = tuple(a for a in names if a != "pod")
    sizes = dict(zip(axis_names, axis_sizes))
    cluster = ClusterSpec(
        chip=V5E,
        chips_per_pod=int(
            __import__("math").prod(sizes[a] for a in small) if small else 1
        ),
        num_pods=int(sizes.get("pod", 1)),
    )
    return HybridPlan(
        small_axes=small,
        large_axes=large,
        grad_sync="hierarchical" if large else "flat",
        exchange=exchange,
        cluster=cluster,
    )


__all__ = [
    "classic_parallel_units",
    "hybrid_parallel_units",
    "classic_connections",
    "hybrid_connections",
    "classic_buffers_per_operator",
    "hybrid_buffers_per_operator",
    "broadcast_threshold",
    "HybridPlan",
    "plan_for_mesh",
]
