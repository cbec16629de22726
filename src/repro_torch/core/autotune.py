"""Topology-driven knob planner for the communication multiplexer.

Port of the mesh-free half of ``repro.core.autotune``: every legal
:class:`~repro_torch.core.multiplexer.CommMultiplexer` configuration is
priced with the :mod:`~repro_torch.core.topology` cost model and the knob
setting with the least modeled shuffle makespan wins.  It needs no device,
so the planner's ``explain()`` stays deterministic.

The knobs, for one exchange of ``rows`` packed rows of ``row_bytes`` each
over a shuffle axis of ``n`` units:

* ``impl`` — scheduled shift phases (``"round_robin"``), bidirectional
  pairing (``"one_factorization"``, even ``n``), or the monolithic
  ``"xla"`` all-to-all (one launch, contention-degraded wire time);
* ``pack_impl`` — ``"torch"`` one-hot/cumsum (O(rows x n) HBM traffic) vs
  the fused ``"cuda"`` partition+pack kernel (O(rows));
* ``pipeline_chunks`` (``C``) — pack chunk ``k + 1`` while chunk ``k``
  ships;
* ``transport_chunks`` (``t``) — split each phase message into ``t``
  independent sends.

    makespan(C) = C * (pack_c + ship_c)
                  - (C - 1) * (1 - 1 / n_dma) * min(pack_c, ship_c)

The constants are the reference's TPU (``topology.V5E``): the port uses
them so that it plans exactly as the reference does, and its ``modeled_s``
is a TPU figure, not an H100 prediction.  :func:`tune_multiplexer` takes
its shuffle axis and pod count from a simulated mesh; :func:`ep_capacity`
and :func:`decode_table_stats` size and describe the MoE layer's per-step
dispatch.  Left for later slices: the live mesh probing (``refine=True``,
``measure_shuffle_config``, ``calibrate_chip``) and the EP layer pricing
(``tune_ep_dispatch``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .hybrid import plan_for_mesh
from .topology import ChipSpec, PACK_IMPLS, V5E, pack_time, pod_broadcast_time, shuffle_time

PIPELINE_CANDIDATES = (1, 2, 4, 8)
TRANSPORT_CANDIDATES = (1, 2, 4)


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Shape summary of one exchange, as seen by a single parallel unit.

    ``rows`` is the per-unit row count entering the shuffle, which under the
    zero-drop capacity bound is also the per-destination message capacity;
    ``row_bytes`` the packed row width (int32 columns x 4).
    """

    rows: int
    row_bytes: int

    def __post_init__(self):
        assert self.rows >= 0 and self.row_bytes > 0, (self.rows, self.row_bytes)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """A multiplexer knob setting plus the model's view of it.

    ``candidates`` holds every evaluated ``(impl, pack_impl, pipeline_chunks,
    transport_chunks, modeled_s)`` tuple, best first.  ``cross_pod`` (pod
    meshes only) says how a broadcast-style join's build side crosses the
    pod axis: ``"broadcast"`` or ``"reshard"``.
    """

    impl: str
    pack_impl: str
    pipeline_chunks: int
    transport_chunks: int
    modeled_s: float
    candidates: tuple = ()
    cross_pod: str | None = None
    cross_pod_modeled_s: dict | None = None


def ep_capacity(
    tokens_per_shard: int, top_k: int, num_experts: int, capacity_factor: float
) -> int:
    """Per-expert message-buffer capacity (the paper's fixed-size reusable
    pool): ``ceil(capacity_factor * fair_share)`` with a floor of 4.

    The one definition: the MoE layer sizes its dispatch buffers with it and
    :func:`decode_table_stats` prices them with it.
    """
    fair = tokens_per_shard * top_k / num_experts
    return max(int(math.ceil(capacity_factor * fair)), 4)


def decode_table_stats(cfg, batch_size: int, num_shards: int) -> TableStats:
    """Shape of the EP token dispatch for ONE decode step, per parallel unit.

    Each unit packs ``batch_size / num_shards`` tokens x ``top_k`` choices
    into its ``E x C`` per-expert capacity buffers (``C`` from
    :func:`ep_capacity`) and ships those: ``rows = E * C`` rows of
    ``d_model`` activations in the compute dtype.  ``cfg`` is duck-typed
    (``num_experts``/``top_k``/``capacity_factor``/``d_model``/``dtype``).
    """
    E = int(getattr(cfg, "num_experts", 0) or 1)
    k = int(getattr(cfg, "top_k", 0) or 1)
    t_loc = max(1, batch_size // max(num_shards, 1))
    C = ep_capacity(t_loc, k, E, float(getattr(cfg, "capacity_factor", 1.0)))
    itemsize = _DTYPE_BYTES[str(getattr(cfg, "dtype", "float32"))]
    return TableStats(rows=E * C, row_bytes=int(cfg.d_model) * itemsize)


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def exchange_makespan(
    stats: TableStats,
    n: int,
    impl: str = "round_robin",
    pack_impl: str = "torch",
    pipeline_chunks: int = 1,
    transport_chunks: int = 1,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    num_pods: int = 1,
    skew: float = 1.0,
) -> float:
    """Modeled end-to-end time of one decoupled exchange (pack + shuffle).

    ``num_pods > 1`` prices the two-level exchange: a coarse cross-pod hop
    (pack by destination pod, ``num_pods - 1`` DCI phases) followed by the
    in-pod shuffle over the ``num_pods``-fold received buffer.  ``skew`` is
    ``max_partition_load / fair_share`` of the max-loaded shard (1.0 =
    balanced): wire time scales with the slowest receiver.
    """
    if skew < 1.0:
        raise ValueError(f"skew is max/fair-share and must be >= 1.0: {skew}")
    if n <= 1 and num_pods <= 1:
        return 0.0
    if stats.rows == 0:
        return 0.0
    hop1 = 0.0
    if num_pods > 1:
        hop1_impl = "xla" if impl == "xla" else "round_robin"
        pod_msg = -(-stats.rows // num_pods) * stats.row_bytes
        hop1 = pack_time(stats.rows, stats.row_bytes, num_pods, chip, pack_impl)
        hop1 += skew * shuffle_time(
            num_pods, pod_msg, chip, hop1_impl, 1, "switch", network="dci"
        )
        hop1 += shuffle_time(num_pods, 4, chip, hop1_impl, 1, "switch",
                             network="dci")
        stats = TableStats(rows=stats.rows * num_pods,
                           row_bytes=stats.row_bytes)
        if n <= 1:
            return hop1
    C = pipeline_chunks
    assert stats.rows % C == 0, (stats.rows, C)
    rows_c = stats.rows // C
    assert rows_c % transport_chunks == 0, (rows_c, transport_chunks)
    pack_c = pack_time(rows_c, stats.row_bytes, n, chip, pack_impl)
    ship_c = skew * shuffle_time(
        n, rows_c * stats.row_bytes, chip, impl, transport_chunks, topology
    )
    # Each chunk also ships the [n] per-destination counts (4 B messages).
    ship_c += shuffle_time(n, 4, chip, impl, 1, topology)
    n_dma = 1 if impl == "xla" else (n - 1) * transport_chunks
    overlap_frac = 0.0 if (C == 1 or n_dma <= 1) else 1.0 - 1.0 / n_dma
    inner = C * (pack_c + ship_c) - (C - 1) * overlap_frac * min(pack_c, ship_c)
    return hop1 + inner


def pod_strategy_times(
    build: TableStats,
    n: int,
    num_pods: int,
    chip: ChipSpec = V5E,
    topology: str = "ring",
) -> dict:
    """Modeled cost of each way to deliver a join's build side on a pod mesh:
    ``"broadcast"`` (in-pod ring all-gather, then each pod's aggregate over
    DCI to every other pod) vs ``"reshard"`` (a two-level hash exchange)."""
    local_bytes = build.rows * build.row_bytes
    in_pod_gather = (n - 1) * local_bytes / chip.ici_link_bandwidth + (
        max(n - 1, 0)
    ) * chip.ici_launch_latency
    broadcast = in_pod_gather + pod_broadcast_time(
        num_pods, n * local_bytes, chip
    )
    reshard = exchange_makespan(
        build, n, chip=chip, topology=topology, num_pods=num_pods
    )
    return {"broadcast": broadcast, "reshard": reshard}


def candidate_configs(
    n: int, stats: Sequence[TableStats]
) -> list[tuple[str, str, int, int]]:
    """Every legal knob setting for these exchanges on an ``n``-unit axis.

    ``pipeline_chunks`` must divide every exchange's row count (one
    multiplexer serves the whole query) and ``transport_chunks`` every
    per-chunk capacity; ``one_factorization`` needs even ``n``.
    """
    g = math.gcd(*[s.rows for s in stats]) if stats else 1
    impls = ["round_robin", "xla"]
    if n >= 2 and n % 2 == 0:
        impls.insert(1, "one_factorization")
    out = []
    for C in PIPELINE_CANDIDATES:
        if g % C:
            continue
        for t in TRANSPORT_CANDIDATES:
            if (g // C) % t:
                continue
            for impl in impls:
                if impl == "xla" and (C > 1 or t > 1):
                    # chunking buys nothing on the monolithic transport
                    continue
                for pack_impl in PACK_IMPLS:
                    out.append((impl, pack_impl, C, t))
    return out


def tune_config(
    n: int,
    table_stats: TableStats | Sequence[TableStats],
    num_pods: int = 1,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    broadcast_stats: TableStats | None = None,
) -> TunedConfig:
    """Analytic argmin over multiplexer knobs for an ``n``-unit shuffle axis.

    Everything the cost model needs is the shuffle-axis size, the pod count
    and the exchange shapes, so plan-time consumers (``explain()``) price a
    plan without any device.  Ties break toward fewer chunks, then by name.
    """
    stats = (
        (table_stats,)
        if isinstance(table_stats, TableStats)
        else tuple(table_stats)
    )
    cross_pod = cross_pod_times = None
    if num_pods > 1 and broadcast_stats is not None:
        cross_pod_times = pod_strategy_times(
            broadcast_stats, n, num_pods, chip, topology
        )
        cross_pod = min(cross_pod_times, key=cross_pod_times.get)
    if n <= 1 or not stats or all(s.rows == 0 for s in stats):
        return TunedConfig(
            "round_robin", "torch", 1, 1, 0.0,
            cross_pod=cross_pod, cross_pod_modeled_s=cross_pod_times,
        )

    scored = []
    for impl, pack_impl, C, t in candidate_configs(n, stats):
        total = sum(
            exchange_makespan(
                s, n, impl, pack_impl, C, t, chip, topology, num_pods
            )
            for s in stats
        )
        scored.append((total, C, t, impl, pack_impl))
    scored.sort(key=lambda r: (r[0], r[1], r[2], r[3], r[4]))
    candidates = tuple(
        (impl, pack_impl, C, t, total) for total, C, t, impl, pack_impl in scored
    )
    total, C, t, impl, pack_impl = scored[0]
    return TunedConfig(
        impl=impl,
        pack_impl=pack_impl,
        pipeline_chunks=C,
        transport_chunks=t,
        modeled_s=total,
        candidates=candidates,
        cross_pod=cross_pod,
        cross_pod_modeled_s=cross_pod_times,
    )


def _shuffle_axis(mesh) -> tuple[str | None, int, int]:
    """The mesh's shuffle axis (largest small-network axis) and pod count."""
    plan = plan_for_mesh(mesh.axis_names, mesh.shape)
    best, size, pods = None, 1, 1
    for ax, s in zip(mesh.axis_names, mesh.shape):
        if ax in plan.large_axes:
            pods *= int(s)
        elif s > size:
            best, size = ax, s
    return best, size, pods


def tune_multiplexer(
    mesh, table_stats: TableStats | Sequence[TableStats], refine: bool = False
) -> TunedConfig:
    """The knobs that minimise the modeled makespan of these exchanges on
    a simulated :class:`~repro_torch.core.exchange.Mesh`: its largest
    small-network axis is the shuffle axis, and a two-level mesh prices the
    two-level exchange.  ``refine=True`` (timing the best candidates on a
    live mesh) raises: mesh probing comes with a later slice.
    """
    if refine:
        raise NotImplementedError(
            "tune_multiplexer(refine=True) probes a live mesh; it comes with the "
            "multi-process fabric slice (ROADMAP A.10)"
        )
    axis, n, num_pods = _shuffle_axis(mesh)
    return tune_config(n if axis is not None else 1, table_stats, num_pods=num_pods)


__all__ = [
    "TableStats",
    "TunedConfig",
    "ep_capacity",
    "decode_table_stats",
    "tune_multiplexer",
    "exchange_makespan",
    "pod_strategy_times",
    "candidate_configs",
    "tune_config",
]
