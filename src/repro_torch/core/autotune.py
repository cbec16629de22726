"""Topology-driven knob planner for the communication multiplexer.

Port of ``repro.core.autotune``: every legal
:class:`~repro_torch.core.multiplexer.CommMultiplexer` configuration is
priced with the :mod:`~repro_torch.core.topology` cost model and the knob
setting with the least modeled shuffle makespan wins.

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

Two modes:

* **analytical** (default): the cost-model argmin, no device work, so the
  planner's ``explain()`` stays deterministic.  The default constants are
  the reference's TPU (``topology.V5E``): with them the port plans exactly
  as the reference does, and ``modeled_s`` is a TPU figure.
* **measured** (``refine=True``): :func:`measure_shuffle_config` times the
  best modeled candidates on the simulated fabric and the measured winner
  is kept.  :func:`calibrate_chip` fits the model's link and pack laws to
  the same fabric, which gives a ``ChipSpec`` whose prices are comparable
  to wall-clock on the device that runs it.

:func:`tune_multiplexer` takes its shuffle axis and pod count from a
simulated mesh; :func:`tune_shared_config` tunes one knob set over several
plans' exchanges (the query-serving engine's shared multiplexer);
:func:`ep_capacity`, :func:`decode_table_stats`, :func:`moe_expert_time`,
:func:`ep_dispatch_makespan` and :func:`tune_ep_dispatch` size and price
the MoE layer's per-step dispatch.  The mesh carries no device, so the
functions that measure take ``device`` (default: the card).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Sequence

from .hybrid import plan_for_mesh
from .schedule import make_schedule, schedule_ring_loads
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
    """A multiplexer knob setting plus the model's (and measurement's) view.

    ``candidates`` holds every evaluated ``(impl, pack_impl, pipeline_chunks,
    transport_chunks, modeled_s)`` tuple, best first; ``measured_s`` is the
    winner's measured wall under ``refine=True``.  ``cross_pod`` (pod
    meshes only) says how a broadcast-style join's build side crosses the
    pod axis: ``"broadcast"`` or ``"reshard"``.
    """

    impl: str
    pack_impl: str
    pipeline_chunks: int
    transport_chunks: int
    modeled_s: float
    measured_s: float | None = None
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


def moe_expert_time(
    cfg, batch_size: int, num_shards: int, chip: ChipSpec = V5E
) -> float:
    """Modeled expert-FFN seconds for ONE decode step on one parallel unit.

    Each unit owns ``E / num_shards`` experts and receives ``num_shards``
    capacity buffers per local expert, so it batch-matmuls
    ``E_loc * num_shards * C`` slot rows through the SwiGLU (``6 * d * f``
    FLOPs a row): the compute the async dispatch pipeline hides exchange
    behind.  Same duck-typed ``cfg`` as :func:`decode_table_stats`.
    """
    E = int(getattr(cfg, "num_experts", 0) or 1)
    k = int(getattr(cfg, "top_k", 0) or 1)
    d = int(cfg.d_model)
    f = int(getattr(cfg, "moe_d_ff", 0) or getattr(cfg, "d_ff", d))
    n = max(num_shards, 1)
    t_loc = max(1, batch_size // n)
    C = ep_capacity(t_loc, k, E, float(getattr(cfg, "capacity_factor", 1.0)))
    E_loc = max(E // n, 1)
    slot_rows = E_loc * n * C
    return slot_rows * 6.0 * d * f / chip.peak_flops_bf16


def ep_dispatch_makespan(
    stats: TableStats,
    n: int,
    compute_s: float,
    impl: str = "round_robin",
    pack_impl: str = "torch",
    num_chunks: int = 1,
    transport_chunks: int = 1,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    num_pods: int = 1,
    overlap: bool = True,
) -> float:
    """Modeled makespan of one EP layer: dispatch + expert FFN + combine.

    ``stats`` is the per-unit dispatch shape (:func:`decode_table_stats`),
    ``compute_s`` the expert compute it feeds (:func:`moe_expert_time`).
    ``num_chunks`` splits the capacity buffers into chunks pipelined like
    the MoE layer's double-buffered path: chunk ``c + 1``'s dispatch runs
    while chunk ``c``'s experts compute.  ``overlap=False`` prices the
    serialized schedule, ``chunks * (dispatch + compute + combine)``; with
    overlap every chunk boundary (the ``chunks - 1`` internal ones plus the
    cross-layer one) hides ``min(compute, exchange)`` scaled by the
    DMA-independence factor ``1 - 1/n_dma``, as in :func:`exchange_makespan`.
    """
    if stats.rows % num_chunks:
        num_chunks = 1
    chunk = TableStats(rows=stats.rows // num_chunks, row_bytes=stats.row_bytes)
    disp_c = exchange_makespan(
        chunk, n, impl, pack_impl, 1, transport_chunks, chip, topology,
        num_pods,
    )
    comb_c = disp_c  # the return trip runs the same schedule mirrored
    comp_c = compute_s / num_chunks
    serial = num_chunks * (disp_c + comp_c + comb_c)
    if not overlap:
        return serial
    n_dma = 1 if impl == "xla" else max(n - 1, 1) * transport_chunks
    if num_pods > 1 and impl != "xla":
        n_dma += num_pods - 1  # the coarse-hop phases are independent sends
    overlap_frac = 0.0 if n_dma <= 1 else 1.0 - 1.0 / n_dma
    boundaries = num_chunks  # chunks-1 internal + 1 cross-layer
    hidden = boundaries * overlap_frac * min(comp_c, disp_c + comb_c)
    return max(serial - hidden, serial - num_chunks * (disp_c + comb_c))


def tune_ep_dispatch(
    cfg,
    batch_size: int,
    num_shards: int,
    num_pods: int = 1,
    impl: str = "round_robin",
    pack_impl: str = "torch",
    chip: ChipSpec = V5E,
    topology: str = "ring",
) -> dict:
    """Pick the async chunk count for the EP dispatch pipeline.

    ``num_shards`` is the TOTAL unit count (pods x in-pod shards).  Sweeps
    the pipeline chunk candidates that divide the per-expert capacity and
    returns ``{"chunks", "serial_s", "async_s", "overlap_fraction",
    "candidates"}``: the unoverlapped and overlapped makespans at the chosen
    chunking, and the share of exchange time hidden behind expert compute.
    """
    E = int(getattr(cfg, "num_experts", 0) or 1)
    k = int(getattr(cfg, "top_k", 0) or 1)
    n_inner = max(num_shards // max(num_pods, 1), 1)
    t_loc = max(1, batch_size // max(num_shards, 1))
    C = ep_capacity(t_loc, k, E, float(getattr(cfg, "capacity_factor", 1.0)))
    stats = decode_table_stats(cfg, batch_size, num_shards)
    compute_s = moe_expert_time(cfg, batch_size, num_shards, chip)
    scored = []
    for ch in PIPELINE_CANDIDATES:
        if C % ch:
            continue
        async_s = ep_dispatch_makespan(
            stats, n_inner, compute_s, impl, pack_impl, ch, 1, chip,
            topology, num_pods, overlap=True,
        )
        serial_s = ep_dispatch_makespan(
            stats, n_inner, compute_s, impl, pack_impl, ch, 1, chip,
            topology, num_pods, overlap=False,
        )
        scored.append((async_s, ch, serial_s))
    scored.sort()
    async_s, chunks, serial_s = scored[0]
    exchange_s = serial_s - compute_s
    frac = (serial_s - async_s) / exchange_s if exchange_s > 0 else 0.0
    return {
        "chunks": chunks,
        "serial_s": serial_s,
        "async_s": async_s,
        "overlap_fraction": frac,
        "candidates": tuple((ch, a, s) for a, ch, s in scored),
    }


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


def tune_shared_config(
    n: int,
    stats_groups: Sequence[TableStats | Sequence[TableStats]],
    num_pods: int = 1,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    weights: Sequence[float] | None = None,
) -> TunedConfig:
    """One knob set for SEVERAL queries' exchanges sharing one multiplexer.

    The query-serving engine runs compatible plans on one mesh, and they
    all ride the same multiplexer — so the knobs are tuned over the UNION
    of every query's exchange shapes: the legal candidate set is the
    intersection (``pipeline_chunks`` must divide every exchange's rows
    across all queries) and the objective is the weighted total makespan.
    ``stats_groups`` holds one group of :class:`TableStats` per query (a
    plan's ``shuffle_stats``); ``weights`` scales each query's share
    (default: uniform).  Degenerate inputs (one unit, no exchanges)
    collapse to :func:`tune_config`'s default exactly.
    """
    groups = tuple(
        (g,) if isinstance(g, TableStats) else tuple(g) for g in stats_groups
    )
    flat = tuple(s for g in groups for s in g)
    if n <= 1 or not flat or all(s.rows == 0 for s in flat):
        return tune_config(n, flat, num_pods, chip, topology)
    if weights is None:
        weights = (1.0,) * len(groups)
    if len(weights) != len(groups):
        raise ValueError(f"{len(weights)} weights for {len(groups)} stats groups")
    scored = []
    for impl, pack_impl, C, t in candidate_configs(n, flat):
        total = sum(
            w * sum(
                exchange_makespan(
                    s, n, impl, pack_impl, C, t, chip, topology, num_pods
                )
                for s in g
            )
            for w, g in zip(weights, groups)
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
    mesh,
    table_stats: TableStats | Sequence[TableStats],
    chip: ChipSpec = V5E,
    topology: str = "ring",
    axis: str | None = None,
    refine: bool = False,
    refine_top_k: int = 3,
    broadcast_stats: TableStats | None = None,
    device="cuda",
) -> TunedConfig:
    """The knobs that minimise the modeled makespan of these exchanges on
    a simulated :class:`~repro_torch.core.exchange.Mesh`.

    ``axis`` defaults to the mesh's largest small-network axis; a two-level
    mesh prices the two-level exchange and, when ``broadcast_stats``
    describes a broadcast-style join's build side, records the cheaper of
    cross-pod ``"broadcast"`` and ``"reshard"`` in
    :attr:`TunedConfig.cross_pod`.  With ``refine=True`` the
    ``refine_top_k`` best modeled candidates are timed on ``device`` by
    :func:`measure_shuffle_config`, at the largest exchange by bytes, and
    the measured winner is returned with ``measured_s`` filled in.
    """
    stats = (
        (table_stats,)
        if isinstance(table_stats, TableStats)
        else tuple(table_stats)
    )
    if axis is None:
        axis, n, num_pods = _shuffle_axis(mesh)
    else:
        n = mesh.size(axis)
        num_pods = _shuffle_axis(mesh)[2]
    tuned = tune_config(
        n if axis is not None else 1, stats, num_pods=num_pods, chip=chip,
        topology=topology, broadcast_stats=broadcast_stats,
    )
    if refine and num_pods > 1:
        # measure_shuffle_config runs the single-level in-pod shuffle; on a
        # two-level mesh that measures neither the DCI hop nor the P-fold
        # hop-2 shapes the model prices, so a "measured winner" would be
        # ranked on the wrong experiment.
        warnings.warn(
            "tune_multiplexer(refine=True) is not supported on two-level "
            "meshes yet; returning the analytical winner",
            stacklevel=2,
        )
        refine = False
    if not refine or len(tuned.candidates) <= 1:
        return tuned
    probe = max(stats, key=lambda s: s.rows * s.row_bytes)
    timed = []
    for impl, pack_impl, C, t, total in tuned.candidates[:refine_top_k]:
        wall = measure_shuffle_config(
            mesh, axis, probe, impl=impl, pack_impl=pack_impl,
            pipeline_chunks=C, transport_chunks=t, device=device,
        )
        timed.append((wall, (total, C, t, impl, pack_impl)))
    timed.sort(key=lambda r: r[0])
    measured, (total, C, t, impl, pack_impl) = timed[0]
    return dataclasses.replace(
        tuned,
        impl=impl,
        pack_impl=pack_impl,
        pipeline_chunks=C,
        transport_chunks=t,
        modeled_s=total,
        measured_s=measured,
    )


# ----------------------------------------------------------------------------
# Measurement on the simulated fabric.
# ----------------------------------------------------------------------------

def _best_wall(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Min wall seconds over ``iters`` runs of ``fn(*args)`` after
    ``warmup`` runs: the run least disturbed by scheduler noise.  Each run
    ends in ``torch.cuda.synchronize()`` when an argument lies on the card
    (the host returns before the card finishes)."""
    import torch

    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def run():
        fn(*args)
        if on_card:
            torch.cuda.synchronize()

    for _ in range(warmup):
        run()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def measure_shuffle_config(
    mesh,
    axis: str,
    stats: TableStats,
    impl: str = "round_robin",
    pack_impl: str = "torch",
    pipeline_chunks: int = 1,
    transport_chunks: int = 1,
    iters: int = 3,
    max_rows: int | None = None,
    device="cuda",
) -> float:
    """Min wall seconds (over ``iters`` runs) of one ``hash_shuffle``.

    A synthetic exchange (uniform int32 keys in ``[0, 2**30)``, rows of
    ``stats.row_bytes // 4`` int32 columns in ``[0, 2**20)``, zero-drop
    capacity) through a real multiplexer on ``mesh``, every shard on
    ``device``, at the actual ``stats.rows`` a unit by default: measuring
    in a smaller regime would undo the tuner's size-driven decisions.
    ``max_rows`` caps the probe; rows are aligned down to a multiple of
    ``pipeline_chunks * transport_chunks``.  With ``pack_impl="cuda"`` on
    the card every chunk's pack launches ``hash_partition_pack``.
    """
    import torch

    from ..relational.table import resolve_device
    from .multiplexer import make_multiplexer

    dev = resolve_device(device)
    rows = stats.rows if max_rows is None else min(stats.rows, max_rows)
    step = pipeline_chunks * transport_chunks  # C | rows and t | rows/C
    rows = max(step, rows - rows % step)
    width = max(1, stats.row_bytes // 4)
    mux = make_multiplexer(
        mesh, impl=impl, pack_impl=pack_impl,
        pipeline_chunks=pipeline_chunks, transport_chunks=transport_chunks,
    )
    S = mesh.num_units
    keys = torch.randint(
        0, 1 << 30, (S, rows), dtype=torch.int32, device=dev,
        generator=torch.Generator(dev).manual_seed(0),
    )
    data = torch.randint(
        0, 1 << 20, (S, rows, width), dtype=torch.int32, device=dev,
        generator=torch.Generator(dev).manual_seed(1),
    )

    def body(k, r):
        out_rows, out_valid, dropped = mux.hash_shuffle(k, r, axis, capacity=rows)
        return out_rows.sum() + out_valid.sum() + dropped.sum()

    return _best_wall(body, keys, data, iters=iters)


def calibrate_chip(
    mesh,
    axis: str,
    chip: ChipSpec = V5E,
    message_rows: Sequence[int] = (1024, 65536),
    row_bytes: int = 16,
    device="cuda",
) -> ChipSpec:
    """Fit the cost model's constants to the fabric actually running.

    The model is two affine laws: shuffle wall = launches + bytes/link_bw,
    pack wall = dispatch + touched/hbm_bw.  Each is timed at the smallest
    and the largest of ``message_rows`` and the 2x2 system solved, which
    gives the effective link bandwidth and launch latency of the scheduled
    all-to-all on ``mesh``'s ``axis`` and the HBM bandwidth and dispatch
    cost of the plain pack, on ``device``.  Returns ``chip`` with those
    four fields replaced and ``-calibrated`` appended to its name (``chip``
    itself when the axis has one unit).  The plan-cache key holds the
    chip's name only, so every fitting of one card shares a key: give each
    fitting its own cache directory or name.
    """
    import torch

    from ..relational.table import resolve_device
    from . import exchange

    n = mesh.size(axis)
    if n <= 1:
        return chip
    dev = resolve_device(device)
    load_sum = sum(schedule_ring_loads(make_schedule(n, "shift")))
    width = max(1, row_bytes // 4)
    S = mesh.num_units

    # -- link law: scheduled all_to_all wall at two message sizes ----------
    walls, sizes = [], []
    for rows in message_rows:
        x = torch.randint(
            0, 1 << 20, (S, n, rows, width), dtype=torch.int32, device=dev,
            generator=torch.Generator(dev).manual_seed(rows),
        )
        walls.append(_best_wall(
            lambda v: exchange.all_to_all(v, mesh, axis, impl="round_robin"), x
        ))
        sizes.append(rows * width * 4)
        del x  # before the next size's tensor is made
    slope = (walls[-1] - walls[0]) / max(sizes[-1] - sizes[0], 1)
    slope = max(slope, 1e-15)
    intercept = max(walls[0] - slope * sizes[0], 1e-9)
    link_bw = load_sum / slope
    launch = intercept / (n - 1)

    # -- pack law: pack_by_destination wall at two row counts --------------
    pk_walls, pk_bytes = [], []
    for rows in message_rows:
        dest = torch.randint(
            0, n, (1, rows), dtype=torch.int32, device=dev,
            generator=torch.Generator(dev).manual_seed(rows + 1),
        )
        data = torch.randint(
            0, 1 << 20, (1, rows, width), dtype=torch.int32, device=dev,
            generator=torch.Generator(dev).manual_seed(rows + 2),
        )
        pk_walls.append(_best_wall(
            lambda d, r, rows=rows: exchange.pack_by_destination(
                d, r, n, rows, impl="torch"
            ),
            dest, data,
        ))
        # the bytes-touched expression of pack_time(impl="torch")
        pk_bytes.append(rows * 12 * (n + 1) + 8 * rows + 2 * rows * row_bytes)
    pk_slope = (pk_walls[-1] - pk_walls[0]) / max(pk_bytes[-1] - pk_bytes[0], 1)
    pk_slope = max(pk_slope, 1e-15)
    pk_intercept = max(pk_walls[0] - pk_slope * pk_bytes[0], 1e-9)

    return dataclasses.replace(
        chip,
        name=chip.name + "-calibrated",
        ici_link_bandwidth=link_bw,
        ici_launch_latency=launch,
        hbm_bandwidth=1.0 / pk_slope,
        kernel_launch_latency=pk_intercept,
    )


__all__ = [
    "TableStats",
    "TunedConfig",
    "decode_table_stats",
    "ep_capacity",
    "moe_expert_time",
    "ep_dispatch_makespan",
    "tune_ep_dispatch",
    "exchange_makespan",
    "pod_strategy_times",
    "candidate_configs",
    "tune_config",
    "tune_shared_config",
    "tune_multiplexer",
    "measure_shuffle_config",
    "calibrate_chip",
]
