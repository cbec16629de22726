"""Hardware model + switch-contention simulator (port of ``repro.core.topology``).

Two roles:

1. Roofline constants of the reference's target hardware (TPU v5e):
   197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s/link ICI.  The port
   keeps ``V5E`` ONLY so that its planner prices exchanges exactly as the
   reference does (``explain()`` parity).  Every ``modeled=`` second the
   port's planner prints is this TPU model, not an H100 prediction; an
   H100 ``ChipSpec`` waits for a calibration pass.

2. A discrete-event model of the paper's switch-contention experiment
   (Fig 10b): uncoordinated all-to-all vs round-robin scheduled phases.
   The paper measures +40 % throughput from scheduling on an 8-port
   InfiniBand switch; the simulator reproduces that number analytically so
   the claim is checkable without network hardware.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip roofline constants (TPU v5e, the assignment's target).

    ``ici_launch_latency`` is the fixed cost of issuing one collective-permute
    (DMA descriptor setup + phase sync) — the TPU analogue of the paper's
    ~1 us inline synchronization message (Fig 10c).  ``kernel_launch_latency``
    is the fixed cost of one pack-kernel dispatch.  Both feed the autotuner's
    per-phase cost model (:func:`phase_time`, :func:`pack_time`).
    """

    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # FLOP/s
    hbm_bandwidth: float = 819e9  # B/s
    ici_link_bandwidth: float = 50e9  # B/s per link per direction
    ici_links_per_chip: int = 4  # 2D torus: +x, -x, +y, -y
    dci_bandwidth: float = 25e9  # B/s per chip cross-pod (optical, scarcer)
    hbm_bytes: int = 16 * 2**30
    vmem_bytes: int = 128 * 2**20
    ici_launch_latency: float = 2e-6  # s per issued ppermute phase
    dci_launch_latency: float = 10e-6  # s per cross-pod phase (DCN RTT-ish)
    kernel_launch_latency: float = 1e-6  # s per pack-kernel dispatch

    def link_bandwidth(self, network: str = "ici") -> float:
        """Per-unit link bandwidth of one network level ('ici' or 'dci')."""
        if network == "ici":
            return self.ici_link_bandwidth
        if network == "dci":
            return self.dci_bandwidth
        raise ValueError(f"unknown network level {network!r}")

    def launch_latency(self, network: str = "ici") -> float:
        """Per-phase collective launch latency of one network level."""
        if network == "ici":
            return self.ici_launch_latency
        if network == "dci":
            return self.dci_launch_latency
        raise ValueError(f"unknown network level {network!r}")


V5E = ChipSpec()


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Two-level cluster: the paper's 'network in the small / in the large'.

    Paper: NUMA/QPI inside a server, InfiniBand between servers.
    Here:  ICI inside a pod, DCI between pods.
    """

    chip: ChipSpec = V5E
    chips_per_pod: int = 256
    num_pods: int = 1

    @property
    def total_chips(self) -> int:
        return self.chips_per_pod * self.num_pods

    def bisection_bandwidth_small(self) -> float:
        """Aggregate ICI bisection bandwidth inside one pod (16x16 torus)."""
        # 16x16 2D torus bisection: 2 * 16 wraparound rings cut twice.
        side = int(round(self.chips_per_pod**0.5))
        return 2 * 2 * side * self.chip.ici_link_bandwidth

    def bisection_bandwidth_large(self) -> float:
        """Aggregate DCI bandwidth between pods."""
        return self.chips_per_pod * self.chip.dci_bandwidth


def _maxmin_rates(flows: list[tuple[int, int]], n: int) -> dict[int, float]:
    """Max-min fair rate per flow index, senders and receivers capped at 1.

    Progressive water-filling: repeatedly saturate the most-constrained port
    and freeze its flows' rates.
    """
    rates: dict[int, float] = {}
    active = set(range(len(flows)))
    send_cap = [1.0] * n
    recv_cap = [1.0] * n
    while active:
        # Per-port share if split evenly among its unfrozen flows.
        port_share: list[tuple[float, str, int]] = []
        snd: dict[int, list[int]] = {}
        rcv: dict[int, list[int]] = {}
        for f in active:
            s, d = flows[f]
            snd.setdefault(s, []).append(f)
            rcv.setdefault(d, []).append(f)
        for s, fs in snd.items():
            port_share.append((send_cap[s] / len(fs), "s", s))
        for d, fs in rcv.items():
            port_share.append((recv_cap[d] / len(fs), "r", d))
        share, kind, port = min(port_share)
        frozen = snd[port] if kind == "s" else rcv[port]
        for f in frozen:
            rates[f] = share
            s, d = flows[f]
            send_cap[s] -= share
            recv_cap[d] -= share
            active.discard(f)
    return rates


def simulate_contention_factor(
    n: int,
    messages_per_pair: int = 8,
    outstanding: int = 3,
    trials: int = 32,
    seed: int = 0,
) -> float:
    """Effective-throughput factor of an UNcoordinated all-to-all.

    Discrete-event model of an ``n``-port switch (paper §3.2.3): each server
    sends ``messages_per_pair`` equal messages to each of the other ``n - 1``
    servers in an independent random target order.  A sender may have up to
    ``outstanding`` head-of-queue messages in flight (InfiniBand credit /
    switch input-buffer depth); beyond that it blocks — the credit-starvation
    effect the paper describes.  Active flows get max-min fair rates with
    sender NICs and receiver ports both capped at link rate.

    Returns ``scheduled_time / unscheduled_time`` (<= 1).  At ``n = 8``,
    ``outstanding = 3`` (default) this yields ~0.73, i.e. scheduling wins
    ~1.4x — the paper's Fig 10(b) measurement (+40 %).  ``outstanding = 1``
    models a bufferless switch (worst case, ~2x win); large ``outstanding``
    approaches ideal output queuing (no win).  The win grows with n
    (1.39x @ 4, 1.47x @ 6, 1.58x @ 16), matching the paper's expectation
    that "the impact of network scheduling ... increase[s] further with the
    cluster size".
    """
    rng = np.random.default_rng(seed)
    factors = []
    ideal = (n - 1) * messages_per_pair  # time units at unit message time
    for _ in range(trials):
        queues = []
        for i in range(n):
            targets = rng.permutation(
                np.repeat([j for j in range(n) if j != i], messages_per_pair)
            )
            queues.append(list(targets))
        # In-flight window per sender: list of [dst, remaining].
        windows: list[list[list[float]]] = [[] for _ in range(n)]
        t = 0.0
        while any(queues) or any(windows):
            for i in range(n):
                while len(windows[i]) < outstanding and queues[i]:
                    windows[i].append([queues[i].pop(0), 1.0])
            flows = [
                (i, int(m[0])) for i in range(n) for m in windows[i]
            ]
            if not flows:
                break
            rates = _maxmin_rates(flows, n)
            # Map flow rates back per message in order.
            k = 0
            dt = float("inf")
            for i in range(n):
                for m in windows[i]:
                    r = rates[k]
                    dt = min(dt, m[1] / r if r > 0 else float("inf"))
                    k += 1
            t += dt
            k = 0
            for i in range(n):
                keep = []
                for m in windows[i]:
                    m[1] -= rates[k] * dt
                    k += 1
                    if m[1] > 1e-12:
                        keep.append(m)
                windows[i] = keep
        factors.append(ideal / t)
    return float(np.mean(factors))


@functools.lru_cache(maxsize=None)
def contention_factor(n: int) -> float:
    """Cached, budgeted contention factor for model/benchmark use.

    The discrete-event simulator is O(n^3)-ish per event; beyond 32 ports
    the factor has plateaued (the paper's effect saturates once every
    receiver is persistently over-subscribed), so we evaluate the simulator
    up to 32 ports with a trial budget that shrinks with n and hold the
    32-port value constant beyond — a *conservative* (smaller) win.
    """
    if n <= 2:
        return 1.0
    if n > 32:
        return contention_factor(32)
    trials = max(2, 64 // n)
    return simulate_contention_factor(n, trials=trials)


def scheduled_vs_unscheduled_speedup(n: int, **kw) -> float:
    """Paper Fig 10(b): throughput gain of round-robin scheduling."""
    if kw:
        return 1.0 / simulate_contention_factor(n, **kw)
    return 1.0 / contention_factor(n)


# ----------------------------------------------------------------------------
# Per-phase cost model (feeds autotune.tune_config).
#
# The paper's argument (§3.2.3, Fig 10b/c) is that the right transport
# strategy follows from message size vs link latency and schedule phase count
# vs switch contention — so the model below prices exactly those terms:
# pack compute against HBM bandwidth, each ppermute phase as launch latency
# plus wire time, and the unscheduled baseline degraded by the simulated
# contention factor.
# ----------------------------------------------------------------------------

# The port's pack knob values: "torch" is the plain one-hot/cumsum pack (the
# reference's "xla"), "cuda" the hand-written kernel (the reference's
# "pallas").  Alphabetical order is the same in both spellings
# ("cuda" < "torch" as "pallas" < "xla"), so the tuner's tie-break sorts
# candidates identically.
PACK_IMPLS = ("torch", "cuda")


def pack_time(
    rows: int,
    row_bytes: float,
    num_dest: int,
    chip: ChipSpec = V5E,
    impl: str = "torch",
) -> float:
    """Modeled partition+pack time for one pipeline chunk (HBM-bound).

    The pack is pure data movement — hash, rank, scatter — so it is priced as
    bytes touched over HBM bandwidth plus one kernel dispatch:

    * ``"torch"`` (one-hot/cumsum plain pack): materializes and re-reads a
      ``[rows, num_dest + 1]`` int32 one-hot (write + cumsum read/write =
      3 passes), then gathers ranks and scatters the rows — the
      O(rows x destinations) term that dominates as the mesh grows.
    * ``"cuda"`` (fused partition+pack kernel): one pass over keys and
      ranks plus the ``[nblocks, bins]`` histogram scan; the scatter
      epilogue reads and writes each row once.  Cost scales with
      ``rows + nblocks x destinations``.
    """
    if rows <= 0:
        return 0.0
    bins = num_dest + 1  # + overflow bucket for invalid rows
    scatter = 2 * rows * row_bytes  # read rows + write buffers (both impls)
    if impl == "torch":
        touched = rows * 12 * bins + 8 * rows + scatter
    elif impl == "cuda":
        nblocks = max(1, -(-rows // 256))
        touched = 8 * rows + 12 * nblocks * bins + scatter
    else:
        raise ValueError(f"unknown pack impl {impl!r}")
    return chip.kernel_launch_latency + touched / chip.hbm_bandwidth


def phase_time(
    message_bytes: float,
    chip: ChipSpec = V5E,
    transport_chunks: int = 1,
    link_load: int = 1,
    network: str = "ici",
) -> float:
    """One scheduled shuffle phase: launch latency per sub-message + wire time.

    ``transport_chunks`` splits the phase message into that many independent
    ppermutes — each pays the launch latency, the wire time is unchanged.
    ``link_load`` is the number of messages sharing the phase's busiest link
    (1 on a non-blocking switch; :func:`repro.core.schedule.ring_phase_load`
    on a torus ring), which stretches the wire time proportionally.
    ``network`` selects the level the phase crosses: ``"ici"`` (in-pod, the
    network in the small) or ``"dci"`` (cross-pod, the network in the large
    — lower bandwidth, higher per-phase latency).
    """
    wire = link_load * message_bytes / chip.link_bandwidth(network)
    return transport_chunks * chip.launch_latency(network) + wire


def shuffle_time(
    n: int,
    message_bytes: float,
    chip: ChipSpec = V5E,
    impl: str = "round_robin",
    transport_chunks: int = 1,
    topology: str = "switch",
    network: str = "ici",
) -> float:
    """Modeled all-to-all time: ``message_bytes`` from each unit to each peer.

    * scheduled impls (``"round_robin"`` = shift schedule,
      ``"one_factorization"``): a sum of :func:`phase_time` over the
      schedule's ``n - 1`` phases.  With ``topology="switch"`` every phase is
      contention-free (the paper's non-blocking switch; at zero launch
      latency this equals ``schedule_link_time(..., scheduled=True)``); with
      ``topology="ring"`` each phase's wire time is stretched by its peak
      ring-link load (multi-hop shifts share links).
    * ``"xla"`` (the monolithic all-to-all): one launch.  On a switch it is
      the paper's *unscheduled* baseline — total wire time degraded by the
      simulated contention factor (:func:`contention_factor`), matching
      ``schedule_link_time(..., scheduled=False)``.  On a ring there is no
      uncoordinated-switch to contend for: the compiler schedules the
      collective over the same links, so it pays the same link-load wire
      bound as the shift schedule with a single launch — its real cost
      relative to the scheduled impls is that one monolithic DMA cannot be
      pipelined against pack compute (see the autotuner's overlap term).

    ``network`` prices the same shuffle over the other network level: the
    cross-pod hop of a two-level exchange is a ``num_pods``-unit all-to-all
    over ``"dci"`` (a switched optical fabric — ``topology="switch"`` is the
    natural pairing; there is no DCI ring to share links on).
    """
    from .schedule import make_schedule, schedule_ring_loads

    if n <= 1 or message_bytes <= 0:
        return 0.0
    if impl == "xla":
        if topology == "ring":
            loads = schedule_ring_loads(make_schedule(n, "shift"))
            wire = sum(loads) * message_bytes / chip.link_bandwidth(network)
            return chip.launch_latency(network) + wire
        wire = (n - 1) * message_bytes / chip.link_bandwidth(network)
        return chip.launch_latency(network) + wire / contention_factor(n)
    kind = "shift" if impl == "round_robin" else impl
    sched = make_schedule(n, kind)
    if topology == "ring":
        loads = schedule_ring_loads(sched)
    elif topology == "switch":
        loads = [1] * sched.num_phases
    else:
        raise ValueError(f"unknown topology {topology!r}")
    return sum(
        phase_time(message_bytes, chip, transport_chunks, load, network)
        for load in loads
    )


def pod_broadcast_time(
    num_pods: int,
    pod_bytes: float,
    chip: ChipSpec = V5E,
) -> float:
    """Cross-pod broadcast: ship one pod's aggregate ``pod_bytes`` to every
    other pod over DCI (ring all-gather: ``num_pods - 1`` phases).  The
    paper's broadcast-join cost under hybrid parallelism — each byte is sent
    once per remote *server*, not once per remote thread.
    """
    if num_pods <= 1 or pod_bytes <= 0:
        return 0.0
    return (num_pods - 1) * phase_time(pod_bytes, chip, network="dci")


def sync_amortization(
    message_bytes: float,
    link_bandwidth: float = V5E.ici_link_bandwidth,
    sync_latency_s: float = 1e-6,
    messages_per_phase: int = 8,
) -> float:
    """Paper Fig 10(c): fraction of peak throughput with phase-sync overhead.

    The paper synchronizes phases with ~1 us inline messages and finds 512 KB
    messages fully hide the cost.  On TPU the phase boundary is the
    collective_permute itself; its launch latency plays the same role.
    """
    transfer = messages_per_phase * message_bytes / link_bandwidth
    return transfer / (transfer + sync_latency_s)


__all__ = [
    "ChipSpec",
    "ClusterSpec",
    "V5E",
    "simulate_contention_factor",
    "contention_factor",
    "scheduled_vs_unscheduled_speedup",
    "pack_time",
    "phase_time",
    "shuffle_time",
    "pod_broadcast_time",
    "sync_amortization",
]
