"""Round-robin network schedules (paper §3.2.3, Fig 10a); a verbatim port of
``repro.core.schedule`` — pure Python, no tensors.

The paper decomposes an all-to-all data shuffle among ``n`` servers into
``n - 1`` *conflict-free phases*: in every phase each server sends to exactly
one target and receives from exactly one source, so no switch output port
(InfiniBand) / no torus link (TPU ICI) is shared within a phase.  This is what
buys the +40 % all-to-all throughput of Fig 10(b).

On a TPU torus the same idea maps onto ``jax.lax.ppermute``: a phase is a
permutation of devices, and a *cyclic shift* permutation routes along disjoint
ring links, so phases are contention-free by construction.

Two schedule families are provided:

* ``shift_schedule(n)`` — phase ``k`` sends ``i -> (i + k) mod n``; works for
  any ``n`` and is the schedule the paper uses (their Fig 10(a) is exactly the
  ``n = 4`` instance).
* ``one_factorization(n)`` — for even ``n``, a round-robin-tournament pairing
  where traffic in each phase is bidirectional between disjoint pairs; useful
  on full-duplex links when send and receive volumes are symmetric.

Both satisfy the invariants checked by :func:`verify_schedule` (and by the
hypothesis property tests):

1. every phase is a perfect matching of senders to receivers
   (a permutation with no fixed points),
2. over all phases, every ordered pair ``(i, j)``, ``i != j`` appears exactly
   once — the union is the complete directed graph, i.e. a full all-to-all.
"""

from __future__ import annotations

import dataclasses

Phase = tuple[tuple[int, int], ...]  # ((src, dst), ...)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A communication schedule: an ordered list of conflict-free phases."""

    n: int
    phases: tuple[Phase, ...]
    name: str = "shift"

    @property
    def num_phases(self) -> int:
        return len(self.phases)

    def phase_permutation(self, k: int) -> list[tuple[int, int]]:
        """Phase ``k`` as a ppermute-style ``[(src, dst), ...]`` list."""
        return list(self.phases[k])

    def sources_for(self, device: int) -> list[int]:
        """The source device ``device`` receives from, per phase."""
        out = []
        for phase in self.phases:
            src = [s for (s, d) in phase if d == device]
            assert len(src) == 1, "schedule not a perfect matching"
            out.append(src[0])
        return out

    def targets_for(self, device: int) -> list[int]:
        """The target device ``device`` sends to, per phase."""
        out = []
        for phase in self.phases:
            dst = [d for (s, d) in phase if s == device]
            assert len(dst) == 1, "schedule not a perfect matching"
            out.append(dst[0])
        return out


def shift_schedule(n: int) -> Schedule:
    """The paper's round-robin schedule: phase ``k`` routes ``i -> i + k``.

    ``n - 1`` phases; each phase is a single cyclic shift, which on a ring /
    torus uses every link in the same direction exactly once -> conflict-free.
    """
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    phases = []
    for k in range(1, n):
        phases.append(tuple((i, (i + k) % n) for i in range(n)))
    return Schedule(n=n, phases=tuple(phases), name="shift")


def one_factorization(n: int) -> Schedule:
    """Round-robin tournament pairing for even ``n`` (circle method).

    ``n - 1`` phases; in each phase the devices form ``n/2`` disjoint pairs and
    exchange bidirectionally.  Each unordered pair appears exactly once, so
    each *ordered* pair appears exactly once as well (both directions in the
    same phase).
    """
    if n < 2 or n % 2 != 0:
        raise ValueError(f"one_factorization requires even n >= 2, got {n}")
    phases = []
    # Circle method: fix device n-1, rotate the rest.
    ring = list(range(n - 1))
    for _ in range(n - 1):
        pairs = [(ring[0], n - 1)]
        for i in range(1, n // 2):
            pairs.append((ring[i], ring[n - 1 - i]))
        phase = []
        for a, b in pairs:
            phase.append((a, b))
            phase.append((b, a))
        phases.append(tuple(sorted(phase)))
        ring = [ring[-1]] + ring[:-1]
    return Schedule(n=n, phases=tuple(phases), name="one_factorization")


def verify_schedule(schedule: Schedule) -> None:
    """Raise ``AssertionError`` unless the schedule is conflict-free and full.

    Checks the two invariants from the module docstring.  Used by the property
    tests and (cheaply, once per program) by the exchange layer.
    """
    n = schedule.n
    seen: set[tuple[int, int]] = set()
    for phase in schedule.phases:
        srcs = [s for (s, _) in phase]
        dsts = [d for (_, d) in phase]
        assert sorted(srcs) == list(range(n)), f"senders not a permutation: {srcs}"
        assert sorted(dsts) == list(range(n)), f"receivers not a permutation: {dsts}"
        for s, d in phase:
            assert s != d, f"self-send {s}->{d} wastes a phase slot"
            assert (s, d) not in seen, f"duplicate pair {(s, d)}"
            seen.add((s, d))
    assert len(seen) == n * (n - 1), (
        f"schedule covers {len(seen)} ordered pairs, expected {n * (n - 1)}"
    )


def make_schedule(n: int, kind: str = "shift") -> Schedule:
    if kind == "shift":
        return shift_schedule(n)
    if kind == "one_factorization":
        return one_factorization(n)
    raise ValueError(f"unknown schedule kind {kind!r}")


def ring_hops(n: int, shift: int) -> int:
    """Number of unidirectional ring hops a cyclic shift by ``shift`` takes.

    Used by the topology cost model: on a bidirectional ring the effective
    hop count of shift ``k`` is ``min(k, n - k)`` (route the short way).
    """
    shift %= n
    return min(shift, n - shift)


def ring_phase_load(phase: Phase, n: int) -> int:
    """Peak link load of one phase on a bidirectional ring, short-way routed.

    Each message ``(s, d)`` occupies every link on its minimal ring path
    (clockwise if ``(d - s) mod n <= n/2``, counter-clockwise otherwise; ties
    go clockwise).  Links are directed, so the two directions don't contend.
    The returned value is the number of messages sharing the busiest link —
    the factor by which that phase's wire time stretches relative to a
    contention-free hop (load 1).  A cyclic shift by ``+-1`` has load 1; a
    shift by ``k`` has load ``min(k, n - k)`` (= :func:`ring_hops`).
    """
    cw = [0] * n  # cw[i]: link i -> i+1
    ccw = [0] * n  # ccw[i]: link i -> i-1
    for s, d in phase:
        fwd = (d - s) % n
        if fwd == 0:
            continue
        if fwd <= n - fwd:
            for h in range(fwd):
                cw[(s + h) % n] += 1
        else:
            for h in range(n - fwd):
                ccw[(s - h) % n] += 1
    return max(max(cw), max(ccw))


def schedule_ring_loads(schedule: Schedule) -> list[int]:
    """Per-phase peak ring-link loads (see :func:`ring_phase_load`)."""
    return [ring_phase_load(p, schedule.n) for p in schedule.phases]


def schedule_link_time(
    n: int,
    bytes_per_pair: float,
    link_bandwidth: float,
    scheduled: bool,
    contention_factor: float | None = None,
) -> float:
    """Analytic all-to-all time on an ``n``-port non-blocking switch.

    Scheduled: ``n - 1`` phases, each phase moves ``bytes_per_pair`` per link
    at full ``link_bandwidth``.  Unscheduled: same total bytes but effective
    bandwidth is degraded by switch contention (HOL blocking / credit
    starvation, paper §3.2.3); the degradation factor defaults to the one
    measured by :mod:`repro.core.topology`'s simulator (~0.71 for n = 8,
    matching the paper's "+40 %").
    """
    total = (n - 1) * bytes_per_pair / link_bandwidth
    if scheduled:
        return total
    if contention_factor is None:
        from .topology import contention_factor as _cf

        contention_factor = _cf(n)
    return total / contention_factor


__all__ = [
    "Phase",
    "Schedule",
    "shift_schedule",
    "one_factorization",
    "verify_schedule",
    "make_schedule",
    "ring_hops",
    "ring_phase_load",
    "schedule_ring_loads",
    "schedule_link_time",
]
