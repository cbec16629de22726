"""Sampling-based statistics for the adaptive planner (port of
``repro.relational.stats``, numpy as in the reference).

:func:`collect_stats` draws a deterministic row sample from each flat
:class:`~repro_torch.relational.table.Table` and derives, per integer
column, an NDV estimate and a heavy-hitter sketch; :func:`partition_overload`
turns a heavy-hitter profile into the ``max_partition_load / fair_share``
factor of a plain or salted hash repartitioning, with the exact runtime
routing hash (:func:`fib_hash32`).  Everything is seeded: the same data
always yields the same profile, keeping ``explain()`` deterministic.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, Mapping, Sequence

import numpy as np

from .table import Table

# Sketch capacity: any key with true sample frequency above 1/k is
# guaranteed present (classic SpaceSaving bound); 32 counters comfortably
# covers every salting-relevant heavy hitter at the shard counts we plan.
SKETCH_CAPACITY = 32

DEFAULT_SAMPLE_SIZE = 2048


class SpaceSaving:
    """Metwally et al.'s SpaceSaving top-k sketch over an integer stream.

    Keeps ``capacity`` counters; when a new key arrives with all counters
    taken, it REPLACES the minimum counter, inherits its count, and records
    that inherited count as the entry's ERROR bound.  Guarantees used by
    the planner: any key whose true frequency exceeds ``n / capacity`` is
    in the sketch after ``n`` updates (a heavy hitter can be overestimated
    but never missed), and ``count - error`` never exceeds the true
    frequency — so filtering on the guaranteed count rejects the phantom
    heavy hitters count inheritance fabricates on uniform data.
    """

    def __init__(self, capacity: int = SKETCH_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = int(capacity)
        self._counts: dict[int, int] = {}
        self._errors: dict[int, int] = {}
        self.total = 0

    def update(self, key: int) -> None:
        key = int(key)
        self.total += 1
        counts = self._counts
        if key in counts:
            counts[key] += 1
        elif len(counts) < self.capacity:
            counts[key] = 1
            self._errors[key] = 0
        else:
            victim = min(counts, key=counts.__getitem__)
            inherited = counts.pop(victim)
            self._errors.pop(victim)
            counts[key] = inherited + 1
            self._errors[key] = inherited

    def update_many(self, keys: Iterable[int]) -> None:
        for k in keys:
            self.update(k)

    def entries(self) -> tuple[tuple[int, int, int], ...]:
        """(key, estimated count, error bound) sorted by count desc, then
        key — a total deterministic order (ties broken by key, never dict
        order).  ``count`` upper-bounds the true frequency, ``count -
        error`` lower-bounds it."""
        return tuple(
            (k, c, self._errors[k])
            for k, c in sorted(
                self._counts.items(), key=lambda kv: (-kv[1], kv[0])
            )
        )


_U32 = np.uint64(0xFFFFFFFF)


def fib_hash32(keys: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``kernels.ref.fibonacci_hash_ref`` (uint32 avalanche)
    — the EXACT hash the runtime exchange routes with, so the planner's
    modeled shard placements match the executor's measured histogram.
    Computed in uint64 with explicit 32-bit masking: numpy's native uint32
    multiply wraps too, but the mask makes the overflow intent explicit and
    silences overflow warnings on scalar inputs."""
    x = np.asarray(keys).astype(np.uint64) & _U32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & _U32
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & _U32
    x ^= x >> np.uint64(16)
    return x


def estimate_ndv(sample: np.ndarray, total_rows: int) -> int:
    """Distinct-value estimate from a uniform row sample.

    GEE (Charikar et al.'s Guaranteed-Error Estimator): keys seen once in
    the sample are the evidence for unseen keys, scaled by ``sqrt(N / n)``
    — the scale factor with a PROVEN ratio-error bound of ``sqrt(N / n)``
    over all distributions (the naive ``N / n`` scale-up overshoots by the
    full sampling fraction on near-uniform data).  Exact when the sample
    covers the table (the scale factor degrades to 1, leaving ``d``),
    clamped to ``[distinct_in_sample, total_rows]`` always.
    """
    n = int(sample.size)
    total_rows = int(total_rows)
    if n == 0 or total_rows == 0:
        return 0
    _, counts = np.unique(sample, return_counts=True)
    d = int(counts.size)
    f1 = int((counts == 1).sum())
    scale = max(np.sqrt(total_rows / n), 1.0)
    est = d - f1 + round(scale * f1)
    return int(min(max(est, d), total_rows))


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-column estimates derived from the sample."""

    name: str
    ndv: int
    # (key, estimated share of rows) sorted by share desc — sketch entries
    # whose share clears the noise floor (>= 2 sample hits).
    heavy_hitters: tuple[tuple[int, float], ...]
    max_share: float


@dataclasses.dataclass(frozen=True)
class TableProfile:
    """Everything the planner knows about one table's actual content."""

    table: str
    rows: int          # valid rows in the profiled table (exact, not capacity)
    sample_rows: int
    columns: Mapping[str, ColumnStats]
    # The raw sampled rows (integer columns only), kept so the planner can
    # run predicate_selectivity over real data instead of guessing.
    sample: Mapping[str, np.ndarray]


def _profile_column(name: str, vals: np.ndarray, total_rows: int) -> ColumnStats:
    sketch = SpaceSaving(SKETCH_CAPACITY)
    sketch.update_many(vals.tolist())
    n = max(int(vals.size), 1)
    # Guaranteed (lower-bound) counts reject inheritance phantoms; a key
    # must provably account for >= 4 sample rows to be called heavy.
    heavy = tuple(
        (k, c / n) for k, c, err in sketch.entries() if c - err >= 4
    )
    return ColumnStats(
        name=name,
        ndv=estimate_ndv(vals, total_rows),
        heavy_hitters=heavy,
        max_share=heavy[0][1] if heavy else (1.0 / n if vals.size else 0.0),
    )


def profile_table(
    name: str,
    table: Table,
    sample_size: int = DEFAULT_SAMPLE_SIZE,
    seed: int = 0,
) -> TableProfile:
    """Sample ``table`` and derive per-integer-column statistics.

    The sample is a seeded without-replacement draw over VALID rows only
    (padding rows carry sentinel values that would poison every estimate).
    If the table is smaller than ``sample_size`` the profile is exact.
    """
    valid = table.valid.cpu().numpy().astype(bool)
    idx = np.flatnonzero(valid)
    rows = int(idx.size)
    # Stable per-table stream: same (seed, name) -> same sample, and two
    # tables profiled under one seed still draw independent samples.
    rng = np.random.default_rng([int(seed), zlib.crc32(name.encode())])
    if rows > sample_size:
        idx = np.sort(rng.choice(idx, size=sample_size, replace=False))
    sample: dict[str, np.ndarray] = {}
    columns: dict[str, ColumnStats] = {}
    for cname in table.columns:
        col = table.columns[cname].cpu().numpy()[idx]
        if not np.issubdtype(col.dtype, np.integer):
            continue
        sample[cname] = col
        columns[cname] = _profile_column(cname, col, rows)
    return TableProfile(
        table=name, rows=rows, sample_rows=int(idx.size),
        columns=columns, sample=sample,
    )


def collect_stats(
    tables: Mapping[str, Table],
    sample_size: int = DEFAULT_SAMPLE_SIZE,
    seed: int = 0,
) -> dict[str, TableProfile]:
    """Profile every table; the dict plugs straight into ``plan_physical``
    / ``PlannedQuery.plan`` as the ``stats`` argument."""
    return {
        name: profile_table(name, t, sample_size=sample_size, seed=seed)
        for name, t in sorted(tables.items())
    }


def partition_overload(
    heavy: Sequence[tuple[int, float]],
    num_shards: int,
    num_salts: int = 1,
    salted: Sequence[int] | None = None,
) -> float:
    """Estimated ``max_partition_load / fair_share`` of hash-partitioning a
    column with this heavy-hitter profile over ``num_shards``.

    Same construction as ``skew.zipf_partition_overload_analytic`` but with
    the RUNTIME routing hash (:func:`fib_hash32`): each heavy key's whole
    share lands on ``fibonacci_hash(key) % num_shards`` — the same shard
    the executor will send it to — and the residual (non-heavy) mass is
    near-uniform under hashing and is spread evenly.  ``num_salts > 1``
    models the salted repartitioning: every key in ``salted`` (default:
    all heavy keys) splits its share evenly across ``num_salts`` salted
    sub-keys (``key * num_salts + salt``, the ``skew.salt_keys`` key
    space) which hash independently; heavy keys NOT in ``salted`` still
    land whole, exactly like the runtime routes them.
    """
    if num_shards <= 1:
        return 1.0
    heavy = list(heavy)
    residual = max(1.0 - sum(s for _, s in heavy), 0.0)
    loads = np.full(num_shards, residual / num_shards, dtype=np.float64)
    if heavy:
        split = (
            {int(k) for k, _ in heavy} if salted is None
            else {int(k) for k in salted}
        ) if num_salts > 1 else set()
        keys: list[int] = []
        shares: list[float] = []
        for k, s in heavy:
            if int(k) in split:
                keys.extend(int(k) * num_salts + j for j in range(num_salts))
                shares.extend([s / num_salts] * num_salts)
            else:
                keys.append(int(k))
                shares.append(s)
        # int64 cast ONLY for bincount (which refuses uint64); the modulus
        # bounds values to num_shards - 1, far below 2**63.
        part = (
            fib_hash32(np.asarray(keys, dtype=np.uint64))
            % np.uint64(num_shards)
        ).astype(np.int64)
        loads += np.bincount(
            part, weights=np.asarray(shares), minlength=num_shards
        )
    return float(loads.max() * num_shards)


def salting_keys(
    cs: ColumnStats, num_shards: int, share_threshold: float | None = None
) -> tuple[int, ...]:
    """Heavy keys worth salting for an ``num_shards``-way repartitioning.

    A key contributes meaningful imbalance well before it fills a whole
    fair share on its own: a key carrying an EIGHTH of a fair share can
    stack on top of the residual and other mid-weight keys to push one
    shard past the runtime threshold.  Default threshold: ``0.125 /
    num_shards`` of total mass (calibrated against the Zipf(1.2) TPC-H
    scenario: anything coarser leaves measured max/fair-share above 1.3
    at 8 shards).
    """
    if share_threshold is None:
        share_threshold = 0.125 / num_shards
    return tuple(k for k, s in cs.heavy_hitters if s >= share_threshold)


# Salts per shard: sub-keys route through the same hash as everything else,
# so with only ``num_shards`` salts the giant key's sub-keys collide and it
# still lumps (measured ~1.38x at 8 shards).  64 salts per shard makes the
# per-heavy-key placement multinomially smooth (~1.15x) and costs nothing:
# partial aggregation is by TRUE key and build sides are replicated, so no
# state scales with the salt count.
SALTS_PER_SHARD = 64


def choose_num_salts(heavy: Sequence[int], num_shards: int) -> int:
    """Salt count for these heavy keys, kept inside the int32 route space.

    Routing computes ``key * num_salts + salt`` in int32 (only for HEAVY
    keys — non-heavy rows route by their raw key), so the salt count is
    halved until the largest salted sub-key fits; 0 means the keys are too
    large to salt safely and the planner falls back to the plain exchange.
    """
    num_salts = SALTS_PER_SHARD * num_shards
    top = max((int(k) for k in heavy), default=0)
    while num_salts > 1 and (top + 1) * num_salts >= 2**31:
        num_salts //= 2
    return num_salts if num_salts > 1 else 0


__all__ = [
    "SKETCH_CAPACITY",
    "DEFAULT_SAMPLE_SIZE",
    "SpaceSaving",
    "fib_hash32",
    "estimate_ndv",
    "ColumnStats",
    "TableProfile",
    "profile_table",
    "collect_stats",
    "partition_overload",
    "salting_keys",
    "choose_num_salts",
    "SALTS_PER_SHARD",
]
