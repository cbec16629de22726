"""Partition-skew analysis and mitigation (paper §3.1); port of
``repro.core.skew``, in numpy.

The paper's argument for hybrid parallelism: with classic exchange operators
every thread is a parallel unit, so an all-to-all shuffle hash-partitions its
input into ``n x t`` partitions (240 on their 6-server cluster).  Under a
moderately skewed Zipf distribution (z = 0.84) the largest of 240 partitions
receives *more than 2x* its fair share, while the largest of only 6
server-level partitions is overloaded by a mere *2.8 %*.  Fewer parallel
units => less skew impact, before any skew-specific technique.

This module reproduces that math (``zipf_partition_overload``) and the
salting helpers of the relational engine:

* ``salt_keys`` — split pathologically heavy keys across ``s`` salted
  sub-keys (the standard skew-join trick; the paper cites this family of
  techniques as orthogonal).
* round-robin *morsel interleaving* is ``relational/table.py``'s
  ``shard_rows`` (against its contiguous ``interleave=False`` placement).
"""

from __future__ import annotations

import numpy as np


def zipf_pmf(num_keys: int, z: float) -> np.ndarray:
    """Zipf probability mass over ``num_keys`` ranked keys, exponent ``z``."""
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    w = ranks**-z
    return w / w.sum()


def _hash_keys(keys: np.ndarray, seed: int) -> np.ndarray:
    """Cheap deterministic integer mix (Fibonacci hashing) for partitioning."""
    x = keys.astype(np.uint64) + np.uint64(seed)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


def zipf_partition_overload(
    num_partitions: int,
    z: float = 0.84,
    num_keys: int = 1_000_000,
    seed: int = 0,
) -> float:
    """Expected relative overload of the largest hash partition.

    Returns ``max_partition_load / fair_share`` where fair share is
    ``1 / num_partitions``.  Computed exactly from the Zipf pmf (no sampling):
    each distinct key's whole mass lands in ``hash(key) % num_partitions``.

    Paper's numbers (z = 0.84): ~2x for 240 partitions, ~1.028 for 6.
    """
    pmf = zipf_pmf(num_keys, z)
    part = (_hash_keys(np.arange(num_keys), seed) % np.uint64(num_partitions)).astype(
        np.int64
    )
    loads = np.bincount(part, weights=pmf, minlength=num_partitions)
    return float(loads.max() * num_partitions)


def generalized_harmonic(num_keys: int, z: float) -> float:
    """H(N, z) = sum_{k=1..N} k^-z, Euler-Maclaurin for huge N.

    Exact summation for the first 100k terms, integral + correction terms for
    the tail — accurate to ~1e-10 relative for the z of interest.
    """
    cut = min(num_keys, 100_000)
    head = float(np.sum(np.arange(1, cut + 1, dtype=np.float64) ** -z))
    if num_keys <= cut:
        return head
    a, b = float(cut), float(num_keys)
    if abs(z - 1.0) < 1e-12:
        integral = np.log(b) - np.log(a)
    else:
        integral = (b ** (1 - z) - a ** (1 - z)) / (1 - z)
    # Euler-Maclaurin: sum_{a+1..b} f ~ integral + (f(b) - f(a))/2 + ...
    corr = (b**-z - a**-z) / 2.0
    return head + integral + corr


def zipf_partition_overload_analytic(
    num_partitions: int,
    z: float = 0.84,
    num_keys: int = 5_600_000_000,
    top: int = 100_000,
    seed: int = 0,
) -> float:
    """Paper-scale skew claim without materializing the key domain.

    The top ``top`` keys are hashed to partitions exactly; the Zipf tail is
    near-uniform under hashing and is spread evenly.  With the paper's
    z = 0.84 and a ~5.6e9-key domain this reproduces BOTH claims of §3.1 at
    once: the largest of 240 partitions carries ~2x its fair share while the
    largest of 6 partitions is overloaded by only ~2.8 %.
    """
    h_all = generalized_harmonic(num_keys, z)
    ranks = np.arange(1, top + 1, dtype=np.float64)
    head_mass = ranks**-z / h_all
    tail_mass = 1.0 - head_mass.sum()
    part = (_hash_keys(np.arange(top), seed) % np.uint64(num_partitions)).astype(
        np.int64
    )
    loads = np.bincount(part, weights=head_mass, minlength=num_partitions)
    loads += tail_mass / num_partitions
    return float(loads.max() * num_partitions)


def zipf_partition_overload_expected(
    num_partitions: int,
    z: float = 0.84,
    num_keys: int = 1_000_000,
    trials: int = 16,
) -> float:
    """Mean over hash seeds — smooths the single-seed variance."""
    vals = [
        zipf_partition_overload(num_partitions, z, num_keys, seed=s)
        for s in range(trials)
    ]
    return float(np.mean(vals))


def salt_keys(
    keys: np.ndarray, heavy_keys: np.ndarray, num_salts: int, seed: int = 0
) -> np.ndarray:
    """Split heavy keys into ``num_salts`` sub-keys to spread their load.

    Non-heavy keys are returned untouched (shifted into the salted key space
    deterministically so no collisions with salted heavy keys are possible).
    The join build side must replicate heavy-key rows across all salts.

    All arithmetic happens in the uint64 key space: the historical int64
    version silently wrapped ``key * num_salts`` for keys above ``2**63 /
    num_salts`` and mapped negative keys and their uint64 twins to the same
    salted slot.  Keys whose shifted value would not fit uint64 — and any
    negative key, which would alias a large uint64 key after the cast — now
    raise instead of corrupting the partitioning.  ``unsalt_keys`` is the
    exact inverse: ``unsalt_keys(salt_keys(k, ...), num_salts) == k``.
    """
    keys = np.asarray(keys)
    num_salts = int(num_salts)
    if num_salts < 1:
        raise ValueError(f"salt_keys: num_salts must be >= 1, got {num_salts}")
    if np.issubdtype(keys.dtype, np.signedinteger) and keys.size and keys.min() < 0:
        raise ValueError(
            "salt_keys: negative keys would alias large uint64 keys after the "
            "unsigned cast; hash keys into [0, 2**64) first"
        )
    u = keys.astype(np.uint64)
    if num_salts > 1 and u.size and int(u.max()) >= 2**64 // num_salts:
        raise ValueError(
            f"salt_keys: key {int(u.max())} * num_salts={num_salts} overflows "
            "the uint64 salted key space"
        )
    out = u * np.uint64(num_salts)
    heavy = np.isin(u, np.asarray(heavy_keys).astype(np.uint64))
    salts = _hash_keys(np.arange(keys.size), seed) % np.uint64(num_salts)
    out[heavy] += salts[heavy]
    return out


def unsalt_keys(salted: np.ndarray, num_salts: int) -> np.ndarray:
    """Recover the original keys from ``salt_keys`` output (exact inverse)."""
    return np.asarray(salted).astype(np.uint64) // np.uint64(num_salts)


def straggler_excess(loads: np.ndarray) -> float:
    """max/mean - 1: the extra work the slowest parallel unit carries."""
    loads = np.asarray(loads, dtype=np.float64)
    return float(loads.max() / loads.mean() - 1.0)


__all__ = [
    "zipf_pmf",
    "generalized_harmonic",
    "zipf_partition_overload",
    "zipf_partition_overload_analytic",
    "zipf_partition_overload_expected",
    "salt_keys",
    "unsalt_keys",
    "straggler_excess",
]
