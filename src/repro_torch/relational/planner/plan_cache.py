"""Persistent plan + compile cache: repeated query templates skip planning
(port of ``repro.relational.planner.plan_cache``).

Planning is pure and deterministic
(:func:`~repro_torch.relational.planner.physical.plan_physical` touches no
device), so a plan is a cacheable artifact.  The key captures exactly the
inputs the planner reads, and its material is the reference's byte for
byte (so are the digests):

* the **canonical render** of the logical DAG (:func:`canonical_render`) —
  a structural, id()-free serialization, identical across process restarts
  and across DAG construction orders;
* the **catalog** (capacities size every exchange buffer);
* the **mesh shape** ``(num_shards, num_pods)`` plus the planner config,
  chip, topology, cross-pod pin, salt threshold and morsel rows;
* the **stats bucket** (:func:`stats_bucket`) — rows and NDVs bucketed to
  powers of two and heavy-hitter shares to coarse magnitude classes, so
  sampling noise keeps the key while a real shift (skew appearing, a table
  growing past a power of two) changes it and forces a replan.

Two cache levels:

* **plans** persist across processes: pickled to ``<cache_dir>/`` (atomic
  tempfile + rename, version-stamped, key material stored alongside so a
  digest collision or format drift reads as a miss, never a wrong plan);
* **compiled runners** are memoized in-process only (a runner holds the
  padded, sharded tables on the device), keyed by plan digest + the
  caller's data token + the multiplexer knobs.

The port's cache is kept apart from the reference's: it reads its own
environment variables (``REPRO_TORCH_PLAN_CACHE_DIR``,
``REPRO_TORCH_PLAN_CACHE_MAX``), names its files ``torchplan-<digest>.pkl``
(the reference counts, evicts and loads ``plan-*.pkl``, and its digests
equal the port's), and loads through an unpickler that refuses any module
outside ``repro_torch``, numpy and the standard library — a reference
entry would import the JAX package.  A refused entry is a miss.

``plan_physical.calls`` is the counter the tests watch: a warm path plans
zero times.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import pickle
import sys
import tempfile
from typing import Callable, Mapping

from ...core.topology import ChipSpec, V5E
from .. import stats as S
from . import logical as L
from .executor import compile_plan
from .physical import DEFAULT_SALT_THRESHOLD, PhysicalPlan, PlannerConfig

# Bump whenever the key material, the pickle layout, or plan semantics
# change — stale artifacts from an older layout must read as misses.
CACHE_FORMAT_VERSION = 3

# Heavy-hitter shares below this floor are sampling noise, not skew: they
# can never push a shard past the salting threshold, so they must not
# perturb the cache key.
HEAVY_SHARE_FLOOR = 1.0 / 64.0

# The port's on-disk entries: ``torchplan-<digest>.pkl``.
ENTRY_PREFIX = "torchplan-"
ENTRY_SUFFIX = ".pkl"


# ---------------------------------------------------------------------------
# Canonical logical-DAG render (the collision-tested identity of a query).
# ---------------------------------------------------------------------------


def canonical_render(root: L.Node) -> str:
    """Structural serialization of a logical DAG.

    Purely a function of node types and field VALUES — never of object
    identity, construction order, or dict iteration — so two plans built
    independently (or in different processes) render identically iff they
    are the same query.  Shared subtrees render structurally (memoized by
    id only to keep DAG walks linear): sharing is an executor
    optimization, not part of the query's identity.
    """
    memo: dict[int, str] = {}

    def aggs(specs) -> str:
        return ";".join(f"{n}:{k}({e.render()})" for n, e, k in specs)

    def r(n: L.Node) -> str:
        if id(n) in memo:
            return memo[id(n)]
        if isinstance(n, L.Scan):
            out = f"Scan({n.table};{','.join(n.columns)})"
        elif isinstance(n, L.Filter):
            out = f"Filter({r(n.child)};{n.pred.render()})"
        elif isinstance(n, L.Project):
            der = ";".join(f"{name}={e.render()}" for name, e in n.derived)
            out = f"Project({r(n.child)};keep={','.join(n.keep)};der={der})"
        elif isinstance(n, L.HashJoin):
            out = (
                f"HashJoin(build={r(n.build)};probe={r(n.probe)};"
                f"on={n.build_key}={n.probe_key};"
                f"payload={','.join(n.payload)})"
            )
        elif isinstance(n, L.GroupBy):
            ke = n.key_expr.render() if n.key_expr is not None else ""
            out = (
                f"GroupBy({r(n.child)};key={n.key};key_expr={ke};"
                f"G={n.num_groups};aggs={aggs(n.aggs)})"
            )
        elif isinstance(n, L.Aggregate):
            out = f"Aggregate({r(n.child)};aggs={aggs(n.aggs)})"
        elif isinstance(n, L.TopK):
            out = (
                f"TopK({r(n.child)};key={n.key};k={n.k};"
                f"payload={','.join(n.payload)})"
            )
        else:
            raise TypeError(f"unknown logical node {type(n).__name__}")
        memo[id(n)] = out
        return out

    return r(root)


def _share_class(share: float) -> int:
    """Coarse magnitude class of a heavy-hitter share: floor(-log2(share)),
    clamped — 1/2 and 1/3 are both class 1, 1/5 is class 2, ...  Sampling
    noise moves a share a few percent; it takes a ~2x change to move class."""
    return min(int(-math.floor(math.log2(max(min(share, 1.0), 1e-9)))), 30)


def stats_bucket(stats: Mapping[str, S.TableProfile] | None) -> str:
    """Quantize optimizer statistics into the cache key's stats bucket.

    ``None`` (static planning) is its own bucket.  Otherwise, per table in
    name order: valid rows bucketed to powers of two, and per integer
    column the NDV power-of-two bucket plus the heavy-hitter set with each
    share reduced to its magnitude class (shares under
    ``HEAVY_SHARE_FLOOR`` dropped — they cannot trigger salting).  The raw
    sample is NOT part of the bucket: two samples of the same distribution
    hit the same cached plan.
    """
    if stats is None:
        return "static"
    parts = []
    for tname in sorted(stats):
        p = stats[tname]
        cols = []
        for cname in sorted(p.columns):
            cs = p.columns[cname]
            heavy = sorted(
                (int(k), _share_class(share))
                for k, share in cs.heavy_hitters
                if share >= HEAVY_SHARE_FLOOR
            )
            hh = ",".join(f"{k}^{c}" for k, c in heavy)
            cols.append(f"{cname}:ndv2^{max(int(cs.ndv), 1).bit_length()}:{hh}")
        parts.append(
            f"{tname}(rows2^{max(int(p.rows), 1).bit_length()};"
            + ";".join(cols) + ")"
        )
    return "|".join(parts)


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """A resolved cache key: the sha256 digest plus the full key material
    (a persisted entry stores the material, and a lookup whose material
    mismatches is a miss, so even a digest collision can never return a
    wrong plan)."""

    digest: str
    material: str


def plan_key(
    root: L.Node,
    catalog: L.Catalog,
    num_shards: int,
    num_pods: int = 1,
    cfg: PlannerConfig | None = None,
    chip: ChipSpec = V5E,
    topology: str = "ring",
    cross_pod: str | None = None,
    stats: Mapping[str, S.TableProfile] | None = None,
    salt_threshold: float = DEFAULT_SALT_THRESHOLD,
    morsel_rows: int | None = None,
) -> PlanKey:
    """The cache key for ``plan_physical`` with these exact arguments.

    Mirrors the planner's signature on purpose: everything
    ``plan_physical`` reads is in the material, and nothing else (the query
    *name* is display metadata, not identity).
    """
    cfg = cfg or PlannerConfig(num_units=num_shards, hybrid=True)
    material = "\n".join(
        (
            f"v={CACHE_FORMAT_VERSION}",
            f"plan={canonical_render(root)}",
            "catalog=" + ",".join(
                f"{t}:{int(catalog[t])}" for t in sorted(catalog)
            ),
            f"mesh=({int(num_shards)},{int(num_pods)})",
            f"cfg=({cfg.num_units},{cfg.threads_per_unit},{cfg.hybrid})",
            f"chip={chip.name}",
            f"topology={topology}",
            f"cross_pod={cross_pod}",
            f"salt_threshold={float(salt_threshold)!r}",
            f"stats={stats_bucket(stats)}",
            f"morsel_rows={morsel_rows}",
        )
    )
    digest = hashlib.sha256(material.encode("utf-8")).hexdigest()
    return PlanKey(digest=digest, material=material)


# ---------------------------------------------------------------------------
# Loading: only the port's own modules, numpy and the standard library.
# ---------------------------------------------------------------------------


class _PortUnpickler(pickle.Unpickler):
    """Refuses every global outside ``repro_torch``, numpy and the standard
    library, before importing it."""

    def find_class(self, module: str, name: str):
        top = module.split(".", 1)[0]
        if top not in ("repro_torch", "numpy") and top not in sys.stdlib_module_names:
            raise pickle.UnpicklingError(
                f"plan-cache entry refers to {module}.{name}; only repro_torch, "
                "numpy and the standard library are loaded"
            )
        return super().find_class(module, name)


# ---------------------------------------------------------------------------
# The cache.
# ---------------------------------------------------------------------------


class PlanCache:
    """Two-level plan + compile cache (module docstring for the design).

    ``cache_dir=None`` (and no ``REPRO_TORCH_PLAN_CACHE_DIR`` in the
    environment) keeps the cache in-process only; with a directory, plans
    persist across processes.  ``max_entries`` (or
    ``REPRO_TORCH_PLAN_CACHE_MAX``; 0 = unlimited) caps the on-disk entry
    count with LRU eviction.  Counters (``hits``/``misses``/``disk_hits``/
    ``evictions``/``executor_hits``/``executor_misses``) feed the serving
    engine's records.
    """

    def __init__(self, cache_dir: str | None = None,
                 max_entries: int | None = None):
        self.cache_dir = (
            cache_dir
            if cache_dir is not None
            else os.environ.get("REPRO_TORCH_PLAN_CACHE_DIR")
        )
        if max_entries is None:
            max_entries = int(os.environ.get("REPRO_TORCH_PLAN_CACHE_MAX", "0"))
        #: On-disk entry cap (0 = unlimited).  Enforced after every insert
        #: by mtime — effectively LRU, because lookup() touches the file.
        self.max_entries = max_entries
        self.evictions = 0
        self._plans: dict[str, PhysicalPlan] = {}
        self._runners: dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.executor_hits = 0
        self.executor_misses = 0

    # -- plan level --------------------------------------------------------

    def _path(self, key: PlanKey) -> str | None:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"{ENTRY_PREFIX}{key.digest}{ENTRY_SUFFIX}")

    def lookup(self, key: PlanKey) -> PhysicalPlan | None:
        """Memory, then disk.  Any persisted-entry problem — unreadable,
        refused by the unpickler, version drift, key-material mismatch — is
        a miss, never an error."""
        plan = self._plans.get(key.digest)
        if plan is not None:
            return plan
        path = self._path(key)
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                entry = _PortUnpickler(f).load()
            if (
                entry.get("version") != CACHE_FORMAT_VERSION
                or entry.get("material") != key.material
            ):
                return None
            plan = entry["plan"]
        except (OSError, pickle.PickleError, EOFError, KeyError,
                AttributeError, ImportError):
            return None
        try:
            os.utime(path)  # LRU touch: recency, not insertion order
        except OSError:
            pass
        self._plans[key.digest] = plan
        self.disk_hits += 1
        return plan

    def insert(self, key: PlanKey, plan: PhysicalPlan) -> None:
        self._plans[key.digest] = plan
        path = self._path(key)
        if path is None:
            return
        os.makedirs(self.cache_dir, exist_ok=True)
        entry = {
            "version": CACHE_FORMAT_VERSION,
            "material": key.material,
            "plan": plan,
        }
        # Atomic publish (tempfile + rename), so a concurrent reader sees
        # either no entry or a complete one.
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(entry, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._enforce_cap(keep=os.path.basename(path))

    def _enforce_cap(self, keep: str | None = None) -> None:
        """Bound the on-disk cache at ``max_entries`` of the port's entry
        files, evicting least-recently-used first (mtime order — ``lookup``
        touches on read).  Races with concurrent processes are benign:
        eviction is a best-effort unlink of a complete entry, a loser just
        re-plans, and every OSError is swallowed.  ``keep`` shields the
        just-inserted entry so the cap can never evict the plan the caller
        is about to rely on."""
        if not self.max_entries or not self.cache_dir:
            return
        try:
            names = [
                n for n in os.listdir(self.cache_dir)
                if n.startswith(ENTRY_PREFIX) and n.endswith(ENTRY_SUFFIX)
            ]
        except OSError:
            return
        if len(names) <= self.max_entries:
            return

        def mtime(n: str) -> float:
            try:
                return os.path.getmtime(os.path.join(self.cache_dir, n))
            except OSError:
                return float("inf")  # can't stat — treat as fresh, skip

        victims = sorted(names, key=mtime)
        excess = len(names) - self.max_entries
        for n in victims:
            if excess <= 0:
                break
            if n == keep:
                continue
            try:
                os.unlink(os.path.join(self.cache_dir, n))
                self.evictions += 1
                excess -= 1
            except OSError:
                excess -= 1  # someone else removed it — still gone

    def get_plan(
        self, key: PlanKey, planner: Callable[[], PhysicalPlan]
    ) -> tuple[PhysicalPlan, bool]:
        """Cached plan for ``key``, or plan-and-insert via ``planner()``.
        Returns ``(plan, hit)``."""
        plan = self.lookup(key)
        if plan is not None:
            self.hits += 1
            return plan, True
        self.misses += 1
        plan = planner()
        self.insert(key, plan)
        return plan, False

    # -- executor level ----------------------------------------------------

    def executor(
        self,
        key: PlanKey,
        plan: PhysicalPlan,
        tables,
        data_token: str = "",
        mux=None,
        **compile_kw,
    ) -> tuple[Callable, bool]:
        """In-process memo of :func:`compile_plan` runners.

        ``data_token`` names the table set the runner holds — the caller
        (the serving engine: one token per engine) changes it when the
        tables change, because a runner over stale copies would silently
        serve old data.  Returns ``(runner, hit)``.
        """
        knobs = tuple(sorted(compile_kw.items())) + (
            ("mux", id(mux)) if mux is not None else (),
        )
        memo_key = (key.digest, data_token, knobs)
        runner = self._runners.get(memo_key)
        if runner is not None:
            self.executor_hits += 1
            return runner, True
        self.executor_misses += 1
        runner = compile_plan(plan, tables, mux=mux, **compile_kw)
        self._runners[memo_key] = runner
        return runner, False

    # -- introspection -----------------------------------------------------

    def clear_memory(self) -> None:
        """Drop the in-process level only (tests use this to simulate a
        restart: persisted plans survive, compiled runners do not)."""
        self._plans.clear()
        self._runners.clear()

    def record(self) -> dict:
        total = self.hits + self.misses
        return dict(
            plan_hits=self.hits,
            plan_misses=self.misses,
            plan_disk_hits=self.disk_hits,
            plan_evictions=self.evictions,
            executor_hits=self.executor_hits,
            executor_misses=self.executor_misses,
            hit_fraction=(self.hits / total) if total else 0.0,
        )


__all__ = [
    "CACHE_FORMAT_VERSION",
    "PlanCache",
    "PlanKey",
    "canonical_render",
    "plan_key",
    "stats_bucket",
]
