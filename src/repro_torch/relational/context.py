"""One execution-configuration object for the query surface (port of
``repro.relational.context``).

Mesh shape, multiplexer knobs, planner config, stats mode, the out-of-core
morsel and spill knobs, the device and the observability hook live in one
frozen, hashable dataclass that every entry point accepts.  The device
defaults to the card (``"cuda"``); ``device="cpu"`` runs the plain versions
on the CPU.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Any, Mapping

if TYPE_CHECKING:  # annotation-only: keeps this module import-cycle-free
    from ..obs.trace import Tracer
    from .planner.physical import PlannerConfig

__all__ = [
    "StatsMode",
    "ExecutionContext",
    "require_context",
]


class StatsMode(enum.Enum):
    """How the planner obtains table statistics."""

    #: Plan from catalog capacities only (no sampling).
    STATIC = "static"
    #: Sample the input tables at plan time
    #: (:func:`repro_torch.relational.stats.collect_stats`).
    COLLECT = "collect"
    #: Use the pre-collected profile in ``ExecutionContext.stats_profile``
    #: (from :func:`repro_torch.relational.stats.collect_stats`).
    PROFILE = "profile"


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """Frozen bundle of everything that parameterizes query execution.

    ``stats_profile`` and ``trace`` are payload, not configuration: they
    are excluded from equality and hash.  The process layout is not here
    either: inside a launched cluster the mesh spans the processes
    (:func:`repro_torch.core.exchange.make_mesh`), so it never enters a
    plan-cache key or ``explain()``.  In particular a traced and an
    untraced context compare (and hash) EQUAL, so attaching a tracer can
    never invalidate a plan-cache entry or an executor memo: tracing
    changes what gets written down, never what runs.
    """

    # --- mesh shape -------------------------------------------------------
    num_shards: int = 1
    num_pods: int = 1
    # --- multiplexer knobs (see core.multiplexer.make_multiplexer) --------
    impl: str = "auto"
    pack_impl: str | None = None  # "torch" | "cuda" | None (tuned)
    num_chunks: int | None = None
    cross_pod: str | None = None
    # --- planner ----------------------------------------------------------
    cfg: PlannerConfig | None = None
    stats_mode: StatsMode = StatsMode.STATIC
    stats_profile: Mapping[str, Any] | None = dataclasses.field(
        default=None, compare=False
    )
    # --- out-of-core morsel streaming ------------------------------------
    #: Global rows per morsel.  On plain in-memory tables this wraps any
    #: table larger than ``morsel_rows`` in a chunked MorselView; chunked
    #: DataSources stream regardless.  None = fully in-memory execution.
    morsel_rows: int | None = None
    #: Hard per-device row budget.  In-memory execution refuses tables whose
    #: per-shard slice exceeds it; streamed execution bounds morsels and
    #: resident state by it.  None = unbounded.
    device_row_budget: int | None = None
    #: Per-(src,dst) message capacity for streamed exchanges.  None sizes
    #: messages for structural zero drop; smaller values force overflow
    #: (spill when ``spill=True``, error otherwise).
    exchange_rows: int | None = None
    #: Route exchange overflow to a host-memory overflow partition and
    #: re-shuffle it in drain passes instead of raising.
    spill: bool = False
    #: Per-shard capacity of streamed group-by state (distinct groups per
    #: shard).  None = min(plan capacity, device_row_budget).
    group_state_rows: int | None = None
    #: Depth of the host-to-device prefetch queue for morsel streaming.
    prefetch_depth: int = 2
    # --- where the tensors live ------------------------------------------
    device: str = "cuda"
    # --- observability ----------------------------------------------------
    #: A :class:`repro_torch.obs.trace.Tracer` to record spans, counters and
    #: per-run query traces into.  Excluded from equality and hash (see the
    #: class docstring).
    trace: "Tracer | None" = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self.num_shards < 1 or self.num_pods < 1:
            raise ValueError("num_shards and num_pods must be >= 1")
        if self.num_shards % self.num_pods:
            raise ValueError(
                f"num_shards={self.num_shards} not divisible by num_pods={self.num_pods}"
            )
        if not isinstance(self.stats_mode, StatsMode):
            raise TypeError(f"stats_mode must be a StatsMode, got {self.stats_mode!r}")
        if self.stats_mode is StatsMode.PROFILE and self.stats_profile is None:
            raise ValueError("StatsMode.PROFILE requires stats_profile")
        if self.stats_profile is not None and self.stats_mode is not StatsMode.PROFILE:
            raise ValueError("stats_profile is only meaningful with StatsMode.PROFILE")
        if self.pack_impl not in (None, "torch", "cuda"):
            raise ValueError(f"pack_impl must be 'torch', 'cuda' or None, got {self.pack_impl!r}")

    def planner_stats(self, tables: Mapping[str, Any] | None = None):
        """The ``stats`` argument for ``plan_physical``.

        ``tables`` (name -> Table) is required for COLLECT mode; pass the
        query's input tables.
        """
        if self.stats_mode is StatsMode.STATIC:
            return None
        if self.stats_mode is StatsMode.PROFILE:
            return dict(self.stats_profile)
        if tables is None:
            raise ValueError("StatsMode.COLLECT needs the input tables to sample")
        from . import stats as rstats

        return rstats.collect_stats(dict(tables))

    def with_(self, **changes) -> "ExecutionContext":
        """`dataclasses.replace` spelled as a method."""
        return dataclasses.replace(self, **changes)


def require_context(ctx: Any, *, where: str) -> ExecutionContext:
    """Entry-point guard: anything that is not an :class:`ExecutionContext`
    gets a pointed TypeError."""
    if isinstance(ctx, ExecutionContext):
        return ctx
    raise TypeError(
        f"{where}: expected an ExecutionContext, got {type(ctx).__name__!r}"
    )
