"""One execution-configuration object for the query surface (port of
``repro.relational.context``).

Mesh shape, multiplexer knobs, planner config, stats mode and the device
live in one frozen, hashable dataclass that every entry point accepts.  The
device defaults to the card (``"cuda"``); ``device="cpu"`` runs the plain
versions on the CPU.  The fields that later slices of the port fill
(``trace`` for telemetry, ``morsel_rows`` and ``spill`` for out-of-core
streaming) exist so code written against the reference's context reads the
same, and setting any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Any, Mapping

if TYPE_CHECKING:  # annotation-only: keeps this module import-cycle-free
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
    #: Use the pre-collected profile in ``ExecutionContext.stats_profile``
    #: (from :func:`repro_torch.relational.stats.collect_stats`).
    PROFILE = "profile"


# field -> the slice of the port that brings it
_LATER_SLICES = {
    "trace": "the telemetry slice (obs/)",
    "morsel_rows": "the streaming and spill slice",
    "spill": "the streaming and spill slice",
}


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """Frozen bundle of everything that parameterizes query execution.

    ``stats_profile`` is payload, not configuration: it is excluded from
    equality and hash.
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
    # --- where the tensors live ------------------------------------------
    device: str = "cuda"
    # --- later slices -----------------------------------------------------
    trace: Any = dataclasses.field(default=None, compare=False, repr=False)
    morsel_rows: int | None = None
    spill: bool = False

    def __post_init__(self) -> None:
        for name, slice_ in _LATER_SLICES.items():
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(
                    f"ExecutionContext.{name} is not ported yet; it comes "
                    f"with {slice_}"
                )
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

    def planner_stats(self):
        """The ``stats`` argument for ``plan_physical``."""
        if self.stats_mode is StatsMode.PROFILE:
            return dict(self.stats_profile)
        return None



def require_context(ctx: Any, *, where: str) -> ExecutionContext:
    """Entry-point guard: anything that is not an :class:`ExecutionContext`
    gets a pointed TypeError."""
    if isinstance(ctx, ExecutionContext):
        return ctx
    raise TypeError(
        f"{where}: expected an ExecutionContext, got {type(ctx).__name__!r}"
    )
