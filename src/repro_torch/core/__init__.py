"""Core of the port: the paper's exchange machinery on PyTorch.

- ``schedule``    — round-robin conflict-free phase schedules (Fig 10a)
- ``topology``    — the reference's TPU cost-model constants + the
                    switch-contention simulator + the pack/shuffle cost model
- ``hybrid``      — hybrid-parallelism planner + paper cost model (§3.1)
- ``autotune``    — plan-time knob tuner for the multiplexer
- ``exchange``    — decoupled exchange operators on the simulated fabric
- ``multiplexer`` — per-mesh communication policy (the RDMA multiplexer)
"""

from . import autotune, exchange, hybrid, multiplexer, schedule, topology

__all__ = ["autotune", "exchange", "hybrid", "multiplexer", "schedule", "topology"]
