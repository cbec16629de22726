"""The paper's own workload configuration (TPC-H over the exchange engine);
port of ``repro.configs.paper``.

Mirrors the evaluation setup of §4: a 6-unit cluster (the nearest power of
two on the simulated mesh), SF-scaled TPC-H, hash-partition vs broadcast
per the hybrid planner, round-robin scheduled transport.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    scale_factor: float = 0.02      # CPU-scale stand-in for the paper's SF 100
    num_units: int = 8              # paper: 6 servers; the 8-unit simulated mesh
    threads_per_unit: int = 40      # paper's 20 cores x 2 HT (cost model only)
    exchange_impl: str = "round_robin"   # the paper's scheduled transport
    message_bytes: int = 512 * 1024      # paper §3.2.3: 512 KB messages
    zipf_z: float = 0.84            # §3.1 skew experiment
    queries: tuple = ("q1", "q6", "q17", "q3")


CONFIG = PaperConfig()
SMOKE = dataclasses.replace(CONFIG, scale_factor=0.001, num_units=4)
