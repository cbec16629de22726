"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

* ``ref``            — plain versions (the CPU path, and the yardstick the
  card's kernels are held to);
* ``build``          — ``nvcc`` builds of ``csrc/*.cu`` and their loading;
* ``hash_partition`` — the CUDA hash and pack kernels
  (``csrc/hash_partition.cu``): wrappers, launch counts;
* ``moe_dispatch``   — the CUDA MoE dispatch kernel
  (``csrc/moe_dispatch.cu``): wrapper, launch count;
* ``flash_attention`` — the CUDA attention forward kernel
  (``csrc/flash_attention.cu``): wrapper, launch count;
* ``ssd_scan``       — the CUDA Mamba2 SSD chunk-scan kernel
  (``csrc/ssd_scan.cu``): wrapper, launch count;
* ``ops``            — the entry points callers use (global within-bin
  ranks over the pack kernels' block outputs, hash partition, MoE slots,
  attention in the model layout, the SSD chunk scan).

All six of the reference's Pallas kernels are ported: ``hash_partition_pack``,
``partition_pack``, ``hash_partition``, ``moe_dispatch``, ``flash_attention``
and ``ssd_scan``.
"""

__all__ = ["build", "ops", "ref", "hash_partition", "moe_dispatch", "flash_attention",
           "ssd_scan"]
