"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

* ``ref``            — plain versions (the CPU path, and the yardstick the
  card's kernels are held to);
* ``hash_partition`` — the CUDA pack kernels (``csrc/hash_partition.cu``):
  build, wrappers, launch counts;
* ``ops``            — global within-bin ranks over the kernels' block
  outputs (the shuffle's entry points).

Of the reference's six Pallas kernels, ``hash_partition_pack`` and
``partition_pack`` are ported; ``hash_partition``, ``moe_dispatch``,
``flash_attention`` and ``ssd_scan`` are still to be ported.
"""

__all__ = ["ops", "ref", "hash_partition"]
