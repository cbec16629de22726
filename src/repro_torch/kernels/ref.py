"""Plain PyTorch versions of the pack kernels (counterpart of ``repro.kernels.ref``).

Every function works on a leading shard dim ``S``: shard ``s`` of each
output equals the reference's per-device output for shard ``s`` of the
input.  The kernel wrappers in :mod:`.hash_partition` run these for tensors
that lie on the CPU; ``chip_smoke.py`` holds the CUDA kernels to them on the
card.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def fibonacci_hash(keys: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 multiply-xor avalanche, as int64 values in
    ``[0, 2**32)``.

    PyTorch on the CPU has no ``>>`` for ``uint32``, so the arithmetic runs
    in int64 and masks to 32 bits after every multiply.  The second constant
    is above ``2**31``, so its product can wrap int64; only the low 32 bits
    are kept, and those are exact under two's-complement wrap.
    """
    x = keys.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x


def partition_pack_ref(
    dest: torch.Tensor, num_bins: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-block histograms ``[S, T/block, num_bins]``, block-local ranks
    ``[S, T]``) for int32 destination ids ``[S, T]``.

    Out-of-range ids (the padding value) match no bin: rank 0, uncounted.
    """
    S, T = dest.shape
    assert T % block == 0, (T, block)
    d = dest.reshape(S, T // block, block)
    bins = torch.arange(num_bins, device=dest.device, dtype=dest.dtype)
    onehot = (d[..., None] == bins).to(torch.int32)
    csum = onehot.cumsum(2, dtype=torch.int32)
    local = ((csum - onehot) * onehot).sum(-1, dtype=torch.int32).reshape(S, T)
    hist = onehot.sum(2, dtype=torch.int32)
    return hist, local


def hash_partition_pack_ref(
    keys: torch.Tensor, valid: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dest ``[S, T]``, per-block histograms ``[S, T/block, P+1]``,
    block-local ranks ``[S, T]``); invalid rows go to the overflow bin ``P``."""
    pid = (fibonacci_hash(keys) % num_partitions).to(torch.int32)
    dest = torch.where(valid != 0, pid, num_partitions).to(torch.int32)
    hist, local = partition_pack_ref(dest, num_partitions + 1, block)
    return dest, hist, local


__all__ = ["fibonacci_hash", "partition_pack_ref", "hash_partition_pack_ref"]
