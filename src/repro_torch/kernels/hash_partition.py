"""The exchange's pack kernels for Hopper: wrappers and launch counts.

Counterpart of ``repro.kernels.hash_partition``.  The kernels are CUDA C++
in ``csrc/hash_partition.cu`` (the source notes which TPU kernel each
replaces, its memory bound and what the design does about it), built at
first use by :mod:`.build` and loaded with ``ctypes``.

Every wrapper takes a leading shard dim ``S`` and launches ONE kernel over
all shards.  A tensor on the CPU goes to the plain version in :mod:`.ref`; a
CUDA tensor launches the kernel or raises; a ``meta`` tensor (the dry run)
gets outputs of the right shapes and launches nothing.  Every call reports
its work to an active op counter (:mod:`repro_torch.obs.cost`): no flops,
its inputs read once and its outputs written once, all int32.
``LAUNCHES`` counts kernel launches only (plain-version calls never
count).  The stream handle is the
raw current stream (``torch.cuda.current_stream`` costs microseconds a
call), and the checks are the ones the kernel needs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..obs import cost
from . import ref
from .build import CudaLibrary, check_int32 as _check, raise_on as _raise_on

MAX_BLOCK = 256
# Past 32 bins the kernel keeps 8 warps x bins int32 counters in shared
# memory, within the 48 KB a block gets without opting in.
MAX_BINS = 48 * 1024 // (8 * 4)

LAUNCHES = {"hash_partition_pack": 0, "partition_pack": 0, "hash_partition": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hash_partition_pack_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.hash_partition_pack_launch.restype = i32
    lib.partition_pack_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.partition_pack_launch.restype = i32
    lib.hash_partition_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.hash_partition_launch.restype = i32


LIBRARY = CudaLibrary("hash_partition.cu", _bind)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_launch(name: str, S: int, T: int, block: int, num_bins: int, dev) -> int:
    """Raise on what the kernel cannot take; return the raw current stream."""
    if not 0 < block <= MAX_BLOCK or T % block:
        raise ValueError(f"{name}: block={block} must be in (0, {MAX_BLOCK}] and divide T={T}")
    if num_bins > MAX_BINS:
        raise ValueError(f"{name}: {num_bins} bins exceed the kernel's shared memory ({MAX_BINS})")
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} are neither CPU nor CUDA")
    if S * T >= 2**31:
        raise ValueError(f"{name}: S*T={S * T} rows exceed the kernel's int arguments")
    return torch._C._cuda_getCurrentRawStream(dev.index)


def hash_partition_pack(
    keys: torch.Tensor, valid: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused hash + mask + pack metadata over ``[S, T]`` int32 keys.

    Returns ``(dest [S, T], per-block histograms [S, T/block, P+1],
    block-local ranks [S, T])``; ``valid`` is int32 (nonzero == valid).
    """
    S, T = keys.shape
    hist = (S, T // max(block, 1), num_partitions + 1)
    with cost.kernel("hash_partition_pack", 0, 4 * (4 * S * T + math.prod(hist))):
        if keys.device.type == "cpu":
            return ref.hash_partition_pack_ref(keys, valid, num_partitions, block)
        if keys.device.type == "meta":
            return torch.empty_like(keys), keys.new_empty(hist), torch.empty_like(keys)
        return _hash_partition_pack(keys, valid, num_partitions, block)


def _hash_partition_pack(keys, valid, num_partitions: int, block: int):
    S, T = keys.shape
    _check("keys", keys, (S, T))
    _check("valid", valid, (S, T))
    stream = _check_launch("hash_partition_pack", S, T, block, num_partitions + 1, keys.device)
    lib = LIBRARY.load()
    dest = torch.empty_like(keys)
    rank = torch.empty_like(keys)
    hist = torch.empty((S, T // block, num_partitions + 1), dtype=torch.int32,
                       device=keys.device)
    err = lib.hash_partition_pack_launch(
        keys.data_ptr(), valid.data_ptr(), dest.data_ptr(), hist.data_ptr(),
        rank.data_ptr(), S, T, block, num_partitions, stream,
    )
    _raise_on("hash_partition_pack", err)
    LAUNCHES["hash_partition_pack"] += 1
    return dest, hist, rank


def partition_pack(
    dest: torch.Tensor, num_bins: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank + block histogram for given ``[S, T]`` int32 destinations.

    Returns ``(per-block histograms [S, T/block, num_bins], block-local
    ranks [S, T])``; out-of-range ids get rank 0 and are not counted.
    """
    S, T = dest.shape
    hist = (S, T // max(block, 1), num_bins)
    with cost.kernel("partition_pack", 0, 4 * (2 * S * T + math.prod(hist))):
        if dest.device.type == "cpu":
            return ref.partition_pack_ref(dest, num_bins, block)
        if dest.device.type == "meta":
            return dest.new_empty(hist), torch.empty_like(dest)
        return _partition_pack(dest, num_bins, block)


def _partition_pack(dest, num_bins: int, block: int):
    S, T = dest.shape
    _check("dest", dest, (S, T))
    stream = _check_launch("partition_pack", S, T, block, num_bins, dest.device)
    lib = LIBRARY.load()
    rank = torch.empty_like(dest)
    hist = torch.empty((S, T // block, num_bins), dtype=torch.int32, device=dest.device)
    err = lib.partition_pack_launch(
        dest.data_ptr(), hist.data_ptr(), rank.data_ptr(), S, T, block,
        num_bins, stream,
    )
    _raise_on("partition_pack", err)
    LAUNCHES["partition_pack"] += 1
    return hist, rank


def hash_partition(
    keys: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash ``[S, T]`` int32 keys to partition ids: ``(pid [S, T],
    per-block histograms [S, T/block, P])``."""
    S, T = keys.shape
    hist = (S, T // max(block, 1), num_partitions)
    with cost.kernel("hash_partition", 0, 4 * (2 * S * T + math.prod(hist))):
        if keys.device.type == "cpu":
            return ref.hash_partition_ref(keys, num_partitions, block)
        if keys.device.type == "meta":
            return torch.empty_like(keys), keys.new_empty(hist)
        return _hash_partition(keys, num_partitions, block)


def _hash_partition(keys, num_partitions: int, block: int):
    S, T = keys.shape
    _check("keys", keys, (S, T))
    stream = _check_launch("hash_partition", S, T, block, num_partitions, keys.device)
    lib = LIBRARY.load()
    pid = torch.empty_like(keys)
    hist = torch.empty((S, T // block, num_partitions), dtype=torch.int32, device=keys.device)
    err = lib.hash_partition_launch(
        keys.data_ptr(), pid.data_ptr(), hist.data_ptr(), S, T, block, num_partitions, stream,
    )
    _raise_on("hash_partition", err)
    LAUNCHES["hash_partition"] += 1
    return pid, hist


__all__ = [
    "LIBRARY",
    "LAUNCHES",
    "MAX_BINS",
    "reset_launch_counts",
    "hash_partition_pack",
    "partition_pack",
    "hash_partition",
]
