"""The exchange's pack kernels for Hopper: wrappers, build and launch counts.

Counterpart of ``repro.kernels.hash_partition``.  The kernels are CUDA C++
in ``csrc/hash_partition.cu`` (the source notes which TPU kernel each
replaces, its memory bound and what the design does about it).  They are
built at first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, keyed by a hash of the source, under ``_build/`` beside
this file, and loaded with ``ctypes``.

Both wrappers take a leading shard dim ``S`` and launch ONE kernel over all
shards.  A tensor on the CPU goes to the plain version in :mod:`.ref`; a
CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches only (plain-version calls never count).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "hash_partition.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_BLOCK = 256
# Shared memory holds 8 warps x bins int32 counters within the 48 KB a
# block gets without opting in.
MAX_BINS = 48 * 1024 // (8 * 4)

LAUNCHES = {"hash_partition_pack": 0, "partition_pack": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA pack kernels cannot be built")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.

    ``BUILD_INFO`` records the library path, the seconds ``nvcc`` took (0.0
    when the library was already built) and ``-Xptxas -v``'s report.
    """
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"hash_partition_{digest}.so"
        seconds, log = 0.0, ""
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hash_partition_pack_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr
        ]
        lib.hash_partition_pack_launch.restype = i32
        lib.partition_pack_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.partition_pack_launch.restype = i32
        BUILD_INFO.update(path=str(lib_path), seconds=seconds, log=log)
        _lib = lib
        return lib


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous int32 tensor of shape {shape}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _check_launch(name: str, S: int, T: int, block: int, num_bins: int, dev) -> None:
    if not 0 < block <= MAX_BLOCK or T % block:
        raise ValueError(f"{name}: block={block} must be in (0, {MAX_BLOCK}] and divide T={T}")
    if num_bins > MAX_BINS:
        raise ValueError(f"{name}: {num_bins} bins exceed the kernel's shared memory ({MAX_BINS})")
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} are neither CPU nor CUDA")
    if S * T >= 2**31:
        raise ValueError(f"{name}: S*T={S * T} rows exceed int32 indexing")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def hash_partition_pack(
    keys: torch.Tensor, valid: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused hash + mask + pack metadata over ``[S, T]`` int32 keys.

    Returns ``(dest [S, T], per-block histograms [S, T/block, P+1],
    block-local ranks [S, T])``; ``valid`` is int32 (nonzero == valid).
    """
    if keys.device.type == "cpu":
        return ref.hash_partition_pack_ref(keys, valid, num_partitions, block)
    S, T = keys.shape
    _check("keys", keys, (S, T))
    _check("valid", valid, (S, T))
    _check_launch("hash_partition_pack", S, T, block, num_partitions + 1, keys.device)
    lib = build()
    dest = torch.empty_like(keys)
    rank = torch.empty_like(keys)
    hist = torch.empty((S, T // block, num_partitions + 1), dtype=torch.int32,
                       device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
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
    if dest.device.type == "cpu":
        return ref.partition_pack_ref(dest, num_bins, block)
    S, T = dest.shape
    _check("dest", dest, (S, T))
    _check_launch("partition_pack", S, T, block, num_bins, dest.device)
    lib = build()
    rank = torch.empty_like(dest)
    hist = torch.empty((S, T // block, num_bins), dtype=torch.int32, device=dest.device)
    stream = torch.cuda.current_stream(dest.device).cuda_stream
    err = lib.partition_pack_launch(
        dest.data_ptr(), hist.data_ptr(), rank.data_ptr(), S, T, block,
        num_bins, stream,
    )
    _raise_on("partition_pack", err)
    LAUNCHES["partition_pack"] += 1
    return hist, rank


__all__ = [
    "SOURCE",
    "BUILD_DIR",
    "BUILD_INFO",
    "LAUNCHES",
    "MAX_BINS",
    "build",
    "reset_launch_counts",
    "hash_partition_pack",
    "partition_pack",
]
