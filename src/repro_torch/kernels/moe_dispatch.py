"""The MoE dispatch kernel for Hopper: wrapper and launch count.

Counterpart of ``repro.kernels.moe_dispatch``.  The kernel is CUDA C++ in
``csrc/moe_dispatch.cu`` (the source notes which TPU kernel it replaces, its
bound and what the design does about it), built at first use by
:mod:`.build` and loaded with ``ctypes``.

The wrapper takes a leading shard dim ``S`` and launches ONE kernel over all
shards.  A tensor on the CPU goes to the plain version in :mod:`.ref`; a
CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import CudaLibrary, check_int32, raise_on

# Shared memory holds 32 warps x E counters plus E running counts within the
# 48 KB a block gets without opting in.
MAX_EXPERTS = 48 * 1024 // (33 * 4)

LAUNCHES = {"moe_dispatch": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_dispatch_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.moe_dispatch_launch.restype = i32


LIBRARY = CudaLibrary("moe_dispatch.cu", _bind)


def reset_launch_counts() -> None:
    LAUNCHES["moe_dispatch"] = 0


def moe_dispatch(
    dest: torch.Tensor, num_dest: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded slots for ``[S, T]`` int32 expert ids:
    ``(slot [S, T], counts [S, num_dest])``; overflow and ids outside
    ``[0, num_dest)`` go to the drop bin ``num_dest * capacity``."""
    if dest.device.type == "cpu":
        return ref.moe_dispatch_ref(dest, num_dest, capacity)
    S, T = dest.shape
    check_int32("dest", dest, (S, T))
    if dest.device.type != "cuda":
        raise ValueError(f"moe_dispatch: tensors on {dest.device} are neither CPU nor CUDA")
    if not 0 < num_dest <= MAX_EXPERTS:
        raise ValueError(f"moe_dispatch: {num_dest} experts exceed the kernel's shared memory "
                         f"({MAX_EXPERTS})")
    if capacity < 0 or (num_dest + 1) * capacity >= 2**31 or S * T >= 2**31:
        raise ValueError(f"moe_dispatch: S*T={S * T}, E={num_dest}, C={capacity} exceed int32")
    lib = LIBRARY.load()
    slot = torch.empty_like(dest)
    counts = torch.empty((S, num_dest), dtype=torch.int32, device=dest.device)
    stream = torch.cuda.current_stream(dest.device).cuda_stream
    err = lib.moe_dispatch_launch(
        dest.data_ptr(), slot.data_ptr(), counts.data_ptr(), S, T, num_dest, capacity, stream,
    )
    raise_on("moe_dispatch", err)
    LAUNCHES["moe_dispatch"] += 1
    return slot, counts


__all__ = ["LIBRARY", "LAUNCHES", "MAX_EXPERTS", "reset_launch_counts", "moe_dispatch"]
