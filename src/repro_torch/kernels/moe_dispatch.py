"""The MoE dispatch kernel for Hopper: wrapper and launch count.

Counterpart of ``repro.kernels.moe_dispatch``.  The kernel is CUDA C++ in
``csrc/moe_dispatch.cu`` (the source notes which TPU kernel it replaces, its
bound and what the design does about it), built at first use by
:mod:`.build` and loaded with ``ctypes``.

The wrapper takes a leading shard dim ``S`` and launches ONE kernel over all
shards.  Expert ids may be int32 or the router's int64 (``torch.topk``'s
index dtype), so the serving path launches no cast.  A tensor on the CPU
goes to the plain version in :mod:`.ref`; a CUDA tensor launches the kernel
or raises; a ``meta`` tensor (the dry run) gets outputs of the right shapes
and launches nothing.  Every call reports its work to an active op counter
(:mod:`repro_torch.obs.cost`): no flops, the ids read once and the slots and
counts written once.  ``LAUNCHES`` counts kernel launches only.

The call runs once per MoE layer of every decode step, where its host time
is most of its cost: the stream handle is the raw current stream, and a
shard of one tile (decode) takes no scratch.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import cost
from . import ref
from .build import CudaLibrary, raise_on

TILE_ROWS = 1024  # rows of a tile (one a thread) once a shard has more than this
_SMEM_INTS = 227 * 1024 // 4  # the most shared memory a block may opt into, int32


def _smem_ints(num_experts: int, threads: int = TILE_ROWS) -> int:
    """The kernel's shared memory: a [warps, E] table, two [E] rows, a
    look-back window of ``threads // E`` predecessors (at least one) and the
    block's ticket."""
    window = max(1, threads // num_experts)
    return (threads // 32 + 2 + window) * num_experts + window + 1


# At most TILE_ROWS: a look-back window holds one value a thread.
MAX_EXPERTS = max(e for e in range(1, TILE_ROWS + 1) if _smem_ints(e) <= _SMEM_INTS)
_ID_BYTES = {torch.int32: 4, torch.int64: 8}

LAUNCHES = {"moe_dispatch": 0}

# Per (CUDA device, stream): the look-back's int32 scratch, grown to the
# largest multi-tile shape seen on that stream.  "sync" (ticket, done
# counts, flags) is zeroed once and every launch leaves it zero; "vals"
# (totals, prefixes) is never cleared.  Launches on one stream run in order,
# so they can share a pair; launches on two streams may overlap, so each
# stream has its own.
_SCRATCH: dict[tuple[int | None, int, str], torch.Tensor] = {}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_dispatch_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i64, ptr, i64, i32, i32, i32,
                                        i32, ptr]
    lib.moe_dispatch_launch.restype = i32


LIBRARY = CudaLibrary("moe_dispatch.cu", _bind)


def reset_launch_counts() -> None:
    LAUNCHES["moe_dispatch"] = 0


def scratch_ints(S: int, T: int, num_experts: int) -> tuple[int, int]:
    """The look-back scratch a launch needs, int32: sync (a ticket, a done
    count a shard, a flag a tile) and vals (a total and an inclusive prefix
    row of ``num_experts`` a tile); none when every shard is one tile."""
    tiles = -(-T // TILE_ROWS)
    if tiles <= 1:
        return 0, 0
    return 1 + S + S * tiles, 2 * S * tiles * num_experts


def _scratch(device: torch.device, stream: int, kind: str, n: int) -> int:
    key = (device.index, stream, kind)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        make = torch.zeros if kind == "sync" else torch.empty
        buf = _SCRATCH[key] = make(n, dtype=torch.int32, device=device)
    return buf.data_ptr()


def moe_dispatch(
    dest: torch.Tensor, num_dest: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded slots for ``[S, T]`` int32 or int64 expert ids:
    ``(slot [S, T], counts [S, num_dest])``, both int32; overflow and ids
    outside ``[0, num_dest)`` go to the drop bin ``num_dest * capacity``."""
    rows = dest.shape[0] if dest.dim() else 1
    nbytes = dest.numel() * (dest.element_size() + 4) + 4 * rows * num_dest
    with cost.kernel("moe_dispatch", 0, nbytes):
        if dest.device.type == "cpu":
            return ref.moe_dispatch_ref(dest, num_dest, capacity)
        if dest.device.type == "meta":
            return (dest.new_empty(dest.shape, dtype=torch.int32),
                    dest.new_empty((rows, num_dest), dtype=torch.int32))
        return _launch(dest, num_dest, capacity)


def _launch(dest: torch.Tensor, num_dest: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    dev = dest.device
    id_bytes = _ID_BYTES.get(dest.dtype)
    if id_bytes is None or dest.dim() != 2 or not dest.is_contiguous():
        raise ValueError(
            f"dest: need a contiguous int32 or int64 tensor [S, T], got {dest.dtype} "
            f"{tuple(dest.shape)} contiguous={dest.is_contiguous()}"
        )
    if dev.type != "cuda":
        raise ValueError(f"moe_dispatch: tensors on {dev} are neither CPU nor CUDA")
    S, T = dest.shape
    if not 0 < num_dest <= MAX_EXPERTS:
        raise ValueError(f"moe_dispatch: {num_dest} experts exceed the kernel's limit "
                         f"({MAX_EXPERTS}: shared memory, a look-back value a thread)")
    if capacity < 0 or (num_dest + 1) * capacity >= 2**31 or S * T >= 2**31:
        raise ValueError(f"moe_dispatch: S*T={S * T}, E={num_dest}, C={capacity} exceed int32")
    lib = LIBRARY.load()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    sync = vals = None
    n_sync = n_vals = 0
    if T > TILE_ROWS:
        n_sync, n_vals = scratch_ints(S, T, num_dest)
        sync = _scratch(dev, stream, "sync", n_sync)
        vals = _scratch(dev, stream, "vals", n_vals)
    slot = torch.empty((S, T), dtype=torch.int32, device=dev)
    counts = torch.empty((S, num_dest), dtype=torch.int32, device=dev)
    err = lib.moe_dispatch_launch(
        dest.data_ptr(), id_bytes, slot.data_ptr(), counts.data_ptr(), sync, n_sync, vals,
        n_vals, S, T, num_dest, capacity, stream,
    )
    raise_on("moe_dispatch", err)
    LAUNCHES["moe_dispatch"] += 1
    return slot, counts


__all__ = ["LIBRARY", "LAUNCHES", "MAX_EXPERTS", "TILE_ROWS", "reset_launch_counts",
           "scratch_ints", "moe_dispatch"]
