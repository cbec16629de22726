"""Entry points over the kernels (counterpart of ``repro.kernels.ops``).

The pack kernels give per-block histograms and block-local ranks; turning
them into global within-bin ranks is an ``[S, nblocks, bins]`` exclusive
scan and a flat gather, left to plain PyTorch as the reference leaves it to
XLA.  Every pack and dispatch function takes a leading shard dim ``S`` and
launches one kernel over all shards.

Attention takes the model layout ``[B, S, H, D]``: :func:`flash_attention`
is the forward kernel; its differentiable form, whose backward recomputes
through the query-chunked plain attention, is
``repro_torch.models.layers.flash_attention_vjp``.  The Mamba2 chunk scan
:func:`ssd_scan` takes the reference's layout.  The reference's
``use_kernels`` switch, its ``use_kernel`` flag on ``ssd_chunked`` and its
attention and scan shape gates have no counterpart: the plain versions run
only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa_kern
from . import hash_partition as kern
from . import moe_dispatch as moe_kern
from . import ssd_scan as ssd_kern


def _combine_block_ranks(
    hist: torch.Tensor, local_rank: torch.Tensor, dest: torch.Tensor, blk: int
) -> torch.Tensor:
    """``rank[s, t] = sum(hist[s, b, dest[s, t]] for b < t // blk) +
    local_rank[s, t]``: nothing of shape ``[rows, bins]`` exists."""
    S, _, num_bins = hist.shape
    base = hist.cumsum(1, dtype=torch.int32) - hist  # exclusive over blocks
    blocks = torch.arange(dest.shape[1], device=dest.device) // blk
    flat_idx = blocks * num_bins + dest.clamp(0, num_bins - 1).long()
    return base.reshape(S, -1).gather(1, flat_idx) + local_rank


def partition_ranks(
    dest: torch.Tensor, num_bins: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(within-bin ranks ``[S, T]``, bin counts ``[S, num_bins]``) for
    destination ids ``[S, T]``.

    Ids outside ``[0, num_bins)`` get an arbitrary rank and count nowhere.
    Any ``T`` works: rows are padded with the inert id ``num_bins``.
    """
    S, T = dest.shape
    blk = min(block, T)
    pad = (-T) % blk
    d = dest.to(torch.int32)
    if pad:
        d = torch.cat([d, d.new_full((S, pad), num_bins)], dim=1)
    hist, local = kern.partition_pack(d.contiguous(), num_bins, block=blk)
    rank = _combine_block_ranks(hist, local, d, blk)
    return rank[:, :T], hist.sum(1, dtype=torch.int32)


def hash_partition_ranks(
    keys: torch.Tensor, valid: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused hash + mask + rank: (dest ``[S, T]``, ranks ``[S, T]``, counts
    ``[S, P+1]``).

    ``dest`` is the masked destination (invalid rows -> overflow bin ``P``).
    Padding rows land in the overflow bin, so only ``counts[:, :P]`` is
    meaningful to callers.
    """
    S, T = keys.shape
    blk = min(block, T)
    pad = (-T) % blk
    k = keys.to(torch.int32)
    v = valid.to(torch.int32)
    if pad:
        k = torch.cat([k, k.new_zeros((S, pad))], dim=1)
        v = torch.cat([v, v.new_zeros((S, pad))], dim=1)
    dest, hist, local = kern.hash_partition_pack(
        k.contiguous(), v.contiguous(), num_partitions, block=blk
    )
    rank = _combine_block_ranks(hist, local, dest, blk)
    return dest[:, :T], rank[:, :T], hist.sum(1, dtype=torch.int32)


def hash_partition(
    keys: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(partition ids ``[S, T]``, per-block histograms ``[S, T/blk, P]``)
    with ``blk = min(block, T)``, which must divide ``T``."""
    T = keys.shape[1]
    blk = min(block, T)
    if T % blk:
        raise ValueError(f"hash_partition: block {blk} does not divide T={T}")
    return kern.hash_partition(keys.to(torch.int32).contiguous(), num_partitions, block=blk)


def moe_dispatch(
    dest: torch.Tensor, num_dest: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot ``[S, T]``, counts ``[S, num_dest]``); overflow -> the drop bin
    ``num_dest * capacity``.  Any ``T``: the kernel masks the ragged tile
    itself, so no padding id is appended.  int32 ids, and the router's
    int64 ones, reach the kernel without a cast."""
    if dest.dtype not in (torch.int32, torch.int64):
        dest = dest.to(torch.int32)
    return moe_kern.moe_dispatch(dest.contiguous(), num_dest, capacity)


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """``q [B, Sq, H, D]``, ``k``/``v [B, Sk, KH, D]`` (the model layout) ->
    ``[B, Sq, H, D]``, through the kernel layout ``[B, H, S, D]``.

    A CUDA tensor launches the kernel at every length (it masks its last,
    partial tiles) and every head dim ``0 < D <= 256`` (one outside {32, 64,
    128, 256} is zero-padded to the next); it raises for anything else (``D
    > 256``, no key, another dtype) and never gives way to the plain
    version.  A CPU tensor takes the plain version at any shape."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return fa_kern.flash_attention(qt, kt, vt, causal=causal, scale=scale).transpose(1, 2)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """The Mamba2 SSD chunk scan: ``x [B, L, H, P]``, ``dt [B, L, H]`` f32,
    ``A [H]`` f32, ``Bm``/``Cm [B, L, G, N]``, optional ``initial_state [B, H,
    P, N]`` f32 -> ``(y [B, L, H, P] in x's dtype, final state [B, H, P, N]
    f32)``.

    A CUDA tensor launches the kernel, which raises for a shape outside its
    limits (``P`` in {8, 16, 32, 64}, ``N`` in {16, 32, 64, 128}, a chunk of
    at most 256 that divides ``L``) and under autograd; it never gives way to
    the plain version.  A CPU tensor takes the plain version."""
    def c(t):
        return None if t is None else t.contiguous()

    return ssd_kern.ssd_scan(c(x), c(dt), c(A), c(Bm), c(Cm), chunk, c(initial_state))


__all__ = ["partition_ranks", "hash_partition_ranks", "hash_partition", "moe_dispatch",
           "flash_attention", "ssd_scan"]
