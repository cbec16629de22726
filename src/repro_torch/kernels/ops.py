"""Pack-rank entry points over the kernels (counterpart of ``repro.kernels.ops``).

The kernels give per-block histograms and block-local ranks; turning them
into global within-bin ranks is an ``[S, nblocks, bins]`` exclusive scan and
a flat gather, left to plain PyTorch as the reference leaves it to XLA.
Every function takes a leading shard dim ``S`` and launches one kernel over
all shards.
"""

from __future__ import annotations

import torch

from . import hash_partition as kern


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


__all__ = ["partition_ranks", "hash_partition_ranks"]
