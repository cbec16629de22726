"""Columnar tables on an explicit device (port of ``repro.relational.table``).

A table has a fixed row capacity, one torch tensor per column and a
``valid`` mask: filtered rows stay in place, masked out (a selection
vector).  Strings are dictionary-encoded to int32, money is int32 cents.

The executor works on tables with a leading shard dim: every column is
``[S, T]`` (shard ``s`` holds ``T`` rows).  :func:`shard_rows` deals a flat
table's rows round-robin onto shards, the reference's interleaved morsel
placement.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping

import numpy as np
import torch


@dataclasses.dataclass
class Table:
    """A fixed-capacity columnar table: ``columns`` + ``valid`` row mask.

    Columns and mask share their leading shape: ``[rows]`` for a flat
    table, ``[S, T]`` for a sharded one.
    """

    columns: dict[str, torch.Tensor]
    valid: torch.Tensor  # bool
    dictionaries: dict[str, list[str]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        shape = tuple(self.valid.shape)
        for name, c in self.columns.items():
            assert tuple(c.shape[: len(shape)]) == shape, (
                f"column {name}: {tuple(c.shape)} != {shape}"
            )

    @property
    def capacity(self) -> int:
        """Rows per shard (the whole table when flat)."""
        return int(self.valid.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def with_mask(self, mask: torch.Tensor) -> "Table":
        """Filter: AND the validity mask (no data movement)."""
        return Table(self.columns, self.valid & mask, self.dictionaries)

    def to(self, device) -> "Table":
        return Table(
            {k: v.to(device) for k, v in self.columns.items()},
            self.valid.to(device),
            self.dictionaries,
        )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Without a CUDA device, anything but ``"cpu"`` raises;
    there is no silent fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


def table_from_numpy(
    columns: Mapping[str, np.ndarray],
    valid: np.ndarray,
    device,
    dictionaries: Mapping[str, list[str]] | None = None,
) -> Table:
    """A table on ``device`` holding exactly these numpy arrays.

    The tests hand the reference's tables over with ``np.asarray`` on each
    column, so both packages compute on identical data.
    """
    return Table(
        {
            k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(device)
            for k, v in columns.items()
        },
        torch.from_numpy(np.require(valid, dtype=bool, requirements=["C", "W"])).to(device),
        dict(dictionaries or {}),
    )


def pad_to(table: Table, capacity: int) -> Table:
    """Grow a flat table to ``capacity`` rows (new rows invalid)."""
    pad = capacity - table.capacity
    assert pad >= 0
    cols = {
        k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        for k, v in table.columns.items()
    }
    valid = torch.cat([table.valid, table.valid.new_zeros((pad,))])
    return Table(cols, valid, table.dictionaries)


def shard_rows(table: Table, num_shards: int) -> Table:
    """Deal a flat table's rows round-robin (row ``i`` -> shard ``i % S``)
    into ``[S, capacity / S]`` columns — the reference's interleaved
    placement followed by its contiguous per-device split."""
    cap = table.capacity
    assert cap % num_shards == 0, f"capacity {cap} % shards {num_shards} != 0"
    per = cap // num_shards

    def arrange(c: torch.Tensor) -> torch.Tensor:
        return c.reshape((per, num_shards) + tuple(c.shape[1:])).transpose(0, 1).contiguous()

    cols = {k: arrange(v) for k, v in table.columns.items()}
    return Table(cols, arrange(table.valid), table.dictionaries)


def morsels(table: Table, morsel_size: int) -> Iterator[Table]:
    """Iterate fixed-size morsels (paper [22]) of a flat table, the last one
    shorter when ``morsel_size`` does not divide the capacity."""
    cap = table.capacity
    for start in range(0, cap, morsel_size):
        end = min(start + morsel_size, cap)
        yield Table(
            {k: v[start:end] for k, v in table.columns.items()},
            table.valid[start:end],
            table.dictionaries,
        )


__all__ = ["Table", "table_from_numpy", "pad_to", "shard_rows", "morsels"]
