"""DataSource: what a ``Scan`` reads from (port of ``repro.relational.source``).

An in-memory :class:`~repro_torch.relational.table.Table` is one
implementation (:class:`TableSource`, a single chunk).  Out-of-core inputs
are chunked: they yield fixed-capacity partitions ("morsels") one at a time,
so a table larger than the card's memory streams through the executor
morsel by morsel (``planner/stream.py``), each morsel copied to the card
from pinned host memory by a background thread (``data/pipeline.py``).

Chunks are fixed-shape by construction: every chunk of a source has the
same row capacity, the last one padded with invalid rows.  Chunks are flat
tables; a chunked source keeps them on the host (CPU tensors), and the
streamed executor moves each one to ``ctx.device`` as it needs it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import torch

from .table import Table, pad_to

__all__ = [
    "DataSource",
    "TableSource",
    "MorselView",
    "GeneratorSource",
    "as_source",
    "concat_tables",
]


def concat_tables(chunks: list[Table]) -> Table:
    """Row-wise concatenation (dictionaries taken from the first chunk)."""
    if not chunks:
        raise ValueError("concat_tables: empty chunk list")
    cols = {c: torch.cat([t.columns[c] for t in chunks]) for c in chunks[0].columns}
    valid = torch.cat([t.valid for t in chunks])
    return Table(cols, valid, dict(chunks[0].dictionaries))


class DataSource:
    """Base interface: a named relation delivered as fixed-capacity chunks."""

    #: Total row capacity across all chunks (what the planner catalogs).
    capacity: int
    #: Number of fixed-capacity chunks; 1 means fully in-memory.
    num_chunks: int
    #: Row capacity of every chunk (``capacity == num_chunks * chunk_rows``).
    chunk_rows: int

    @property
    def is_chunked(self) -> bool:
        return self.num_chunks > 1

    def chunks(self) -> Iterator[Table]:
        raise NotImplementedError

    def materialize(self) -> Table:
        """The whole relation as one in-memory Table (the streaming oracle)."""
        return concat_tables(list(self.chunks()))


class TableSource(DataSource):
    """An in-memory Table as a single-chunk source."""

    def __init__(self, table: Table):
        self.table = table
        self.capacity = table.capacity
        self.num_chunks = 1
        self.chunk_rows = table.capacity

    def chunks(self) -> Iterator[Table]:
        yield self.table

    def materialize(self) -> Table:
        return self.table


class MorselView(DataSource):
    """Chunked view over an in-memory Table.

    Slices ``table`` into ``ceil(capacity / morsel_rows)`` fixed-capacity
    morsels (the last padded with invalid rows), so ``capacity`` grows to
    the next multiple of ``morsel_rows``; the padding rows are invalid and
    change no result.  The morsels are views of ``table`` and live where it
    does.
    """

    def __init__(self, table: Table, morsel_rows: int):
        if morsel_rows < 1:
            raise ValueError("morsel_rows must be >= 1")
        self.table = table
        self.chunk_rows = min(morsel_rows, table.capacity)
        self.num_chunks = math.ceil(table.capacity / self.chunk_rows)
        self.capacity = self.num_chunks * self.chunk_rows

    def chunks(self) -> Iterator[Table]:
        t, m = self.table, self.chunk_rows
        for i in range(self.num_chunks):
            lo, hi = i * m, min((i + 1) * m, t.capacity)
            cols = {c: t.columns[c][lo:hi] for c in t.columns}
            chunk = Table(cols, t.valid[lo:hi], dict(t.dictionaries))
            yield pad_to(chunk, m) if hi - lo < m else chunk


class GeneratorSource(DataSource):
    """Chunks produced on demand by ``make_chunk(chunk_index) -> Table``.

    The true out-of-core source: chunks are generated (or loaded) lazily,
    so only ``chunk_rows`` rows are resident on the host per chunk.
    """

    def __init__(self, make_chunk: Callable[[int], Table], num_chunks: int, chunk_rows: int):
        if num_chunks < 1 or chunk_rows < 1:
            raise ValueError("num_chunks and chunk_rows must be >= 1")
        self.make_chunk = make_chunk
        self.num_chunks = num_chunks
        self.chunk_rows = chunk_rows
        self.capacity = num_chunks * chunk_rows

    def chunks(self) -> Iterator[Table]:
        for i in range(self.num_chunks):
            chunk = self.make_chunk(i)
            if chunk.capacity != self.chunk_rows:
                raise ValueError(
                    f"chunk {i} has capacity {chunk.capacity}, expected {self.chunk_rows}"
                )
            yield chunk


def as_source(obj: "Table | DataSource") -> DataSource:
    if isinstance(obj, DataSource):
        return obj
    if isinstance(obj, Table):
        return TableSource(obj)
    raise TypeError(f"expected Table or DataSource, got {type(obj)!r}")
