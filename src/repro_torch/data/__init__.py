"""Data pipeline (counterpart of ``repro.data``): deterministic synthetic
streams + binary token files."""

from .pipeline import (
    Prefetcher,
    SyntheticLM,
    TokenFileDataset,
    make_batch_iterator,
    write_token_file,
)

__all__ = [
    "SyntheticLM",
    "TokenFileDataset",
    "Prefetcher",
    "make_batch_iterator",
    "write_token_file",
]
