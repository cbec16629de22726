"""Deterministic sharded data pipeline with background prefetch (port of
``repro.data.pipeline``; the port keeps its own copy, and its batches are
numpy arrays bit-equal to the reference's).

Two sources:

* :class:`SyntheticLM` — seeded synthetic token stream (a learnable
  order-k Markov chain, so training loss actually falls); deterministic in
  ``(seed, step, shard)``, which makes restarts reproducible: after a crash
  the restored step index regenerates exactly the batches that would have
  followed — data-pipeline state needs NO checkpointing.
* :class:`TokenFileDataset` — memory-mapped binary token files (the
  production path), sampled in deterministic windows per (step, shard).

Sharding follows the paper's morsel discipline: the global batch is cut
into per-datashard *morsels* assigned round-robin, so a skewed/hot region
of the corpus decorrelates across shards (table.shard_rows uses the same
trick for relations).

:class:`Prefetcher` overlaps host-side batch assembly with device compute
on a background thread (the data-pipeline analogue of the paper's
dedicated network thread).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np

from ..configs.base import ModelConfig, ShapeSpec


@dataclasses.dataclass
class SyntheticLM:
    """Order-1 Markov token stream; next-token structure is learnable."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    markov_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        s = min(self.markov_states, self.vocab_size)
        # sparse-ish transition matrix over a reduced state space
        self.trans = rng.dirichlet(np.full(s, 0.3), size=s).astype(np.float64)
        self.proj = rng.integers(0, self.vocab_size, size=s)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        assert self.global_batch % self.num_shards == 0
        b_local = self.global_batch // self.num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4_096 + self.shard
        )
        s = self.trans.shape[0]
        states = rng.integers(0, s, size=b_local)
        seq = np.empty((b_local, self.seq_len + 1), np.int64)
        cum = np.cumsum(self.trans, axis=1)
        for t in range(self.seq_len + 1):
            seq[:, t] = self.proj[states]
            u = rng.random(b_local)
            states = (cum[states] < u[:, None]).sum(axis=1).clip(max=s - 1)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass
class TokenFileDataset:
    """Deterministic random windows over a memory-mapped token file."""

    path: str
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0

    def __post_init__(self):
        self.tokens = np.memmap(self.path, dtype=np.int32, mode="r")
        assert len(self.tokens) > self.seq_len + 1, "token file too small"

    def batch(self, step: int) -> dict[str, np.ndarray]:
        b_local = self.global_batch // self.num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4_096 + self.shard
        )
        starts = rng.integers(0, len(self.tokens) - self.seq_len - 1, size=b_local)
        rows = np.stack([self.tokens[s : s + self.seq_len + 1] for s in starts])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }


def write_token_file(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)


def _augment_for_family(cfg: ModelConfig, batch: dict) -> dict:
    """The reference adds stub modality inputs here (whisper frames, VLM
    patches) from a per-step generator; those families are not ported yet,
    so nothing here draws from one."""
    if cfg.family == "encdec":
        raise NotImplementedError("encoder-decoder batches (whisper frames) come with the "
                                  "Whisper slice (ROADMAP A.15)")
    if cfg.family == "vlm":
        raise NotImplementedError("VLM batches (patch prefix) come with the dense-model slice "
                                  "(ROADMAP A.12)")
    return batch


def make_batch_iterator(
    cfg: ModelConfig,
    shape: ShapeSpec,
    seed: int = 0,
    start_step: int = 0,
    source: Any = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Infinite deterministic iterator of training batches for (cfg, shape)."""
    src = source or SyntheticLM(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
    )
    step = start_step
    while True:
        yield _augment_for_family(cfg, src.batch(step))
        step += 1


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded queue)."""

    _DONE = object()

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


__all__ = [
    "SyntheticLM",
    "TokenFileDataset",
    "write_token_file",
    "make_batch_iterator",
    "Prefetcher",
]
