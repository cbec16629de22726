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
dedicated network thread); given a CUDA device, the thread also copies each
item to the card from pinned memory on a stream of its own.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..tree import leaves, tree_map


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
    """Background-thread prefetch of an iterator (depth-bounded queue).

    With ``device`` a CUDA device, the thread also moves every item to the
    card: each CPU tensor in it (in nested dicts, lists and dataclasses such
    as a ``Table``) is pinned (``pin_memory()``) and copied with
    ``non_blocking=True`` on the thread's own CUDA stream, and an event
    recorded after the copies travels with the item.  ``__next__`` makes
    the consumer's current stream wait on that event and marks every device
    tensor of the item as used by that stream (``record_stream``), so the
    caching allocator does not hand its memory out while the consumer still
    reads it.  Without ``device`` (or with a CPU one) items pass through as
    the iterator yields them.  An error in the iterator, or in pinning and
    copying, is raised by the ``__next__`` that would have returned the item.
    """

    _DONE = object()

    def __init__(self, it: Iterator[Any], depth: int = 2, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = None
        self._device = dev

        def produce():
            if dev is None:
                yield from it
                return
            torch.cuda.set_device(dev)  # a new thread starts on device 0
            stream = torch.cuda.Stream(dev)
            for item in it:
                with torch.cuda.stream(stream):
                    moved = tree_map(lambda x: _to_card(x, dev), item)
                    done = torch.cuda.Event()
                    done.record(stream)
                yield moved, done

        def run():
            try:
                for item in produce():
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
        if self._device is None:
            return item
        moved, done = item
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(done)
        for x in leaves(moved):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(stream)
        return moved


def _to_card(x, device: torch.device):
    """A CPU tensor pinned and copied to ``device`` without blocking the
    host (on the caller's current stream); anything else unchanged."""
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x


__all__ = [
    "SyntheticLM",
    "TokenFileDataset",
    "write_token_file",
    "make_batch_iterator",
    "Prefetcher",
]
