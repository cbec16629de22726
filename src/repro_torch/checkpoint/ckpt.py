"""Crash-consistent checkpoints of the port's state (port of
``repro.checkpoint.ckpt``).

* **crash consistency** — a checkpoint is written to ``step_<n>.tmp`` and
  renamed to ``step_<n>`` once complete (manifest last, fsynced); readers
  only ever see complete checkpoints, and a crash mid-write leaves the
  previous one intact.
* **retention** — :class:`CheckpointManager` keeps the newest ``keep``
  checkpoints; directories without a manifest are skipped by
  :func:`latest_step`.
* **layout** — one ``.npy`` file per leaf of a tree of nested dicts, lists
  and dataclasses of tensors (``TrainState`` among them), saved from the
  device through ``.cpu()``; a JSON manifest names each leaf by its path
  (``params/seg0/3/attn/wq``) with its shape and dtype.  ``bfloat16``, which
  numpy lacks, is stored as its 16-bit pattern.

The reference writes one file per addressable shard and re-shards on
restore (an elastic restart onto another mesh); one device has one shard,
and :func:`restore_checkpoint` places every leaf on the device it is given.
Only checkpoints that the port wrote are read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from ..tree import leaves_with_paths, tree_map

MANIFEST = "MANIFEST.json"
_STEP_DIR = re.compile(r"step_(\d+)")


def _name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as checkpoint ``step``; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    for path, leaf in leaves_with_paths(tree):
        name = _name(path)
        fn = re.sub(r"[^A-Za-z0-9_.-]", "_", name) + ".npy"
        np.save(os.path.join(tmp, fn), _to_numpy(leaf))
        manifest["leaves"][name] = {
            "file": fn,
            "shape": list(leaf.shape),
            "dtype": str(leaf.dtype).removeprefix("torch."),
        }

    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def restore_checkpoint(directory: str, step: int | None, target: Any, device=None) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors), each
    leaf with the target leaf's dtype, on ``device`` (default: the target
    leaf's device).  ``step=None`` takes the newest checkpoint.  A leaf of
    ``target`` that the checkpoint lacks raises ``KeyError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)

    def load(path, leaf):
        name = _name(path)
        if name not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        entry = manifest["leaves"][name]
        t = _from_numpy(np.load(os.path.join(ckpt_dir, entry["file"])), entry["dtype"])
        if list(t.shape) != entry["shape"]:
            raise ValueError(f"checkpoint leaf {name!r}: file shape {list(t.shape)}, "
                             f"manifest {entry['shape']}")
        return t.to(device=device if device is not None else leaf.device, dtype=leaf.dtype)

    return tree_map(load, target, with_path=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in os.listdir(directory):
        m = _STEP_DIR.fullmatch(d)
        if m and os.path.exists(os.path.join(directory, d, MANIFEST)):
            best = max(best or -1, int(m.group(1)))
    return best


@dataclasses.dataclass
class CheckpointManager:
    """Periodic save + retention + resume for the training loop."""

    directory: str
    every: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree: Any) -> str | None:
        if self.every <= 0 or step % self.every != 0:
            return None
        path = save_checkpoint(self.directory, step, tree)
        self._gc()
        return path

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.directory) if (m := _STEP_DIR.fullmatch(d))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def restore_latest(self, target: Any, device=None) -> tuple[int, Any] | None:
        step = latest_step(self.directory)
        if step is None:
            return None
        return step, restore_checkpoint(self.directory, step, target, device)


__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]
