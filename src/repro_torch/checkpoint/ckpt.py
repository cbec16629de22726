"""Sharded, crash-consistent checkpoints of the port's state, with elastic
restore (port of ``repro.checkpoint.ckpt``).

* **crash consistency** — a checkpoint is written to ``step_<n>.tmp`` and
  renamed to ``step_<n>`` once complete (manifest last, fsynced); readers
  only ever see complete checkpoints, and a crash mid-write leaves the
  previous one intact.
* **sharded save** — the reference's manifest schema: every leaf names its
  global ``shape``, its ``dtype`` and its ``shards``, each a ``.npy`` file
  and the ``index`` it covers (``[start, stop]`` a split dim, ``None`` a
  whole one; ``None`` for a whole leaf).  On a mesh that spans processes
  every process writes its own shards of the leaves it holds in part (the
  train state's expert leaves, :func:`repro_torch.train.step.
  state_shardings`) and process 0 writes each replicated leaf once; on a
  ``data x model`` grid a leaf may be split along two dims, and each piece
  is written once, by the process that ``owned`` names
  (:func:`repro_torch.train.step.state_owners`).
  Process 0 alone clears ``step_<n>.tmp``, merges the processes' parts of
  the manifest and renames, each step after a barrier.
* **elastic restore** — :func:`restore_checkpoint` assembles each leaf, or
  only the rows the restoring process holds, from whichever shards cover
  them, so a state saved over 2 processes restores whole into 1, or over
  4, and one saved on a ``(4, 2)`` grid onto ``(2, 4)``.  The port's earlier one-file-a-leaf checkpoints still restore.
* **retention** — :class:`CheckpointManager` keeps the newest ``keep``
  checkpoints; directories without a manifest are skipped by
  :func:`latest_step`.

Leaves are saved from the device through ``.cpu()``; ``bfloat16``, which
numpy lacks, is stored as its 16-bit pattern.  Only checkpoints that the
port wrote are read.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..tree import leaves, leaves_with_paths, tree_map

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


def _spans(mesh) -> bool:
    return mesh is not None and mesh.num_processes > 1


def _barrier(mesh) -> None:
    if _spans(mesh):
        dist.barrier(group=mesh.group)


def _cut(leaf: torch.Tensor, held) -> list:
    """The one-dim shards of ``held`` along which this process holds only
    part of ``leaf`` (empty: it holds the leaf whole)."""
    if held is None:
        return []
    return [h for h in held.dims() if leaf.shape[h.dim] != h.size]


def save_checkpoint(directory: str, step: int, tree: Any, shardings: Any = None,
                    mesh=None, owned: Any = None) -> str:
    """Write ``tree`` as checkpoint ``step``; returns the final path.

    ``shardings`` (a tree like ``tree`` of
    :class:`~repro_torch.train.step.Shard` or ``None`` leaves) says which
    rows of each leaf this process holds, along one dim or several; on a
    ``mesh`` that spans processes every process calls this with its own
    shards (on a grid, ``mesh`` spans every process of it).  ``owned`` (a
    tree like ``tree`` of bools) says which pieces this process writes;
    without it a split leaf is written by every process, a whole one by
    process 0."""
    rank = mesh.process_index if _spans(mesh) else 0
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    _barrier(mesh)
    if rank == 0:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _barrier(mesh)

    pairs = list(leaves_with_paths(tree))
    held_leaves = leaves(shardings) if shardings is not None else [None] * len(pairs)
    writes = leaves(owned) if owned is not None else [None] * len(pairs)
    part: dict[str, Any] = {}
    for (path, leaf), held, mine in zip(pairs, held_leaves, writes):
        cut = _cut(leaf, held)
        if not (mine if mine is not None else cut or rank == 0):
            continue  # another process writes this piece
        name = _name(path)
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
        fn = f"{safe}.shard{rank if cut else 0}.npy"
        np.save(os.path.join(tmp, fn), _to_numpy(leaf))
        shape, index = list(leaf.shape), None
        if cut:
            index = [None] * leaf.ndim
            for h in cut:
                shape[h.dim] = h.size
                index[h.dim] = [h.start, h.stop]
        part[name] = {"file_prefix": safe, "shape": shape,
                      "dtype": str(leaf.dtype).removeprefix("torch."),
                      "shards": [{"file": fn, "index": index}]}
    with open(os.path.join(tmp, f"part{rank}.json"), "w") as f:
        json.dump(part, f)
        f.flush()
        os.fsync(f.fileno())
    _barrier(mesh)

    if rank == 0:
        manifest: dict[str, Any] = {"step": step, "leaves": {}}
        for fn in sorted(glob.glob(os.path.join(tmp, "part*.json")),
                         key=lambda p: int(re.search(r"part(\d+)", p).group(1))):
            with open(fn) as f:
                for name, entry in json.load(f).items():
                    if name in manifest["leaves"]:
                        manifest["leaves"][name]["shards"] += entry["shards"]
                    else:
                        manifest["leaves"][name] = entry
            os.remove(fn)
        # the tree's own leaf order
        manifest["leaves"] = {n: manifest["leaves"][n]
                              for n in (_name(p) for p, _ in pairs)}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    _barrier(mesh)
    return final


def _assemble(entry: dict, ckpt_dir: str, want=None) -> np.ndarray:
    """A leaf from its shard files: whole, or only the rows ``want`` (a
    :class:`~repro_torch.train.step.Shard`, along one dim or several)
    names, reading just the shards that cover them."""
    shape = list(entry["shape"])
    wants = want.dims() if want is not None else ()
    if "shards" not in entry:  # the port's earlier layout: one whole file
        a = np.load(os.path.join(ckpt_dir, entry["file"]))
        if list(a.shape) != shape:
            raise ValueError(f"checkpoint leaf file {entry['file']!r}: shape {list(a.shape)}, "
                             f"manifest {shape}")
        for w in wants:
            a = np.take(a, range(w.start, w.stop), axis=w.dim)
        return a
    for w in wants:
        shape[w.dim] = w.stop - w.start
    out, filled = None, 0
    for sh in entry["shards"]:
        index = sh["index"] or [None] * len(shape)
        src = [slice(None)] * len(shape)
        dst = [slice(None) if s is None else slice(s[0], s[1]) for s in index]
        covers = True
        for w in wants:
            a, b = index[w.dim] or (0, entry["shape"][w.dim])
            lo, hi = max(a, w.start), min(b, w.stop)
            if lo >= hi:
                covers = False
                break
            src[w.dim] = slice(lo - a, hi - a)
            dst[w.dim] = slice(lo - w.start, hi - w.start)
        if not covers:
            continue
        data = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        if out is None:
            out = np.empty(shape, dtype=data.dtype)
        block = data[tuple(src)]
        out[tuple(dst)] = block
        filled += block.size
    if out is None or filled != out.size:
        raise ValueError(f"checkpoint leaf {entry['file_prefix']!r}: its shards cover "
                         f"{filled} of {int(np.prod(shape))} values")
    return out


def restore_checkpoint(directory: str, step: int | None, target: Any, device=None,
                       shardings: Any = None) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors), each
    leaf with the target leaf's dtype, on ``device`` (default: the target
    leaf's device).  ``step=None`` takes the newest checkpoint.  Where
    ``shardings`` (as in :func:`save_checkpoint`) says this process holds a
    shard of a leaf and the target leaf is that shard, only its rows are
    read: the restoring mesh may differ from the saving one.  A leaf of
    ``target`` that the checkpoint lacks raises ``KeyError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)

    def load(path, leaf, held=None):
        name = _name(path)
        if name not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        entry = manifest["leaves"][name]
        cut = _cut(leaf, held)
        a = _assemble(entry, ckpt_dir, cut[0]._replace(also=tuple(cut[1:])) if cut else None)
        t = _from_numpy(np.array(a, order="C"), entry["dtype"])
        if t.shape != leaf.shape:
            raise ValueError(f"checkpoint leaf {name!r}: {list(t.shape)} read, the target "
                             f"holds {list(leaf.shape)}")
        return t.to(device=device if device is not None else leaf.device, dtype=leaf.dtype)

    if shardings is None:
        return tree_map(load, target, with_path=True)
    return tree_map(load, target, shardings, with_path=True)


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
    """Periodic save + retention + resume for the training loop; ``mesh``,
    ``shardings`` and ``owned`` as in :func:`save_checkpoint`."""

    directory: str
    every: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree: Any, shardings: Any = None, mesh=None,
                   owned: Any = None) -> str | None:
        if self.every <= 0 or step % self.every != 0:
            return None
        path = save_checkpoint(self.directory, step, tree, shardings, mesh, owned)
        if not _spans(mesh) or mesh.process_index == 0:
            self._gc()
        _barrier(mesh)
        return path

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.directory) if (m := _STEP_DIR.fullmatch(d))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def restore_latest(self, target: Any, device=None,
                       shardings: Any = None) -> tuple[int, Any] | None:
        step = latest_step(self.directory)
        if step is None:
            return None
        return step, restore_checkpoint(self.directory, step, target, device, shardings)


__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]
