"""The reference's parameters, as numpy arrays, into the port's layout.

The reference initialises with ``jax.random``, which the port cannot
reproduce, so tests that hold the port to the reference hand the
reference's params over through numpy.  Its pytree stacks layers on
leading dims: a transformer's ``seg{i}``, Mamba2's ``layers``, Zamba2's
``tail`` and Whisper's ``encoder`` and ``decoder`` leaves are ``[L, ...]``,
Zamba2's ``groups`` leaves ``[ng, gs, ...]``.  The port keeps a list of
per-layer dicts (a list of such lists for ``groups``).
Every other leaf keeps its shape and layout: attention, dense-MLP, MoE
``ffn`` and Mamba2 leaves alike, Zamba2's unstacked ``shared`` block, and
the embedding ``table`` (with no ``unembed`` leaf when the embeddings are
tied).  :func:`tensor_params` cuts such params into a tensor-parallel
process's slices.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _num_layers(tree) -> int:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return int(np.shape(tree)[0])


def _stack_depth(name: str) -> int:
    """How many leading dims of a top-level entry stack layers."""
    if name == "groups":
        return 2
    return 1 if name.startswith("seg") or name in ("layers", "tail", "encoder", "decoder") else 0


def _unstack(tree, depth: int, device):
    if depth == 0:
        return tree_map(lambda a: _tensor(a, device), tree)
    return [_unstack(tree_map(lambda a, l=l: np.asarray(a)[l], tree), depth - 1, device)
            for l in range(_num_layers(tree))]


def from_reference(params: Mapping[str, Any], device="cuda") -> dict:
    """Reference param pytree (nested dicts of arrays) -> port params on
    ``device`` (the card unless the caller asks for the CPU)."""
    return {name: _unstack(sub, _stack_depth(name), device) for name, sub in params.items()}


def tensor_params(params: dict, cfg, ctx=None) -> dict:
    """This process's slices of whole port params (:func:`from_reference`'s
    output) under the tensor table of ``ctx`` (default the active
    context), cut as ``init``'s ``tensor_place`` cuts them as it draws (a
    Mamba block by its head-aligned sections)."""
    from ..distributed.sharding import current_mesh_context, tensor_slices
    from .registry import build

    ctx = ctx or current_mesh_context()
    if ctx is None or not ctx.tensor:
        raise ValueError("tensor_params needs a mesh context with the tensor table")
    api = build(cfg)
    return tensor_slices(params, api.param_specs, ctx, api.tensor_index)


__all__ = ["from_reference", "tensor_params"]
