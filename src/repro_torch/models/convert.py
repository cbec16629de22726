"""The reference's parameters, as numpy arrays, into the port's layout.

The reference initialises with ``jax.random``, which the port cannot
reproduce, so tests that hold the port to the reference hand the
reference's params over through numpy.  Its pytree stacks every segment's
layers on a leading dim (``seg{i}`` leaves are ``[L, ...]``); the port keeps
a list of per-layer dicts.  Every other leaf keeps its shape and layout:
attention, dense-MLP and MoE ``ffn`` leaves alike, and the embedding
``table`` (with no ``unembed`` leaf when the embeddings are tied).
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


def from_reference(params: Mapping[str, Any], device="cpu") -> dict:
    """Reference param pytree (nested dicts of arrays) -> port params."""
    out = {}
    for name, sub in params.items():
        if name.startswith("seg"):
            out[name] = [
                tree_map(lambda a, l=l: _tensor(np.asarray(a)[l], device), sub)
                for l in range(_num_layers(sub))
            ]
        else:
            out[name] = tree_map(lambda a: _tensor(a, device), sub)
    return out


__all__ = ["from_reference"]
