"""The reference's parameters, as numpy arrays, into the port's layout.

The reference initialises with ``jax.random``, which the port cannot
reproduce, so tests that hold the port to the reference hand the
reference's params over through numpy.  Its pytree stacks every segment's
layers on a leading dim (``seg{i}`` leaves are ``[L, ...]``); the port keeps
a list of per-layer dicts.  Every other leaf keeps its shape and layout.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


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
                _tree(sub, lambda a, l=l: _tensor(np.asarray(a)[l], device))
                for l in range(_num_layers(sub))
            ]
        else:
            out[name] = _tree(sub, lambda a: _tensor(a, device))
    return out


__all__ = ["from_reference"]
