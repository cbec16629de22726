"""AdamW (decoupled weight decay) + WSD / cosine learning-rate schedules
(port of ``repro.train.optim``).

Moments are f32 tensors beside each parameter, on its device.  Everything
stays on the device, the step count and the learning rate too, so an update
never waits for the host.  The update is functional: it returns new
parameter and moment tensors and leaves its inputs as they were.

WSD (warmup-stable-decay) is the schedule MiniCPM trains with: linear
warmup, a long constant plateau, a short sqrt-shaped decay.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"  # "cosine" | "wsd" | "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1  # WSD: fraction of steps spent decaying


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Schedule value at ``step`` (an int or an int tensor), as f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        decay_steps = max(cfg.total_steps * cfg.decay_frac, 1.0)
        decay_start = cfg.total_steps - decay_steps
        frac = torch.clamp((s - decay_start) / decay_steps, 0.0, 1.0)
        # MiniCPM-style: sqrt-shaped anneal to 10 % of peak
        decay = 1.0 - (1.0 - 0.1) * torch.sqrt(frac)
        return cfg.lr * warm * decay
    # cosine to 10 % of peak
    frac = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    return cfg.lr * warm * (0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * frac)))


def adamw_init(params: Any) -> Any:
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def _global_norm(tree: Any, sharded: list[bool | None] | None = None,
                 process_sum: Callable[[torch.Tensor], torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """The gradient's global norm.  Where ``sharded`` marks a leaf ``True``,
    this process holds its piece of it, and the squares of every process's
    pieces are added through one scalar ``process_sum`` (an all-reduce over
    the processes), so every process gets the same norm; ``False``, the
    leaf is whole on every process and added here once; ``None``, another
    process adds this piece (a copy of it on a ``data x model`` grid, whose
    pieces may lie over two axes) and it is skipped."""
    squares = [g.float().square().sum() for g in leaves(tree)]
    if sharded is None:
        return torch.sqrt(sum(squares))
    zero = torch.zeros((), dtype=torch.float32, device=squares[0].device)
    whole = sum((q for q, s in zip(squares, sharded) if s is False), zero)
    shards = process_sum(sum((q for q, s in zip(squares, sharded) if s), zero))
    return torch.sqrt(whole + shards)


def _decays(path: tuple, p: torch.Tensor) -> bool:
    """The reference decays leaves of 2 or more dims, norms and biases not.
    Its segment leaves carry a leading layer dim the port's per-layer dicts
    do not (a list index in the path), so a segment leaf counts one dim more:
    the per-layer norm scales decay, as they do in the reference."""
    in_segment = any(isinstance(key, int) for key in path)
    return p.ndim + in_segment >= 2


def adamw_update(
    cfg: AdamWConfig, grads: Any, opt_state: Any, params: Any,
    sharded: list[bool | None] | None = None,
    process_sum: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[Any, Any, dict]:
    """One AdamW step; returns ``(new_params, new_opt_state, metrics)``.

    The gradient is clipped by its global norm (``metrics["grad_norm"]`` is
    the norm before clipping); ``sharded`` and ``process_sum`` are
    :func:`_global_norm`'s, for a state whose leaves are partly this
    process's shards."""
    count = opt_state["count"] + 1
    gnorm = _global_norm(grads, sharded, process_sum)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    def upd(path, p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        decay = cfg.weight_decay if _decays(path, p) else 0.0
        p32 = p32 - lr * (step + decay * p32)
        return p32.to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"], with_path=True)
    new_opt = {f: tree_map(lambda t, i=i: t[i], out) for i, f in ((1, "m"), (2, "v"))}
    new_opt["count"] = count
    return tree_map(lambda t: t[0], out), new_opt, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_at"]
