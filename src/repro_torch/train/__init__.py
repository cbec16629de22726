"""Training (counterpart of ``repro.train``): optimizer, schedules, the
microbatched train step."""

from .optim import AdamWConfig, adamw_init, adamw_update, lr_at
from .step import TrainState, make_train_step, state_shardings, train_state_specs

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "lr_at",
    "TrainState",
    "make_train_step",
    "train_state_specs",
    "state_shardings",
]
