"""The cost hook: how work that an op counter cannot see op by op reports itself.

:mod:`repro_torch.launch.op_cost` counts a program's aten operations as
PyTorch dispatches them.  Two kinds of work tell it themselves, through
this module, which imports nothing of the port, so that ``kernels/`` and
``core/`` can import it without importing ``launch/``:

* a hand-written kernel (:func:`kernel`): its wrapper opens the context with
  the kernel's flops and bytes (its inputs read once, its outputs written
  once, the operations its shapes need).  The counter counts the kernel
  once by that formula and ignores the ops dispatched inside: the plain
  version's on the CPU, the launch's allocations on the card, nothing on
  ``meta``.  So the three devices count a call alike.
* a collective over the process fabric (:func:`collective`):
  ``core/exchange.py`` reports the bytes it hands the fabric, by kind.

:func:`region` names a part of a program (the train step's microbatch), so
that the counter can report that part apart.  With no counter active each
of the three is a no-op.  The active counter is a process global, not a
thread-local: autograd runs the backward, and the remat recompute, on its
own thread on the card, and those kernels report to the same counter.
"""

from __future__ import annotations

import contextlib
from typing import Any

_ACTIVE: list[Any] = []
_NULL = contextlib.nullcontext()


def active() -> Any:
    """The counter that hears reports now, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def reporting_to(counter: Any):
    """Make ``counter`` the active counter for the block."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.pop()


def kernel(name: str, flops: int, nbytes: int):
    """The context a kernel wrapper runs its call in (see the module
    docstring)."""
    c = active()
    return _NULL if c is None else c.kernel(name, flops, nbytes)


def region(name: str):
    """The context a named part of a program runs in."""
    c = active()
    return _NULL if c is None else c.region(name)


def collective(kind: str, nbytes: int) -> None:
    """``nbytes`` handed to the process fabric by one collective of
    ``kind`` (``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``)."""
    c = active()
    if c is not None:
        c.collective(kind, nbytes)


__all__ = ["active", "reporting_to", "kernel", "region", "collective"]
