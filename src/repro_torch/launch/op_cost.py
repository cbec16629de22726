"""Per-process cost of a program, counted op by op as PyTorch dispatches it
(the port's counterpart of ``repro.launch.hlo_cost``).

The reference parses XLA's optimized HLO text and multiplies each ``while``
body by its trip count.  The port runs eagerly and has no HLO:
:func:`analyze` runs the function under a ``TorchDispatchMode`` and counts
what is dispatched, on any device (``meta`` included, where nothing is
allocated):

* **flops** -- the formulas of ``torch.utils.flop_counter`` (2 x |result| x
  |contracted dims| for ``mm``, ``addmm``, ``bmm``, ``baddbmm``, the
  convolutions and the SDPA forward and backward), each op outside its
  registry that would run as a C++ composite's parts decomposed first, as
  ``FlopCounterMode`` does (but not an op with a kernel of its own: a
  counted run computes the same bits as an uncounted one);
  plus each hand-written kernel's own formula, which its wrapper reports
  through :mod:`repro_torch.obs.cost` (the ops of its plain body are not
  counted, so the CPU, the card and ``meta`` count a call alike).  The
  reference's HLO counts a kernel's custom call as 0.
* **bytes** -- the eager program's traffic: the operands plus the results
  of every aten op that is not a view or a metadata op, plus the kernels'
  formulas.  The reference leaves out the elementwise ops because XLA fuses
  them; PyTorch eager fuses nothing, so the port counts them.  Collectives'
  own buffers (``c10d`` ops) are not bytes but ``collective_bytes``.
* **collective_bytes** -- by kind, the bytes this process hands the process
  fabric (``core/exchange.py``'s ``pod_hop_kinds()`` over the window), where
  the reference counts each collective's result shape.  Unit exchanges
  inside one process are index permutations on one device: bytes, not
  collectives.
* **async_collective_bytes** -- ``{}``: every process-fabric collective is
  synchronous.
* **unknown_trip_whiles** -- 0: an eager run unrolls every loop.
* **peak_live_bytes** -- the most bytes held at once by the storages the
  counter saw made (each op's non-aliasing outputs), each counted until it
  is freed (a finalizer on the storage, which PyTorch keeps while any
  tensor, a saved one for the backward included, uses it).  The
  counterpart of XLA's ``temp_size_in_bytes``: what existed before the call
  (params, inputs) is not counted.

Beside those, ``kernels`` (calls, flops and bytes by kernel) and
``regions`` (the counts inside each named :func:`repro_torch.obs.cost.region`,
the train step's ``"microbatch"``).
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..obs import cost

aten = torch.ops.aten

# Ops that read sizes, strides or layout, as ``FlopCounterMode`` lists them:
# run, not counted.
_METADATA = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default, aten.sym_size.default,
    aten.stride.default, aten.sym_stride.default, aten.storage_offset.default,
    aten.sym_storage_offset.default, aten.numel.default, aten.sym_numel.default,
    aten.dim.default, torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
# Allocations that move no bytes.
_NO_TRAFFIC = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
    aten.new_empty.default, aten.new_empty_strided.default, aten.lift_fresh.default,
}
# Namespaces whose ops are collectives (counted through obs.cost) or
# bookkeeping, never bytes.
_NOT_BYTES = ("c10d", "_c10d_functional", "profiler")


_BACKEND_KEYS = {"cpu": "CPU", "cuda": "CUDA", "meta": "Meta"}


@functools.cache
def _composite(func, device: str) -> bool:
    """Whether ``func``, reaching the mode whole on ``device``, would run
    as its C++ composite's parts (no kernel of its own for the device),
    which the counter then counts part by part.  An op with a kernel of its
    own runs that kernel, even where a composite exists too
    (``silu_backward``), so a counted run computes the same bits as an
    uncounted one."""
    if func._overloadpacket in flop_registry:
        return False
    name = func.name()
    if not torch._C._dispatch_has_kernel_for_dispatch_key(name, "CompositeImplicitAutograd"):
        return False
    own = (_BACKEND_KEYS.get(device, "CPU"), "CompositeExplicitAutograd",
           "CompositeExplicitAutogradNonFunctional")
    return not any(torch._C._dispatch_has_kernel_for_dispatch_key(name, k) for k in own)


def _device(args) -> str:
    for a in tree_flatten(args)[0]:
        if isinstance(a, torch.Tensor):
            return a.device.type
    return "cpu"


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _Tally:
    """flops, bytes and collective bytes of a program or a part of one."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.coll: dict[str, int] = {}

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": dict(self.coll)}


class OpCounter(TorchDispatchMode):
    """The counting mode; :func:`analyze` is its usual entry point.  Enter
    it with :meth:`counting`, which also makes it the active counter of
    :mod:`repro_torch.obs.cost`."""

    def __init__(self) -> None:
        super().__init__()
        self.total = _Tally()
        self.kernels: dict[str, dict[str, int]] = {}
        self.regions: dict[str, _Tally] = {}
        self._open: list[_Tally] = []  # the regions now open
        self._in_kernel = 0
        self._live: dict[int, int] = {}  # id(storage) -> bytes, alive
        self._live_bytes = 0
        self.peak_live_bytes = 0

    # -- what obs.cost calls ---------------------------------------------

    def _add(self, flops: int, nbytes: int) -> None:
        for t in [self.total, *self._open]:
            t.flops += flops
            t.bytes += nbytes

    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        if self._in_kernel == 0:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self._add(flops, nbytes)
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1

    @contextlib.contextmanager
    def region(self, name: str):
        tally = self.regions.setdefault(name, _Tally())
        self._open.append(tally)
        try:
            yield
        finally:
            self._open.remove(tally)

    def collective(self, kind: str, nbytes: int) -> None:
        for t in [self.total, *self._open]:
            t.coll[kind] = t.coll.get(kind, 0) + nbytes

    # -- the mode ------------------------------------------------------------

    @contextlib.contextmanager
    def counting(self):
        with self, cost.reporting_to(self):
            yield self

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, out: Any, func) -> None:
        """Count each new storage among ``func``'s outputs as live until it
        is freed."""
        rets = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) and len(rets) > 1 else (out,)
        for ret, o in zip(rets, outs):
            if ret.alias_info is not None:
                continue  # a view or the in-place target: no new storage
            for t in tree_flatten(o)[0]:
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                key = id(st)
                if key in self._live:
                    continue
                n = st.nbytes()
                self._live[key] = n
                self._live_bytes += n
                self.peak_live_bytes = max(self.peak_live_bytes, self._live_bytes)
                weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        if _composite(func, _device((args, kwargs))):  # as FlopCounterMode
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self._track(out, func)
        if self._in_kernel:
            return out
        packet = func._overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        nbytes = 0
        if not (func.is_view or func in _NO_TRAFFIC or func.namespace in _NOT_BYTES):
            nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        if flops or nbytes:
            self._add(flops, nbytes)
        return out

    def result(self) -> dict:
        return {
            **self.total.as_dict(),
            "async_collective_bytes": {},
            "unknown_trip_whiles": 0,
            "peak_live_bytes": self.peak_live_bytes,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "regions": {k: v.as_dict() for k, v in self.regions.items()},
        }


def analyze(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return its per-process cost (the module docstring's keys); the
    function's result is dropped (enter :meth:`OpCounter.counting` to keep
    it)."""
    counter = OpCounter()
    with counter.counting():
        fn(*args, **kwargs)
    return counter.result()


__all__ = ["OpCounter", "analyze"]
