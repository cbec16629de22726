"""Serving engines: static and continuous batching over KV caches (port of
``repro.serve.engine``).

* :class:`ServeEngine` — the static batch: same-prompt-length batches
  decoded in lock step; the batch retires when every stream finishes.
* :class:`ContinuousEngine` — the paper's fix applied to decode slots: a
  :class:`SlotAllocator` keeps a slot map over ONE shared KV cache, finished
  sequences are evicted between decode steps and freed slots are refilled
  from the pending queue (prefill-on-admit writes the new cache rows in
  place).

Expert-parallel models route their token dispatch through the multiplexer:
when a mesh context is active and ``cfg.moe_impl == "ep_shardmap"``, the
continuous engine tunes a :class:`~repro_torch.core.multiplexer.CommMultiplexer`
for the decode-shaped messages (:func:`repro_torch.core.autotune.decode_table_stats`)
and makes it ambient around admission and decode, so every MoE layer packs
with the tuned pack (the ``moe_dispatch`` kernel) and ships over the tuned
transport.  The static engine has no multiplexer: the plain pack and
``cfg.exchange_impl``.  Both give the same tokens, because the pack and the
transport do not change what is delivered.

The static engine serves every ported family: a KV cache grows to
``capacity`` positions after prefill, an SSM state is O(1) and stays as it
is (:func:`grow_cache`).  The continuous engine needs a per-position KV
cache (``decode_step_slots``) and raises for the SSM and hybrid families.

Both engines run where the params live: ``device`` defaults to the card and
raises without one; pass ``device="cpu"`` for the CPU.  Greedy sampling is
the reference's; sampling with a temperature draws from a ``torch.Generator``
and is not held to the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..models import registry
from ..obs.trace import maybe_span
from ..relational.table import resolve_device


def sample_token(gen: torch.Generator | None, logits: torch.Tensor,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy (t=0) or temperature sampling; logits ``[B, vocab]`` -> ``[B]``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # int32 [prompt_len]
    max_new_tokens: int
    eos_id: int = -1  # -1: never stops early
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    # --- continuous batching: arrival + per-request stats -------------------
    arrival_step: int = 0          # decode-step tick at which it may be admitted
    admitted_step: int | None = None
    finished_step: int | None = None
    ttft_s: float | None = None    # wall from ARRIVAL to first token
    decode_tok_s: float | None = None  # tokens/s over the decode phase
    _t_arrive: float | None = dataclasses.field(default=None, repr=False)
    _t_first: float | None = dataclasses.field(default=None, repr=False)

    @property
    def num_new_tokens(self) -> int:
        return len(self.out_tokens)


class SlotAllocator:
    """Slot map over the shared KV cache: admission + eviction-on-finish.

    Holds ``free + live == num_slots`` at every step boundary (``check()``);
    a leaked slot is a leaked cache row.
    """

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._free: list[int] = list(range(num_slots - 1, -1, -1))  # pop() -> slot 0 first
        self.live: dict[int, Request] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def admit(self, request: Request) -> int:
        """Assign a free slot to ``request``; the caller prefills its row."""
        if not self._free:
            raise RuntimeError("no free slot (caller must check num_free)")
        slot = self._free.pop()
        self.live[slot] = request
        return slot

    def release(self, slot: int) -> Request:
        """Eviction-on-finish: the slot returns to the free list at once."""
        request = self.live.pop(slot)
        self._free.append(slot)
        return request

    def check(self) -> None:
        if len(self._free) + len(self.live) != self.num_slots:
            raise AssertionError(
                f"slot leak: free={len(self._free)} live={len(self.live)} != {self.num_slots}"
            )
        if not set(self._free).isdisjoint(self.live):
            raise AssertionError(f"slot both free and live: {self._free} {sorted(self.live)}")


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class ServeEngine:
    """Greedy/temperature STATIC batched generation over the model API."""

    def __init__(self, api: registry.ModelApi, batch_size: int, capacity: int,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.api = api
        self.cfg = api.cfg
        self.batch_size = batch_size
        self.capacity = capacity
        self.temperature = temperature
        self.device = resolve_device(device)
        self.gen = _generator(self.device, seed)
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "slot_steps": 0, "wall": 0.0}

    def generate(self, params, requests: list[Request]) -> list[Request]:
        """Run one static batch of same-length prompts to completion."""
        t0 = time.perf_counter()
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests exceed batch_size={self.batch_size}")
        plen = requests[0].prompt.shape[0]
        if any(r.prompt.shape[0] != plen for r in requests):
            raise ValueError("a static batch needs one prompt length: bucket by length")
        B = self.batch_size
        prompts = np.zeros((B, plen), np.int32)
        for i, r in enumerate(requests):
            prompts[i] = r.prompt

        logits, cache = self.api.prefill(params, {"tokens": torch.from_numpy(prompts).to(self.device)})
        self.stats["prefill_tokens"] += int(prompts.size)
        ctx_len = plen
        cache = grow_cache(self.api, cache, B, self.capacity)

        max_new = max(r.max_new_tokens for r in requests)
        tokens = sample_token(self.gen, logits, self.temperature)
        first = tokens.cpu().numpy()
        live = np.array([not r.done for r in requests] + [False] * (B - len(requests)))
        for i, r in enumerate(requests):
            r.out_tokens.append(int(first[i]))
            if r.max_new_tokens <= 1 or int(first[i]) == r.eos_id:
                r.done = True
                live[i] = False

        pos = ctx_len
        for _step in range(1, max_new):
            if pos >= self.capacity or not live.any():
                break
            logits, cache = self.api.decode_step(params, tokens[:, None], cache, pos)
            tokens = sample_token(self.gen, logits, self.temperature)
            self.stats["decode_steps"] += 1
            self.stats["slot_steps"] += B
            pos += 1
            arr = tokens.cpu().numpy()
            for i, r in enumerate(requests):
                if live[i]:
                    r.out_tokens.append(int(arr[i]))
                    if len(r.out_tokens) >= r.max_new_tokens or arr[i] == r.eos_id:
                        r.done = True
                        live[i] = False
        for r in requests:
            r.done = True
        self.stats["wall"] += time.perf_counter() - t0
        return requests


def grow_cache(api: registry.ModelApi, cache: Any, batch_size: int, capacity: int) -> Any:
    """Pad prefill-sized cache leaves with zeros to the shape of
    ``api.init_cache(batch_size, capacity)``'s, as the reference does: a
    leaf whose shape already matches (an SSM state, a conv window) is kept
    as it is, a KV leaf grows along its positions.  The template is built on
    the ``meta`` device, so it allocates nothing."""
    from ..tree import tree_map

    template = api.init_cache(batch_size, capacity, device="meta")

    def grow(leaf, ref):
        if leaf.shape == ref.shape:
            return leaf
        if any(have > want for have, want in zip(leaf.shape, ref.shape)):
            raise ValueError(f"a cache leaf {tuple(leaf.shape)} exceeds the capacity-"
                             f"{capacity} shape {tuple(ref.shape)}")
        grown = leaf.new_zeros(ref.shape)
        grown[tuple(slice(0, n) for n in leaf.shape)] = leaf
        return grown

    return tree_map(grow, cache, template)


def generate_bucketed(engine: ServeEngine, params, requests: list[Request]) -> list[Request]:
    """Static-batch a MIXED-length workload: bucket by prompt length, then
    run fixed batches per bucket, in arrival order within each bucket."""
    buckets: dict[int, list[Request]] = {}
    for r in requests:
        buckets.setdefault(r.prompt.shape[0], []).append(r)
    for plen in sorted(buckets):
        group = buckets[plen]
        for i in range(0, len(group), engine.batch_size):
            engine.generate(params, group[i : i + engine.batch_size])
    return requests


def make_mixed_workload(
    vocab_size: int,
    num_requests: int,
    prompt_lens: Sequence[int],
    max_new: int,
    rng: np.random.Generator,
    arrival_rate: float = 0.0,
) -> list[Request]:
    """The standard mixed workload: prompt lengths cycle through
    ``prompt_lens``, output budgets are uniform in ``[1, max_new]``, and with
    ``arrival_rate`` r > 0 request ``i`` arrives at decode step ``i / r``."""
    reqs = []
    for i in range(num_requests):
        plen = prompt_lens[i % len(prompt_lens)]
        reqs.append(Request(
            prompt=rng.integers(0, vocab_size, plen, dtype=np.int32),
            max_new_tokens=int(rng.integers(1, max_new + 1)),
            arrival_step=int(i / arrival_rate) if arrival_rate > 0 else 0,
        ))
    return reqs


def engine_record(reqs: list[Request], stats: dict, wall: float) -> dict:
    """One engine run -> the comparable summary record."""
    total_new = sum(len(r.out_tokens) for r in reqs)
    rec = {
        "requests": len(reqs),
        "new_tokens": total_new,
        "decode_steps": stats["decode_steps"],
        "slot_steps": stats["slot_steps"],
        "wall_s": round(wall, 4),
        "tok_s": round(total_new / wall, 2) if wall > 0 else None,
    }
    ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
    if ttfts:
        rec["ttft_mean_s"] = round(float(np.mean(ttfts)), 4)
        rec["ttft_p99_s"] = round(float(np.quantile(ttfts, 0.99)), 4)
    if "live_slot_steps" in stats:
        rec["live_slot_steps"] = stats["live_slot_steps"]
    return rec


# ----------------------------------------------------------------------------
# Continuous batching.
# ----------------------------------------------------------------------------

class ContinuousEngine:
    """Continuous-batching generation: slot map + admission between steps.

    One persistent ``[batch_size, capacity]`` KV cache; per iteration:

    1. **admit** — free slots are refilled from the arrived queue (grouped
       by prompt length, one batched prefill per group, its rows written
       into the slots' cache regions in place);
    2. **decode** — one fixed-shape ``decode_step_slots`` over ALL slots at
       their own positions (dead slots compute masked garbage);
    3. **evict** — streams that hit ``max_new_tokens``/EOS/capacity release
       their slot at once.

    ``slot_steps`` (= decode_steps x batch_size) is the slot-occupancy
    currency of the static-vs-continuous comparison.
    """

    def __init__(self, api: registry.ModelApi, batch_size: int, capacity: int,
                 temperature: float = 0.0, seed: int = 0, tracer=None, device="cuda"):
        #: Optional :class:`repro_torch.obs.trace.Tracer` — admission rounds,
        #: prefill groups and decode steps become spans on it.
        self.tracer = tracer
        if api.decode_step_slots is None:
            raise NotImplementedError(
                f"continuous batching needs a per-position KV cache; family "
                f"{api.cfg.family!r} does not provide decode_step_slots"
            )
        self.api = api
        self.cfg = api.cfg
        self.batch_size = batch_size
        self.capacity = capacity
        self.temperature = temperature
        self.device = resolve_device(device)
        self.gen = _generator(self.device, seed)
        self.alloc = SlotAllocator(batch_size)
        self.stats = {
            "prefill_tokens": 0, "prefill_calls": 0, "decode_steps": 0, "slot_steps": 0,
            "live_slot_steps": 0, "idle_steps": 0, "admitted": 0, "finished": 0, "wall": 0.0,
        }
        self.mux = self._make_decode_multiplexer()

    # -- EP dispatch over the communication multiplexer ---------------------

    def _make_decode_multiplexer(self):
        """Tune a multiplexer for the decode step's expert traffic, when the
        model is expert-parallel and a mesh context is active."""
        if self.cfg.moe_impl != "ep_shardmap":
            return None
        from ..distributed.sharding import current_mesh_context

        ctx = current_mesh_context()
        if ctx is None:
            return None
        # A parallel unit is one member of the JOINT (pod, exchange) axis.
        pods = ctx.mesh.size(ctx.pod_axis) if ctx.pod_axis is not None else 1
        units = ctx.exchange_size * pods
        if units <= 1:
            return None
        from ..core.autotune import decode_table_stats
        from ..core.multiplexer import make_multiplexer

        stats = decode_table_stats(self.cfg, self.batch_size, units)
        return make_multiplexer(ctx.mesh, auto=True, table_stats=[stats])

    def _mux_scope(self):
        if self.mux is None:
            return contextlib.nullcontext()
        from ..core.multiplexer import use_multiplexer

        return use_multiplexer(self.mux)

    # -- prefill-on-admit ---------------------------------------------------

    @staticmethod
    def _scatter_prefill(cache, pref, slots: torch.Tensor) -> None:
        """Write prefill rows ``0..len(slots)-1`` into their slots' cache
        regions, in place.  The reference completes the slot vector to a
        permutation and re-writes the other slots' current bytes; writing
        only the admitted rows leaves the same cache."""
        n = slots.shape[0]
        for seg, leaves in cache.items():
            for name, leaf in leaves.items():
                p = pref[seg][name]
                leaf[:, slots, : p.shape[2]] = p[:, :n].to(leaf.dtype)

    def _admit_group(self, params, cache, requests: list[Request], step: int, t0: float):
        """Prefill one same-prompt-length group (padded to the batch) and
        write it into the admitted slots."""
        B, plen = self.batch_size, requests[0].prompt.shape[0]
        prompts = np.zeros((B, plen), np.int32)
        for j, r in enumerate(requests):
            prompts[j] = r.prompt
        with maybe_span(self.tracer, f"prefill:len{plen}", "serve",
                        requests=len(requests), step=step):
            logits, pref_cache = self.api.prefill(
                params, {"tokens": torch.from_numpy(prompts).to(self.device)})
            if self.tracer is not None and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()  # the span ends with the work
        self.stats["prefill_tokens"] += len(requests) * plen
        self.stats["prefill_calls"] += 1
        ctx_len = int(pref_cache["seg0"]["k"].shape[2])
        if ctx_len >= self.capacity:
            raise ValueError(
                f"admission rejected: prefill context of {ctx_len} rows cannot fit a "
                f"capacity-{self.capacity} cache slot"
            )

        slot_of = [self.alloc.admit(r) for r in requests]
        self._scatter_prefill(cache, pref_cache, torch.tensor(slot_of, device=self.device))

        first = sample_token(self.gen, logits, self.temperature).cpu().numpy()
        now = time.perf_counter() - t0
        for j, r in enumerate(requests):
            r.admitted_step = step
            r.out_tokens.append(int(first[j]))
            r.ttft_s = now - (r._t_arrive or 0.0)
            r._t_first = now
            self.stats["admitted"] += 1
            self._positions[slot_of[j]] = ctx_len
            self._tokens[slot_of[j]] = int(first[j])
            if r.max_new_tokens <= 1 or int(first[j]) == r.eos_id:
                self._finish(slot_of[j], r, step, t0)

    def _finish(self, slot: int, r: Request, step: int, t0: float):
        r.done = True
        r.finished_step = step
        dt = (time.perf_counter() - t0) - (r._t_first or 0.0)
        if r.num_new_tokens > 1 and dt > 0:
            r.decode_tok_s = (r.num_new_tokens - 1) / dt
        self.stats["finished"] += 1
        self.alloc.release(slot)
        # park the dead slot at position 0 with token 0: it keeps decoding
        # (fixed batch shape) into a region the next admission overwrites
        self._positions[slot] = 0
        self._tokens[slot] = 0

    # -- the serve loop -----------------------------------------------------

    def serve(self, params, requests: list[Request]) -> list[Request]:
        """Run a mixed-length workload to completion with slot refill.

        Requests become admittable at ``arrival_step`` (a decode-step tick).
        Among the arrived, freed slots go to the LONGEST remaining budget
        first (ties keep arrival order, so uniform workloads admit FIFO).
        Raises before any state changes on a request whose prompt cannot fit
        a cache slot.
        """
        for r in requests:
            if r.prompt.shape[0] >= self.capacity:
                raise ValueError(
                    f"admission rejected: prompt of {r.prompt.shape[0]} tokens cannot fit "
                    f"a capacity-{self.capacity} cache slot"
                )
        t0 = time.perf_counter()
        B = self.batch_size
        pending = sorted(requests, key=lambda r: r.arrival_step)
        cache = self.api.init_cache(B, self.capacity, device=self.device)
        self._positions = np.zeros((B,), np.int32)
        self._tokens = np.zeros((B,), np.int32)
        step = 0

        with self._mux_scope():
            while pending or self.alloc.live:
                # -- admission: refill freed slots from the arrived queue --
                n_arrived = 0
                while n_arrived < len(pending) and pending[n_arrived].arrival_step <= step:
                    n_arrived += 1
                for i in range(n_arrived):  # TTFT clock starts at arrival
                    if pending[i]._t_arrive is None:
                        pending[i]._t_arrive = time.perf_counter() - t0
                admittable: list[Request] = []
                if n_arrived and self.alloc.num_free:
                    # LPT pick among the arrived; admit in arrival order
                    pick = sorted(range(n_arrived), key=lambda i: -pending[i].max_new_tokens)
                    chosen = set(pick[: self.alloc.num_free])
                    admittable = [pending[i] for i in sorted(chosen)]
                    pending = [r for i, r in enumerate(pending) if i not in chosen]
                by_len: dict[int, list[Request]] = {}
                for r in admittable:
                    by_len.setdefault(r.prompt.shape[0], []).append(r)
                if by_len:
                    with maybe_span(self.tracer, f"admission-round:{step}", "serve",
                                    admitted=len(admittable), groups=len(by_len)):
                        for plen in sorted(by_len):
                            self._admit_group(params, cache, by_len[plen], step, t0)
                self.alloc.check()

                if not self.alloc.live:
                    # nothing to decode: idle tick toward the next arrival
                    step += 1
                    self.stats["idle_steps"] += 1
                    continue

                # -- one fixed-shape decode step over every slot -----------
                with maybe_span(self.tracer, f"decode-step:{step}", "serve",
                                live=len(self.alloc.live)):
                    logits, cache = self.api.decode_step_slots(
                        params,
                        torch.from_numpy(self._tokens[:, None].copy()).to(self.device),
                        cache,
                        torch.from_numpy(self._positions.copy()).to(self.device),
                    )
                    sampled = sample_token(self.gen, logits, self.temperature).cpu().numpy()
                self.stats["decode_steps"] += 1
                self.stats["slot_steps"] += B
                self.stats["live_slot_steps"] += len(self.alloc.live)

                # -- bookkeeping + eviction-on-finish ----------------------
                for slot, r in list(self.alloc.live.items()):
                    tok = int(sampled[slot])
                    r.out_tokens.append(tok)
                    self._tokens[slot] = tok
                    self._positions[slot] += 1
                    if (r.num_new_tokens >= r.max_new_tokens or tok == r.eos_id
                            or self._positions[slot] >= self.capacity):
                        self._finish(slot, r, step, t0)
                step += 1
                self.alloc.check()

        self.stats["wall"] += time.perf_counter() - t0
        return requests


__all__ = [
    "ServeEngine",
    "ContinuousEngine",
    "SlotAllocator",
    "Request",
    "sample_token",
    "generate_bucketed",
    "grow_cache",
    "make_mixed_workload",
    "engine_record",
]
