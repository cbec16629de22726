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

The static engine serves every family: a KV cache grows to ``capacity``
positions after prefill (the hybrid family's prefill writes it at that
capacity at once), an SSM state is O(1) and stays as it is
(:func:`grow_cache`).  The continuous engine needs a per-position KV cache
(``decode_step_slots``) and raises for the SSM, hybrid and encoder-decoder
families, as the reference's does, with or without the tensor table.

Across processes (a mesh context whose mesh spans ``R`` processes, every
process running the same calls) both engines split their batch as the
reference's ``"batch" -> (pod, data)`` rule does (:func:`_batch_rows`):
each process prefills, caches and decodes its ``B / R`` rows, the
expert-parallel MoE layer moves tokens between the processes over the pod
hop, and each call's sampled tokens are gathered, so every process returns
every request's tokens.  The continuous engine's slot ``s`` lives on
process ``s // (B / R)``; its slot map, admission and eviction run alike on
every process from the request list and the gathered tokens, and a
prefilled cache row whose slot another process owns is sent there
(:func:`route_rows`).  A batch that ``R`` does not divide runs whole on
every process.  Params stay whole on every process, except under the
tensor table (:func:`~repro_torch.distributed.sharding.tensor_rules`),
where both engines run the whole batch on every process over each
process's slices of the model (``stats["rows"] == "tensor"``; the static
engine for the SSM and hybrid families too, each process on its SSM heads):
the continuous engine holds every slot's cache rows of the process's kv heads
and writes each prefill group in place (no row moves); the logits come
gathered to the full vocab, so generators seeded alike sample the same
tokens and the slot map, admission and eviction run alike on every process.

Side inputs (``extra_inputs``: a VLM's ``patches [B, P, d]``, an
encoder-decoder's ``frames [B, S_f, d]``) join every prefill batch.  Static
decode continues where the reference reads it from its first cache leaf
(:func:`_decode_start`): after the whole prefill context, patches plus
prompt; for an encoder-decoder, at the frames' length.  Two parities with
the reference follow for Whisper, kept on purpose: the cross cache grows
with zero rows that decode attends over, and frames longer or shorter than
the prompt move the first decode position.

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

from ..core import exchange
from ..distributed.sharding import (
    current_mesh_context,
    gather_rows,
    local_rows,
    mesh_context,
    split_rows,
)
from ..models import registry
from ..obs.trace import maybe_span
from ..relational.table import resolve_device
from ..tree import leaves, tree_map


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


def _on_device(extra: dict | None, device: torch.device) -> dict:
    """Side inputs (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in (extra or {}).items()}


def _side_rows(extra: dict | None) -> int:
    """The rows a VLM's patches put before every prompt (0 without them)."""
    return int(extra["patches"].shape[1]) if extra and "patches" in extra else 0


def _batch_rows(batch_size: int):
    """How a batch of ``batch_size`` rows lies over the active mesh:
    ``(mode, mesh, ctx)``.  ``"whole"`` without a mesh that spans processes;
    ``"tensor"`` under the tensor table (every process the whole batch, the
    model's matrices split); otherwise on a mesh over ``R`` processes
    ``"split"`` where ``R`` divides the batch (each process its rows, the
    MoE layer under ``moe_tokens="local"``), else ``"replicated"`` (every
    process the whole batch under ``"global"``).  ``mesh`` is the mesh to
    split over (``None`` unless ``"split"``), ``ctx`` the context to run the
    model under."""
    ctx = current_mesh_context()
    if ctx is None or ctx.mesh.num_processes == 1:
        return "whole", None, ctx
    if ctx.tensor:
        return "tensor", None, ctx
    if split_rows(batch_size, ctx.mesh):
        return "split", ctx.mesh, dataclasses.replace(ctx, moe_tokens="local")
    return "replicated", None, ctx


def _gathered(t: torch.Tensor, mesh) -> np.ndarray:
    """Every process's rows of ``t`` on the host (``t`` itself off a split)."""
    return (t if mesh is None else gather_rows(t, mesh)).cpu().numpy()


def _decode_start(cfg, plen: int, extra: dict | None) -> int:
    """The static engine's first decode position, as the reference reads it
    (the position axis of ``jax.tree.leaves(cache)[0]``, whose dict keys
    JAX sorts): the prompt after a VLM's patch rows; for an encoder-decoder
    the frames' length (its first sorted leaf is ``cross_k``), which is the
    prompt's only when the two agree, as the launcher makes them."""
    if cfg.family == "encdec":
        return int(extra["frames"].shape[1])
    return plen + _side_rows(extra)


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

    def generate(self, params, requests: list[Request],
                 extra_inputs: dict | None = None) -> list[Request]:
        """Run one static batch of same-length prompts to completion, with
        ``extra_inputs`` (``[batch_size, ...]`` each) in its prefill.

        Under a mesh context whose mesh spans ``R`` processes every process
        calls this with the same whole batch.  Where ``R`` divides
        ``batch_size``, each process prefills and decodes only its rows of
        the prompts, of ``extra_inputs`` and of the cache (``batch_size / R``
        of them), and every step's sampled tokens are gathered over the pod
        hop, so that every process fills every ``Request`` and keeps the
        same live mask.  Otherwise every process runs the whole batch: under
        the tensor table (``params`` then the process's slices) each call's
        logits are gathered to the full vocab on every process, so every
        process samples the same tokens from generators seeded alike.
        ``stats["rows"]`` says which (``"split"``, ``"tensor"``,
        ``"replicated"``, or ``"whole"`` off such a mesh).  Every process
        makes the same number of prefill and decode calls: the MoE layer's
        pod hops, the tensor table's reductions and the gathers are
        collectives, and a process that left the loop early would hang the
        others.  Greedy tokens equal the one-process run's; with a
        temperature, under a split each process draws its rows' tokens from
        its own generator.
        """
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

        mode, mesh, ctx = _batch_rows(B)
        self.stats["rows"] = mode
        batch = {"tokens": torch.from_numpy(prompts),
                 **{k: torch.as_tensor(v) for k, v in (extra_inputs or {}).items()}}
        if mesh is not None:
            batch = local_rows(batch, mesh)
        batch = {k: v.to(self.device) for k, v in batch.items()}
        rows = batch["tokens"].shape[0]

        with mesh_context(ctx):
            logits, cache = self.api.prefill(params, batch, capacity=self.capacity)
        self.stats["prefill_tokens"] += int(prompts.size)
        # decode continues after the WHOLE prefill context (a VLM's patch
        # rows + the prompt; an encoder-decoder's frames), in a capacity-long
        # cache
        ctx_len = _decode_start(self.cfg, plen, extra_inputs)
        cache = grow_cache(self.api, cache, rows, self.capacity)

        max_new = max(r.max_new_tokens for r in requests)
        tokens = sample_token(self.gen, logits, self.temperature)
        first = _gathered(tokens, mesh)
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
            with mesh_context(ctx):
                logits, cache = self.api.decode_step(params, tokens[:, None], cache, pos)
            tokens = sample_token(self.gen, logits, self.temperature)
            self.stats["decode_steps"] += 1
            self.stats["slot_steps"] += B
            pos += 1
            arr = _gathered(tokens, mesh)
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
    leaf whose shape already matches (an SSM state, a conv window, a cache
    prefilled at its capacity) is kept as it is, a KV leaf grows along its
    positions (the dim its ``cache_spec_fn()`` names ``"kv_seq"``) and only
    there.  Any other mismatch raises: a leaf of other heads, rows or width
    than the template's is a layout fault, which zero padding would hide.
    The template is built on the ``meta`` device, so it allocates nothing."""
    template = api.init_cache(batch_size, capacity, device="meta")

    def grow(path, leaf, ref, spec):
        if leaf.shape == ref.shape:
            return leaf
        where = "/".join(map(str, path))
        seq = spec.index("kv_seq") if "kv_seq" in spec else None
        others = [d for d in range(ref.ndim) if d != seq]
        if (seq is None or leaf.ndim != ref.ndim
                or any(leaf.shape[d] != ref.shape[d] for d in others)):
            raise ValueError(f"cache leaf {where} {tuple(leaf.shape)} differs from the "
                             f"capacity-{capacity} shape {tuple(ref.shape)} outside its "
                             "positions")
        if leaf.shape[seq] > ref.shape[seq]:
            raise ValueError(f"cache leaf {where} {tuple(leaf.shape)} exceeds the capacity-"
                             f"{capacity} shape {tuple(ref.shape)}")
        grown = leaf.new_zeros(ref.shape)
        grown.narrow(seq, 0, leaf.shape[seq]).copy_(leaf)
        return grown

    return tree_map(grow, cache, template, api.cache_spec_fn(), with_path=True)


def generate_bucketed(engine: ServeEngine, params, requests: list[Request],
                      extra_inputs: dict | None = None) -> list[Request]:
    """Static-batch a MIXED-length workload: bucket by prompt length, then
    run fixed batches per bucket, in arrival order within each bucket."""
    buckets: dict[int, list[Request]] = {}
    for r in requests:
        buckets.setdefault(r.prompt.shape[0], []).append(r)
    for plen in sorted(buckets):
        group = buckets[plen]
        for i in range(0, len(group), engine.batch_size):
            engine.generate(params, group[i : i + engine.batch_size], extra_inputs)
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

@dataclasses.dataclass(frozen=True)
class RowRoute:
    """Where one process's prefilled cache rows go (:func:`route_rows`), in
    local row numbers: ``keep`` pairs ``(prefill row, slot row)`` written in
    place; ``send[p]`` the prefill rows for process ``p``; ``recv[p]`` the
    slot rows that process ``p``'s message fills, both in admission order."""

    keep: list
    send: dict
    recv: dict


def route_rows(slot_of: Sequence[int], batch_size: int, processes: int, rank: int) -> RowRoute:
    """Process ``rank``'s part in moving a prefill group's cache rows to their
    slots, a pure function of the slot map: admitted row ``j`` is prefilled
    on process ``j // n`` (``n = batch_size / processes``) at local row
    ``j % n`` and belongs to slot ``slot_of[j]``, which lives on process
    ``slot_of[j] // n`` at local row ``slot_of[j] % n``.  Rows are listed in
    admission order, so a (source, destination) pair's message holds the
    same rows in the same order on both ends."""
    n = batch_size // processes
    keep, send, recv = [], {}, {}
    for j, slot in enumerate(slot_of):
        src, dst = j // n, slot // n
        if src == dst == rank:
            keep.append((j % n, slot % n))
        elif src == rank:
            send.setdefault(dst, []).append(j % n)
        elif dst == rank:
            recv.setdefault(src, []).append(slot % n)
    return RowRoute(keep, send, recv)


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

    On a mesh over ``R`` processes that divide ``batch_size`` (``stats["rows"]
    == "split"``) each process holds the cache rows of its ``batch_size / R``
    slots, prefills its rows of each group and decodes its slots;
    ``stats["moved_rows"]`` counts the prefilled rows sent to the process
    that owns their slot.  Under the tensor table (``"tensor"``) every
    process holds every slot over its slices of the model and moves no row.
    The multiplexer is tuned from the model alone (no timing), so every
    process builds the same one (two-level where the mesh has pods: under
    the tensor table its units are ``pods x q``).
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
            "live_slot_steps": 0, "idle_steps": 0, "admitted": 0, "finished": 0,
            "moved_rows": 0, "wall": 0.0,
        }
        self.mux = self._make_decode_multiplexer()

    # -- EP dispatch over the communication multiplexer ---------------------

    def _make_decode_multiplexer(self):
        """Tune a multiplexer for the decode step's expert traffic, when the
        model is expert-parallel and a mesh context is active."""
        if self.cfg.moe_impl != "ep_shardmap":
            return None
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
    def _scatter_prefill(cache, pref, slots: torch.Tensor, rows: torch.Tensor | None = None
                         ) -> None:
        """Write prefill rows ``rows`` (default ``0..len(slots)-1``) into the
        cache rows ``slots`` (this process's), in place.  The reference
        completes the slot vector to a permutation and re-writes the other
        slots' current bytes; writing only the admitted rows leaves the same
        cache."""
        for seg, leaves in cache.items():
            for name, leaf in leaves.items():
                p = pref[seg][name]
                p = p[:, : slots.shape[0]] if rows is None else p[:, rows]
                leaf[:, slots, : p.shape[2]] = p.to(leaf.dtype)

    def _route_prefill(self, cache, pref, slot_of: list[int], mesh) -> None:
        """Across processes: write this process's prefilled rows whose slots
        it owns in place, and trade the others with their owners in one
        ``collective-permute`` round (a message a cache leaf and process
        pair, tagged with the leaf's number)."""
        R = mesh.num_processes
        n = self.batch_size // R
        route = route_rows(slot_of, self.batch_size, R, mesh.process_index)
        self.stats["moved_rows"] += sum(j // n != s // n for j, s in enumerate(slot_of))

        def index(rows):
            return torch.tensor(rows, dtype=torch.long, device=self.device)

        if route.keep:
            src, dst = zip(*route.keep)
            self._scatter_prefill(cache, pref, index(dst), index(src))
        named = [(seg, name, leaf) for seg, lv in pref.items() for name, leaf in lv.items()]
        sends = [(proc, tag, leaf[:, index(rows)])
                 for proc, rows in route.send.items() for tag, (_, _, leaf) in enumerate(named)]
        got: dict[int, dict] = {proc: {} for proc in route.recv}
        recvs = []
        for proc, rows in route.recv.items():
            for tag, (seg, name, leaf) in enumerate(named):
                buf = leaf.new_empty((leaf.shape[0], len(rows)) + tuple(leaf.shape[2:]))
                got[proc].setdefault(seg, {})[name] = buf
                recvs.append((proc, tag, buf))
        if sends or recvs:
            exchange._p2p(mesh, sends, recvs)
        for proc, rows in route.recv.items():
            self._scatter_prefill(cache, got[proc], index(rows))

    def _admit_group(self, params, cache, requests: list[Request], step: int, t0: float,
                     extra: dict):
        """Prefill one same-prompt-length group (padded to the batch), with
        the side inputs ``extra`` (on the device; this process's rows under
        a split), and write it into the admitted slots."""
        B, plen = self.batch_size, requests[0].prompt.shape[0]
        _mode, mesh, ctx = self._layout
        prompts = np.zeros((B, plen), np.int32)
        for j, r in enumerate(requests):
            prompts[j] = r.prompt
        tokens = {"tokens": torch.from_numpy(prompts)}
        if mesh is not None:
            tokens = local_rows(tokens, mesh)
        with maybe_span(self.tracer, f"prefill:len{plen}", "serve",
                        requests=len(requests), step=step):
            with mesh_context(ctx):
                logits, pref_cache = self.api.prefill(
                    params, {"tokens": tokens["tokens"].to(self.device), **extra})
            if self.tracer is not None and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()  # the span ends with the work
        self.stats["prefill_tokens"] += len(requests) * plen
        self.stats["prefill_calls"] += 1
        # a slot starts from the PREFILL CACHE's length, any leaf's axis 2
        # (``k`` under GQA, ``c`` under MLA): a VLM's patch rows come before
        # the prompt, and decode continues after both
        ctx_len = int(leaves(pref_cache)[0].shape[2])
        if ctx_len >= self.capacity:
            raise ValueError(
                f"admission rejected: prefill context of {ctx_len} rows (prompt {plen} + "
                f"side inputs) cannot fit a capacity-{self.capacity} cache slot"
            )

        first = _gathered(sample_token(self.gen, logits, self.temperature), mesh)
        slot_of = [self.alloc.admit(r) for r in requests]
        if mesh is None:
            self._scatter_prefill(cache, pref_cache, torch.tensor(slot_of, device=self.device))
        else:
            self._route_prefill(cache, pref_cache, slot_of, mesh)

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

    def serve(self, params, requests: list[Request],
              extra_inputs: dict | None = None) -> list[Request]:
        """Run a mixed-length workload to completion with slot refill.

        Requests become admittable at ``arrival_step`` (a decode-step tick).
        Among the arrived, freed slots go to the LONGEST remaining budget
        first (ties keep arrival order, so uniform workloads admit FIFO).
        ``extra_inputs`` (``[batch_size, ...]`` each) join every prefill
        group.  Raises before any state changes on a request whose prompt,
        with the side-input rows a VLM's patches prepend, cannot fit a cache
        slot.

        Under a mesh context whose mesh spans ``R`` processes every process
        calls this with the same requests.  Where ``R`` divides
        ``batch_size`` each process holds a ``[batch_size / R, capacity]``
        cache, the rows of its slots (slot ``s`` on process ``s // (batch_size
        / R)``), prefills its rows of every group (and of ``extra_inputs``)
        and decodes its slots, the MoE layer under ``moe_tokens="local"``;
        every call's sampled tokens are gathered, so the slot map, admission
        and eviction run alike on every process, and every process fills
        every ``Request``.  Otherwise every process runs the whole engine:
        under the tensor table (``params`` then the process's slices) on
        the full-vocab logits each call gathers.  ``stats["rows"]`` says
        which.  Every process makes every prefill and decode call, dead
        slots' included: the MoE layer's pod hops, the tensor table's
        reductions and the gathers are collectives.
        """
        side = _side_rows(extra_inputs)
        for r in requests:
            if r.prompt.shape[0] + side >= self.capacity:
                raise ValueError(
                    f"admission rejected: prompt of {r.prompt.shape[0]} tokens"
                    + (f" + {side} side-input rows" if side else "")
                    + f" cannot fit a capacity-{self.capacity} cache slot"
                )
        B = self.batch_size
        self._layout = mode, mesh, ctx = _batch_rows(B)
        self.stats["rows"] = mode
        if mesh is not None and extra_inputs:
            extra_inputs = local_rows({k: torch.as_tensor(v) for k, v in extra_inputs.items()},
                                      mesh)
        extra = _on_device(extra_inputs, self.device)
        rows = B if mesh is None else B // mesh.num_processes
        lo = 0 if mesh is None else mesh.process_index * rows  # this process's first slot
        t0 = time.perf_counter()
        pending = sorted(requests, key=lambda r: r.arrival_step)
        cache = self.api.init_cache(rows, self.capacity, device=self.device)
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
                            self._admit_group(params, cache, by_len[plen], step, t0, extra)
                self.alloc.check()

                if not self.alloc.live:
                    # nothing to decode: idle tick toward the next arrival
                    step += 1
                    self.stats["idle_steps"] += 1
                    continue

                # -- one fixed-shape decode step over every slot -----------
                with maybe_span(self.tracer, f"decode-step:{step}", "serve",
                                live=len(self.alloc.live)):
                    with mesh_context(ctx):
                        logits, cache = self.api.decode_step_slots(
                            params,
                            torch.from_numpy(self._tokens[lo:lo + rows, None].copy()).to(
                                self.device),
                            cache,
                            torch.from_numpy(self._positions[lo:lo + rows].copy()).to(
                                self.device),
                        )
                    sampled = _gathered(sample_token(self.gen, logits, self.temperature), mesh)
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
    "RowRoute",
    "route_rows",
    "sample_token",
    "generate_bucketed",
    "grow_cache",
    "make_mixed_workload",
    "engine_record",
]
