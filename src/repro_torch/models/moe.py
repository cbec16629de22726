"""Mixture-of-Experts layer routed through the exchange fabric (port of
``repro.models.moe``).

The paper's mapping: a token is a tuple, the router's expert id is the join
key, the per-expert capacity buffers are the multiplexer's message pool, and
the expert-parallel dispatch/combine is the decoupled exchange operator's
all-to-all, over the simulated fabric of :mod:`repro_torch.core.exchange`.

Two execution paths (``cfg.moe_impl``):

* ``"dense"`` (and its alias ``"gspmd"``) — every expert for every token,
  weighted combine; exact, no capacity drops.
* ``"ep_shardmap"`` — expert parallelism over the units of the active
  :class:`~repro_torch.distributed.sharding.MeshContext`.  The reference's
  ``shard_map`` becomes a leading unit dim: tokens ``[T, d]`` are viewed as
  ``[N, T/N, d]`` in unit order (pod-major on a two-level mesh), and expert
  ``e`` lives on unit ``e // E_loc``.  Every unit's body runs at once.  On
  a mesh that spans processes each process runs its own units' bodies (and
  experts).  Under the context's ``moe_tokens="global"`` (serving) every
  process holds all ``T`` tokens and the outputs are gathered, so every
  process returns all ``T``; under ``"local"`` (training, set by the train
  step; serving a batch split over the processes, set by the static engine)
  each process feeds its own ``T / R`` rows and gets back only theirs, and
  the pod hop's backward carries the gradient.

An expert leaf is either whole (``E`` rows) or already this process's slice
(``local_units * E_loc`` rows: the sharded train state of
:func:`repro_torch.train.step.state_shardings`, or a served model's experts
under the tensor table, :func:`~repro_torch.distributed.sharding.tensor_rules`).
Under the tensor table every process holds all ``T`` tokens
(``moe_tokens="global"``): the expert-parallel path runs its units' bodies
on its own experts and gathers every unit's output, and where that path
declines (``T`` or ``E`` not a multiple of the units) the dense path is the
reference's ``moe_dense`` under ``experts -> model``: each process computes
its experts for every token and one all-reduce sums them.  No path runs on
experts a process does not hold.  :func:`record_drops` collects each
expert-parallel call's per-unit drop counts, :func:`record_paths` the path
each call took, :func:`record_routes` each call's top-k sets and how near
each token is to another route.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Iterator

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import exchange
from ..core.autotune import ep_capacity
from ..core.exchange import Mesh
from ..core.multiplexer import current_multiplexer
from ..distributed.sharding import current_mesh_context, tensor_all_reduce, tensor_context
from ..kernels import ops, ref
from . import layers as L


def init_moe_layer(gen: torch.Generator, cfg: ModelConfig) -> Any:
    """Router and routed experts; with ``num_shared_experts``, a ``shared``
    SwiGLU MLP of width ``moe_d_ff x num_shared_experts`` that every token
    goes through (DeepSeek-V2's shared experts, fused into one MLP as the
    reference fuses them)."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    dt = L.pdtype(cfg)
    p = {
        "router": L._normal(gen, (d, E), 0.02, torch.float32),  # router in f32
        "w_gate": L.he_init(gen, (E, d, f), d, dt),
        "w_up": L.he_init(gen, (E, d, f), d, dt),
        "w_down": L.he_init(gen, (E, f, d), f, dt),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg, d_ff=f * cfg.num_shared_experts)
    return p


def specs_moe_layer(cfg: ModelConfig) -> Any:
    s = {
        "router": (None, None),
        "w_gate": ("experts", "expert_fsdp", None),
        "w_up": ("experts", "expert_fsdp", None),
        "w_down": ("experts", None, "expert_fsdp"),
    }
    if cfg.num_shared_experts:
        s["shared"] = L.specs_mlp(cfg)
    return s


def route(params, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routing -> (weights ``[..., k]`` f32, expert ids ``[..., k]``
    int64 as ``torch.topk`` gives them, which both packs take without a
    cast), the ids in descending probability order as ``lax.top_k`` gives
    them.  The router product stays in full f32."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.router_norm_topk:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def _expert_ffn(w_gate, w_up, w_down, x):
    """Batched per-expert SwiGLU: x ``[E, C, d]`` -> ``[E, C, d]``."""
    g = torch.bmm(x, w_gate)
    u = torch.bmm(x, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


# ----------------------------------------------------------------------------
# Dense path (exact; the oracle of the tests).
# ----------------------------------------------------------------------------

def moe_dense(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Evaluate all experts for all tokens, combine by router weight.

    With this process's slice of the experts under the tensor table (``E /
    R`` expert rows, process ``i`` holding run ``i``), the reference's
    ``moe_dense`` under ``experts -> model``: the process's experts for
    every token, weighted by their columns of the full ``[T, E]`` router
    weights, then one all-reduce over the processes.  Expert leaves of any
    other size raise."""
    T, _ = x.shape
    dt = x.dtype
    E, held = cfg.num_experts, params["w_gate"].shape[0]
    w, idx = route(params, cfg, x)
    full_w = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    full_w.scatter_add_(1, idx, w)
    ctx = None
    if held != E:
        ctx = tensor_context()
        if ctx is None or held * ctx.mesh.num_processes != E:
            raise ValueError(
                f"dense MoE on expert leaves of {held} rows: neither all {E} experts nor a "
                "process's slice under the tensor table")
        lo = ctx.mesh.process_index * held
        full_w = full_w[:, lo:lo + held]
    _record_path("dense" if ctx is None else "dense-tensor")
    g = torch.einsum("td,edf->tef", x, params["w_gate"].to(dt))
    u = torch.einsum("td,edf->tef", x, params["w_up"].to(dt))
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, params["w_down"].to(dt))
    y = torch.einsum("ted,te->td", y, full_w.to(dt))
    return y if ctx is None else tensor_all_reduce(y, ctx)


# ----------------------------------------------------------------------------
# Expert-parallel path (the paper's exchange pipeline).
# ----------------------------------------------------------------------------

_DROPS: list | None = None
_PATHS: list | None = None
_ROUTES: list | None = None


@contextlib.contextmanager
def record_paths() -> Iterator[list]:
    """Inside the with-block every MoE call appends the path it took, in
    call order: ``"ep"`` (expert-parallel), ``"dense"`` (every expert on
    this process) or ``"dense-tensor"`` (this process's experts under the
    tensor table, then an all-reduce)."""
    global _PATHS
    prev, _PATHS = _PATHS, []
    try:
        yield _PATHS
    finally:
        _PATHS = prev


def _record_path(path: str) -> None:
    if _PATHS is not None:
        _PATHS.append(path)


@contextlib.contextmanager
def record_routes() -> Iterator[list]:
    """Inside the with-block every MoE layer call appends its tokens'
    routes, in call order, on the host: ``(ids, margin)``, ``ids [T, k]``
    the top-k experts of each token in ascending order (int16, so two runs'
    sets compare row by row) and ``margin [T]`` the gap between its k-th and
    its (k+1)-th router logit (f32), which says how near a token is to
    another route.  It costs one more router product a call; outside the
    block, nothing."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def _record_route(params, cfg: ModelConfig, tokens: torch.Tensor) -> None:
    logits = tokens.float() @ params["router"]
    top = torch.topk(logits, min(cfg.top_k + 1, cfg.num_experts), dim=-1, sorted=True)
    ids = top.indices[:, :cfg.top_k].sort(dim=-1).values.to(torch.int16)
    margin = (top.values[:, cfg.top_k - 1] - top.values[:, cfg.top_k]
              if cfg.top_k < cfg.num_experts else torch.full_like(top.values[:, 0], float("inf")))
    _ROUTES.append((ids.cpu(), margin.cpu()))


@contextlib.contextmanager
def record_drops() -> Iterator[list]:
    """Inside the with-block every expert-parallel call appends its local
    units' drop counts (``[local_units]`` int32) to the yielded list, in
    call order: a remat recompute calls again (it stops early, past the
    dispatch, once it has every saved tensor back)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _resolve_exchange(cfg: ModelConfig, mux) -> tuple[str, str]:
    """The EP exchange policy ``(impl, pack_impl)``: both from the ambient
    multiplexer when there is one; else ``cfg.exchange_impl`` with the
    plain pack."""
    if mux is not None:
        return mux.impl, mux.pack_impl
    return cfg.exchange_impl, "torch"


def _dispatch_slots(flat_dest: torch.Tensor, E: int, C: int, pack_impl: str):
    """``slot = expert * C + arrival rank``, overflow -> the ``E * C`` drop
    bin, for expert ids ``[N, T]``: ``(slot [N, T], kept [N, T])``.

    ``"cuda"`` launches the ``moe_dispatch`` kernel once over all units;
    ``"torch"`` is the plain one-hot + cumsum.  Both give the same slots.
    """
    if pack_impl == "cuda":
        slot, _ = ops.moe_dispatch(flat_dest, E, C)
    elif pack_impl == "torch":
        slot, _ = ref.moe_dispatch_ref(flat_dest, E, C)
    else:
        raise ValueError(f"unknown pack impl {pack_impl!r}")
    return slot, slot < E * C


def _ep_moe_local(params, cfg: ModelConfig, x: torch.Tensor, mesh: Mesh,
                  axis_name: str, pod_axis: str | None = None):
    """Every local unit's body at once: ``x [U, T_loc, d]`` -> ``(y [U,
    T_loc, d], dropped [U])`` for this process's ``U = mesh.local_units``
    of the ``N`` units.

    The ambient multiplexer (the continuous engine's tuned policy), when
    there is one, carries the dispatch and return trips and names the pack;
    else ``cfg.exchange_impl`` with the plain pack.  On a pod mesh a unit is
    one member of the joint ``(pod, axis_name)`` axis and both trips take
    the two-level fabric, a pure permutation like the flat route.  A chunk
    count (the mux's ``pipeline_chunks``, else ``cfg.moe_async_chunks``)
    that divides ``C`` ships the capacity buffers in that many chunks; the
    output does not depend on it.
    """
    mux = current_multiplexer()
    U, T_loc, d = x.shape
    N = mesh.num_units
    E, k = cfg.num_experts, cfg.top_k
    E_loc = E // N
    C = ep_capacity(T_loc, k, E, cfg.capacity_factor)
    dt = x.dtype
    impl, pack_impl = _resolve_exchange(cfg, mux)

    w, idx = route(params, cfg, x)  # [U, T_loc, k]

    # -- step 2: partition tuples into per-expert messages (the message pool).
    flat_dest = idx.reshape(U, T_loc * k)
    flat_rows = x.repeat_interleave(k, dim=1)  # token copy per choice, in order
    slot, kept = _dispatch_slots(flat_dest, E, C, pack_impl)
    # Dropped rows all write zeros to each unit's drop row E * C, so the
    # collision there is deterministic; the drop row is then cut off.
    unit = torch.arange(U, device=x.device)[:, None]
    buffers = x.new_zeros((U * (E * C + 1), d))
    buffers[(unit * (E * C + 1) + slot).reshape(-1)] = torch.where(
        kept[..., None], flat_rows, 0
    ).reshape(-1, d)
    buffers = buffers.view(U, E * C + 1, d)[:, :-1]
    dropped = (~kept).sum(1, dtype=torch.int32)
    if _DROPS is not None:
        _DROPS.append(dropped)

    # -- step 3: the multiplexer shuffle to the experts' owner units.
    if pod_axis is None and mux is not None and mux.plan.pod_axis is not None \
            and mux.plan.num_pods > 1:
        raise ValueError(
            "flat EP dispatch with a two-level multiplexer: the mesh has a pod "
            f"axis ({mux.plan.pod_axis!r}) but the MoE layer was not given it; "
            "pass the pod axis through MeshContext.pod_axis"
        )

    # The mux's dispatch/combine take the flat route on a single-level mesh.
    if mux is not None:
        ship_out = functools.partial(mux.dispatch, axis_name=axis_name)
        ship_back = functools.partial(mux.combine, axis_name=axis_name)
    elif pod_axis is not None:
        ship_out, ship_back = (
            functools.partial(fn, mesh=mesh, inner_axis=axis_name, outer_axis=pod_axis, impl=impl)
            for fn in (exchange.dispatch_two_level, exchange.combine_two_level)
        )
    else:
        ship_out = ship_back = functools.partial(
            exchange.all_to_all, mesh=mesh, axis=axis_name, impl=impl
        )

    # Unit n owns experts [n * E_loc, (n + 1) * E_loc): expert order is
    # already owner-major, so the local units' experts are one slice, which
    # a sharded state already holds alone.
    held = params["w_gate"].shape[0]
    if held == E:
        mine = slice(mesh.unit_offset * E_loc, (mesh.unit_offset + U) * E_loc)
    elif held == U * E_loc:
        mine = slice(None)
    else:
        raise ValueError(f"expert leaves of {held} rows: neither all {E} experts nor this "
                         f"process's {U * E_loc}")
    wg, wu, wd = (params[name][mine].to(dt) for name in ("w_gate", "w_up", "w_down"))

    chunks = mux.pipeline_chunks if mux is not None else cfg.moe_async_chunks
    if chunks < 1 or C % chunks:
        chunks = 1
    cc = C // chunks
    send = buffers.reshape(U, N, E_loc, C, d)  # [sender, owner, ...]

    rets = []
    for c in range(chunks):
        got = ship_out(send[:, :, :, c * cc:(c + 1) * cc].reshape(U, N, E_loc * cc, d))
        # got[n, j] = unit j's slice for n's local experts.
        recv = got.reshape(U, N, E_loc, cc, d).transpose(1, 2).reshape(U * E_loc, N * cc, d)
        # -- steps 5-6: the batched expert FFN, each expert on its owner.
        out = _expert_ffn(wg, wu, wd, recv)  # [U * E_loc, N * cc, d]
        # -- step 7: the return trip through the same schedule.
        back = out.reshape(U, E_loc, N, cc, d).transpose(1, 2).reshape(U, N, E_loc * cc, d)
        rets.append(ship_back(back).reshape(U, N, E_loc, cc, d))

    ret = rets[0] if chunks == 1 else torch.cat(rets, dim=3)
    ret = torch.cat([ret.reshape(U, E * C, d), x.new_zeros((U, 1, d))], dim=1)  # drop bin reads 0

    # combine: y[t] = sum_k w[t, k] * ret[slot(t, k)]
    gathered = torch.gather(ret, 1, slot.long()[..., None].expand(U, T_loc * k, d))
    y = torch.einsum("ntkd,ntk->ntd", gathered.reshape(U, T_loc, k, d), w.to(dt))
    return y, dropped


def moe_ep(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Expert-parallel MoE over the active mesh context's units.

    On a pod mesh a unit is one member of the joint ``(pod, exchange)``
    axis and dispatch/combine take the two-level fabric; a single-level
    multiplexer on a pod mesh is an error.  Shapes the units do not divide
    (``T % N`` or ``E % N``) fall back to :func:`moe_dense`, as in the
    reference, with ``T`` the global token count (under ``"local"`` tokens,
    this process's rows times the process count, so every process decides
    alike), on this process's tokens under ``"local"`` (the dense path is
    token by token).  Across processes under ``"local"`` with sharded expert
    leaves (the train state) they raise instead: this process holds only its
    own experts, so it cannot take the dense path.  Under ``"global"`` with
    the process's experts (the tensor table) the fallback is the dense
    path's tensor-parallel form, every process on its own experts.
    """
    ctx = current_mesh_context()
    if ctx is None:
        raise ValueError("moe_impl='ep_shardmap' needs an active mesh context")
    axis = ctx.exchange_axis
    pod = ctx.pod_axis
    pods = ctx.mesh.size(pod) if pod is not None else 1
    if pods <= 1:
        pod = None
    N = pods * ctx.exchange_size

    mux = current_multiplexer()
    if mux is not None and pod is not None and mux.plan.pod_axis is None:
        raise ValueError(
            f"EP dispatch on a pod mesh ({pods} pods) with a single-level "
            "multiplexer: its flat all-to-all would cross the slow network; "
            "build the multiplexer for the same two-level mesh"
        )

    mesh = ctx.mesh
    T, d = x.shape
    local = ctx.moe_tokens == "local" and mesh.num_processes > 1
    T_all = T * mesh.num_processes if local else T
    if N == 1 or T_all == 0 or T_all % N != 0 or cfg.num_experts % N != 0:
        if local and params["w_gate"].shape[0] != cfg.num_experts:
            raise ValueError(
                f"expert-parallel MoE across {mesh.num_processes} processes: {T_all} tokens "
                f"and {cfg.num_experts} experts must both split over the {N} units"
            )
        return moe_dense(params, cfg, x)
    _record_path("ep")
    U = mesh.local_units
    mine = (x.reshape(U, T // U, d) if local
            else x.reshape(N, T // N, d)[mesh.unit_offset:mesh.unit_offset + U])
    y, _ = _ep_moe_local(params, cfg, mine, mesh, axis, pod_axis=pod)
    if local:
        return y.reshape(T, d)
    return exchange.gather_units(y, mesh).reshape(T, d)


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The FFN slot of a MoE transformer layer: routed experts, plus the
    shared experts' MLP on every token after either path (its width
    ``moe_d_ff x num_shared_experts`` splits as ``d_ff`` does under the
    tensor table)."""
    B, S, d = x.shape
    tokens = x.reshape(B * S, d)
    if _ROUTES is not None:
        _record_route(params, cfg, tokens)
    if cfg.moe_impl == "ep_shardmap":
        y = moe_ep(params, cfg, tokens)
    else:  # "dense" and "gspmd"
        y = moe_dense(params, cfg, tokens)
    y = y.reshape(B, S, d)
    if cfg.num_shared_experts:
        f = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
        y = y + L.mlp_block(params["shared"], cfg, x, d_ff=f)
    return y


__all__ = [
    "init_moe_layer",
    "specs_moe_layer",
    "route",
    "moe_dense",
    "moe_ep",
    "moe_ffn",
    "record_drops",
    "record_paths",
    "record_routes",
]
