"""Relational operators on sharded tables (port of ``repro.relational.operators``).

Every operator takes tensors with a leading shard dim ``[S, T]`` and works
on all shards at once; shard ``s`` of each result equals what the
reference's per-device operator returns on shard ``s``.  The operators are
mask-carrying and shape-static: sort-based PK-FK join (stable sort +
batched ``searchsorted``), dense and sorted group-by (``scatter_add_`` /
``scatter_reduce_`` over flattened ``(shard, group)`` ids) and top-k by a
stable descending sort (``lax.top_k`` breaks ties toward the lower index,
``torch.topk`` leaves them unspecified).
"""

from __future__ import annotations

import torch

from .table import Table

_KEY_SENTINEL = torch.iinfo(torch.int32).max
_INT32_MIN = torch.iinfo(torch.int32).min


def sum_where(col: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-shard masked sum in f32 ``[S]`` (money sums accumulate in f32,
    as in the reference)."""
    return torch.where(mask, col.to(torch.float32), 0.0).sum(-1)


def count_where(mask: torch.Tensor) -> torch.Tensor:
    """Per-shard count ``[S]`` (int32)."""
    return mask.sum(-1, dtype=torch.int32)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-shard segment sum: ``vals``/``seg`` ``[S, T]`` -> ``[S, num_segments]``."""
    S = vals.shape[0]
    flat = seg.long() + torch.arange(S, device=seg.device)[:, None] * num_segments
    out = vals.new_zeros(S * num_segments)
    out.scatter_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out.reshape(S, num_segments)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-shard segment max of int32 values; empty segments hold the int32
    minimum, as ``jax.ops.segment_max`` gives them."""
    S = vals.shape[0]
    flat = seg.long() + torch.arange(S, device=seg.device)[:, None] * num_segments
    out = vals.new_full((S * num_segments,), _INT32_MIN)
    out.scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1), "amax", include_self=False)
    return out.reshape(S, num_segments)


def groupby_dense(
    group_ids: torch.Tensor,
    num_groups: int,
    aggregates: dict[str, tuple[torch.Tensor, str]],
    valid: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Aggregate into a small dense group table per shard (``[S, G]``).

    ``aggregates``: name -> (column, 'sum'|'count'); sums in f32, counts in
    int32.  The cross-shard combine (a sum over the shard dim) is the
    caller's.

    On the card ``scatter_add_`` adds with atomics in no fixed order, and
    with millions of rows a group an f32 sum would differ from run to run;
    there the sums accumulate in f64 and round to f32 once, so the result
    does not depend on the order.  On the CPU the scatter is sequential and
    sums in f32, as the reference does.
    """
    gid = torch.where(valid, group_ids.to(torch.int64), num_groups)  # invalid -> overflow
    acc = torch.float64 if valid.is_cuda else torch.float32
    out = {}
    for name, (col, kind) in aggregates.items():
        if kind == "sum":
            vals = torch.where(valid, col.to(acc), 0.0)
        else:  # count
            vals = valid.to(torch.int32)
        sums = _segment_sum(vals, gid, num_groups + 1)[:, :num_groups]
        out[name] = sums.to(torch.float32) if kind == "sum" else sums
    return out


def groupby_sorted(
    keys: torch.Tensor,
    valid: torch.Tensor,
    aggregates: dict[str, tuple[torch.Tensor, str]],
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Sort-based group-by for large key domains, per shard.

    Returns ``(group_keys, group_valid, aggs)`` all ``[S, T]`` (each row could
    be its own group — the static worst case).
    """
    S, n = keys.shape
    skeys = torch.where(valid, keys.to(torch.int32), _KEY_SENTINEL)
    sk, order = torch.sort(skeys, dim=1, stable=True)
    is_start = torch.ones_like(sk, dtype=torch.bool)
    is_start[:, 1:] = sk[:, 1:] != sk[:, :-1]
    gid = is_start.cumsum(1) - 1  # dense group id per sorted row
    sval = valid.gather(1, order)
    out = {}
    for name, (col, kind) in aggregates.items():
        if kind == "sum":
            vals = torch.where(sval, col.to(torch.float32).gather(1, order), 0.0)
        else:
            vals = sval.to(torch.int32)
        out[name] = _segment_sum(vals, gid, n)
    gkeys = _segment_max(torch.where(sval, sk, -1), gid, n)
    gvalid = _segment_max(sval.to(torch.int32), gid, n) > 0
    return gkeys, gvalid, out


def join_pk(
    build_keys: torch.Tensor,
    build_valid: torch.Tensor,
    probe_keys: torch.Tensor,
    probe_valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted PK-FK join per shard: (build_row_index, match_mask) per probe
    row.  ``build_row_index`` addresses the ORIGINAL build order."""
    skeys = torch.where(build_valid, build_keys.to(torch.int32), _KEY_SENTINEL)
    sk, order = torch.sort(skeys, dim=1, stable=True)
    pk = probe_keys.to(torch.int32).contiguous()
    pos = torch.searchsorted(sk, pk).clamp_(0, sk.shape[1] - 1)
    match = (sk.gather(1, pos) == pk) & probe_valid
    return order.gather(1, pos), match


def gather_payload(
    build: Table, build_idx: torch.Tensor, match: torch.Tensor, names: list[str]
) -> dict[str, torch.Tensor]:
    """Gather build-side columns for matched probe rows (zeros elsewhere)."""
    out = {}
    for n in names:
        got = build.columns[n].gather(1, build_idx)
        out[n] = torch.where(match, got, torch.zeros_like(got))
    return out


def topk_order(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last dim, ties toward the lower index
    (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_rows(
    sort_key: torch.Tensor, valid: torch.Tensor, k: int,
    payload: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Per-shard top-k rows by key (descending); invalid rows sort last."""
    neg = torch.where(valid, sort_key.to(torch.float32), float("-inf"))
    vals, idx = topk_order(neg, k)
    out = {name: col.gather(1, idx) for name, col in payload.items()}
    return vals, out


__all__ = [
    "sum_where",
    "count_where",
    "groupby_dense",
    "groupby_sorted",
    "join_pk",
    "gather_payload",
    "topk_order",
    "topk_rows",
]
