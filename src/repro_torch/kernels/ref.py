"""Plain PyTorch versions of the kernels (counterpart of ``repro.kernels.ref``).

The hash, pack and dispatch functions work on a leading shard dim ``S``:
shard ``s`` of each output equals the reference's per-device output for
shard ``s`` of the input.  The kernel wrappers in :mod:`.hash_partition`,
:mod:`.moe_dispatch`, :mod:`.flash_attention` and :mod:`.ssd_scan` run these
for tensors that lie on the CPU; ``chip_smoke.py`` holds the CUDA kernels to
them on the card.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, KH, Sk, D]
    v: torch.Tensor,  # [B, KH, Sk, D]
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """GQA attention in the kernel layout: query head ``h`` reads KV head
    ``h // (H / KH)``; the logits in the input dtype, then f32 and scaled; a
    causal mask from the top-left corner (``qpos >= kpos``, both from 0,
    also when ``Sq != Sk``); an f32 softmax, cast back for the product."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KH, G, Sq, D)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k).float() * scale
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)
        logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v)
    return out.reshape(B, H, Sq, v.shape[-1])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits, to nearest, ties away
    from zero) with the 13 low bits cleared, by the bit arithmetic the f32
    attention kernel runs: ``(bits + 0x1000) & ~0x1fff``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x = hi + lo`` to within ``2^-22 |x|``, both exact tf32 values."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as three products of tf32 halves, each exact in f32 and
    summed in f32: ``lo.hi + hi.lo + hi.hi`` (the dropped ``lo.lo`` is near
    ``2^-22`` relative)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def flash_attention_3xtf32_ref(
    q: torch.Tensor,  # [B, H, Sq, D] f32
    k: torch.Tensor,  # [B, KH, Sk, D] f32
    v: torch.Tensor,  # [B, KH, Sk, D] f32
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """The f32 attention kernel's arithmetic on the CPU (used by the tests
    only): ``q k^T`` in 3xTF32, the scaled logits' softmax numerator
    ``exp(s - max)`` in f32, its product with ``v`` in 3xTF32, then the
    division by the row sum.  It must agree with :func:`flash_attention_ref`
    to f32 accuracy, where one tf32 pass would not."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, KH, G * Sq, D)
    logits = _matmul_3xtf32(qg, k.float().transpose(-1, -2)).reshape(B, KH, G, Sq, Sk) * scale
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = _matmul_3xtf32(p.reshape(B, KH, G * Sq, Sk), v.float()).reshape(B, KH, G, Sq, D)
    return (out / p.sum(-1, keepdim=True)).reshape(B, H, Sq, D)


def ssd_scan_ref(
    x: torch.Tensor,   # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] (already softplus'd)
    A: torch.Tensor,   # [H] negative
    Bm: torch.Tensor,  # [B, L, G, N]
    Cm: torch.Tensor,  # [B, L, G, N]
    chunk: int,
    initial_state: torch.Tensor | None = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 SSD chunk scan: ``(y [B, L, H, P] in x's dtype, final
    state [B, H, P, N] f32)``, the body of the reference's ``ssd_chunked``.

    Chunk by chunk, all in f32: ``a_cs`` is the inclusive cumsum of ``dt *
    A`` in the chunk; the intra-chunk quadratic weighs ``C_i . B_j`` by
    ``exp(a_cs_i - a_cs_j) * dt_j`` for ``j <= i``; the entering state is read
    with ``exp(a_cs_i)``; then the state decays by ``exp(a_cs_last)`` and takes
    ``sum_j exp(a_cs_last - a_cs_j) dt_j x_j B_j^T``.  Head ``h`` reads group
    ``h // (H / G)`` of B and C.
    """
    B_, Lq, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    if Lq % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide the sequence length {Lq}")
    nc = Lq // chunk
    xc = x.reshape(B_, nc, chunk, G, R, P).float()
    dtc = dt.reshape(B_, nc, chunk, G, R).float()
    Bc = Bm.reshape(B_, nc, chunk, G, N).float()
    Cc = Cm.reshape(B_, nc, chunk, G, N).float()
    if initial_state is None:
        s = torch.zeros((B_, G, R, P, N), dtype=torch.float32, device=x.device)
    else:
        s = initial_state.reshape(B_, G, R, P, N).float()
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None, None]  # [1, Q, Q, 1, 1]
    A_gr = A.float().reshape(G, R)
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        a_cs = (dtq * A_gr).cumsum(1)  # [B, Q, G, R]
        scores = torch.einsum("bign,bjgn->bijg", Cq, Bq)
        seg = a_cs[:, :, None] - a_cs[:, None]  # [B, Q, Q, G, R]
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        m = scores[..., None] * decay * dtq[:, None]
        y = torch.einsum("bijgr,bjgrp->bigrp", m, xq)
        y = y + torch.einsum("bign,bgrpn->bigrp", Cq, s) * torch.exp(a_cs)[..., None]
        a_last = a_cs[:, -1]  # [B, G, R]
        w = torch.exp(a_last[:, None] - a_cs) * dtq  # [B, Q, G, R]
        upd = torch.einsum("bjgn,bjgrp->bgrpn", Bq, xq * w[..., None])
        s = s * torch.exp(a_last)[..., None, None] + upd
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B_, Lq, H, P)
    return y.to(x.dtype), s.reshape(B_, H, P, N)


def ssd_scan_staged_ref(
    x: torch.Tensor,   # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H]
    A: torch.Tensor,   # [H]
    Bm: torch.Tensor,  # [B, L, G, N]
    Cm: torch.Tensor,  # [B, L, G, N]
    chunk: int,
    initial_state: torch.Tensor | None = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_ref` cut into the three stages the CUDA kernels run
    (``csrc/ssd_scan.cu``), all chunks at once where the kernels run them in
    parallel; used by the tests only.

    1. Per chunk: ``a_cs``, the chunk's own state ``sum_j exp(a_last -
       a_cs_j) dt_j x_j B_j^T`` and the scores ``C_i . B_j`` once per group;
    2. in chunk order, the state entering each chunk: ``S = exp(a_last) S +
       local``, from the initial state;
    3. per chunk: the weighted scores times x, plus ``exp(a_cs_i) (C_i . S)``
       with the entering state.
    """
    B_, Lq, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    if Lq % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide the sequence length {Lq}")
    nc = Lq // chunk
    xc = x.reshape(B_, nc, chunk, G, R, P).float()
    dtc = dt.reshape(B_, nc, chunk, G, R).float()
    Bc = Bm.reshape(B_, nc, chunk, G, N).float()
    Cc = Cm.reshape(B_, nc, chunk, G, N).float()
    # 1. chunk states and scores
    a_cs = (dtc * A.float().reshape(G, R)).cumsum(2)  # [B, nc, Q, G, R]
    a_last = a_cs[:, :, -1]  # [B, nc, G, R]
    w = torch.exp(a_last[:, :, None] - a_cs) * dtc
    local = torch.einsum("bcjgn,bcjgrp->bcgrpn", Bc, xc * w[..., None])
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)
    # 2. state passing
    if initial_state is None:
        s = torch.zeros((B_, G, R, P, N), dtype=torch.float32, device=x.device)
    else:
        s = initial_state.reshape(B_, G, R, P, N).float()
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * torch.exp(a_last[:, c])[..., None, None] + local[:, c]
    S = torch.stack(entering, 1)  # [B, nc, G, R, P, N]
    # 3. chunk outputs
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[:, :, None, None]  # [Q, Q, 1, 1]
    seg = a_cs[:, :, :, None] - a_cs[:, :, None]  # [B, nc, Q, Q, G, R]
    decay = torch.exp(torch.where(causal, seg, float("-inf")))
    m = scores[..., None] * decay * dtc[:, :, None]
    y = torch.einsum("bcijgr,bcjgrp->bcigrp", m, xc)
    y = y + torch.einsum("bcign,bcgrpn->bcigrp", Cc, S) * torch.exp(a_cs)[..., None]
    return y.reshape(B_, Lq, H, P).to(x.dtype), s.reshape(B_, H, P, N)


_M32 = 0xFFFFFFFF


def fibonacci_hash(keys: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 multiply-xor avalanche, as int64 values in
    ``[0, 2**32)``.

    PyTorch on the CPU has no ``>>`` for ``uint32``, so the arithmetic runs
    in int64 and masks to 32 bits after every multiply.  The second constant
    is above ``2**31``, so its product can wrap int64; only the low 32 bits
    are kept, and those are exact under two's-complement wrap.
    """
    x = keys.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x


def partition_pack_ref(
    dest: torch.Tensor, num_bins: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-block histograms ``[S, T/block, num_bins]``, block-local ranks
    ``[S, T]``) for int32 destination ids ``[S, T]``.

    Out-of-range ids (the padding value) match no bin: rank 0, uncounted.
    The one-hot is laid out ``[S, T/block, num_bins, block]`` so the rank
    scan runs along the last axis: a scan over an outer axis is hundreds of
    times slower on the card (one lane a bin, walked nearly serially).
    """
    S, T = dest.shape
    assert T % block == 0, (T, block)
    d = dest.reshape(S, T // block, 1, block)
    bins = torch.arange(num_bins, device=dest.device, dtype=dest.dtype)
    onehot = (d == bins[:, None]).to(torch.int32)
    csum = onehot.cumsum(-1, dtype=torch.int32)
    local = ((csum - onehot) * onehot).sum(2, dtype=torch.int32).reshape(S, T)
    hist = onehot.sum(-1, dtype=torch.int32)
    return hist, local


def hash_partition_pack_ref(
    keys: torch.Tensor, valid: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dest ``[S, T]``, per-block histograms ``[S, T/block, P+1]``,
    block-local ranks ``[S, T]``); invalid rows go to the overflow bin ``P``."""
    pid = (fibonacci_hash(keys) % num_partitions).to(torch.int32)
    dest = torch.where(valid != 0, pid, num_partitions).to(torch.int32)
    hist, local = partition_pack_ref(dest, num_partitions + 1, block)
    return dest, hist, local


def hash_partition_ref(
    keys: torch.Tensor, num_partitions: int, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(partition ids ``[S, T]``, per-block histograms ``[S, T/block, P]``)."""
    pid = (fibonacci_hash(keys) % num_partitions).to(torch.int32)
    hist, _ = partition_pack_ref(pid, num_partitions, block)
    return pid, hist


def moe_dispatch_ref(
    dest: torch.Tensor, num_dest: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot ``[S, T]``, counts ``[S, num_dest]``) for expert ids ``[S, T]``.

    ``slot = dest * capacity + rank`` (``rank`` = earlier rows of the shard
    with the same expert) if the row fits its expert's buffer, else the drop
    bin ``num_dest * capacity``; ids outside ``[0, num_dest)`` always land
    in the drop bin.  Counts are clamped to ``capacity``.  The reference's
    one-hot + cumsum: it materialises ``[S, T, num_dest]``.
    """
    experts = torch.arange(num_dest, device=dest.device, dtype=dest.dtype)
    onehot = (dest[..., None] == experts).to(torch.int32)
    rank = ((onehot.cumsum(1, dtype=torch.int32) - onehot) * onehot).sum(-1, dtype=torch.int32)
    kept = (dest >= 0) & (dest < num_dest) & (rank < capacity)
    slot = torch.where(kept, dest * capacity + rank, num_dest * capacity).to(torch.int32)
    counts = onehot.sum(1, dtype=torch.int32).clamp(max=capacity)
    return slot, counts


__all__ = [
    "flash_attention_ref",
    "tf32_round",
    "split_tf32",
    "flash_attention_3xtf32_ref",
    "ssd_scan_ref",
    "ssd_scan_staged_ref",
    "fibonacci_hash",
    "partition_pack_ref",
    "hash_partition_pack_ref",
    "hash_partition_ref",
    "moe_dispatch_ref",
]
