#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--seed 0] [--profile]
                          [--queries q1,q6,q17,q3,q3_pods,q18_pods,q3_rr]

Phases, in order; any failure raises and the process exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions; a machine without CUDA exits 2 before printing any result;
2. build — ``nvcc`` builds ``csrc/hash_partition.cu``,
   ``csrc/moe_dispatch.cu``, ``csrc/flash_attention.cu`` and
   ``csrc/ssd_scan.cu`` for ``sm_90a``, all at once (seconds and ``-Xptxas
   -v`` printed);
3. kernels — every ported kernel at its main path's shapes, held against
   its plain PyTorch version on the card and timed with CUDA events (mean
   over 50 launches after warm-up, 20 for attention) beside the plain
   version and the bound: ``hash_partition_pack`` (P=8, 10 % invalid rows),
   ``partition_pack`` (3 bins, with padding ids) and ``hash_partition``
   (P=8) at S=8 shards x one shard's lineitem rows; ``moe_dispatch`` at
   OLMoE's decode shape (S=8, T=64, E=64, C=4) and prefill shape (S=8,
   T=16,384, C=320), on the router's int64 expert ids, all bit for bit
   and bound by bytes over 3.35 TB/s, the three packs and ``moe_dispatch``
   also with one call's wall (host clock over 1,000 calls) beside its
   device time (profiler) and the bound's share of that;
   ``flash_attention`` at train100m's shape (B=8, H=12, KH=4, S=2,048,
   D=64, causal) in f32 and bf16 and one non-causal ``Sq != Sk`` case,
   within the reference's tolerances (2e-5 f32, 2e-2 bf16), beside
   ``scaled_dot_product_attention`` (timed only) and bound by the larger of
   bytes over 3.35 TB/s and flops over 989 TFLOP/s (bf16) or three times
   the flops over 494.7 TFLOP/s (f32 in 3xTF32; one f32 FMA pass over 67
   TFLOP/s is printed beside it); ``ssd_scan`` at Mamba2-1.3B's
   prefill shape (B=8, L=2,048, H=64, P=64, N=128, chunk 256) in bf16 (y
   within 2e-2, one bf16 rounding; the state within 2e-4) and f32 (2e-4),
   and at batch 1 over a 32,768-token prompt, at Zamba2-7B's (B=4, H=112,
   N=64), chained from a nonzero initial state and with two groups, against
   its plain version, bound by the larger of bytes and f32 flops, with one
   call profiled for the device time of each of its three kernels;
4. queries — TPC-H at ``--sf`` through the port's planner and executor:
   Q1, Q6, Q17, Q3 on 8 shards, Q3 and Q18 on 2 pods x 4, and Q3 again
   with an explicit ``impl="round_robin", num_chunks=2``.  Every answer is
   checked against the port's numpy oracle at the reference tests'
   tolerances, every run must drop no row, and the launch counters must
   show each shuffle edge's pack went through the kernels.  The Q3 rerun
   must give the same order keys and revenues within rtol 1e-6
   (``scatter_add_`` on the card sums floats in no fixed order);
5. serving — OLMoE-1B-7B at full width (random weights from ``--seed``, f32
   master params, bf16 compute), expert-parallel over 8 simulated units
   flat and over 2 pods x 4.  A uniform workload (64 requests x 256 prompt
   tokens x 16 new, batch 64) through the static engine (no multiplexer:
   plain pack, round-robin) and the continuous engine (tuned multiplexer:
   the ``moe_dispatch`` kernel pack) must give identical greedy tokens; one
   prefill's logits must be bit-identical between the two packs; the
   continuous runs must launch ``moe_dispatch`` once per MoE layer of every
   prefill and decode step, the static runs never.  A mixed workload
   (``make_mixed_workload``: prompts 128/256/512, 1-32 new tokens, 4
   arrivals a step; 128 requests flat, 64 on 2 x 4) must complete with ``alloc.check()`` holding and in
   fewer slot-steps than static batching.  Prefill and decode tokens/s,
   TTFT p50/p99 and peak memory are printed; one prefill and one decode
   step are profiled;
6. training — train100m at full width and depth (random weights from
   ``--seed``, f32, ``remat="block"``) with ``attn_impl="flash"``, batch 8 x
   2,048 tokens, 20 AdamW steps (lr 3e-4, 5 warm-up steps), through the
   calls ``launch/train.py`` makes.  Every loss must be finite and the mean
   of the last 5 below the first; ``flash_attention`` must launch 2 x 12
   times a step (each layer's forward and its remat recompute; the
   backward recomputes through the chunked plain attention).  One step
   from the same state and batch under ``attn_impl="chunked"`` must give
   the same loss (rtol 1e-5) and grad norm (rtol 1e-4).  The CLI
   (``launch.train.main``, seq 512) runs 4 steps with a checkpoint every 2,
   then resumes to step 6 in the same directory; its last loss must equal
   an uninterrupted 6-step run's within rtol 1e-5 (the embedding
   gradient's ``index_put`` sums in no fixed order on the card).  Then the
   same model with bf16 compute over f32 master params (the reference's
   default dtypes), 5 steps of the same schedule: the loss must fall, 24
   ``flash_attention`` launches a step (the bf16 kernel: 120, counted apart
   from the f32 run's 480), and one step must equal the chunked path's
   within rtol 2**-7 (loss) and 2**-5 (grad norm), 4 and 16 units of bf16
   roundoff.  ms a step, tokens/s and peak memory are printed; one step of
   each run is profiled;
7. SSM serving — Mamba2-1.3B (48 layers, d_model 2,048) and Zamba2-7B (81
   layers, d_model 3,584) at full width and depth (random weights from
   ``--seed``, f32 master params, bf16 compute) through the static engine:
   Mamba2 16 requests x 2,048 prompt tokens x 32 new at batch 8, then one
   request of 32,768 tokens x 8 new; Zamba2 8 x 2,048 x 16 new at batch 4.
   ``ssd_scan`` must launch once per Mamba2 layer of every prefill (48, 81).
   In f32 compute, a prefill must agree with a shorter prefill followed by
   decode steps (the plain token-by-token recurrence ``ssd_step``): Mamba2
   2 x 2,048 against 1,792 + 256 steps, Zamba2 1 x 512 against 256 + 256;
   the last logits and every layer's SSM state within 1e-3 of the largest
   magnitude.  Prefill and decode tokens/s, ms a decode step and peak
   memory are printed; one prefill and one decode step of each model are
   profiled;
8. a ``{"kernels": [...]}`` JSON line, then the card's name and power limit;
9. the last line: ``{"ok": true, "device": {...}}``.

Wall times are host clock around work that ends in
``torch.cuda.synchronize()``, taken on each query's second run and around
every prefill and decode step.  ``--profile`` adds a third run of each query
under ``torch.profiler`` and prints device time by kernel and the device's
busy share of the wall time.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# CUDA cores f32; dense tensor cores, tf32 and bf16
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
N_SHARDS = 8
ALL_RUNS = ("q1", "q6", "q17", "q3", "q3_pods", "q18_pods", "q3_rr")
# serving: batch, prompt tokens, new tokens, cache positions (the uniform
# workload); mixed requests on 8 units and on 2 x 4 (fewer, for time)
SERVE_SHAPE = (64, 256, 16, 545)
MIXED_REQUESTS = {1: 128, 2: 64}
# training: batch, seq, steps; the CLI resume check's seq
TRAIN_SHAPE = (8, 2048, 20)
CLI_SEQ = 512
# the bf16-compute run: steps, and flash against chunked within (loss, grad
# norm) rtols of 4 and 16 units of bf16 roundoff (u = 2**-9): the two paths
# round the probabilities at different points, about u in each layer's output
TRAIN_BF16_STEPS = 5
TRAIN_BF16_RTOL = (2.0**-7, 2.0**-5)
# SSM serving: requests, prompt tokens, new tokens, batch; each f32 check's
# batch, full length and split point
SSM_SERVE = {"mamba2-1.3b": (16, 2048, 32, 8), "zamba2-7b": (8, 2048, 16, 4)}
SSM_LONG = (32768, 8)  # Mamba2: one request of the reference's prefill_32k length
SSM_CHECK = {"mamba2-1.3b": [(2, 2048, 1792), (1, SSM_LONG[0], SSM_LONG[0] - 256)],
             "zamba2-7b": [(1, 512, 256)]}
SSM_CHECK_TOL = 1e-3
# Ported kernels no main path calls (the reference calls hash_partition
# only from its tests): checked and timed, never required to launch.
OFF_PATH = ("hash_partition",)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as sk

    hp.reset_launch_counts()
    md.reset_launch_counts()
    fa.reset_launch_counts()
    sk.reset_launch_counts()


def _counts() -> dict:
    """Every kernel's launches since the last :func:`_reset_counts`."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as sk

    return {**hp.LAUNCHES, **md.LAUNCHES, **fa.LAUNCHES, **sk.LAUNCHES}


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def _kernel_row(name, replaces, source, label, nbytes, kern, plain, note=""):
    """Run a kernel and its plain version once, require bit-equality, time
    both with CUDA events and compute the bytes bound."""
    import torch

    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} ({label}): kernel disagrees with its plain version "
                             f"(max |err| {err})")
    ms = _time_ms(kern)
    plain_ms = _time_ms(plain)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(
        f"[kernels] {name}: {label} bit-exact{note}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({nbytes} B), "
        f"{100 * bound_ms / ms:.2f}% of bound"
    )
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, match=True,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None,
    )


def _attention_flops(B: int, H: int, Sq: int, Sk: int, D: int, causal: bool) -> int:
    """``4 * B * H * D`` (two products of ``D`` multiply-adds) for every
    (query, key) pair the kernel computes; causal from the top-left corner."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    return 4 * B * H * D * pairs


def _flash_row(B, H, KH, Sq, Sk, D, causal, dtype, seed) -> dict:
    """The attention kernel against its plain version within the reference's
    tolerance, timed beside the plain version and SDPA (never used by the
    port); bound by the larger of bytes and flops."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, KH, Sk, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, KH, Sk, D), generator=gen, device="cuda").to(dt)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash_attention {dtype} {(B, H, KH, Sq, Sk, D, causal)}: "
                             f"disagrees with its plain version (max |err| {err})")
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal), iters=20)
    plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), iters=20)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), iters=20)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = _attention_flops(B, H, Sq, Sk, D, causal)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # f32 runs three tf32 products (3xTF32) on the tensor cores; one f32 FMA
    # pass on the CUDA cores is the other bound printed
    ops_ms = (3 * flops / PEAK_FLOPS["tf32"] if dtype == "float32"
              else flops / PEAK_FLOPS[dtype]) * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    label = f"B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} D={D} {'causal' if causal else 'full'} {dtype}"
    extra = {}
    fma = ""
    if dtype == "float32":
        extra["bound_f32_fma_ms"] = max(bytes_ms, flops / PEAK_FLOPS["float32"] * 1e3)
        fma = (f"; f32 FMA bound {extra['bound_f32_fma_ms']:.4f} ms, "
               f"{100 * extra['bound_f32_fma_ms'] / ms:.2f}% of it")
    print(
        f"[kernels] flash_attention: {label} within {tol} (max |err| {err:.3g}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"by {bound_by}{' (3xTF32)' if dtype == 'float32' else ''} ({flops} flop, {nbytes} B), "
        f"{100 * bound_ms / ms:.2f}% of bound{fma}"
    )
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:100", match=True, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, **extra,
    )


def _ssd_flops(B: int, L: int, H: int, P: int, N: int, Q: int, G: int) -> int:
    """The least work of the chunk scan: the ``C_i . B_j`` scores once per
    (b, group, chunk) for the ``Q (Q + 1) / 2`` pairs ``j <= i``; per (b,
    head, chunk) the intra term over the same pairs, the state read and the
    state update (``Q N P`` multiply-adds each)."""
    nc, pairs = L // Q, Q * (Q + 1) // 2
    return 2 * pairs * N * B * G * nc + (2 * pairs * P + 4 * Q * N * P) * B * H * nc


def _ssd_row(B, L, H, P, N, Q, G, dtype, seed, initial_state=False) -> dict:
    """The chunk-scan kernel against its plain version (y within 2e-4 in
    f32 and 2e-2 in bf16, the f32 state within 2e-4), timed beside the plain
    version; bound by the larger of bytes and f32 flops.  The inputs follow
    the model's distributions: dt log-uniform in [1e-3, 1e-1], A uniform in
    [-16, -1]."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    x = torch.randn((B, L, H, P), generator=gen, device="cuda").to(dt_)
    dt = torch.exp(uniform((B, L, H), math.log(1e-3), math.log(1e-1)))
    A = -uniform((H,), 1.0, 16.0)
    Bm = torch.randn((B, L, G, N), generator=gen, device="cuda").to(dt_)
    Cm = torch.randn((B, L, G, N), generator=gen, device="cuda").to(dt_)
    s0 = torch.randn((B, H, P, N), generator=gen, device="cuda") if initial_state else None
    y, fin = sk.ssd_scan(x, dt, A, Bm, Cm, Q, s0)
    want_y, want_fin = ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q, s0)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 2e-2
    err = float((y.float() - want_y.float()).abs().max())
    err_s = float((fin - want_fin).abs().max())
    if not (torch.allclose(y.float(), want_y.float(), rtol=tol, atol=tol)
            and torch.allclose(fin, want_fin, rtol=2e-4, atol=2e-4)):
        raise AssertionError(f"ssd_scan {dtype} {(B, L, H, P, N, Q, G)}: disagrees with its "
                             f"plain version (max |err| y {err}, state {err_s})")
    del want_y, want_fin
    ms = _time_ms(lambda: sk.ssd_scan(x, dt, A, Bm, Cm, Q, s0), iters=10, warmup=2)
    plain_ms = _time_ms(lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q, s0), iters=3, warmup=1)
    nbytes = (2 * x.numel() + 2 * Bm.numel()) * x.element_size() + 4 * (
        dt.numel() + A.numel() + fin.numel() + (s0.numel() if initial_state else 0))
    flops = _ssd_flops(B, L, H, P, N, Q, G)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["float32"] * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    label = (f"B={B} L={L} H={H} P={P} N={N} Q={Q} G={G} {dtype}"
             + (" from an initial state" if initial_state else ""))
    print(
        f"[kernels] ssd_scan: {label}: y within {tol} (max |err| {err:.3g}), state within "
        f"2e-4 ({err_s:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({flops} flop, {nbytes} B), "
        f"{100 * bound_ms / ms:.2f}% of bound"
    )
    _profile_call(f"ssd_scan {label}", lambda: sk.ssd_scan(x, dt, A, Bm, Cm, Q, s0),
                  kernel=("ssd_", "ssd_scan"), top=3)  # its three kernels apart
    return dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:135", match=True, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )


def _topk_expert_ids(S: int, tokens: int, E: int, k: int, gen):
    """Expert ids ``[S, tokens * k]`` as the router gives them: each token's
    k distinct experts in descending-score order, tokens in arrival order,
    int64 (``torch.topk``'s index dtype, which the kernel reads)."""
    import torch

    scores = torch.rand((S, tokens, E), generator=gen, device="cuda")
    return torch.topk(scores, k, dim=-1).indices.reshape(S, tokens * k).contiguous()


def _wall_and_device_ms(fn, kernel: str, calls: int = 1000) -> tuple[float, float]:
    """One call's wall (host clock over ``calls`` back-to-back calls, then a
    synchronise) and its device time (``torch.profiler`` over 50 calls, the
    device kernels whose name holds ``kernel``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA" and kernel in e.key)
    return wall_ms, us / 50 / 1e3


def phase_kernels(sf: float, seed: int) -> list[dict]:
    """Every ported kernel at the shapes its main path gives it, against its
    plain version.  Returns the rows of the JSON line: one per kernel, the
    MoE dispatch at its decode and prefill shapes, attention in f32 and
    bf16."""
    import numpy as np
    import torch

    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    from repro_torch.relational.datagen import table_capacity

    S = N_SHARDS
    T = math.ceil(table_capacity("lineitem", sf) / S / 256) * 256
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    keys = torch.from_numpy(rng.integers(0, 2**31 - 1, (S, T), dtype=np.int32)).to(dev)
    valid = torch.from_numpy((rng.random((S, T)) >= 0.1).astype(np.int32)).to(dev)
    # the pod hop: bins 0..2 (2 pods + overflow), 3 is the padding id
    dest = torch.from_numpy(rng.integers(0, 4, (S, T), dtype=np.int32)).to(dev)
    hp_src = "src/repro_torch/kernels/csrc/hash_partition.cu"
    packs = [
        ("hash_partition_pack", "src/repro/kernels/hash_partition.py:161",
         f"S={S} T={T} P=8", S * T * 16 + S * (T // 256) * 9 * 4,
         lambda: hp.hash_partition_pack(keys, valid, 8),
         lambda: ref.hash_partition_pack_ref(keys, valid, 8)),
        ("partition_pack", "src/repro/kernels/hash_partition.py:111",
         f"S={S} T={T} bins=3", S * T * 8 + S * (T // 256) * 3 * 4,
         lambda: hp.partition_pack(dest, 3),
         lambda: ref.partition_pack_ref(dest, 3)),
        ("hash_partition", "src/repro/kernels/hash_partition.py:81",
         f"S={S} T={T} P=8", S * T * 8 + S * (T // 256) * 8 * 4,
         lambda: hp.hash_partition(keys, 8),
         lambda: ref.hash_partition_ref(keys, 8)),
    ]
    rows = []
    for name, replaces, label, nbytes, kern, plain in packs:
        row = _kernel_row(name, replaces, hp_src, label, nbytes, kern, plain)
        # the host's part and the device's part of a call, apart
        row["wall_ms"], row["device_ms"] = _wall_and_device_ms(kern, "_kernel<")
        print(f"[kernels] {name}: one call {row['wall_ms']:.4f} ms of wall (1000 calls, "
              f"host clock), {row['device_ms']:.4f} ms of device time (profiler), "
              f"{100 * row['bound_ms'] / row['device_ms']:.2f}% of bound by device time")
        rows.append(row)
    # OLMoE-1B-7B: 64 experts, top-8, on 8 units.  Decode: 64 slots -> 8
    # tokens a unit, C = 4.  Prefill: 64 x 256 prompt tokens -> 2048 a unit,
    # C = 320.  Both with capacity factor 1.25, so some rows drop.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, k = 64, 8
    moe_rows = []
    for phase, tokens, C in (("decode", 8, 4), ("prefill", 2048, 320)):
        ids = _topk_expert_ids(S, tokens, E, k, gen)
        T_m = tokens * k
        dropped = int((md.moe_dispatch(ids, E, C)[0] == E * C).sum())
        row = _kernel_row(
            "moe_dispatch", "src/repro/kernels/moe_dispatch.py:68",
            "src/repro_torch/kernels/csrc/moe_dispatch.cu",
            f"{phase} S={S} T={T_m} E={E} C={C} int64 ids", S * T_m * 12 + S * E * 4,
            lambda ids=ids, C=C: md.moe_dispatch(ids, E, C),
            lambda ids=ids, C=C: ref.moe_dispatch_ref(ids, E, C),
            note=f", {dropped} of {S * T_m} rows to the drop bin",
        )
        row["wall_ms"], row["device_ms"] = _wall_and_device_ms(
            lambda ids=ids, C=C: md.moe_dispatch(ids, E, C), "dispatch_kernel")
        print(f"[kernels] moe_dispatch: {phase} one call "
              f"{row['wall_ms']:.4f} ms of wall (1000 calls, host clock), "
              f"{row['device_ms']:.4f} ms of device time (profiler)")
        moe_rows.append(row)
    # train100m's attention: the training shape in f32 (the row) and bf16,
    # and the reference test's non-causal Sq != Sk case
    B, S_t = TRAIN_SHAPE[:2]
    flash = [_flash_row(B, 12, 4, S_t, S_t, 64, True, "float32", seed),
             _flash_row(B, 12, 4, S_t, S_t, 64, True, "bfloat16", seed),
             _flash_row(2, 4, 1, 128, 256, 64, False, "float32", seed)]
    # the SSM prefills: Mamba2-1.3B at batch 8 (bf16 is the row) and its
    # long prompt at batch 1 (64 blocks, the state carried over 128 chunks);
    # Zamba2-7B
    L_long = SSM_LONG[0]
    ssd = [_ssd_row(8, 2048, 64, 64, 128, 256, 1, "bfloat16", seed),
           _ssd_row(8, 2048, 64, 64, 128, 256, 1, "float32", seed),
           _ssd_row(1, L_long, 64, 64, 128, 256, 1, "bfloat16", seed),
           _ssd_row(1, L_long, 64, 64, 128, 256, 1, "float32", seed),
           _ssd_row(4, 2048, 112, 64, 64, 256, 1, "bfloat16", seed),
           _ssd_row(2, 1024, 64, 64, 128, 256, 1, "float32", seed, initial_state=True),
           _ssd_row(2, 1024, 64, 64, 128, 256, 2, "float32", seed)]
    flash[1]["launch_key"] = "flash_attention[bfloat16]"  # the bf16 training run's
    return rows + moe_rows + [flash[0], flash[1], ssd[0]]


def _close(got, want, rtol) -> bool:
    import numpy as np

    return bool(np.allclose(np.asarray(got, np.float64), want, rtol=rtol, atol=0.0))


def check_answer(q: str, got, want) -> None:
    """The reference tests' tolerances (tests/test_planner.py)."""
    if q == "q1":
        ok = all(_close(got[k], want[k], 1e-4) for k in want)
    elif q == "q6":
        ok = _close(float(got), want, 1e-4)
    elif q == "q17":
        ok = _close(float(got), want, 1e-3)
    elif q == "q3":
        ok = [int(k) for k in got["o_orderkey"]] == [int(k) for k in want["o_orderkey"]] \
            and _close(got["revenue"], want["revenue"], 1e-5)
    elif q == "q18":
        def as_map(r):
            return {int(k): (int(tp), float(sq)) for k, tp, sq in
                    zip(r["o_orderkey"], r["o_totalprice"], r["sum_qty"])}
        ok = len(want["o_orderkey"]) > 0 and as_map(got) == as_map(want)
    else:
        raise ValueError(q)
    if not ok:
        raise AssertionError(f"{q}: result disagrees with the numpy oracle:\n{got}\n{want}")


def _profile(run: str, runner, wall_s: float) -> None:
    """A third run under ``torch.profiler``: device time by kernel name and
    the device's busy share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {run}: wall {wall * 1e3:.2f} ms under the profiler "
          f"({wall_s * 1e3:.2f} ms without); device busy {busy_us / 1e3:.2f} ms "
          f"= {100 * busy_us / 1e6 / wall:.1f}% of wall")
    for e in rows[:10]:
        print(f"[profile] {run}:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:100]}")


def phase_queries(sf: float, seed: int, runs: list[str], profile: bool = False) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import hash_partition as hp
    from repro_torch.relational import datagen, oracle
    from repro_torch.relational.context import ExecutionContext
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.executor import compile_plan

    t0 = time.perf_counter()
    tabs = datagen.gen_all(sf, seed, device="cuda")
    torch.cuda.synchronize()
    print(f"[queries] TPC-H SF {sf} seed {seed}: lineitem {tabs['lineitem'].capacity} rows, "
          f"generated in {time.perf_counter() - t0:.2f} s")
    li, pt, od, cu = tabs["lineitem"], tabs["part"], tabs["orders"], tabs["customer"]
    oracles = {
        "q1": lambda: oracle.q1_oracle(li),
        "q6": lambda: oracle.q6_oracle(li),
        "q17": lambda: oracle.q17_oracle(li, pt),
        "q3": lambda: oracle.q3_oracle(cu, od, li),
        "q18": lambda: oracle.q18_oracle(li, od, cu),
    }
    specs = {
        "q1": ("q1", dict()),
        "q6": ("q6", dict()),
        "q17": ("q17", dict()),
        "q3": ("q3", dict()),
        "q3_pods": ("q3", dict(num_pods=2)),
        "q18_pods": ("q18", dict(num_pods=2)),
        "q3_rr": ("q3", dict(impl="round_robin", num_chunks=2)),
    }
    wants: dict = {}
    results: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the main path starts here
    for run in runs:
        q, knobs = specs[run]
        ctx = ExecutionContext(num_shards=N_SHARDS, device="cuda", **knobs)
        pq = tpch.ALL_QUERIES[q]()
        plan = tpch.plan_query(pq, tabs, ctx)
        before = dict(hp.LAUNCHES)
        runner = compile_plan(plan, tabs, ctx)
        out = runner.dispatch()
        dropped = int(out[1])
        got = runner.finalize(out)
        got = pq.finalize(got) if pq.finalize else got
        delta = {k: hp.LAUNCHES[k] - before[k] for k in ("hash_partition_pack", "partition_pack")}
        mux = runner.mux
        edges = len(plan.shuffle_stats)
        # every shuffle packs through the kernels: one hash_partition_pack
        # launch per pipeline chunk of each shuffle edge (a chunk count that
        # does not divide the edge's rows runs it unchunked), one
        # partition_pack per edge for the pod hop
        C = mux.pipeline_chunks
        want_hpp = sum(C if (st.rows * ctx.num_pods) % C == 0 else 1 for st in plan.shuffle_stats)
        want_pp = edges if ctx.num_pods > 1 else 0
        if edges and mux.pack_impl != "cuda":
            raise AssertionError(f"{run}: {edges} shuffle edges on the plain pack ({mux.describe()})")
        if dropped != 0:
            raise AssertionError(f"{run}: {dropped} rows dropped")
        if delta != {"hash_partition_pack": want_hpp, "partition_pack": want_pp}:
            raise AssertionError(
                f"{run}: kernel launches {delta}, expected hash_partition_pack="
                f"{want_hpp} partition_pack={want_pp} ({edges} shuffle edges, {mux.describe()})"
            )
        if q not in wants:
            wants[q] = oracles[q]()
        check_answer(q, got, wants[q])
        # second run: the timed one (its launches count toward the main path too)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if profile:
            _profile(run, runner, wall)
        results[run] = got
        print(
            f"[queries] {run}: ok vs oracle, dropped=0, shuffles={edges}, "
            f"knobs={mux.describe()}, launches={delta}, wall(2nd run)={wall * 1e3:.2f} ms"
        )
    if "q3" in results and "q3_rr" in results:
        a, b = results["q3"], results["q3_rr"]
        if list(map(int, a["o_orderkey"])) != list(map(int, b["o_orderkey"])) or not np.allclose(
            a["revenue"], b["revenue"], rtol=1e-6, atol=0.0
        ):
            raise AssertionError("q3 round_robin x2 chunks disagrees with the tuned run")
        print("[queries] q3_rr: same order keys as the tuned q3, revenues within rtol 1e-6 "
              "(scatter_add_ on the card sums floats in no fixed order)")
    launches = _counts()
    print(f"[queries] launches over the main path: {launches}")
    print(f"[queries] torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    return launches


class _Timed:
    """Wall seconds of every call of a model-API function, each ended by
    ``torch.cuda.synchronize()`` (the engines wait for every step's tokens
    anyway, so the syncs cost nothing extra)."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls, self.tokens = fn, 0.0, 0, 0

    def __call__(self, params, batch, *rest):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(params, batch, *rest)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        # prefill: every row of the batch, padding rows included
        self.tokens += batch["tokens"].numel() if isinstance(batch, dict) else batch.shape[0]
        return out


def _timed_api(api):
    import dataclasses

    return dataclasses.replace(
        api, prefill=_Timed(api.prefill), decode_step=_Timed(api.decode_step),
        decode_step_slots=api.decode_step_slots and _Timed(api.decode_step_slots),
    )


def _serving_line(tag: str, api, reqs, stats: dict) -> None:
    import numpy as np

    slots = api.decode_step_slots
    pre, dec = api.prefill, slots if slots is not None and slots.calls else api.decode_step
    padded_prefill_tokens = pre.tokens
    decode_tokens = sum(len(r.out_tokens) - 1 for r in reqs)
    ttft = [r.ttft_s for r in reqs if r.ttft_s is not None]
    line = (
        f"[serving] {tag}: {len(reqs)} requests; prefill {pre.calls} calls, "
        f"{stats['prefill_tokens']} prompt tokens ({padded_prefill_tokens} with padding rows) "
        f"in {pre.seconds:.3f} s = {stats['prefill_tokens'] / pre.seconds:.1f} prompt tok/s "
        f"({padded_prefill_tokens / pre.seconds:.1f} tok/s processed); decode {dec.calls} steps, "
        f"{decode_tokens} tokens in {dec.seconds:.3f} s = {decode_tokens / dec.seconds:.1f} tok/s "
        f"({1e3 * dec.seconds / max(dec.calls, 1):.2f} ms/step); slot_steps={stats['slot_steps']}"
    )
    if ttft:
        line += (f"; TTFT p50 {1e3 * float(np.quantile(ttft, 0.5)):.1f} ms, "
                 f"p99 {1e3 * float(np.quantile(ttft, 0.99)):.1f} ms")
    print(line)


def _profile_call(tag: str, fn, kernel: tuple[str, str] = ("dispatch_kernel", "moe_dispatch"),
                     top: int = 8) -> None:
    """One call under ``torch.profiler``: device busy share of its wall time,
    the top device kernels, and the device time of ``kernel`` (the key
    substring, summed over every device kernel it matches, and the name to
    print; ``ssd_scan`` is three kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {tag}: wall {wall * 1e3:.2f} ms under the profiler; device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / 1e6 / wall:.1f}% of wall")
    for e in rows[:top]:
        print(f"[profile] {tag}:   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    key, name = kernel
    matched = [e for e in rows if key in e.key]
    if matched:
        us = sum(e.self_device_time_total for e in matched)
        calls = max(e.count for e in matched)
        print(f"[profile] {tag}: {name} device time {us / 1e3:.4f} ms over {calls} calls = "
              f"{us / 1e3 / calls:.4f} ms each, {100 * us / busy_us:.1f}% of device time ("
              + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.4f} ms" for e in matched)
              + ")")


def phase_serving(seed: int) -> dict:
    """OLMoE-1B-7B at full width in bf16, expert-parallel over 8 simulated
    units, flat and 2 pods x 4, through both engines.  Returns every
    kernel's launches over the continuous runs (the main path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.exchange import make_mesh
    from repro_torch.core.multiplexer import use_multiplexer
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import registry
    from repro_torch.serve import (ContinuousEngine, Request, ServeEngine, generate_bucketed,
                                   make_mixed_workload)
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("olmoe-1b-7b")
    base_api = registry.build(cfg)
    t0 = time.perf_counter()
    params = base_api.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"[serving] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_experts} experts top-{cfg.top_k}, vocab {cfg.vocab_size}, {cfg.dtype} compute; "
          f"{n_params} f32 params ({4 * n_params} B) from seed {seed} in "
          f"{time.perf_counter() - t0:.2f} s")
    L = cfg.num_layers
    B, plen, new, cap = SERVE_SHAPE
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, plen, dtype=np.int32) for _ in range(B)]
    main_path = dict.fromkeys(_counts(), 0)

    def continuous(api, reqs, tag):
        """One continuous run on the main path: counts set to 0 just before
        it and read just after; ``moe_dispatch`` once per MoE layer of
        every prefill and decode step."""
        _reset_counts()
        ce = ContinuousEngine(api, batch_size=B, capacity=cap)
        ce.serve(params, reqs)
        counts = _counts()
        want = L * (ce.stats["prefill_calls"] + ce.stats["decode_steps"])
        if counts["moe_dispatch"] != want or ce.mux.pack_impl != "cuda":
            raise AssertionError(f"{tag}: moe_dispatch launched {counts['moe_dispatch']} times, "
                                 f"expected {want} ({ce.mux.describe()})")
        for k, v in counts.items():
            main_path[k] += v
        return ce, counts["moe_dispatch"]

    def static(api, reqs, tag, bucketed):
        _reset_counts()
        se = ServeEngine(api, batch_size=B, capacity=cap)
        generate_bucketed(se, params, reqs) if bucketed else se.generate(params, reqs)
        if _counts()["moe_dispatch"] != 0:
            raise AssertionError(f"{tag}: the static engine launched moe_dispatch")
        return se

    for pods in (1, 2):
        tag = "8 units" if pods == 1 else "2 pods x 4"
        with mesh_context(MeshContext(make_mesh(N_SHARDS, pods))):
            # -- uniform: static (plain pack) vs continuous (kernel pack) --
            s_api = _timed_api(base_api)
            reqs_s = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
            se = static(s_api, reqs_s, f"{tag} uniform", bucketed=False)
            _serving_line(f"{tag} uniform static", s_api, reqs_s, se.stats)

            c_api = _timed_api(base_api)
            reqs_c = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
            ce, launched = continuous(c_api, reqs_c, f"{tag} uniform")
            _serving_line(f"{tag} uniform continuous", c_api, reqs_c, ce.stats)
            if [r.out_tokens for r in reqs_c] != [r.out_tokens for r in reqs_s]:
                raise AssertionError(f"{tag}: continuous and static greedy tokens differ")
            print(f"[serving] {tag}: static and continuous greedy tokens identical "
                  f"({B} x {new}); moe_dispatch launched {launched} = {L} layers x "
                  f"({ce.stats['prefill_calls']} prefills + {ce.stats['decode_steps']} decode steps), "
                  f"0 in the static run; knobs {ce.mux.describe()}")

            # -- one prefill: kernel pack vs plain pack, bit for bit --------
            batch = {"tokens": torch.from_numpy(np.stack(prompts)).cuda()}
            with use_multiplexer(ce.mux):
                k_logits, _ = base_api.prefill(params, batch)
            with use_multiplexer(dataclasses.replace(ce.mux, pack_impl="torch")):
                p_logits, _ = base_api.prefill(params, batch)
            if not torch.equal(k_logits, p_logits):
                raise AssertionError(f"{tag}: prefill logits differ between the packs")
            if not torch.isfinite(k_logits).all():
                raise AssertionError(f"{tag}: non-finite logits")
            print(f"[serving] {tag}: prefill logits [{B}, {cfg.vocab_size}] bit-identical, "
                  f"kernel pack vs plain pack; all finite")
            del k_logits, p_logits
            if pods == 1:
                with use_multiplexer(ce.mux):
                    _profile_call(f"{tag} prefill [{B}, {plen}]",
                                     lambda: base_api.prefill(params, batch))
                    cache = base_api.init_cache(B, cap)
                    toks = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
                    pos = torch.full((B,), plen, dtype=torch.int32, device="cuda")
                    _profile_call(f"{tag} decode step B={B}",
                                     lambda: base_api.decode_step_slots(params, toks, cache, pos))
                    del cache
            del batch

            # -- mixed: lengths 128/256/512, 1-32 new, 4 arrivals a step ----
            mixed = make_mixed_workload(cfg.vocab_size, MIXED_REQUESTS[pods],
                                        (plen // 2, plen, 2 * plen), 2 * new, rng, arrival_rate=4)
            mixed_s = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in mixed]
            m_api = _timed_api(base_api)
            ce2, launched = continuous(m_api, mixed, f"{tag} mixed")
            ce2.alloc.check()
            if not all(r.done and 1 <= len(r.out_tokens) <= r.max_new_tokens for r in mixed):
                raise AssertionError(f"{tag} mixed: a request did not complete")
            _serving_line(f"{tag} mixed continuous", m_api, mixed, ce2.stats)
            sm_api = _timed_api(base_api)
            st = static(sm_api, mixed_s, f"{tag} mixed", bucketed=True)
            _serving_line(f"{tag} mixed static", sm_api, mixed_s, st.stats)
            c, s_ = ce2.stats["slot_steps"], st.stats["slot_steps"]
            if c >= s_:
                raise AssertionError(f"{tag} mixed: continuous {c} slot-steps, static {s_}")
            print(f"[serving] {tag} mixed: alloc.check() holds; slot_steps continuous={c} "
                  f"static={s_} ({s_ / c:.2f}x fewer); moe_dispatch launched {launched} = {L} x "
                  f"({ce2.stats['prefill_calls']} prefills + {ce2.stats['decode_steps']} decode steps)")
    print(f"[serving] launches over the main path: {main_path}")
    print(f"[serving] torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    del params
    torch.cuda.empty_cache()
    return main_path


def _train_run(cfg, seed: int, steps: int, tag: str):
    """``steps`` AdamW steps (lr 3e-4, 5 warm-up steps over a 20-step
    schedule) of ``cfg`` at ``TRAIN_SHAPE``'s batch from ``seed``, through
    the calls ``launch/train.py`` makes; every step must launch
    ``flash_attention`` 2 x layers times and the loss must fall.  Returns the
    state, the step function, the optimizer, the batch source and every
    kernel's launches over the steps (a main path)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import Prefetcher, make_batch_iterator
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, total = TRAIN_SHAPE
    api = registry.build(cfg)
    opt = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=total, schedule=cfg.lr_schedule)
    step_fn = make_train_step(api, opt)
    state = TrainState.create(api, seed)
    n_params = sum(t.numel() for t in leaves(state.params))
    per_step = cfg.num_layers * (1 if cfg.remat == "none" else 2)
    print(f"[training] {tag}: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"tied, {cfg.dtype} compute over {cfg.param_dtype} params, remat={cfg.remat}, "
          f"attn_impl={cfg.attn_impl}; {n_params} params from seed {seed}; batch {B} x {S}; "
          f"TF32 off")
    it = Prefetcher(make_batch_iterator(cfg, ShapeSpec("chip", S, B, "train"), seed=seed), depth=2)

    def next_batch():
        return {k: torch.from_numpy(v).to("cuda") for k, v in next(it).items()}

    losses, walls = [], []
    _reset_counts()  # the main path starts here
    for i in range(steps):
        batch = next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = _counts()["flash_attention"]
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launched = _counts()["flash_attention"] - before
        if launched != per_step:
            raise AssertionError(f"{tag} step {i}: flash_attention launched {launched} times, "
                                 f"expected {per_step}")
    launches = _counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite loss: {losses}")
    tail = float(np.mean(losses[-5:]))
    if not tail < losses[0]:
        raise AssertionError(f"{tag}: the loss did not fall: first {losses[0]}, last 5 mean {tail}")
    steady = float(np.mean(walls[1:]))
    print(f"[training] {tag} losses: {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"[training] {tag} loss {losses[0]:.4f} -> mean of the last 5 {tail:.4f}; all finite")
    print(f"[training] {tag} flash_attention launched {launches['flash_attention']} = {steps} "
          f"steps x {per_step} (2 x {cfg.num_layers} layers: forward + remat recompute)")
    print(f"[training] {tag} step wall: first {walls[0] * 1e3:.1f} ms; steps 2-{steps} mean "
          f"{steady * 1e3:.1f} ms (min {min(walls[1:]) * 1e3:.1f}, max {max(walls[1:]) * 1e3:.1f}) "
          f"= {B * S / steady:.1f} tokens/s; peak memory {torch.cuda.max_memory_allocated()} B")
    return state, step_fn, opt, next_batch, launches


def _flash_vs_chunked(cfg, opt, step_fn, state, batch, tag: str, rtol_loss: float,
                      rtol_norm: float) -> None:
    """One step from one state and batch under ``attn_impl="flash"`` and
    ``"chunked"``: the loss and the grad norm within the given rtols."""
    from repro_torch.models import registry
    from repro_torch.train import make_train_step

    _, m_flash = step_fn(state, batch)
    chunked = registry.build(cfg.scaled(attn_impl="chunked"))
    _, m_chunk = make_train_step(chunked, opt)(state, batch)
    d_loss = abs(float(m_flash["loss"]) - float(m_chunk["loss"])) / abs(float(m_chunk["loss"]))
    d_norm = abs(float(m_flash["grad_norm"]) - float(m_chunk["grad_norm"])) / float(m_chunk["grad_norm"])
    print(f"[training] {tag} flash vs chunked, one step from one state and batch: loss "
          f"{float(m_flash['loss']):.6f} vs {float(m_chunk['loss']):.6f} (rel {d_loss:.3g}, "
          f"rtol {rtol_loss:.3g}), grad norm {float(m_flash['grad_norm']):.6f} vs "
          f"{float(m_chunk['grad_norm']):.6f} (rel {d_norm:.3g}, rtol {rtol_norm:.3g})")
    if d_loss > rtol_loss or d_norm > rtol_norm:
        raise AssertionError(f"{tag}: flash and chunked attention disagree beyond rtol "
                             f"{rtol_loss:.3g} / {rtol_norm:.3g}")


def phase_training(seed: int) -> dict:
    """train100m at full width with the flash kernel: 20 steps in f32, the
    chunked cross-check, the CLI's checkpoint resume, one profiled step;
    then 5 steps with bf16 compute over f32 master params, its own chunked
    cross-check and profiled step.  Returns every kernel's launches over the
    two runs (the main path), the bf16 run's ``flash_attention`` launches
    under ``flash_attention[bfloat16]``."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the f32 checks below assume full f32")
    B, S, steps = TRAIN_SHAPE
    cfg = get_config("train100m").scaled(attn_impl="flash")
    state, step_fn, opt, next_batch, launches = _train_run(cfg, seed, steps, "f32")
    batch = next_batch()
    _flash_vs_chunked(cfg, opt, step_fn, state, batch, "f32", 1e-5, 1e-4)
    _profile_call(f"f32 train step [{B}, {S}]", lambda: step_fn(state, batch),
                  kernel=("flash_fwd_f32", "flash_attention"), top=10)
    del state, batch
    torch.cuda.empty_cache()

    # the CLI: 4 steps with a checkpoint every 2, resume to 6, against 6 straight
    common = ["--arch", "train100m", "--seq-len", str(CLI_SEQ), "--batch", str(B),
              "--seed", str(seed), "--log-every", "1"]
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d2:
        runs = {}
        for tag, argv in (("4 steps", ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"]),
                          ("resumed to 6", ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2"]),
                          ("6 straight", ["--steps", "6", "--ckpt-dir", d2])):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                st, last = train_cli.main(common + argv)
            runs[tag] = (st, last, out.getvalue(), time.perf_counter() - t0)
    st, last, log, _ = runs["resumed to 6"]
    if "resumed from checkpoint at step 4" not in log or int(st.step) != 6:
        raise AssertionError(f"the CLI did not resume at step 4:\n{log}")
    want = runs["6 straight"][1]["loss"]
    if not math.isfinite(want) or abs(last["loss"] - want) > 1e-5 * abs(want):
        raise AssertionError(f"resumed last loss {last['loss']} vs uninterrupted {want}")
    print(f"[training] CLI seq {CLI_SEQ}: " + "; ".join(
        f"{tag} {r[3]:.2f} s, last loss {r[1]['loss']:.6f}" for tag, r in runs.items())
        + f"; resumed at step 4, |diff| {abs(last['loss'] - want):.3g} (rtol 1e-5)")
    del runs, st
    torch.cuda.empty_cache()

    # bf16 compute over f32 master params (the reference's default dtypes);
    # the tolerances are TRAIN_BF16_RTOL's, from bf16 rounding
    cfg16 = get_config("train100m").scaled(dtype="bfloat16", attn_impl="flash")
    state, step_fn, opt, next_batch, launches16 = _train_run(cfg16, seed, TRAIN_BF16_STEPS,
                                                             "bf16")
    batch = next_batch()
    _flash_vs_chunked(cfg16, opt, step_fn, state, batch, "bf16", *TRAIN_BF16_RTOL)
    _profile_call(f"bf16 train step [{B}, {S}]", lambda: step_fn(state, batch),
                  kernel=("flash_fwd_bf16", "flash_attention"), top=10)
    print(f"[training] flash_attention launches: f32 {launches['flash_attention']}, bf16 "
          f"{launches16['flash_attention']}")
    del state, batch
    torch.cuda.empty_cache()
    launches16["flash_attention[bfloat16]"] = launches16.pop("flash_attention")
    return {k: launches.get(k, 0) + launches16.get(k, 0) for k in {*launches, *launches16}}


def _rel_err(got, want) -> float:
    """``max |got - want|`` over the largest ``|want|``."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _ssm_check(api32, params, seed: int, arch: str, nb: int, full: int, split: int) -> None:
    """In f32 compute: one prefill of ``nb`` prompts of ``full`` tokens
    against a prefill of their first ``split`` followed by one decode step a
    token (the plain recurrence ``ssd_step``).  The last logits and every
    layer's SSM state must agree within ``SSM_CHECK_TOL`` of the largest
    magnitude: the two sides differ only in f32 rounding, compounded through
    the layers (and, at batch 1, through the chunks of a long prompt)."""
    import numpy as np
    import torch

    from repro_torch.serve import grow_cache
    from repro_torch.tree import leaves_with_paths

    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(0, api32.cfg.vocab_size, (nb, full), dtype=np.int32)).cuda()
    t0 = time.perf_counter()
    want_logits, want_cache = api32.prefill(params, {"tokens": tokens})
    _, cache = api32.prefill(params, {"tokens": tokens[:, :split]})
    cache = grow_cache(api32, cache, nb, full)
    for pos in range(split, full):
        logits, cache = api32.decode_step(params, tokens[:, pos : pos + 1], cache, pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (torch.isfinite(logits).all() and torch.isfinite(want_logits).all()):
        raise AssertionError(f"{arch} f32 check: non-finite logits")
    err_logits = _rel_err(logits, want_logits)
    want_states = {p: w for p, w in leaves_with_paths(want_cache) if "ssm" in p}
    err_state = 0.0
    for path, got in leaves_with_paths(cache):
        if "ssm" in path:
            flat_got = got.reshape(-1, *got.shape[-4:])
            flat_want = want_states[path].reshape(flat_got.shape)
            err_state = max(err_state, *(_rel_err(g, w) for g, w in zip(flat_got, flat_want)))
    n_states = sum(w.reshape(-1, *w.shape[-4:]).shape[0] for w in want_states.values())
    print(f"[ssm] {arch} f32 check: prefill of {nb} x {full} against a prefill of {split} "
          f"and {full - split} decode steps: last logits rel err {err_logits:.3g}, the worst "
          f"of {n_states} layers' SSM states {err_state:.3g} (limit {SSM_CHECK_TOL}); "
          f"{wall:.2f} s")
    if err_logits > SSM_CHECK_TOL or err_state > SSM_CHECK_TOL:
        raise AssertionError(f"{arch}: prefill and prefill + decode disagree beyond "
                             f"{SSM_CHECK_TOL}")


def _ssm_model(arch: str, seed: int) -> dict:
    """One SSM model at full width through the static engine.  Returns
    every kernel's launches over its serving runs (the main path)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    api = registry.build(cfg)
    t0 = time.perf_counter()
    params = api.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    L = cfg.num_layers  # every layer of both models is a Mamba2 layer
    print(f"[ssm] {arch}: {L} Mamba2 layers, d_model {cfg.d_model}, "
          f"H={cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} "
          f"P={cfg.ssm_head_dim} N={cfg.ssm_state} chunk {cfg.ssm_chunk}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype} compute; {n_params} f32 params ({4 * n_params} B) "
          f"from seed {seed} in {time.perf_counter() - t0:.2f} s")
    n_req, plen, new, batch = SSM_SERVE[arch]
    rng = np.random.default_rng(seed)
    runs = [(f"{n_req} x {plen} + {new} new, batch {batch}", n_req, plen, new, batch)]
    if arch == "mamba2-1.3b":
        runs.append((f"1 x {SSM_LONG[0]} + {SSM_LONG[1]} new", 1, *SSM_LONG, 1))
    main_path = dict.fromkeys(_counts(), 0)
    for tag, n, plen_r, new_r, b in runs:
        t_api = _timed_api(api)
        engine = ServeEngine(t_api, batch_size=b, capacity=plen_r + new_r)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, plen_r, dtype=np.int32),
                        max_new_tokens=new_r) for _ in range(n)]
        _reset_counts()
        for i in range(0, n, b):
            engine.generate(params, reqs[i : i + b])
        counts = _counts()
        for k, v in counts.items():
            main_path[k] += v
        if counts["ssd_scan"] != L * t_api.prefill.calls:
            raise AssertionError(f"{arch} {tag}: ssd_scan launched {counts['ssd_scan']} times, "
                                 f"expected {L} x {t_api.prefill.calls} prefills")
        if not all(len(r.out_tokens) == new_r and all(0 <= t < cfg.vocab_size
                                                       for t in r.out_tokens) for r in reqs):
            raise AssertionError(f"{arch} {tag}: a request did not get {new_r} tokens")
        _serving_line(f"{arch} {tag}", t_api, reqs, engine.stats)
        print(f"[ssm] {arch} {tag}: ssd_scan launched {counts['ssd_scan']} = {L} layers x "
              f"{t_api.prefill.calls} prefills; prefill {1e3 * t_api.prefill.seconds / t_api.prefill.calls:.1f} "
              f"ms a call")
    print(f"[ssm] {arch}: torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, plen), dtype=np.int32)).cuda()
    _profile_call(f"{arch} prefill [{batch}, {plen}]",
                  lambda: api.prefill(params, {"tokens": tokens}),
                  kernel=("ssd_", "ssd_scan"), top=10)
    cache = api.init_cache(batch, plen + 1)
    _profile_call(f"{arch} decode step B={batch}",
                  lambda: api.decode_step(params, tokens[:, :1], cache, plen),
                  kernel=("ssd_", "ssd_scan"), top=5)
    del cache
    api32 = registry.build(cfg.scaled(dtype="float32"))
    for nb, full, split in SSM_CHECK[arch]:
        _ssm_check(api32, params, seed, arch, nb, full, split)
    del params
    torch.cuda.empty_cache()
    return main_path


def phase_ssm(seed: int) -> dict:
    """Mamba2-1.3B, then Zamba2-7B; every kernel's launches over both."""
    runs = [_ssm_model(arch, seed) for arch in SSM_SERVE]
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", default=",".join(ALL_RUNS))
    ap.add_argument("--profile", action="store_true",
                    help="profile a third run of each query (device time by kernel)")
    args = ap.parse_args()
    runs = [r for r in args.queries.split(",") if r]
    if unknown := sorted(set(runs) - set(ALL_RUNS)):
        ap.error(f"unknown runs {unknown}; choose from {ALL_RUNS}")

    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # 1. device
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] {kind}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build: one nvcc per source, all at once
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as sk

    libs = (hp.LIBRARY, md.LIBRARY, fa.LIBRARY, sk.LIBRARY)
    t0 = time.perf_counter()
    build.build_all(libs)
    print(f"[build] {len(libs)} libraries built and loaded in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"[build] {lib.info['path']}: nvcc {lib.info['seconds']:.2f} s")
        for line in lib.info["log"].splitlines():
            print(f"[build] {line}")

    # 3. kernels against their plain versions
    kernels = phase_kernels(args.sf, args.seed)

    # 4. queries (the relational main path)
    q_launches = phase_queries(args.sf, args.seed, runs, args.profile)

    # 5. serving (the MoE main path)
    s_launches = phase_serving(args.seed)

    # 6. training (the training main path)
    t_launches = phase_training(args.seed)

    # 7. SSM serving (the SSM main path)
    m_launches = phase_ssm(args.seed)
    paths = (q_launches, s_launches, t_launches, m_launches)
    launches = {k: sum(p.get(k, 0) for p in paths) for k in {k for p in paths for k in p}}
    for k in kernels:
        k["launches"] = launches[k.pop("launch_key", k["name"])]
        if k["launches"] <= 0 and k["name"] not in OFF_PATH:
            raise AssertionError(f"{k['name']} was never launched on the main path")

    # 8-9. results
    print(json.dumps({"kernels": kernels}))
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
