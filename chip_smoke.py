#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--seed 0] [--profile]
                          [--queries q1,q6,q17,q3,q3_pods,q18_pods,q3_rr]

Phases, in order; any failure raises and the process exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions; a machine without CUDA exits 2 before printing any result;
2. build — ``nvcc`` builds the pack kernels from ``csrc/hash_partition.cu``
   for ``sm_90a`` (seconds and ``-Xptxas -v`` printed);
3. kernels — ``hash_partition_pack`` (P=8, 10 % invalid rows) and
   ``partition_pack`` (3 bins, with padding ids) at the main path's shapes
   (S=8 shards x one shard's lineitem rows, padded to 256), held bit for bit
   against their plain PyTorch versions on the card, and timed with CUDA
   events (mean over 50 launches after warm-up) beside the plain versions
   and the memory bound (bytes / 3.35 TB/s);
4. queries — TPC-H at ``--sf`` through the port's planner and executor:
   Q1, Q6, Q17, Q3 on 8 shards, Q3 and Q18 on 2 pods x 4, and Q3 again
   with an explicit ``impl="round_robin", num_chunks=2``.  Every answer is
   checked against the port's numpy oracle at the reference tests'
   tolerances, every run must drop no row, and the launch counters must
   show each shuffle edge's pack went through the kernels.  The Q3 rerun
   must give the same order keys and revenues within rtol 1e-6
   (``scatter_add_`` on the card sums floats in no fixed order);
5. a ``{"kernels": [...]}`` JSON line, then the card's name and power limit;
6. the last line: ``{"ok": true, "device": {...}}``.

Wall times are host clock around work that ends in
``torch.cuda.synchronize()``, taken on each query's second run.
``--profile`` adds a third run under ``torch.profiler`` and prints device
time by kernel and the device's busy share of the wall time.
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
N_SHARDS = 8
ALL_RUNS = ("q1", "q6", "q17", "q3", "q3_pods", "q18_pods", "q3_rr")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def phase_kernels(sf: float, seed: int) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.kernels import hash_partition as hp
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
    out = []
    for name, replaces, bins, read_b, write_b, kern, plain in (
        (
            "hash_partition_pack", "src/repro/kernels/hash_partition.py:161", 9, 8, 8,
            lambda: hp.hash_partition_pack(keys, valid, 8),
            lambda: ref.hash_partition_pack_ref(keys, valid, 8),
        ),
        (
            "partition_pack", "src/repro/kernels/hash_partition.py:111", 3, 4, 4,
            lambda: hp.partition_pack(dest, 3),
            lambda: ref.partition_pack_ref(dest, 3),
        ),
    ):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        match = all(torch.equal(g, w) for g, w in zip(got, want))
        if not match:
            raise AssertionError(f"{name}: kernel disagrees with its plain version (max |err| {err})")
        ms = _time_ms(kern)
        plain_ms = _time_ms(plain)
        nbytes = S * T * (read_b + write_b) + S * (T // 256) * bins * 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(
            f"[kernels] {name}: S={S} T={T} bins={bins} bit-exact; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B), "
            f"{100 * bound_ms / ms:.1f}% of bound"
        )
        out.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/hash_partition.cu",
            replaces=replaces, launches=0, match=True, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None,
        ))
    return out


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
    hp.reset_launch_counts()  # the main path starts here
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
        delta = {k: hp.LAUNCHES[k] - before[k] for k in before}
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
    launches = dict(hp.LAUNCHES)
    print(f"[queries] launches over the main path: {launches}")
    print(f"[queries] torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    return launches


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

    # 2. build
    from repro_torch.kernels import hash_partition as hp

    t0 = time.perf_counter()
    hp.build()
    print(f"[build] {hp.BUILD_INFO['path']}: nvcc {hp.BUILD_INFO['seconds']:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s")
    for line in hp.BUILD_INFO["log"].splitlines():
        print(f"[build] {line}")

    # 3. kernels against their plain versions
    kernels = phase_kernels(args.sf, args.seed)

    # 4. queries
    launches = phase_queries(args.sf, args.seed, runs, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was never launched on the main path")

    # 5-6. results
    print(json.dumps({"kernels": kernels}))
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
