#!/usr/bin/env python3
"""Measurements of the port's kernels that ``chip_smoke.py`` does not make.

    python3 tools/torch_kernel_probe.py pack-time [--src DIR]
    python3 tools/torch_kernel_probe.py moe-time [--src DIR]
    python3 tools/torch_kernel_probe.py moe-host [--calls 1000]
    python3 tools/torch_kernel_probe.py mma-rate
    python3 tools/torch_kernel_probe.py pack-law
    python3 tools/torch_kernel_probe.py flash-time [--src DIR]

``pack-time`` holds the three pack kernels bit for bit against their plain
versions at ``chip_smoke.py`` phase 3's shapes (S=8 shards x T=750,080
rows, one shard's lineitem rows at SF 1; P=8, 3 bins, seed 0) and gives
each three times: CUDA events over 50 back-to-back calls after 5 (as
``chip_smoke.py``'s rows), one call's wall (host clock over 1,000 calls,
then a synchronise) and the device time of its kernel (``torch.profiler``
over 50 calls), beside the bytes bound and the plain version's events
time.  ``partition_pack`` is also run at
9, 16, 17, 32, 33 and 65 bins.  As a yardstick, ``Tensor.copy_`` moves the
same bytes (the card's practical rate).  Last, one whole ``ops.partition_ranks``
and ``ops.hash_partition_ranks`` call is profiled: the device time of each
kernel it launches (the pack kernel, then the combine's cumsum, arange,
gather, add and sum).  ``--src`` as for ``moe-time``.

``moe-time`` times ``moe_dispatch`` at OLMoE's decode (S=8, T=64, E=64,
C=4) and prefill (S=8, T=16,384, C=320) shapes on router-ordered int32 ids
(which every version of the wrapper takes), two ways: CUDA events over 50
back-to-back calls after 5 (as ``chip_smoke.py``'s rows), and the kernel's
device time from ``torch.profiler`` over 50 calls.  ``--src`` points it at
another checkout's ``src`` (an older commit unpacked with ``git archive``),
so two versions are compared in one run on one card.

``mma-rate`` times the tensor cores' ``mma.sync`` issue rate with nothing
else in the way: every warp of 4 blocks an SM runs 8 independent
accumulator chains of ``m16n8k8`` tf32 (the f32 attention kernel's
instruction) or ``m16n8k16`` bf16 (the bf16 kernel's), and the rate is
printed in instructions and TFLOP/s for the card.

``moe-host`` splits the host time of one ``moe_dispatch`` call at the
decode shape into its parts, each timed with ``time.perf_counter`` over
``--calls`` calls (a synchronise after the loop): the checks, one
``torch.empty``, the stream handle, the ``ctypes`` launch and the whole
call, on int64 (the router's) and int32 ids.

``pack-law`` takes apart the plain pack that ``calibrate_chip``'s pack law
times: one ``pack_by_destination(impl="torch")`` call on one shard (8
destinations, rows of 16 B, seeded) at ``chip_smoke.py`` phase 4d's 1,024
and 2**21 rows and at 65,536 between, by CUDA events over 5 calls after 2
and by device time a kernel (``torch.profiler``, one call); then the rank
scan alone in two layouts: ``cumsum`` over the row axis of a
``[1, 1, rows, 9]`` int32 one-hot, and the same one-hot scanned along its
last axis (laid out ``[1, 1, 9, rows]``, as ``partition_pack_ref`` lays
it).

``flash-time`` times ``flash_attention`` at ``chip_smoke.py`` phase 3's
shapes (``FLASH_TIME_ROWS``): the three whose lengths are multiples of 64
(train100m's B=8, H=12, KH=4, S=2,048, D=64 causal in f32 and bf16, and
Whisper-medium's encoder at training, B=8, H=KH=16, S=2,048, non-causal
bf16) and the three with a partial tile or a padded head dim (Whisper's
encoder at serving, 1,500 frames at batch 4; 1,500 causal f32 with GQA
4:1; D=48 f32).  Each row is held to the plain version (2e-5 f32, 2e-2
bf16) and timed by CUDA events over 20 calls after 5; a tree whose wrapper
raises at a shape prints that.  ``--src`` as for ``moe-time``: parent,
change, change, parent in one call compares two trees on one card.  The
library's ``-Xptxas -v`` report (registers, spills) is printed first.

Each needs a CUDA card and prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _events_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_MMA_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

template <bool kBf16>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x * 0x01010101u, b1 = b0 ^ 0x00ff00ffu;
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + i) * 0x00010001u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (kBf16) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      } else {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  }
  float sum = 0.f;
  for (int j = 0; j < 8; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_rate_launch(int bf16, void* out, int blocks, int iters, void* stream) {
  if (bf16) mma_loop<true><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  else mma_loop<false><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_rate() -> None:
    import ctypes
    import tempfile

    import torch

    from repro_torch.kernels import build

    with tempfile.TemporaryDirectory() as d:
        src, lib_path = Path(d) / "mma_rate.cu", Path(d) / "mma_rate.so"
        src.write_text(_MMA_SRC)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, text=True, timeout=300)
        lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    out = torch.empty(4 * sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, bf16, flop in (("tf32 m16n8k8", 0, 2 * 16 * 8 * 8),
                             ("bf16 m16n8k16", 1, 2 * 16 * 8 * 16)):
        for per_sm in (4, 1):  # 32 and 8 warps an SM
            blocks = per_sm * sms

            def run():
                if lib.mma_rate_launch(bf16, out.data_ptr(), blocks, iters, stream):
                    raise RuntimeError("mma_rate launch failed")

            ms = _events_ms(run, 5)
            n = blocks * 8 * iters * 8  # warps x iterations x chains
            print(f"[mma-rate] {name}, {8 * per_sm} warps an SM: {n} mma.sync in {ms:.4f} ms = "
                  f"{n * flop / ms / 1e9:.1f} TFLOP/s, "
                  f"{n / sms / (ms * 1e-3) / 1e9:.4f} G mma/s an SM")


def _router_ids(S: int, T: int, E: int, dtype):
    """Expert ids ``[S, T]`` as the router gives them (8 choices a token)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    scores = torch.rand((S, T // 8, E), generator=gen, device="cuda")
    return torch.topk(scores, 8, dim=-1).indices.reshape(S, T).to(dtype).contiguous()


def moe_time() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref

    print(f"[moe-time] package: {Path(md.__file__).resolve().parents[2]}")
    E = 64
    for phase, T, C in (("decode", 64, 4), ("prefill", 16_384, 320)):
        ids = _router_ids(8, T, E, torch.int32)
        got = md.moe_dispatch(ids, E, C)
        want = ref.moe_dispatch_ref(ids, E, C)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"moe_dispatch {phase}: differs from the plain version")
        ms = _events_ms(lambda: md.moe_dispatch(ids, E, C), 50, warmup=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                md.moe_dispatch(ids, E, C)
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA" and "dispatch_kernel" in e.key)
        print(f"[moe-time] {phase} S=8 T={T} E={E} C={C} int32 ids: events {ms:.4f} ms a call "
              f"(50 back to back), device {us / 50 / 1e3:.4f} ms a call (profiler, 50 calls)")


def _device_ms(fn, calls: int = 50) -> tuple[float, list[str]]:
    """Device time a call of ``fn`` and the names of its device kernels
    (``torch.profiler`` over ``calls`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    us = sum(e.self_device_time_total for e in rows)
    return us / calls / 1e3, sorted({e.key[:60] for e in rows})


def _wall_ms(fn, calls: int = 1000) -> float:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def pack_time() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import ops, ref

    print(f"[pack-time] package: {Path(hp.__file__).resolve().parents[2]}")
    S, T, P, hbm = 8, 750_080, 8, 3.35e12
    nblk = T // 256
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 2**31 - 1, (S, T), dtype=np.int32)).cuda()
    valid = torch.from_numpy((rng.random((S, T)) >= 0.1).astype(np.int32)).cuda()
    # ids in [0, bins]: ``bins`` is the padding id, which matches no bin
    dests = {b: torch.from_numpy(rng.integers(0, b + 1, (S, T), dtype=np.int32)).cuda()
             for b in (3, 9, 16, 17, 32, 33, 65)}
    cases = [("hash_partition_pack", f"P={P}", S * T * 16 + S * nblk * (P + 1) * 4,
              lambda: hp.hash_partition_pack(keys, valid, P),
              lambda: ref.hash_partition_pack_ref(keys, valid, P))]
    cases += [("partition_pack", f"bins={b}", S * T * 8 + S * nblk * b * 4,
               lambda d=d, b=b: hp.partition_pack(d, b),
               lambda d=d, b=b: ref.partition_pack_ref(d, b)) for b, d in dests.items()]
    cases += [("hash_partition", f"P={P}", S * T * 8 + S * nblk * P * 4,
               lambda: hp.hash_partition(keys, P), lambda: ref.hash_partition_ref(keys, P))]
    for name, label, nbytes, kern, plain in cases:
        got, want = kern(), plain()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} {label}: differs from the plain version")
        ms = _events_ms(kern, 50, warmup=5)
        wall = _wall_ms(kern)
        dev_ms, names = _device_ms(kern)
        plain_ms = _events_ms(plain, 50, warmup=5)
        bound = nbytes / hbm * 1e3
        print(f"[pack-time] {name} S={S} T={T} {label}: bit-exact; events {ms:.4f} ms a call "
              f"(50 back to back), wall {wall:.4f} ms (1000 calls), device {dev_ms:.4f} ms "
              f"(profiler, 50 calls; {names}); bound {bound:.4f} ms ({nbytes} B): "
              f"{100 * bound / dev_ms:.1f}% by device time, {100 * bound / ms:.1f}% by events; "
              f"plain version {plain_ms:.4f} ms (events, 50 after 5)")
    # the yardstick: what the card takes to copy the same bytes (one [S, T]
    # and one [S, 2 T] int32 tensor: partition_pack's and hash_partition_pack's
    # reads and writes without their histograms)
    for rows in (T, 2 * T):
        a = torch.zeros((S, rows), dtype=torch.int32, device="cuda")
        b = torch.empty_like(a)
        dev_ms, _ = _device_ms(lambda: b.copy_(a))
        nbytes = 2 * a.numel() * 4
        print(f"[pack-time] copy_ of [{S}, {rows}] int32 ({nbytes} B moved): device "
              f"{dev_ms:.4f} ms (profiler, 50 calls) = {nbytes / dev_ms / 1e9:.3f} TB/s, "
              f"{100 * nbytes / hbm * 1e3 / dev_ms:.1f}% of {hbm / 1e12} TB/s")
    for tag, fn in (("ops.partition_ranks bins=3", lambda: ops.partition_ranks(dests[3], 3)),
                    ("ops.hash_partition_ranks P=8",
                     lambda: ops.hash_partition_ranks(keys, valid, P))):
        wall = _wall_ms(fn, 200)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        rows = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                      key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in rows) / 20 / 1e3
        print(f"[pack-time] {tag} S={S} T={T}: wall {wall:.4f} ms (200 calls), device "
              f"{total:.4f} ms a call (profiler, 20 calls) in {sum(e.count for e in rows) // 20} "
              f"kernels:")
        for e in rows:
            print(f"[pack-time]   {e.self_device_time_total / 20 / 1e3:.4f} ms x{e.count // 20} "
                  f"{e.key[:100]}")


def pack_law() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import exchange

    n, width = 8, 4
    for rows in (1024, 65536, 2**21):
        gen = torch.Generator("cuda").manual_seed(rows)
        dest = torch.randint(0, n, (1, rows), dtype=torch.int32, device="cuda", generator=gen)
        data = torch.randint(0, 1 << 20, (1, rows, width), dtype=torch.int32, device="cuda",
                             generator=gen)

        def pack():
            return exchange.pack_by_destination(dest, data, n, rows, impl="torch")

        ms = _events_ms(pack, 5, warmup=2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pack()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                      key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in kern) / 1e3
        print(f"[pack-law] pack_by_destination(impl='torch') S=1 rows={rows} n={n} "
              f"width={width}: events {ms:.4f} ms a call (5 after 2); device {total:.4f} ms "
              f"in {sum(e.count for e in kern)} kernels (profiler, one call):")
        for e in kern[:6]:
            print(f"[pack-law]   {e.self_device_time_total / 1e3:.4f} ms x{e.count} "
                  f"{e.key[:100]}")
        onehot = (dest.reshape(1, 1, rows)[..., None] == torch.arange(
            n + 1, device="cuda", dtype=torch.int32)).to(torch.int32)
        lanes = onehot.transpose(2, 3).contiguous()
        row_scan = _events_ms(lambda: onehot.cumsum(2, dtype=torch.int32), 5, warmup=2)
        lane_scan = _events_ms(lambda: lanes.cumsum(3, dtype=torch.int32), 5, warmup=2)
        if not torch.equal(onehot.cumsum(2, dtype=torch.int32).transpose(2, 3),
                           lanes.cumsum(3, dtype=torch.int32)):
            raise AssertionError("the two scans disagree")
        print(f"[pack-law] rows={rows}: cumsum over the row axis of the [1, 1, {rows}, {n + 1}] "
              f"one-hot {row_scan:.4f} ms; the same scan along the last axis of "
              f"[1, 1, {n + 1}, {rows}] {lane_scan:.4f} ms (events, 5 after 2; equal)")


def moe_host(calls: int) -> None:
    import torch

    from repro_torch.kernels import moe_dispatch as md

    S, T, E, C = 8, 64, 64, 4
    ids64 = _router_ids(S, T, E, torch.int64)
    ids = ids64.to(torch.int32)
    dev = ids.device
    lib = md.LIBRARY.load()
    slot = torch.empty((S, T), dtype=torch.int32, device=dev)
    counts = torch.empty((S, E), dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def checks():
        md._ID_BYTES.get(ids.dtype)
        ids.dim()
        ids.is_contiguous()
        S_, T_ = ids.shape
        return 0 < E <= md.MAX_EXPERTS and (E + 1) * C < 2**31 and S_ * T_ < 2**31

    def launch():
        lib.moe_dispatch_launch(ids.data_ptr(), 4, slot.data_ptr(), counts.data_ptr(), None, 0,
                                None, 0, S, T, E, C, stream)

    parts = {
        "checks (dtype, dim, contiguity, limits)": checks,
        "one torch.empty": lambda: torch.empty((S, T), dtype=torch.int32, device=dev),
        "raw stream (torch._C._cuda_getCurrentRawStream)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "ctypes launch": launch,
        "moe_dispatch, int64 ids (the MoE layer's call)": lambda: md.moe_dispatch(ids64, E, C),
        "moe_dispatch, int32 ids": lambda: md.moe_dispatch(ids, E, C),
    }
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / calls * 1e6
        print(f"[moe-host] {name}: {us:.2f} us a call ({calls} calls)")


# (B, H, KH, Sq, Sk, D, causal, dtype)
FLASH_TIME_ROWS = (
    (8, 12, 4, 2048, 2048, 64, True, "float32"),
    (8, 12, 4, 2048, 2048, 64, True, "bfloat16"),
    (8, 16, 16, 2048, 2048, 64, False, "bfloat16"),
    (4, 16, 16, 1500, 1500, 64, False, "bfloat16"),
    (1, 4, 1, 1500, 1500, 64, True, "float32"),
    (2, 8, 2, 192, 192, 48, True, "float32"),
)


def flash_time() -> None:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    fa.LIBRARY.load()
    print(f"[flash] {fa.__file__}: nvcc {fa.LIBRARY.info['seconds']:.2f} s")
    for line in fa.LIBRARY.info["log"].splitlines():
        if "Compiling entry" in line:
            print(f"[flash] {line.split('entry function')[-1].strip()[:40]}")
        elif "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[flash] {line.strip()}")
    for B, H, KH, Sq, Sk, D, causal, dtype in FLASH_TIME_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(0)
        dt = getattr(torch, dtype)
        q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, KH, Sk, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, KH, Sk, D), generator=gen, device="cuda").to(dt)
        label = f"B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} D={D} {'causal' if causal else 'full'} {dtype}"
        try:
            got = fa.flash_attention(q, k, v, causal=causal)
        except ValueError as e:
            print(f"[flash] {label}: raises ({e})")
            continue
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2e-5 if dtype == "float32" else 2e-2
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        del want
        ms = _events_ms(lambda: fa.flash_attention(q, k, v, causal=causal), iters=20, warmup=5)
        print(f"[flash] {label}: kernel {ms:.4f} ms; max |err| {err:.3g} "
              f"({'within' if ok else 'BEYOND'} {tol})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("pack-time", "moe-time", "moe-host", "mma-rate", "pack-law",
                                     "flash-time"))
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--src", type=Path,
                    help="pack-time, moe-time, flash-time: another checkout's src directory")
    args = ap.parse_args()
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"[device] nvidia-smi: {_smi()}")
    if args.what == "pack-time":
        pack_time()
    elif args.what == "moe-time":
        moe_time()
    elif args.what == "mma-rate":
        mma_rate()
    elif args.what == "pack-law":
        pack_law()
    elif args.what == "flash-time":
        flash_time()
    else:
        moe_host(args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
