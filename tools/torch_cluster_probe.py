#!/usr/bin/env python3
"""The port's process fabric on the card, beyond what ``chip_smoke.py`` runs.

    python3 tools/torch_cluster_probe.py gloo-cuda
    python3 tools/torch_cluster_probe.py train [--arch train100m|olmoe-1b-7b|qwen2.5-3b]
                                               [--profile]
                                               [--out DIR]
    python3 tools/torch_cluster_probe.py serve [--runs olmoe,mamba2,olmoe_continuous,
                                                       tensor_f32,tensor,tensor_ssm_f32,
                                                       tensor_ssm,tensor_long_500k] [--out DIR]
    python3 tools/torch_cluster_probe.py layouts [--layouts gloo:2x4,nccl:2x4,nccl:4x2]
                                                 [--sf 1] [--morsel-rows 1048576] [--out DIR]

``gloo-cuda`` asks Gloo itself, in a 2-process cluster on one card, to
carry CUDA tensors (no staging): ``all_reduce``, ``all_gather``,
``all_to_all_single`` and a ``batch_isend_irecv`` pair, each printed as
carried (and right) or refused with Gloo's message.  The port stages every
Gloo message through host memory whatever the answer; this records what
Gloo would do.

``train`` runs the ``dp_train`` scenario of
``tests/_torch_multiproc_driver.py`` (data-parallel training,
``train/step.py``) at train100m's full width and depth (f32, flash) over 4
NCCL ranks of 2 units, one pod and one card a rank, at a global batch of 8
x 2,048: each worker asserts that both ``grad_sync`` modes equal process
0's one-process step and that the params stay bit-identical; each mode's
step walls, the sync's wall alone and the bytes a rank puts on the pod hop
a step are printed beside the cards' names and power limits.  ``train
--arch olmoe-1b-7b`` runs the ``moe_train`` scenario instead (OLMoE-1B-7B's
experts sharded over the 4 ranks, a quarter each): first a 2-layer cut at
full width in f32 (8 x 1,024 tokens) held to rank 0's one-process step
over the same 8 units, as ``chip_smoke.py`` phase 6c holds it, then 3 steps
of all 16 layers with bf16 compute over f32 params at 8 x 2,048: losses
finite, the replicated params bit-identical on every rank; each rank's step
walls, pod-hop bytes and peak memory are printed.  ``--profile`` adds, on
each rank, one more step counted op by op and one under ``torch.profiler``
(train100m's, and each OLMoE run's), and prints a line of JSON a rank as
``chip_smoke.py`` phases 6b and 6c do (``chip_smoke._profiled_steps``): the
step's ms, counted flops, bytes and collective bytes by kind (gated against
the pod hop's and the dry run's count on ``meta`` of the same config,
batch and 4 x 2 layout), the trace's overlap fraction, idle share and busy
share, MFU of the four cards against the bf16 peak, and the peak of live
bytes beside the allocator's.  The traces go to a temporary directory.

``train --arch qwen2.5-3b`` runs the ``grid_train`` scenario (dense
training on a ``data x model`` grid under the reference's
``default_rules(False)``: heads, ``d_ff`` and vocab over each model row,
every ``fsdp`` dim and the batch over each data column) over 4 NCCL ranks
as a 2 x 2 grid, a card a rank, in two clusters: first Qwen2.5-3B at full width
cut to ``GRID_CHECK_LAYERS`` layers in f32 at 8 x 512 tokens, 2 steps held
to rank 0's one-process step (loss rtol 1e-5, grad norm 1e-4, every
gradient piece 1e-4 of its leaf's max, params 1e-5), as ``chip_smoke.py``
phase 9f holds it; then all 36 layers with bf16 compute over f32 params at
8 x 2,048, 3 steps: losses finite, the replicated leaves bit-identical
within their groups, every group's bytes by kind equal to the count from
the shapes.  Each rank's step walls, state bytes (beside the whole f32
state's: params, gradients, ``m`` and ``v``), peak and bytes by group are
printed beside the cards' names and power limits.

``serve`` runs the ``serve`` scenario (the serving engines with their
batch split over the processes, ``serve/engine.py``) over 4 NCCL ranks of 2
units, a card a rank, in three clusters: (a) OLMoE-1B-7B at full width and
depth, bf16 compute over bf16 params, expert-parallel, 32 x 2,048-token
prompts + 16 new (8 rows a rank) through the static engine, the split run
twice; (b) Mamba2-1.3B at ``prefill_32k``'s own batch, 32 x 32,768 + 4 new
(8 rows a rank, bf16 over f32 params, the dry run's policy), each rank's
tokens held to a one-process engine on its 8 rows (the same shapes, so
bit-identical); (c) OLMoE-1B-7B as in (a) through the continuous engine:
32 slots (8 a rank, each rank holding only its slots' cache rows), 64
mixed requests (prompts of 1,024 and 2,048 tokens, 1-16 new, 4 arrivals a
step), each worker asserting that the tokens, the spans and the tuned
multiplexer are equal on every rank and that its pod-hop bytes equal the
count derived from the one-process engine's schedule.  It prints a line of
JSON a rank and run: prefill and decode ms, tokens/s (and for (c) TTFT and
the moved rows), the pod hop's bytes beside the derived count, the peak
memory, and for Mamba2 the dry run's count of the same cell on ``4x2``
(arguments plus peak live, counted on ``meta`` beside the workers).

``serve --runs tensor_f32,tensor`` runs the ``tensor_serve`` scenario
(tensor-parallel serving under ``distributed.sharding.tensor_rules``: every
rank the whole batch over its slices of the heads, ``d_ff`` and vocab, the
layers all-reducing and all-gathering over NCCL) in two clusters of the
same 4 ranks: (a) ``tensor_f32``, DeepSeek-67B at full width and 16 of its
95 layers, f32 with TF32 off, ``attn_impl="flash"``, 4 x 256 + 8 new,
held to rank 0's one-process engine on the whole tree (logits within
``rtol = atol = 2e-4``, greedy tokens equal, rank 0's placed params equal
to the whole tree's slices); (b) ``tensor``, DeepSeek-67B at all 95 layers
and Qwen1.5-32B at all 64 in bf16, 8 x 2,048 + 16 new, twice, with one
more decode step profiled.  A line of JSON a rank and cell: prefill ms and
tokens/s, decode ms a step, the pod hop's bytes against the count from the
shapes, params and cache counted on ``meta`` beside the peak, the flash
launches, the profiled step's all-reduce device time.

``serve --runs tensor_continuous_f32,tensor_continuous,tensor_continuous_67b``
runs the same scenario with ``--tp-mixed``: each cell's static run, then
a mixed workload through the continuous engine under the tensor table
(every rank every slot's cache rows of its kv heads), the static prompts
through it, and the mixed requests through ``generate_bucketed``: (c)
``tensor_continuous_f32``, OLMoE-1B-7B at all 16 layers in f32 with its
experts split (16 a rank), 16 slots, 32 mixed requests of 128 and 256
tokens, against rank 0's one-process engines on the whole tree; (d)
``tensor_continuous``, the same model in bf16 on the ``olmoe_continuous``
run's workload (32 slots, 64 requests of 1,024 and 2,048 tokens, 4 a
step); (e) ``tensor_continuous_67b``, DeepSeek-67B at all 95 layers in
bf16, 16 slots, 32 requests of 1,024 and 2,048 tokens, 2 a step.  A line
of JSON a rank: TTFT, new tokens/s, each prefill group's ms by prompt
length, ms a decode step, slot-steps beside ``generate_bucketed``'s, the
pod hop against the schedule's count, the peak beside the counts on
``meta``.

``serve --runs tensor_ssm_f32,tensor_ssm,tensor_long_500k`` runs the SSM and
hybrid families under the tensor table (each rank its SSM heads' slices of
every Mamba2 block, Zamba2's shared block split as a dense layer, the
static engine): (a) ``tensor_ssm_f32``, Mamba2-1.3B at all 48 layers on 8 x
2,048 + 8 and Zamba2-7B at all 81 (``attn_impl="flash"``) on 4 x 1,024 + 8,
f32 with TF32 off, each against rank 0's one-process engine on the whole
tree (27.0 GB for Zamba2) within ``2e-4``, tokens equal; (b)
``tensor_ssm``, bf16 over f32 params: Mamba2-1.3B's ``prefill_32k`` at its
batch of 32 (the ``mamba2`` run's row split, beside it) and Zamba2-7B on 8
x 2,048 + 16, twice; (c) ``tensor_long_500k``, two clusters: Mamba2-1.3B's
``long_500k`` in f32 (one 524,288-token prompt + 8 new) against rank 0's
one-process run of it, last-token logits and every rank's heads of the
prefill states within ``2e-4``; then Zamba2-7B's in bf16 over f32 params,
no one-process reference (no card holds it): tokens equal on every rank,
and the whole prefill's last-token logits beside a 524,032-token prefill
plus 256 decode steps, the last at position 524,287 (recorded).  A line of
JSON a rank and cell as for the other tensor runs, with the SSM heads a
rank and, for (c), the split check's numbers.

``serve --runs tensor_mla,tensor_encdec`` runs MLA and the encoder-decoder
under the tensor table: (j) ``tensor_mla``, two clusters: DeepSeek-V2-Lite-16B
at all 27 layers in bf16 (4 of 16 MLA heads of ``wq``, ``wk_b``, ``wv_b``
and ``wo``, the compressed cache whole, 16 of 64 experts a rank,
expert-parallel) on 8 x 2,048 + 16 and on ``tensor_continuous``'s mixed
workload through the continuous engine; then 12 layers in f32 against rank
0's one-process engines, both engines, each MoE call's routes against the
one-process run's; (k) ``tensor_encdec``, Whisper-medium at full depth (4 of
16 heads a rank): f32 against rank 0's one-process engine on 4 x 1,500
frames and prompt tokens + 32 new, then bf16 over f32 params on phase 10's
workload (the batch of 4 twice).  ``--runs tensor_long_500k_f32`` (i) runs
(h)'s Zamba2-7B split check in f32 at 13 of 81 layers.  With
``--tp-routes`` (``tensor_continuous_f32``, the f32 half of
``tensor_mla``) a rank's line carries every MoE call's flipped routes
against rank 0's one-process run and the router margins at them.

``layouts`` prints the cards' names, power limits and ``nvidia-smi topo
-m``, builds the kernels, then runs every scenario of
``tests/_torch_multiproc_driver.py`` in each layout (``backend:PxU``, P
processes of U units, one pod a process; NCCL takes a card a rank) with the
coarse hop timed per Q3 and Q17 edge.  Every 2 x 4 layout's integers (the
two-level shuffle, the hierarchical psum, Q3's order keys, every edge's
histogram, the drops, the streamed edges' reports) must equal the first
2 x 4 layout's; each layout's per-process results are written under
``<--out>/<layout>/`` (default ``artifacts/cluster_probe``, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
DRIVER = ROOT / "tests" / "_torch_multiproc_driver.py"

GLOO_CUDA_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.cluster import init_cluster
info = init_cluster()
import torch
import torch.distributed as dist
rank, R = info.process_id, info.num_processes
t = torch.arange(8, dtype=torch.int32, device="cuda") + rank


def all_reduce():
    x = t.clone()
    dist.all_reduce(x)
    return torch.equal(x.cpu(), sum(torch.arange(8, dtype=torch.int32) + r for r in range(R)))


def all_gather():
    out = [torch.empty_like(t) for _ in range(R)]
    dist.all_gather(out, t)
    return all(torch.equal(o.cpu(), torch.arange(8, dtype=torch.int32) + r)
               for r, o in enumerate(out))


def all_to_all_single():
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    want = torch.cat([(torch.arange(8, dtype=torch.int32) + r).view(R, -1)[rank]
                      for r in range(R)])
    return torch.equal(out.cpu(), want)


def send_recv():
    peer = (rank + 1) % R
    got = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                   dist.P2POp(dist.irecv, got, (rank - 1) % R)])
    for r in reqs:
        r.wait()
    return torch.equal(got.cpu(), torch.arange(8, dtype=torch.int32) + (rank - 1) % R)


for fn in (all_reduce, all_gather, all_to_all_single, send_recv):
    try:
        ok = fn()
        torch.cuda.synchronize()
        print(f"GLOO_CUDA {fn.__name__}: carried, {'right' if ok else 'WRONG'}")
    except Exception as e:  # noqa: BLE001 - the refusal is the finding
        print(f"GLOO_CUDA {fn.__name__}: refused: {type(e).__name__}: {str(e).splitlines()[0][:200]}")
dist.barrier()
dist.destroy_process_group()
"""


def _smi() -> str:
    """Prints the cards' names, power limits and topology; returns the
    names and power limits, one card after another."""
    lines = []
    for args in (["--query-gpu=name,power.limit", "--format=csv,noheader"], ["topo", "-m"]):
        out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        print(f"[smi] nvidia-smi {' '.join(args)}:\n{out.stdout.strip()}")
        lines.append(out.stdout.strip())
    return "; ".join(lines[0].splitlines())


def gloo_cuda() -> int:
    from repro_torch.launch.cluster import run_local_cluster

    _smi()
    outs = run_local_cluster(["-c", GLOO_CUDA_WORKER, str(SRC)], num_processes=2, local_units=1,
                             timeout_s=180, echo=False, backend="gloo", device="cuda")
    for pid, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("GLOO_CUDA"):
                print(f"[gloo-cuda] proc {pid}: {line}")
    return 0


def _integers(res: dict) -> dict:
    """What two 2 x 4 layouts must agree on, bit for bit."""
    tp = res["tpch_pod_mesh"]
    return {
        "two_level_shuffle": res["two_level_shuffle"],
        "hierarchical_psum": res["hierarchical_psum"]["int32"],
        "q3_orderkeys": tp["q3"]["orderkeys"],
        "edges": {q: {k: e["hist"] for k, e in tp[q]["edges"].items()} for q in ("q3", "q17")},
        "dropped": [tp[q]["dropped"] for q in ("q3", "q17")],
        "salted_edges": {k: e["hist"] for k, e in res["salted_pod_shuffle"]["edges"].items()},
        "oocore_reports": res["oocore_pod_stream"]["reports"],
    }


def layouts(specs: list[str], sf: float, morsel_rows: int, out: Path) -> int:
    import time

    from repro_torch.kernels import build
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.launch.cluster import run_local_cluster

    _smi()
    build.build_all((hp.LIBRARY, md.LIBRARY))
    first = None
    for spec in specs:
        backend, shape = spec.split(":")
        procs, units = (int(v) for v in shape.split("x"))
        dump = out / spec.replace(":", "_")
        t0 = time.perf_counter()
        outs = run_local_cluster(
            [str(DRIVER), "all", "--sf", str(sf), "--morsel-rows", str(morsel_rows),
             "--time-hop", "--dump", str(dump)],
            num_processes=procs, local_units=units, timeout_s=900, echo=False,
            backend=backend, device="cuda",
        )
        wall = time.perf_counter() - t0
        for pid, log in enumerate(outs):
            for line in log.splitlines():
                if line.startswith(("PASS", "[hop]")):
                    print(f"[{spec}] proc {pid}: {line}")
        dumps = [json.loads((dump / f"p{p}.json").read_text()) for p in range(procs)]
        for d in dumps[1:]:
            if _integers(d["results"]) != _integers(dumps[0]["results"]):
                raise AssertionError(f"{spec}: the processes disagree")
        print(f"[{spec}] all scenarios passed in {wall:.1f} s (launcher wall); seconds a "
              f"scenario on proc 0: {json.dumps(dumps[0]['seconds'])}")
        print(f"[{spec}] pack launches by process: {json.dumps([d['launches'] for d in dumps])}")
        if (procs, units) == (2, 4):
            if first is None:
                first = (spec, _integers(dumps[0]["results"]))
            elif _integers(dumps[0]["results"]) != first[1]:
                raise AssertionError(f"{spec}: integers differ from {first[0]}'s")
            else:
                print(f"[{spec}] integers bit-identical to {first[0]}'s")
    return 0


def _profile_args(profile: str | None) -> list[str]:
    return ["--profile", profile] if profile else []


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


#: the grid probe's f32 check: rank 0 holds the whole state beside its piece
GRID_CHECK_LAYERS = 8
#: the grid probe's data x model layout over its 4 ranks
GRID = "2x2"


def train_grid(out: Path, smi: str) -> int:
    import time

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.cluster import run_local_cluster
    from repro_torch.launch.mesh import parse_grid

    D, M = parse_grid(GRID)
    procs = D * M
    build.build_all((fa.LIBRARY,))
    tag = f"[train-grid nccl:{GRID}]"
    runs = {"check": ["--grid-cells", f"qwen2.5-3b:{GRID_CHECK_LAYERS}", "--grid-shape", "8x512",
                      "--grid-ref", "rank0", "--grid-steps", "2"],
            "deep": ["--grid-cells", "qwen2.5-3b", "--grid-shape", "8x2048", "--grid-ref",
                     "none", "--grid-steps", "3", "--grid-dtype", "bfloat16"]}
    for part, extra in runs.items():
        dump = out / f"grid_{part}_{GRID}"
        t0 = time.perf_counter()
        outs = run_local_cluster(
            [str(DRIVER), "grid_train", "--grid-full", "--grid-layouts", GRID, *extra,
             "--dump", str(dump)],
            num_processes=procs, local_units=1, timeout_s=900, echo=False, backend="nccl",
            device="cuda",
        )
        wall = time.perf_counter() - t0
        for pid, log in enumerate(outs):
            if "PASS grid_train" not in log:
                raise AssertionError(f"{tag} {part} rank {pid}: no PASS\n{log[-4000:]}")
        recs = [json.loads((dump / f"p{p}.json").read_text())["results"]["grid_train"]
                ["qwen2.5-3b"] for p in range(procs)]
        c = recs[0]["config"]
        print(f"{tag} {part}: Qwen2.5-3B full width, {c['layers']} layers, {c['dtype']} over "
              f"f32 params, remat {c['remat']}, flash; the whole f32 state (params, grads, m, v) "
              f"{recs[0]['whole_state_bytes']} B ({smi})")
        if part == "check":
            r0 = recs[0]["layouts"][GRID]
            print(f"{tag} check against rank 0's one-process step (steps "
                  + ", ".join(f"{w * 1e3:.1f}" for w in recs[0]["one_process_step_s"])
                  + f" ms, peak {recs[0]['one_process_peak']} B): loss rel {r0['loss_rel']:.3g}, "
                  f"worst gradient piece {r0['grad_rel']:.3g}, steps' grad norm rel "
                  + ", ".join(f"{v:.3g}" for v in r0["step_norm_rel"]) + ", params within "
                  + ", ".join(f"{v:.3g}" for v in r0["params_abs"]))
        for pid, rec in enumerate(recs):
            r = rec["layouts"][GRID]
            print(f"{tag} {part} rank {pid} at (data, model) {tuple(r['coords'])}: state "
                  f"{r['state_bytes']} B; steps " + ", ".join(f"{w * 1e3:.1f}" for w in r["step_s"])
                  + " ms; losses " + ", ".join(f"{m['loss']:.5f}" for m in r["metrics"])
                  + f"; peak {r['peak']} B; replicated identical {r['identical']}; bytes a step "
                  f"{r['step_hop'][0]} (the shapes' count {r['hop_want']}); flash_attention "
                  f"{r['launches']} a step")
        print(f"{tag} {part} passed in {wall:.1f} s (launcher wall)")
    return 0


def train(out: Path, arch: str, profile: bool = False) -> int:
    import tempfile
    import time

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.cluster import run_local_cluster

    backend, procs, units = "nccl", 4, 2
    smi = _smi()
    if arch == "qwen2.5-3b":
        return train_grid(out, smi)
    traces = tempfile.mkdtemp(prefix="probe_traces_") if profile else None
    if arch == "olmoe-1b-7b":
        return train_moe(out, backend, procs, units, traces, smi)
    build.build_all((fa.LIBRARY,))
    dump = out / f"dp_{backend}_{procs}x{units}"
    t0 = time.perf_counter()
    if traces:
        from repro_torch.configs import get_config

        meta = _chip_smoke()._count_on_meta(get_config("train100m").scaled(attn_impl="flash"),
                                            (8, 2048), (procs, units))
    outs = run_local_cluster(
        [str(DRIVER), "dp_train", "--dp-archs", "train100m", "--dp-full", "--dp-shape", "8x2048",
         "--dump", str(dump)] + _profile_args(traces),
        num_processes=procs, local_units=units, timeout_s=600, echo=False,
        backend=backend, device="cuda",
    )
    wall = time.perf_counter() - t0
    for pid, log in enumerate(outs):
        for line in log.splitlines():
            if line.startswith(("PASS", "[dp]")):
                print(f"[train {backend}:{procs}x{units}] proc {pid}: {line}")
    recs = [json.loads((dump / f"p{p}.json").read_text())["results"]["dp_train"]["train100m"]
            for p in range(procs)]
    for mode, m in recs[0]["modes"].items():
        print(f"[train {backend}:{procs}x{units}] {mode} against the one-process step: loss rel "
              f"{m['loss_rel']:.3g}, worst leaf {m['leaf_rel']:.3g}, first step's grad norm rel "
              f"{m['step_norm_rel'][0]:.3g}, params after 3 steps within {m['params_abs']:.3g}; "
              f"{m['step_hop_bytes'][0]} B a step on the pod hop (leaves {recs[0]['leaf_bytes']})")
        for pid, r in enumerate(recs):
            mr = r["modes"][mode]
            print(f"[train {backend}:{procs}x{units}] {mode} proc {pid}: steps "
                  + ", ".join(f"{w * 1e3:.1f}" for w in mr["step_s"])
                  + f" ms, first gradient (warm-up included) {mr['grad_s'] * 1e3:.1f} ms, sync "
                  f"alone {mr['sync_s'] * 1e3:.1f} ms, flash_attention {mr['launches']} a step")
    print(f"[train {backend}:{procs}x{units}] passed in {wall:.1f} s (launcher wall)")
    if traces:
        _chip_smoke()._profiled_steps(
            f"train {backend}:{procs}x{units}", meta, (procs, units), procs,
            [r["modes"]["auto"] for r in recs], {"all-reduce": recs[0]["leaf_bytes"]},
            "float32", smi)
    return 0


def train_moe(out: Path, backend: str, procs: int, units: int, traces: str | None,
              smi: str) -> int:
    import time

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.launch.cluster import run_local_cluster

    build.build_all((fa.LIBRARY, md.LIBRARY))
    dump = out / f"moe_{backend}_{procs}x{units}"
    tag = f"[train-moe {backend}:{procs}x{units}]"
    t0 = time.perf_counter()
    if traces:  # the 2-layer f32 cut at 8 x 1,024, and all 16 layers in bf16 at 8 x 2,048
        cs = _chip_smoke()
        cut = cs.moe_train_config(2)
        runs = {"check": (cs._count_on_meta(cut, (8, 1024), (procs, units)), cut.dtype),
                "deep": (cs._count_on_meta(cut.scaled(num_layers=16, dtype="bfloat16"),
                                           (8, 2048), (procs, units)), "bfloat16")}
    outs = run_local_cluster(
        [str(DRIVER), "moe_train", "--moe-full", "--moe-layers", "2", "--moe-shape", "8x1024",
         "--moe-deep-steps", "3", "--dump", str(dump)] + _profile_args(traces),
        num_processes=procs, local_units=units, timeout_s=900, echo=False,
        backend=backend, device="cuda",
    )
    wall = time.perf_counter() - t0
    for pid, log in enumerate(outs):
        for line in log.splitlines():
            if line.startswith(("PASS", "[moe]")):
                print(f"{tag} proc {pid}: {line}")
    recs = [json.loads((dump / f"p{p}.json").read_text())["results"]["moe_train"]
            for p in range(procs)]
    c = recs[0]["check"]
    print(f"{tag} 2-layer cut against rank 0's one-process step: loss rel {c['loss_rel']:.3g}, "
          f"worst leaf {c['leaf_rel']:.3g} (expert slices "
          + ", ".join(f"{k} {v:.3g}" for k, v in c["expert_slice_rel"].items())
          + f"), first grad norm rel {c['step_norm_rel'][0]:.3g}, drops bit-exact "
          f"{c['drops_equal']}, init equal {c['init_equal']}, params after 3 steps within "
          f"{c['params_abs']:.3g}; rank 0's seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in c["parts_s"].items()))
    for pid, r in enumerate(recs):
        for part in ("check", "deep"):
            m = r[part]
            hop = m["step_hop_bytes"][0]
            print(f"{tag} {part} proc {pid}: {m['layers']} layers, state {m['state_bytes']} B, "
                  f"steps " + ", ".join(f"{w * 1e3:.1f}" for w in m["step_s"])
                  + f" ms, losses " + ", ".join(f"{x['loss']:.5f}" for x in m["metrics"])
                  + f", pod hop {hop} B a step, peak {m['peak']} B, launches a step "
                  f"{m['launches'][0]}")
    print(f"{tag} passed in {wall:.1f} s (launcher wall)")
    if traces:
        for part, (meta, dtype) in runs.items():
            cs._profiled_steps(f"{tag.strip('[]')} {part}", meta, (procs, units), procs,
                               [r[part] for r in recs], cs.moe_collectives(recs[0][part]),
                               dtype, smi)
    return 0


SERVE_RUNS = {
    # (a) OLMoE-1B-7B, all 16 layers, bf16 over bf16 params, expert-parallel,
    # 8 rows a rank; the split run twice (the first warms the kernels)
    "olmoe": ["--serve-cells", "olmoe-1b-7b:0:32x2048x16", "--serve-dtype", "bfloat16",
              "--serve-param-dtype", "bfloat16", "--serve-ref", "none", "--serve-repeat", "2"],
    # (b) Mamba2-1.3B at prefill_32k's own batch of 32 (8 rows a rank), the dry
    # run's policy (bf16 over f32 params), each rank held to a one-process
    # engine on its own rows
    "mamba2": ["--serve-cells", "mamba2-1.3b:0:32x32768x4", "--serve-dtype", "bfloat16",
               "--serve-param-dtype", "float32", "--serve-ref", "rows"],
    # (c) OLMoE-1B-7B as in (a) through the continuous engine: 32 slots (8 a
    # rank), 64 mixed requests, prompts 1,024 and 2,048, 1-16 new, 4 a step
    "olmoe_continuous": ["--serve-cells", "", "--serve-continuous", "olmoe-1b-7b:0:32x64x16",
                         "--serve-prompts", "1024,2048", "--serve-rate", "4",
                         "--serve-dtype", "bfloat16", "--serve-param-dtype", "bfloat16",
                         "--serve-ref", "none"],
}
#: Tensor-parallel serving (the ``tensor_serve`` scenario, the tensor table):
#: every rank the whole batch over its slices of the heads, d_ff and vocab.
TENSOR_RUNS = {
    # (a) DeepSeek-67B at full width, 16 of its 95 layers (as deep as rank 0
    # holds the whole tree in f32 beside its own quarter: ~51 + ~13 GB), f32
    # params and compute, TF32 off, attn_impl="flash", held to rank 0's
    # one-process engine on the whole tree within rtol = atol = 2e-4
    "tensor_f32": ["--tp-cells", "deepseek-67b:16:4x256x8", "--tp-ref", "whole",
                   "--tp-dtype", "float32", "--tp-param-dtype", "float32"],
    # (b) DeepSeek-67B at all 95 layers and Qwen1.5-32B at all 64, bf16 params and
    # compute, 8 x 2,048 + 16 new, the run twice (the first warms the kernels),
    # one more decode step profiled (the all-reduce's device time)
    "tensor": ["--tp-cells", "deepseek-67b:0:8x2048x16,qwen1.5-32b:0:8x2048x16",
               "--tp-ref", "none", "--tp-dtype", "bfloat16",
               "--tp-param-dtype", "bfloat16", "--tp-repeat", "2", "--tp-profile"],
    # (c) the continuous engine's f32 gate: OLMoE-1B-7B at all 16 layers with
    # its experts split (16 of 64 a rank), f32 with TF32 off, rank 0's
    # one-process engines on the whole 27.7 GB tree beside its quarter: the
    # static engine on 16 x 256 + 8, then 16 slots and 32 mixed requests
    # (128 and 256 tokens, 1-8 new, 2 a step), logits within 2e-4, tokens equal
    # (since PR 36 with every MoE call's routes against rank 0's one-process
    # runs: the flipped routes and the router margins at them, ROADMAP §C.3)
    "tensor_continuous_f32": ["--tp-cells", "olmoe-1b-7b:0:16x256x8", "--tp-ref", "whole",
                              "--tp-dtype", "float32", "--tp-param-dtype", "float32",
                              "--tp-mixed", "16x32x8", "--serve-prompts", "128,256",
                              "--serve-rate", "2", "--tp-routes"],
    # (d) OLMoE-1B-7B at all 16 layers in bf16 under the tensor table (4 q and
    # 4 kv heads and 16 experts a rank) on the split-rows engine's workload
    # (the "olmoe_continuous" run): 32 slots, 64 mixed requests of 1,024 and
    # 2,048 tokens, 1-16 new, 4 a step; the static engine on 32 x 2,048 + 16
    "tensor_continuous": ["--tp-cells", "olmoe-1b-7b:0:32x2048x16", "--tp-ref", "none",
                          "--tp-dtype", "bfloat16", "--tp-param-dtype", "bfloat16",
                          "--tp-mixed", "32x64x16", "--serve-prompts", "1024,2048",
                          "--serve-rate", "4"],
    # (e) DeepSeek-67B at all 95 layers in bf16 through the continuous engine:
    # 16 slots, 32 mixed requests of 1,024 and 2,048 tokens, 1-16 new, 2 a
    # step; the static engine on 16 x 2,048 + 16
    "tensor_continuous_67b": ["--tp-cells", "deepseek-67b:0:16x2048x16", "--tp-ref", "none",
                              "--tp-dtype", "bfloat16", "--tp-param-dtype", "bfloat16",
                              "--tp-mixed", "16x32x16", "--serve-prompts", "1024,2048",
                              "--serve-rate", "2"],
    # (f) the SSM and hybrid families' f32 gate: Mamba2-1.3B at all 48 layers
    # (16 of 64 SSM heads a rank) and Zamba2-7B at all 81 (28 of 112, 8 q and 8
    # kv heads at D = 112), f32 with TF32 off, rank 0's one-process engine on
    # the whole tree first (Zamba2's 27.0 GB beside its 6.75 GB quarter)
    "tensor_ssm_f32": ["--tp-cells", "mamba2-1.3b:0:8x2048x8,zamba2-7b:0:4x1024x8",
                       "--tp-ref", "whole", "--tp-dtype", "float32",
                       "--tp-param-dtype", "float32"],
    # (g) bf16 over f32 params (the dry run's policy): Mamba2-1.3B's
    # prefill_32k at its batch of 32 (the "mamba2" run's cell under the row
    # split) and Zamba2-7B at all 81 layers on 8 x 2,048 + 16, twice
    "tensor_ssm": ["--tp-cells", "mamba2-1.3b:0:32x32768x4,zamba2-7b:0:8x2048x16",
                   "--tp-ref", "none", "--tp-dtype", "bfloat16", "--tp-param-dtype", "float32",
                   "--tp-repeat", "2"],
    # (h) the long_500k cell, two clusters: Mamba2-1.3B in f32 against rank
    # 0's one-process run (logits and each rank's heads of the prefill states);
    # Zamba2-7B in bf16 over f32 params (no card holds it whole: 125.1 GB
    # counted), the whole prefill against 524,032 tokens + 256 decode steps
    "tensor_long_500k": [
        ["--tp-cells", "mamba2-1.3b:0:1x524288x8", "--tp-ref", "whole", "--tp-states",
         "--tp-dtype", "float32", "--tp-param-dtype", "float32"],
        ["--tp-cells", "zamba2-7b:0:1x524288x8", "--tp-ref", "none", "--tp-split", "256",
         "--tp-dtype", "bfloat16", "--tp-param-dtype", "float32"],
    ],
    # (i) Zamba2-7B's long_500k split check in f32 at 13 of 81 layers (two
    # shared-block calls, ~7.5 GB of KV cache a rank), to tell bf16 rounding
    # from a fault in (h)'s bf16 gap (ROADMAP §C.4)
    "tensor_long_500k_f32": ["--tp-cells", "zamba2-7b:13:1x524288x8", "--tp-ref", "none",
                             "--tp-split", "256", "--tp-dtype", "float32",
                             "--tp-param-dtype", "float32"],
    # (j) MLA under the tensor table, two clusters: DeepSeek-V2-Lite-16B at all
    # 27 layers in bf16 (4 of 16 MLA heads, 16 of 64 experts a rank,
    # expert-parallel over the 8 units), 8 x 2,048 + 16 through the static
    # engine and the tensor_continuous run's workload (32 slots, 64 requests of
    # 1,024 and 2,048 tokens, 1-16 new, 4 a step) through the continuous one;
    # then 12 of 27 layers in f32 with TF32 off against rank 0's one-process
    # engines on the whole ~27.9 GB tree beside its quarter (16 x 256 + 8,
    # then 16 slots and 32 mixed requests of 128 and 256 tokens), every MoE
    # call's routes held to the one-process run's
    "tensor_mla": [
        ["--tp-cells", "deepseek-v2-lite-16b:0:8x2048x16:0:ep", "--tp-ref", "none",
         "--tp-dtype", "bfloat16", "--tp-param-dtype", "bfloat16", "--tp-mixed", "32x64x16",
         "--serve-prompts", "1024,2048", "--serve-rate", "4"],
        ["--tp-cells", "deepseek-v2-lite-16b:12:16x256x8:0:ep", "--tp-ref", "whole",
         "--tp-dtype", "float32", "--tp-param-dtype", "float32", "--tp-mixed", "16x32x8",
         "--serve-prompts", "128,256", "--serve-rate", "2", "--tp-routes"],
    ],
    # (k) the encoder-decoder under the tensor table, two clusters:
    # Whisper-medium at full depth (24 + 24 layers, 4 q and 4 kv heads a rank)
    # in f32 with TF32 off against rank 0's one-process engine, 4 requests of
    # 1,500 frames and 1,500 prompt tokens + 32 new, attn_impl="flash"; then
    # bf16 over f32 params on phase 10's workload (8 x 1,500 + 32 at batch 4:
    # the batch of 4 twice)
    "tensor_encdec": [
        ["--tp-cells", "whisper-medium:0:4x1500x32", "--tp-ref", "whole",
         "--tp-dtype", "float32", "--tp-param-dtype", "float32"],
        ["--tp-cells", "whisper-medium:0:4x1500x32", "--tp-ref", "none",
         "--tp-dtype", "bfloat16", "--tp-param-dtype", "float32", "--tp-repeat", "2"],
    ],
}


def serve(out: Path, runs: list[str]) -> int:
    """The serving engines' batch split over 4 NCCL ranks of 2 units, a card
    a rank: the driver's ``serve`` scenario for each of ``runs`` (names in
    ``SERVE_RUNS``), each in its own cluster.  Prints each rank's prefill and
    decode ms, tokens/s, pod-hop bytes and peak memory (for the continuous
    run also TTFT and the moved rows), and for Mamba2 the peak beside the
    dry run's count of ``prefill_32k`` on ``4x2`` (arguments plus peak
    live)."""
    import threading
    import time

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.launch import dryrun
    from repro_torch.launch.cluster import run_local_cluster

    backend, procs, units = "nccl", 4, 2
    smi = _smi()
    build.build_all((md.LIBRARY, sk.LIBRARY, fa.LIBRARY))
    counted = {}

    def count():  # rank 0's program on meta, beside the workers
        cfg = dryrun.dryrun_config("mamba2-1.3b", SHAPES["prefill_32k"], multi_pod=True)
        counted.update(dryrun.count_cell(cfg, SHAPES["prefill_32k"], procs, units))

    counter = threading.Thread(target=count)
    if "mamba2" in runs:
        counter.start()
    for name in runs:
        tag = f"[serve {name} {backend}:{procs}x{units}]"
        dump = out / f"serve_{name}_{backend}_{procs}x{units}"
        t0 = time.perf_counter()
        if name in TENSOR_RUNS:  # one cluster, or several in turn, each its dump
            runs_of = TENSOR_RUNS[name]
            clusters = [runs_of] if isinstance(runs_of[0], str) else runs_of
            dumps = [dump if len(clusters) == 1 else dump / str(i) for i in range(len(clusters))]
            argvs = [[str(DRIVER), "tensor_serve", "--tp-full", "--dump", str(d)] + a
                     for d, a in zip(dumps, clusters)]
        else:
            dumps = [dump]
            argvs = [[str(DRIVER), "serve", "--serve-full", "--dump", str(dump)]
                     + SERVE_RUNS[name]]
        for argv, d in zip(argvs, dumps):
            try:
                outs = run_local_cluster(argv, num_processes=procs, local_units=units,
                                         timeout_s=900, echo=False, backend=backend,
                                         device="cuda")
            except RuntimeError as e:  # every worker's log, whole, where the caller can read it
                d.mkdir(parents=True, exist_ok=True)
                (d / "failure.log").write_text(str(e))
                for line in str(e).splitlines():
                    if "FAIL" in line or "Error:" in line and "c10" not in line:
                        print(f"{tag} {line[:2000]}")
                raise
            for pid, log in enumerate(outs):
                for line in log.splitlines():
                    if line.startswith(("PASS", "[serve]", "[tensor-serve]")):
                        print(f"{tag} proc {pid}: {line}")
            if name in TENSOR_RUNS:
                _tensor_lines(tag, d, procs, smi)
        wall = time.perf_counter() - t0
        if name in TENSOR_RUNS:
            print(f"{tag} passed in {wall:.1f} s (launcher wall)")
            continue
        recs = [json.loads((dump / f"p{p}.json").read_text())["results"]["serve"]
                for p in range(procs)]
        if name == "mamba2":
            counter.join()
        for pid, rec in enumerate(recs):
            for arch, r in rec["archs"].items():
                B, S, new = r["shape"]
                rows = B // procs
                line = {"rank": pid, "arch": arch, "layers": r["layers"], "dtype": r["dtype"],
                        "param_dtype": r["param_dtype"], "rows": r["rows"],
                        "rows_a_rank": rows, "prompt": S, "new": new,
                        "prefill_ms": [p[0] * 1e3 for p in r["prefill_s"]],
                        "prefill_tok_s": [rows * S / p[0] for p in r["prefill_s"]],
                        "decode_ms_a_step": [1e3 * sum(d) / max(len(d), 1)
                                             for d in r["decode_s"]],
                        "decode_tok_s": [rows * len(d) / sum(d) if d else None
                                         for d in r["decode_s"]],
                        "pod_hop_bytes": r["hop_bytes"], "pod_hop_derived": r["want_hop"],
                        "pod_hop_kinds": r["hop_kinds"], "peak": r["peak"],
                        "launches": r["launches"], "expert_calls": r["expert_calls"],
                        "tokens_repeat_equal": r["tokens_repeat_equal"], "nvidia_smi": smi}
                if "one_process" in r:
                    one = r["one_process"]
                    line.update(tokens_equal_one_process=r["tokens_equal"],
                                logits_bit_equal=r.get("logits_bit_equal"),
                                logit_rel=max(r["logit_rel"]),
                                one_process_prefill_ms=one["prefill_s"][0] * 1e3,
                                one_process_peak=one["peak"])
                if name == "mamba2":
                    model = counted["argument_bytes"] + counted["peak_live_bytes"]
                    line.update(dryrun_args_plus_peak_live=model,
                                peak_over_dryrun=r["peak"] / model if r["peak"] else None)
                print(f"{tag} rank {pid}: {json.dumps(line)}")
            for arch, r in rec["continuous"].items():
                slots, n_req, new = r["shape"]
                n = len(r["decode_s"])
                line = {"rank": pid, "arch": arch, "engine": "continuous", "layers": r["layers"],
                        "dtype": r["dtype"], "param_dtype": r["param_dtype"], "rows": r["rows"],
                        "slots": slots, "slots_a_rank": slots // procs, "requests": n_req,
                        "prompts": r["prompts"], "max_new": new, "rate": r["rate"],
                        "prefill_groups": len(r["prefill_s"]),
                        "prefill_ms": [p * 1e3 for p in r["prefill_s"]],
                        "decode_steps": n, "decode_ms_a_step": 1e3 * sum(r["decode_s"]) / max(n, 1),
                        "record": r["record"], "moved_rows": r["stats"]["moved_rows"],
                        "sent_rows": r["want_hop"]["sent_rows"],
                        "moved_row_bytes": r["want_hop"]["moved_row_bytes"],
                        "pod_hop_bytes": r["hop_bytes"], "pod_hop_derived": r["want_hop"],
                        "pod_hop_kinds": r["hop_kinds"], "cache_bytes": r["cache_bytes"],
                        "whole_cache_bytes": r["whole_cache_bytes"], "peak": r["peak"],
                        "launches": r["launches"], "expert_calls": r["expert_calls"],
                        "equal_on_every_process": r["equal_on_every_process"], "mux": r["mux"],
                        "nvidia_smi": smi}
                print(f"{tag} rank {pid}: {json.dumps(line)}")
        print(f"{tag} passed in {wall:.1f} s (launcher wall)")
    if "mamba2" in runs:
        counter.join()
        print(f"[serve] the dry run's count of mamba2-1.3b x prefill_32k x 4x2 (rank 0, meta): "
              f"arguments {counted['argument_bytes']} B + peak live {counted['peak_live_bytes']} B "
              f"in {counted['count_s']:.1f} s")
    return 0


def _tensor_lines(tag: str, dump: Path, procs: int, smi: str) -> None:
    """A line of JSON a rank and cell of a tensor-parallel run: prefill ms
    and tokens/s (the whole batch, which every rank serves), decode ms a
    step, the pod hop's bytes by kind beside the count from the shapes, the
    params and cache counted on ``meta`` beside the peak, the flash launches,
    the tokens equal on every rank, against rank 0's one-process engine
    where there is one, and the profiled decode step's collectives."""
    recs = [json.loads((dump / f"p{p}.json").read_text())["results"]["tensor_serve"]
            for p in range(procs)]
    for pid, rec in enumerate(recs):
        for arch, r in rec["archs"].items():
            B, S, new = r["shape"]
            ls = r["leaf_shapes"]
            attn = next((k[:-2] for k in ("seg0/0/attn/wq", "shared/attn/wq", "encoder/0/attn/wq")
                         if k in ls), None)
            ssm = next((k for k in ("layers/0/mamba/A_log", "groups/0/0/mamba/A_log")
                        if k in ls), None)
            line = {"rank": pid, "arch": arch, "layers": r["layers"], "dtype": r["dtype"],
                    "param_dtype": r["param_dtype"], "attn_impl": r["attn_impl"],
                    "rows": r["rows"], "batch": B, "prompt": S, "new": new,
                    "q_heads_a_rank": ls[attn + "wq"][1] if attn else None,
                    "kv_heads_a_rank": ls[attn + "wk"][1] if attn and attn + "wk" in ls else None,
                    "ssm_heads_a_rank": ls[ssm][0] if ssm else None,
                    "prefill_ms": [p[0] * 1e3 for p in r["prefill_s"]],
                    "prefill_tok_s": [B * S / p[0] for p in r["prefill_s"]],
                    "decode_ms_a_step": [1e3 * sum(d) / max(len(d), 1) for d in r["decode_s"]],
                    "decode_tok_s": [B * len(d) / sum(d) if d else None for d in r["decode_s"]],
                    "pod_hop_bytes": r["hop_bytes"], "pod_hop_kinds": r["hop_kinds"],
                    "pod_hop_derived": r["want_hop"],
                    "param_bytes_counted": r["param_bytes_counted"],
                    "cache_bytes_counted": r["cache_bytes_counted"], "peak": r["peak"],
                    "launches": r["launches"],
                    "tokens_equal_on_every_rank": r["tokens_equal_on_every_process"],
                    "tokens_repeat_equal": r["tokens_repeat_equal"], "seconds": r["seconds"],
                    "nvidia_smi": smi}
            if "logit_abs" in r:
                line.update(logits_close=r["logits_close"], logit_abs_max=max(r["logit_abs"]),
                            tokens_equal_one_process=r["tokens_equal"])
            if "one_process" in r:
                one = r["one_process"]
                line.update(params_equal_slices=r["params_equal_slices"],
                            one_process_prefill_ms=one["prefill_s"][0] * 1e3,
                            one_process_decode_ms_a_step=1e3 * sum(one["decode_s"])
                            / max(len(one["decode_s"]), 1),
                            one_process_peak=one["peak"])
            if "decode_profile" in r:
                line["decode_profile"] = r["decode_profile"]
            if "state_abs" in r:
                line.update(states_close=r["states_close"], state_abs=r["state_abs"])
            if "split" in r:
                line["split"] = r["split"]
            for k in ("routes", "continuous_refused", "want_flash"):
                if k in r:
                    line[k] = r[k]
            print(f"{tag} rank {pid}: {json.dumps(line)}")
            if "continuous" in r:
                print(f"{tag} rank {pid}: {json.dumps(_continuous_line(pid, arch, r, smi))}")


def _continuous_line(pid: int, arch: str, r: dict, smi: str) -> dict:
    """A tensor-parallel continuous run's line: TTFT, new tokens/s, each
    prefill group's ms by prompt length, ms a decode step, slot-steps beside
    ``generate_bucketed``'s, the pod hop against the schedule's count, the
    peak beside the params and cache counted on ``meta``, the tokens equal
    on every rank, and where rank 0 ran them, against its one-process
    engine."""
    c = r["continuous"]
    slots, n_req, new = c["shape"]
    by_len: dict = {}
    for plen, s in zip(c["group_lengths"], c["prefill_s"]):
        by_len.setdefault(plen, []).append(s * 1e3)
    n = len(c["decode_s"])
    line = {"rank": pid, "arch": arch, "engine": "continuous", "layers": r["layers"],
            "dtype": r["dtype"], "rows": c["rows"], "slots": slots, "requests": n_req,
            "prompts": c["prompts"], "max_new": new, "rate": c["rate"],
            "ttft_mean_s": c["record"].get("ttft_mean_s"),
            "ttft_p99_s": c["record"].get("ttft_p99_s"), "new_tok_s": c["record"]["tok_s"],
            "record": c["record"], "prefill_groups": c["groups"],
            "prefill_ms_by_len": {k: [min(v), sum(v) / len(v), max(v)] for k, v in by_len.items()},
            "decode_steps": n, "decode_ms_a_step": 1e3 * sum(c["decode_s"]) / max(n, 1),
            "slot_steps": c["stats"]["slot_steps"], "bucketed": c["bucketed"],
            "uniform_equal_static": c.get("uniform_equal_static"), "paths": c["paths"],
            "pod_hop_bytes": c["hop_bytes"], "pod_hop_kinds": c["hop_kinds"],
            "pod_hop_derived": c["want_hop"], "param_bytes_counted": r["param_bytes_counted"],
            "cache_bytes_counted": c["cache_bytes_counted"], "peak": c["peak"],
            "launches": c["launches"], "mux": c["mux"],
            "equal_on_every_rank": c["equal_on_every_process"], "nvidia_smi": smi}
    if "one_process" in c:
        one = c["one_process"]
        line.update(logits_close=one["logits_close"], logit_abs_max=max(one["logit_abs"]),
                    prefill_logit_abs_max=max(one["prefill_logit_abs"]),
                    tokens_equal_one_process=one["tokens_equal"],
                    stats_spans_steps_drops_equal=[one[k] for k in (
                        "stats_equal", "spans_equal", "steps_equal", "drops_equal")],
                    drops=sum(one["drops"]), one_process=r["one_process_continuous"])
        if "routes" in one:
            line["routes"] = one["routes"]
    return line


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("gloo-cuda", "layouts", "train", "serve"))
    ap.add_argument("--layouts", default="gloo:2x4,nccl:2x4,nccl:4x2")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--morsel-rows", type=int, default=1 << 20)
    ap.add_argument("--out", type=Path, default=ROOT / "artifacts" / "cluster_probe")
    ap.add_argument("--arch", choices=("train100m", "olmoe-1b-7b", "qwen2.5-3b"),
                    default="train100m")
    ap.add_argument("--runs", default=",".join(SERVE_RUNS),
                    help="serve: which of " + ", ".join(list(SERVE_RUNS) + list(TENSOR_RUNS))
                         + ", comma-separated (default the first three)")
    ap.add_argument("--profile", action="store_true",
                    help="train: one step a rank counted and one profiled (see above)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("torch_cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.mode == "gloo-cuda":
        return gloo_cuda()
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "train":
        return train(args.out, args.arch, args.profile)
    if args.mode == "serve":
        return serve(args.out, args.runs.split(","))
    return layouts(args.layouts.split(","), args.sf, args.morsel_rows, args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
