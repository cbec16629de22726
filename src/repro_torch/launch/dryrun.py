"""The dry run: count every (arch x shape x layout) cell on the ``meta``
device, with no card (the port's counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A|all]
        [--shape S|all] [--mesh single|multi|both] [--out DIR] [--set k=v]

The reference lowers and compiles each cell for 256 or 512 fake TPU devices
and reads XLA's cost and memory analyses.  The port runs eagerly: a cell
runs once on ``meta`` (shapes only, nothing allocated) under
:mod:`~repro_torch.launch.op_cost`'s counter.  Its artifact has the
reference's keys, but ``count_s`` in place of ``lower_s`` and
``compile_s``, and neither ``xla_cost_analysis`` nor ``hlo_bytes``;
``memory_analysis`` holds this process's argument and output bytes, the
counter's ``peak_live_bytes`` as ``temp_size_in_bytes``, and the card's
80 GB.  The ``roofline`` row divides by ``H100_SXM``'s published peaks.

**Layouts.**  The reference's meshes are 256 and 512 TPU chips (16 x 16 and
2 x 16 x 16), split by tensor parallelism and FSDP.  The port has neither:
it replicates every leaf but the MoE experts, which sit over the units
(ROADMAP §C), so those meshes have no counterpart.  The dry run counts the
layouts the port runs instead, pinned as the reference pins its meshes:

* ``single`` = ``"1x8"``: one process on one card, a mesh of 8 units (the
  layout of ``chip_smoke.py``'s serving cells);
* ``multi`` = ``"4x2"``: four processes, a card each, one pod a process of
  2 units (the four-card probe's layout).  Rank 0's program is counted in
  this one process under torch's ``fake`` process group, whose collectives
  return at once (on ``meta`` nothing moves); every rank runs the same
  program on its own rows and experts.

**A cell.**  Train cells run ``make_train_step`` under ``grad_sync="auto"``
on this process's rows.  A step of ``n > 2`` microbatches is counted at two
(so the count holds the accumulation's own form) and one microbatch's work
(the op counter's ``"microbatch"`` region: its gradient and its
accumulation) is added ``n - 2`` times more, the counterpart of the
reference's trip-count multiplication; the rest of the step (the gradient
sync and the AdamW update) counts once.  The result equals the looped
step's count key for key (``tests/test_torch_dryrun.py``).  Prefill and decode cells run ``api.prefill`` and
``api.decode_step`` under the mesh context, as the static serving engine
runs them: on ``4x2`` each rank takes its ``B / 4`` rows of the batch and a
cache of as many rows, the MoE layer under ``moe_tokens="local"``, where 4
divides the batch; a batch it does not divide (``long_500k``'s one row)
is counted whole, replicated on every rank, as the reference drops a mesh
axis that does not divide a dim.  A MoE cell runs under the two-level
multiplexer with the kernel pack, as the card does.  ``long_500k`` for the
attention archs is ``skipped`` with the reference's reason.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config, shapes_for
from ..configs.base import SHAPES, ModelConfig, ShapeSpec
from ..core.exchange import Mesh, make_mesh
from ..core.multiplexer import make_multiplexer, use_multiplexer
from ..core.topology import H100_SXM
from ..distributed.sharding import MeshContext, local_rows, mesh_context, split_rows
from ..models import registry as R
from ..train import AdamWConfig
from ..train.step import TrainState, make_train_step, state_shardings
from ..tree import leaves
from . import op_cost
from . import roofline as RL

# Per-arch microbatch counts for train_4k (the reference's).
MICROBATCHES = {
    "deepseek-67b": 16,
    "qwen1.5-32b": 16,
    "zamba2-7b": 8,
    "minicpm-2b": 4,
    "qwen2.5-3b": 4,
    "deepseek-v2-lite-16b": 4,
    "olmoe-1b-7b": 4,
    "mamba2-1.3b": 4,
    "whisper-medium": 4,
    "qwen2-vl-2b": 4,
}

#: name, chips, processes, units a process
LAYOUTS = {False: ("1x8", 1, 1, 8), True: ("4x2", 4, 4, 2)}

LONG_CONTEXT_REASON = "pure full-attention arch; sub-quadratic required (DESIGN.md)"


def dryrun_config(
    arch: str, shape: ShapeSpec, overrides: dict | None = None, multi_pod: bool = False
) -> ModelConfig:
    """The execution policy used on the production mesh (not the smoke one)."""
    cfg = get_config(arch)
    over: dict = dict(dtype="bfloat16", remat="block", scan_layers=True)
    if shape.kind == "train":
        # each microbatch must still cover every data-parallel lane
        lanes = 32 if multi_pod else 16
        over["num_microbatches"] = min(
            MICROBATCHES.get(arch, 4), shape.global_batch // lanes
        )
    if cfg.num_experts:
        # EP exchange for bulk shapes; replicate-and-reduce at decode
        over["moe_impl"] = "ep_shardmap" if shape.kind != "decode" else "gspmd"
    if overrides:
        over.update(overrides)
    return cfg.scaled(**over)


@contextlib.contextmanager
def fake_processes(world_size: int):
    """This process as rank 0 of ``world_size`` under torch's ``fake``
    process group (none for one process); destroyed on exit."""
    if world_size == 1:
        yield None
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run counts rank 0 under a fake process group of its own; "
                           "a process group is already initialized here")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def layout_mesh(processes: int, units: int, group: Any = None) -> Mesh:
    """One process: a one-pod mesh of ``units``; more: one pod a process of
    ``units`` each, this process rank 0."""
    if processes == 1:
        return make_mesh(units)
    return Mesh(processes, units, processes, 0, group)


def _nbytes(tree: Any) -> int:
    if isinstance(tree, tuple):  # an argument or result tuple (``tree`` takes it for a leaf)
        return sum(_nbytes(t) for t in tree)
    return sum(t.numel() * t.element_size() for t in leaves(tree) if isinstance(t, torch.Tensor))


def build_cell(api: R.ModelApi, shape: ShapeSpec, ctx: MeshContext):
    """``(fn, args)`` of one cell on ``meta``, for this process: a train
    step on its rows; a prefill or a decode step on its ``B / R`` rows and
    a cache of as many where the ``R`` processes divide the batch (the
    static engine's split), the whole batch and cache where they do not."""
    cfg = api.cfg
    batch, _ = R.input_specs(cfg, shape)
    if shape.kind == "train":
        step = make_train_step(api, AdamWConfig(schedule=cfg.lr_schedule))
        state = TrainState.create(api, 0, device="meta", shardings=state_shardings(api, ctx))
        return step, (state, local_rows(batch, ctx.mesh))
    rows = shape.global_batch
    if split_rows(rows, ctx.mesh):
        batch = local_rows(batch, ctx.mesh)
        rows //= ctx.mesh.num_processes
    params, _ = R.param_shape_specs(cfg)
    if shape.kind == "prefill":
        return api.prefill, (params, batch)
    cache, _ = R.cache_shape_specs(cfg, dataclasses.replace(shape, global_batch=rows))
    return api.decode_step, (params, batch["tokens"], cache, shape.seq_len - 1)


def _count(api, shape: ShapeSpec, ctx: MeshContext) -> dict:
    """The op counter's result for one cell, a train step's microbatches
    multiplied out, and the arguments' and outputs' bytes."""
    cfg = api.cfg
    n_mb = max(cfg.num_microbatches, 1) if shape.kind == "train" else 1
    if n_mb > 2:  # count two microbatches (the accumulation's form) and multiply
        api = R.build(cfg.scaled(num_microbatches=2))
    fn, args = build_cell(api, shape, ctx)
    if n_mb > 2:
        state, rows = args
        keep = 2 * next(iter(rows.values())).shape[0] // n_mb
        args = (state, {k: v[:keep] for k, v in rows.items()})
    counter = op_cost.OpCounter()
    with counter.counting():
        out = fn(*args)
    res = counter.result()
    res["argument_bytes"] = _nbytes(args)
    res["output_bytes"] = _nbytes(out)
    if n_mb > 2:
        mb = res["regions"]["microbatch"]
        extra = n_mb - 2
        res["flops"] += extra * mb["flops"] // 2
        res["bytes"] += extra * mb["bytes"] // 2
        res["collective_bytes"] = {k: v + extra * mb["collective_bytes"].get(k, 0) // 2
                                   for k, v in res["collective_bytes"].items()}
        res["argument_bytes"] = _nbytes(args[0]) + n_mb * _nbytes(args[1]) // 2
    return res


def count_cell(cfg: ModelConfig, shape: ShapeSpec, processes: int, units: int) -> dict:
    """Count one cell of ``cfg`` at ``shape`` on ``processes`` x ``units``
    (rank 0's program): the op counter's keys, ``argument_bytes``,
    ``output_bytes`` and ``count_s``."""
    t0 = time.perf_counter()
    with fake_processes(processes) as group:
        mesh = layout_mesh(processes, units, group)
        ctx = MeshContext(mesh)
        api = R.build(cfg)
        mux = (use_multiplexer(make_multiplexer(mesh, pack_impl="cuda"))
               if cfg.num_experts and cfg.moe_impl == "ep_shardmap" else contextlib.nullcontext())
        if shape.kind != "train" and split_rows(shape.global_batch, mesh):
            ctx = dataclasses.replace(ctx, moe_tokens="local")  # each rank's own tokens
        with mesh_context(ctx), mux, torch.no_grad() if shape.kind != "train" else \
                contextlib.nullcontext():
            res = _count(api, shape, ctx)
    res["count_s"] = time.perf_counter() - t0
    return res


def _write(art: dict, out_dir: str | None, tag: str = "") -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{art['arch']}__{art['shape']}__{art['mesh']}{('__' + tag) if tag else ''}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(art, f, indent=1, default=str)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: str | None = None,
    overrides: dict | None = None,
    verbose: bool = True,
) -> dict:
    shape = SHAPES[shape_name]
    overrides = dict(overrides or {})
    tag = overrides.pop("tag", "")
    cfg = dryrun_config(arch, shape, overrides, multi_pod=multi_pod)
    mesh_name, chips, processes, units = LAYOUTS[multi_pod]

    reason = None
    if shape.name == "long_500k" and not cfg.supports_long_context:
        reason = LONG_CONTEXT_REASON
    if reason:
        art = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
               "reason": reason}
        _write(art, out_dir)
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] SKIPPED: {reason}")
        return art

    c = count_cell(cfg, shape, processes, units)
    art: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
                 "overrides": overrides, "tag": tag}
    art["memory_analysis"] = {
        "argument_size_in_bytes": c["argument_bytes"],
        "output_size_in_bytes": c["output_bytes"],
        "temp_size_in_bytes": c["peak_live_bytes"],
        "hbm_bytes": H100_SXM.hbm_bytes,
    }
    art["cost_analysis"] = {"flops": c["flops"], "bytes accessed": c["bytes"]}
    art["unknown_trip_whiles"] = c["unknown_trip_whiles"]
    art["collective_bytes"] = c["collective_bytes"]
    art["async_collective_bytes"] = c["async_collective_bytes"]
    art["kernels"] = c["kernels"]
    art["count_s"] = c["count_s"]

    n_active = R.param_count(cfg, active_only=True)
    n_total = R.param_count(cfg)
    art["params"] = n_total
    art["active_params"] = n_active
    art["model_flops"] = RL.model_flops(cfg, shape, n_active)
    art["ideal_bytes"] = RL.ideal_memory_bytes(
        cfg, shape, n_active, n_total, cfg.num_microbatches
    )
    art["status"] = "ok"

    terms = RL.from_artifact(art, chip=H100_SXM)
    art["chip"] = H100_SXM.name
    art["roofline"] = terms.row()
    if verbose:
        mem = art["memory_analysis"]
        print(
            f"[{arch} × {shape_name} × {mesh_name}] count={art['count_s']:.1f}s "
            f"flops/chip={c['flops']:.4g} bytes/chip={c['bytes']:.4g} "
            f"coll/chip={sum(c['collective_bytes'].values()):.4g} "
            f"args={mem['argument_size_in_bytes']:.4g} peak_live={mem['temp_size_in_bytes']:.4g} "
            f"dominant={terms.dominant} roofline={100*terms.roofline_fraction:.1f}%"
        )
    _write(art, out_dir, tag)
    return art


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="all", help="arch id or 'all'")
    p.add_argument("--shape", default="all", help="shape name or 'all'")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--out", default="artifacts/dryrun_torch")
    p.add_argument("--set", action="append", default=[],
                   help="cfg override key=value (e.g. attn_impl=flash)")
    args = p.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures, rows = [], []
    for arch in archs:
        cfg = get_config(arch)
        shapes = [s.name for s in shapes_for(cfg)] + (
            ["long_500k"] if not cfg.supports_long_context else []
        )
        if args.shape != "all":
            shapes = [args.shape]
        for shape_name in shapes:
            for mp in meshes:
                try:
                    art = run_cell(arch, shape_name, mp, args.out, overrides or None)
                except Exception:
                    failures.append((arch, shape_name, mp))
                    print(f"FAILED: {arch} × {shape_name} × multi_pod={mp}")
                    traceback.print_exc()
                    continue
                if art["status"] == "ok":
                    rows.append(RL.from_artifact(art, chip=H100_SXM))
    if rows:
        print(RL.format_table(rows))
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print("all requested dry-run cells passed")


if __name__ == "__main__":
    main()
