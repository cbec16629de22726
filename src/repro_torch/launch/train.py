"""End-to-end training entry point of the port (counterpart of
``repro.launch.train``).

A real training loop on one device: the deterministic data pipeline with
background prefetch, the microbatched AdamW train step, periodic
crash-consistent checkpoints, and resume from the newest checkpoint — kill
it at any step and rerun the same command to continue (the pipeline
regenerates exactly the batches that would have followed).

  PYTHONPATH=src python -m repro_torch.launch.train --arch train100m \\
      --steps 100 --seq-len 512 --ckpt-dir ckpt --ckpt-every 20

The flags are the reference's.  It runs on the card; :func:`main` takes
``device="cpu"`` from Python.

``--grid DxM`` (the port's switch; the reference trains on whatever mesh
its context holds) trains across the ``D * M`` processes of a launch as the
reference's ``data x model`` mesh under its ``default_rules``
(:func:`~repro_torch.launch.mesh.make_grid_context`): heads, ``d_ff`` and
vocab split over each model row, every ``fsdp`` dim and the batch over each
data column.  Each process draws its pieces of the state already cut, each
data column takes its rows of every global batch, and checkpoints are saved
and resumed by pieces::

  python -m repro_torch.launch.cluster --processes 4 --local-units 1 -- \
      -m repro_torch.launch.train --arch qwen2.5-3b --smoke --grid 2x2

Only the dense family trains there; the others refuse, as the train step
does (ROADMAP queue A, item 9(d)(ii)).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..configs.base import ShapeSpec
from ..core.exchange import live_processes
from ..data import Prefetcher, make_batch_iterator
from ..distributed.sharding import current_mesh_context, local_rows, mesh_context
from ..models import registry as R
from ..train import AdamWConfig, TrainState, make_train_step
from ..train.step import grid_world, refuse_tensor_table, state_owners, state_shardings
from .cluster import init_cluster, leave_cluster
from .mesh import make_grid_context, parse_grid


def main(argv=None, device: str = "cuda") -> tuple[TrainState, dict]:
    """Run the CLI; returns the final state and the last step's metrics
    (as floats; empty when resuming at or past ``--steps``)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--grid", default="",
                   help="DxM: train over the launch's D * M processes as a data x model mesh")
    args = p.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.scaled(num_microbatches=args.microbatches)
    joined = args.grid and live_processes()[0] == 1
    if joined:  # join the launch (a no-op outside one: the grid then raises)
        device = init_cluster().device or device
    ctx = make_grid_context(*parse_grid(args.grid)) if args.grid else current_mesh_context()
    refuse_tensor_table(ctx, cfg)  # before any state is built
    with mesh_context(ctx):
        out = _train(args, cfg, ctx, device)
    if joined:
        leave_cluster()
    return out


def _train(args, cfg, ctx, device) -> tuple[TrainState, dict]:
    api = R.build(cfg)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")

    opt = AdamWConfig(
        lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
        schedule=cfg.lr_schedule,
    )
    step_fn = make_train_step(api, opt)

    shardings = state_shardings(api, ctx)
    state = TrainState.create(api, args.seed, device=device, shardings=shardings)
    # the rows of a global batch this process takes: its data column's on a
    # grid, its own under data parallelism, all of them under the tensor table
    rows = (ctx.data if ctx.data is not None else None if ctx.tensor else ctx.mesh) \
        if ctx is not None else None
    ckpt_mesh = (grid_world(ctx) if ctx.tensor else ctx.mesh) if ctx is not None else None
    owned = state_owners(api, ctx)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every or 0)
        restored = mgr.restore_latest(state, shardings=shardings)
        if restored is not None:
            start, state = restored
            print(f"resumed from checkpoint at step {start}")

    it = Prefetcher(
        make_batch_iterator(cfg, shape, seed=args.seed, start_step=start), depth=2
    )
    t0 = time.perf_counter()
    tokens_done = 0
    last: dict = {}
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(state.step.device) for k, v in next(it).items()}
        if rows is not None:
            batch = local_rows(batch, rows)
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq_len
        if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.maybe_save(step + 1, state, shardings, ckpt_mesh, owned)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            last = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            print(
                f"step {step + 1:5d}  loss {last['loss']:.4f}  "
                f"lr {last['lr']:.2e}  gnorm {last['grad_norm']:.3f}  "
                f"tok/s {tokens_done / dt:,.0f}"
            )
    print("done")
    return state, last


if __name__ == "__main__":
    main()
