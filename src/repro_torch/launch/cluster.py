"""Multi-process cluster bring-up (port of ``repro.launch.cluster``).

The port's mesh can span real OS processes: each process owns whole pods,
so the in-pod axis stays inside one process (and, on the card, inside one
card), and every operation over the ``pod`` axis crosses the process
boundary through ``torch.distributed`` (:mod:`repro_torch.core.exchange`'s
process fabric).  Two halves:

* :func:`init_cluster` — the worker half.  Call it at the top of a worker
  script; it reads the ``REPRO_TORCH_CLUSTER_*`` environment (or explicit
  arguments) and runs ``torch.distributed.init_process_group`` with an
  explicit backend (``"gloo"`` or ``"nccl"``) and device.  After it returns,
  :func:`~repro_torch.core.exchange.make_mesh` spans the processes.

* :func:`run_local_cluster` — the launcher half.  Spawns N copies of a
  worker script as OS processes on this host (rendezvous on a free
  localhost port), spools each worker's output to a file, enforces a
  deadline (killing every worker when it passes), and raises with every
  worker's output on any failure.

Command line::

    python -m repro_torch.launch.cluster --processes 2 --local-units 4 \\
        --backend gloo --device cpu tests/_torch_multiproc_driver.py all

Gloo runs on the CPU, and on the card with every rank sharing it (each
pod-hop message then goes through host memory).  NCCL needs one card a
rank: a rank's card is its local rank modulo the visible card count, and
more ranks than cards on the host raises; no backend is ever switched.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

ENV_COORDINATOR = "REPRO_TORCH_CLUSTER_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_TORCH_CLUSTER_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_TORCH_CLUSTER_PROCESS_ID"
ENV_LOCAL_UNITS = "REPRO_TORCH_CLUSTER_LOCAL_UNITS"
ENV_BACKEND = "REPRO_TORCH_CLUSTER_BACKEND"
ENV_DEVICE = "REPRO_TORCH_CLUSTER_DEVICE"
BACKENDS = ("gloo", "nccl")

_JOINED: "ClusterInfo | None" = None


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """What :func:`init_cluster` established."""

    process_id: int
    num_processes: int
    coordinator: str | None
    local_units: int
    backend: str | None = None
    device: str | None = None


def _cluster_device(backend: str, device: str, process_id: int, num_processes: int):
    """The rank's device: ``cpu``, or the card it runs on."""
    import torch

    if device == "cpu":
        if backend == "nccl":
            raise ValueError('backend="nccl" needs device="cuda"; on the CPU use backend="gloo"')
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError(
            'device="cuda" but CUDA is not available; pass device="cpu" to run '
            "the cluster on the CPU"
        )
    if backend == "nccl":
        if num_processes > cards:
            raise ValueError(
                f'backend="nccl" needs one card a rank: {num_processes} ranks on '
                f'{cards} card(s); launch with backend="gloo" to share a card, or '
                "with at most one rank a card"
            )
        return torch.device("cuda", process_id % cards)
    return torch.device("cuda", torch.cuda.current_device())


def init_cluster(
    *,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_units: int | None = None,
    backend: str | None = None,
    device: str | None = None,
    timeout_s: int = 120,
) -> ClusterInfo:
    """Join (or degenerate to) a ``torch.distributed`` cluster.  Call FIRST.

    Arguments default to the ``REPRO_TORCH_CLUSTER_*`` environment set by
    :func:`run_local_cluster` (backend ``"gloo"`` and device ``"cuda"``
    when unset); outside a launched cluster (all unset) this is a no-op
    returning a single-process :class:`ClusterInfo`, so worker scripts also
    run standalone.  Under NCCL the rank's card becomes the current device.
    ``local_units`` is the units each process holds (the in-pod axis size
    of a one-pod-a-process mesh).
    """
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    if local_units is None:
        local_units = int(os.environ.get(ENV_LOCAL_UNITS, "0"))
    backend = backend or os.environ.get(ENV_BACKEND, "gloo")
    device = device or os.environ.get(ENV_DEVICE, "cuda")
    global _JOINED
    if num_processes <= 1:
        _JOINED = ClusterInfo(process_id, num_processes, coordinator, local_units)
        return _JOINED
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    import torch
    import torch.distributed as dist

    dev = _cluster_device(backend, device, process_id, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None,
    )
    _JOINED = ClusterInfo(
        process_id=process_id,
        num_processes=num_processes,
        coordinator=coordinator,
        local_units=local_units,
        backend=backend,
        device=str(dev),
    )
    return _JOINED


def local_unit_count() -> int:
    """Units each process holds: what :func:`init_cluster` was given, 1
    before (or without) a launch."""
    return (_JOINED.local_units if _JOINED is not None else 0) or 1


def sync_processes() -> None:
    """Block until every process of the cluster reaches this point (a
    no-op in one process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def leave_cluster() -> None:
    """Wait for every process, then leave the ``torch.distributed`` group (a
    no-op in one process).  A worker that exits while another still talks
    to it can abort in the group's teardown; the launched entry points call
    this last."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_cluster(
    argv: list[str],
    num_processes: int = 2,
    local_units: int = 4,
    timeout_s: int = 600,
    env: dict | None = None,
    echo: bool = True,
    backend: str = "gloo",
    device: str = "cuda",
) -> list[str]:
    """Spawn ``argv`` as ``num_processes`` coordinated worker processes.

    Each worker gets the ``REPRO_TORCH_CLUSTER_*`` environment
    (:func:`init_cluster` reads it).  Output is spooled to files (not
    pipes: a full pipe would deadlock a worker blocked in a collective with
    a chatty peer).  Returns each worker's combined stdout+stderr, in
    process order; raises ``RuntimeError`` with every worker's log if any
    worker exits nonzero or the deadline passes (every worker is then
    killed).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    port = _free_port()
    procs, logs = [], []
    for pid in range(num_processes):
        e = dict(os.environ)
        e.update(env or {})
        e.update({
            ENV_COORDINATOR: f"127.0.0.1:{port}",
            ENV_NUM_PROCESSES: str(num_processes),
            ENV_PROCESS_ID: str(pid),
            ENV_LOCAL_UNITS: str(local_units),
            ENV_BACKEND: backend,
            ENV_DEVICE: device,
        })
        log = tempfile.NamedTemporaryFile(
            mode="w+", suffix=f".proc{pid}.log", delete=False
        )
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, *argv],
            env=e, stdout=log, stderr=subprocess.STDOUT, text=True,
        ))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(
            f"cluster run timed out after {timeout_s}s\n"
            + _format_logs(argv, procs, _read_logs(logs))
        ) from None
    outputs = _read_logs(logs)
    if echo:
        for pid, out in enumerate(outputs):
            for line in out.splitlines():
                print(f"[proc {pid}] {line}")
    if any(p.returncode for p in procs):
        raise RuntimeError(
            f"cluster run failed (exit codes {[p.returncode for p in procs]})\n"
            + _format_logs(argv, procs, outputs)
        )
    return outputs


def _read_logs(logs) -> list[str]:
    outputs = []
    for log in logs:
        log.flush()
        log.seek(0)
        outputs.append(log.read())
        log.close()
        os.unlink(log.name)
    return outputs


def _format_logs(argv, procs, outputs) -> str:
    parts = [f"argv: {argv}"]
    for pid, out in enumerate(outputs):
        parts.append(f"--- proc {pid} (exit {procs[pid].returncode}) ---")
        parts.append(out)
    return "\n".join(parts)


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.cluster",
        description="Run a worker script as a local multi-process torch.distributed "
        "cluster (N processes x M units each).",
    )
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-units", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--backend", choices=BACKENDS, default="gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("worker", nargs=argparse.REMAINDER,
                    help="worker script and its arguments")
    args = ap.parse_args(argv)
    worker = [a for a in args.worker if a != "--"]
    if not worker:
        ap.error("missing worker script")
    try:
        run_local_cluster(
            worker, num_processes=args.processes, local_units=args.local_units,
            timeout_s=args.timeout, backend=args.backend, device=args.device,
        )
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


__all__ = [
    "ClusterInfo",
    "init_cluster",
    "run_local_cluster",
    "local_unit_count",
    "sync_processes",
    "leave_cluster",
    "main",
]

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
