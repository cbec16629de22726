"""The port's launcher and topology-derived meshes (no multi-process mesh):
the cases of ``tests/test_cluster.py`` on ``repro_torch.launch``.

The live 2-process behaviour runs in ``tests/test_torch_multiprocess.py``;
here the spawner mechanics run with torch-free workers, and the meshes'
actionable failures, the refusal of NCCL with two ranks on one card and the
launch modules' freedom from JAX are checked in process.
"""

import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.exchange import POD_AXIS, SHUFFLE_AXIS
from repro_torch.launch import cluster
from repro_torch.launch.cluster import (
    ENV_BACKEND,
    ENV_COORDINATOR,
    ENV_DEVICE,
    ENV_LOCAL_UNITS,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    init_cluster,
    run_local_cluster,
)
from repro_torch.launch.mesh import (
    _squarest_factors,
    make_context,
    make_pod_mesh,
    make_production_mesh,
    make_test_mesh,
)

ENVS = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID, ENV_LOCAL_UNITS, ENV_BACKEND,
        ENV_DEVICE)


def test_squarest_factors():
    assert _squarest_factors(256) == (16, 16)
    assert _squarest_factors(8) == (2, 4)
    assert _squarest_factors(7) == (1, 7)
    assert _squarest_factors(12) == (3, 4)


def test_run_local_cluster_sets_worker_env():
    outputs = run_local_cluster(
        ["-c",
         "import os;print(%s)" % ", ".join(f"os.environ['{v}']" for v in (
             ENV_PROCESS_ID, ENV_NUM_PROCESSES, ENV_LOCAL_UNITS, ENV_BACKEND, ENV_DEVICE))],
        num_processes=2, local_units=3, timeout_s=60, echo=False, device="cpu",
    )
    assert [o.split()[0] for o in outputs] == ["0", "1"]
    assert all(o.split()[1:] == ["2", "3", "gloo", "cpu"] for o in outputs)


def test_run_local_cluster_surfaces_worker_failure():
    with pytest.raises(RuntimeError, match="boom") as e:
        run_local_cluster(
            ["-c", "import os, sys; print('alive', os.environ['%s']); "
                   "sys.exit('boom') if os.environ['%s'] == '1' else None"
             % (ENV_PROCESS_ID, ENV_PROCESS_ID)],
            num_processes=2, timeout_s=60, echo=False, device="cpu",
        )
    # every worker's log, the one that succeeded too
    assert "alive 0" in str(e.value) and "alive 1" in str(e.value)


def test_run_local_cluster_timeout_kills_workers():
    with pytest.raises(RuntimeError, match="timed out"):
        run_local_cluster(
            ["-c", "import time; time.sleep(60)"],
            num_processes=1, timeout_s=2, echo=False, device="cpu",
        )


def test_run_local_cluster_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        run_local_cluster(["-c", "pass"], backend="mpi", echo=False)


def test_init_cluster_is_noop_outside_a_launch(monkeypatch):
    for var in ENVS:
        monkeypatch.delenv(var, raising=False)
    info = init_cluster()
    assert info.num_processes == 1 and info.process_id == 0
    assert not torch.distributed.is_initialized()


def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch):
    """NCCL needs a card a rank; two ranks on one card must name the Gloo
    backend, never switch to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        init_cluster(coordinator="127.0.0.1:1", num_processes=2, process_id=0,
                     local_units=4, backend="nccl", device="cuda")
    assert not torch.distributed.is_initialized()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_cluster(coordinator="127.0.0.1:1", num_processes=2, process_id=0,
                     local_units=4, backend="gloo", device="cuda")
    with pytest.raises(ValueError, match='backend="gloo"'):
        init_cluster(coordinator="127.0.0.1:1", num_processes=2, process_id=0,
                     local_units=4, backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


def test_production_mesh_single_process_needs_pod_override():
    # pytest runs single-process: multi_pod without an override must point
    # at the launcher, not die in a reshape five layers down.
    with pytest.raises(ValueError, match="repro_torch.launch.cluster"):
        make_production_mesh(multi_pod=True)


def test_production_mesh_rejects_non_factoring_pods():
    # one unit in this process: 1 % 2 != 0
    with pytest.raises(ValueError, match="do not split"):
        make_production_mesh(multi_pod=True, num_pods=2)


def test_pod_mesh_rejects_non_factoring_pods():
    with pytest.raises(ValueError, match="pods"):
        make_pod_mesh(num_pods=3)


def test_meshes_map_the_reference_axes_onto_q():
    mesh = make_test_mesh()
    assert (mesh.num_pods, mesh.n, mesh.num_processes) == (1, 8, 1)
    assert make_test_mesh((2, 4), (POD_AXIS, "model")).shape == (2, 4)
    single = make_production_mesh()
    assert single.axis_names == (SHUFFLE_AXIS,) and single.num_units == 1
    assert make_context(mesh=make_test_mesh((2, 4), (POD_AXIS, "data"))).data_axes == (
        POD_AXIS, SHUFFLE_AXIS)
    assert make_context().data_axes == (SHUFFLE_AXIS,)
    with pytest.raises(ValueError, match="axes"):
        make_pod_mesh(axes=(POD_AXIS, "expert"))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        make_test_mesh((2, 4), ("data", "expert"))


def test_cluster_cli_runs_a_trivial_worker():
    rc = cluster.main(
        ["--processes", "2", "--timeout", "60", "--device", "cpu", "--",
         "-c", "print('worker alive')"]
    )
    assert rc == 0


def test_cluster_cli_reports_a_failing_worker(capsys):
    rc = cluster.main(["--processes", "2", "--timeout", "60", "--device", "cpu", "--",
                       "-c", "raise SystemExit('boom')"])
    assert rc == 1 and "boom" in capsys.readouterr().err


def test_cluster_cli_missing_worker():
    with pytest.raises(SystemExit):
        cluster.main(["--processes", "2"])


def test_launch_modules_import_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.launch.cluster, repro_torch.launch.mesh\n"
        "import repro_torch.core.exchange, repro_torch.core.multiplexer\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr
