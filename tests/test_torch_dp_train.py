"""Data-parallel training across REAL processes (2 x 4 units over Gloo on the
CPU): ``train/step.py`` under a mesh that spans processes.

ONE port cluster (``repro_torch.launch.cluster``) runs the ``dp_train``
scenario of ``tests/_torch_multiproc_driver.py`` at train100m's and
Mamba2-1.3B's smoke configs (global batch 8 x 32, 4 rows a process, 1 a
unit) and dumps each process's numbers.  Process 0 holds each mode's first
gradient and steps to its own one-process step on the whole batch (no
mesh); the port's one-process step is held to the reference's by
``tests/test_torch_train.py::test_three_train_steps_match_reference`` and
``tests/test_torch_ssm_train.py``, so this chain holds the data-parallel
step to the reference's single-device step.  Tolerances: the loss within
rtol 1e-5, every gradient leaf within ``1e-4 * max |b|``, the grad norm
within rtol 1e-4, the params after 3 steps within 1e-5 (the default
schedule's lr of 3e-6 to 9e-6) and bit-identical on both processes.
"""

import json
import os

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.launch.cluster import run_local_cluster
from repro_torch.models import registry
from repro_torch.tree import leaves

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_multiproc_driver.py")
PROCESSES, UNITS = 2, 4
ARCHS = ["train100m", "mamba2-1.3b"]
MODES = ["auto", "hierarchical"]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    outs = run_local_cluster(
        [DRIVER, "dp_train", "--dp-archs", ",".join(ARCHS), "--dp-shape", "8x32",
         "--dump", str(tmp)],
        num_processes=PROCESSES, local_units=UNITS, timeout_s=300, echo=False,
        backend="gloo", device="cpu", env={"OMP_NUM_THREADS": "2"},
    )
    assert all("PASS dp_train" in o for o in outs), outs
    got = []
    for pid in range(PROCESSES):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            got.append(json.load(f)["results"]["dp_train"])
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_equals_the_one_process_step(dumps, arch, mode):
    rec = dumps[0][arch]["modes"][mode]
    assert rec["loss_rel"] <= 1e-5
    assert rec["leaf_rel"] <= 1e-4
    assert max(rec["step_loss_rel"]) <= 1e-5
    assert max(rec["step_norm_rel"]) <= 1e-4
    assert rec["params_abs"] <= 1e-5
    # every process reports the same synced loss and grad norm, step by step
    for other in dumps[1:]:
        assert other[arch]["modes"][mode]["metrics"] == rec["metrics"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_bit_identical_on_every_process(dumps, arch, mode):
    assert all(d[arch]["modes"][mode]["ranks_identical"] for d in dumps)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_pod_hop_carries_each_leaf_once(dumps, arch, mode):
    """``"auto"``: one all-reduce a leaf (and the loss) of the leaf's f32
    bytes; ``"hierarchical"``: each unit's reduced block, so the leaf padded
    to the unit count; neither a stack of the process's 4 units."""
    sizes = [t.numel() for t in
             leaves(registry.build(get_smoke_config(arch)).init(0, device="cpu"))]
    rec = dumps[0][arch]
    m = rec["modes"][mode]
    assert rec["params"] == sum(sizes)
    leaf_bytes = 4 * (sum(sizes) + 1)
    want = leaf_bytes if mode == "auto" else 4 * sum(-(-n // UNITS) * UNITS for n in sizes + [1])
    assert m["step_hop_bytes"] == [want] * 3
    assert m["grad_hop"]["bytes"] == m["sync_hop"]["bytes"] == want
    assert m["grad_hop"]["messages"] == len(sizes) + 1
    assert leaf_bytes <= want < 2 * leaf_bytes
