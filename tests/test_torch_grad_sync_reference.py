"""A pinned difference from the reference: its explicit two-level gradient
sync scales the gradient by the number of data-parallel devices.

In ONE subprocess that runs this file as a script with 8 fake XLA devices
(the flag is never set in the pytest process), the reference takes one
train step of Qwen2.5-3B's smoke config on an ``(8, 16)`` batch from
``PRNGKey(0)`` under ``jit`` on the ``(pod 2, data 2, model 2)`` mesh with
``default_rules(True)`` and ``pod_axis="pod"``, under ``grad_sync="auto"``
and ``"hierarchical"``.  Its ``"hierarchical"`` step
runs ``hierarchical_psum_tree`` over ``(data, pod)`` on the gradient that
``jax.value_and_grad`` already took over the whole global batch,
replicated on every device, so its grad norm is 4.0 (pod x data) times the
``"auto"`` one.  The port's ``"hierarchical"`` step on its 2 x 4 pod mesh
(a gradient a unit, summed, over the unit count) equals the reference's
``"auto"`` mesh step instead.  If the reference is ever fixed, the first
test fails and says so.
"""

import os
import pickle
import subprocess
import sys

if __name__ == "__main__":  # the reference side, on 8 fake devices
    # LLVM's optimization level 0 cuts the two steps' compile time by a
    # third; the loss and grad norms agree with the default level's to f32
    # rounding
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

ARCH = "qwen2.5-3b"
DP_DEVICES = 4  # pod x data on the reference's (2, 2, 2) mesh


def reference_main(out_path: str) -> None:
    import jax

    from repro.configs import get_smoke_config
    from repro.distributed.sharding import MeshContext, default_rules, mesh_context
    from repro.launch.mesh import make_test_mesh
    from repro.models import registry
    from repro.train import AdamWConfig, make_train_step
    from repro.train.step import TrainState, state_shardings

    cfg = get_smoke_config(ARCH)
    key = jax.random.PRNGKey(0)
    state = TrainState.create(registry.build(cfg), key)
    batch = {
        "tokens": jax.random.randint(key, (8, 16), 0, cfg.vocab_size),
        "labels": jax.random.randint(key, (8, 16), 0, cfg.vocab_size),
    }
    opt = AdamWConfig(lr=1e-3)
    out = {"params": jax.tree.map(np.asarray, state.params),
           "batch": {k: np.asarray(v) for k, v in batch.items()}}
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    ctx = MeshContext(mesh=mesh, rules=default_rules(True), exchange_axis="model",
                      data_axes=("pod", "data"), pod_axis="pod")
    for mode in ("auto", "hierarchical"):
        api = registry.build(cfg.scaled(grad_sync=mode))
        with mesh_context(ctx):
            state_s = jax.device_put(state, state_shardings(api, ctx))
            _, m = jax.jit(make_train_step(api, opt))(state_s, batch)
        out[mode] = {k: float(v) for k, v in m.items()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:  # written by this file's own subprocess
        return pickle.load(f)


def test_reference_hierarchical_sync_scales_by_the_data_parallel_devices(reference):
    """The reference's hierarchical mesh step has ``DP_DEVICES`` times the
    grad norm of its auto one (the same loss).  A failure here means the
    reference changed: drop the difference from ROADMAP §C."""
    auto, hier = reference["auto"], reference["hierarchical"]
    np.testing.assert_allclose(hier["grad_norm"], DP_DEVICES * auto["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(hier["loss"], auto["loss"], rtol=1e-5)


def test_port_hierarchical_sync_equals_the_reference_auto_mesh_step(reference):
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.exchange import make_mesh
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import convert, registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step

    api = registry.build(get_smoke_config(ARCH).scaled(grad_sync="hierarchical"))
    state = TrainState.from_params(convert.from_reference(reference["params"], device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    with mesh_context(MeshContext(make_mesh(8, 2))):
        _, m = make_train_step(api, AdamWConfig(lr=1e-3))(state, batch)
    np.testing.assert_allclose(float(m["loss"]), reference["auto"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), reference["auto"]["grad_norm"], rtol=1e-4)


if __name__ == "__main__":
    reference_main(sys.argv[1])
