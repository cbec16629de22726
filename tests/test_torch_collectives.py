"""The port's hierarchical collectives, streaming consume, gradient sync and
buffer donation against the JAX package, bit for bit.

In ONE subprocess that runs this file as a script with 8 fake XLA devices
(the flag is never set in the pytest process) the reference runs
``hierarchical_psum``, ``hierarchical_psum_tree`` (leaves that need
padding), ``flat_psum_tree``, ``scheduled_all_to_all_consume`` (every
schedule, both axes of a 2 x 4 mesh), the multiplexer's ``shuffle_consume``
(every transport) and ``psum_tree`` (flat and two-level) under
``shard_map``, and ``donate_buffers``; the port runs the same on its
in-process fabric.  Integer inputs and an order-sensitive fold, so any
difference in what is summed or in which order messages arrive shows.
"""

import os
import subprocess
import sys

if __name__ == "__main__":  # the reference side, on 8 fake devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

N, PODS = 8, 2
A_FLAT = N
CONSUME_CASES = [  # (mesh, axis, schedule)
    ("flat", "x", "shift"), ("flat", "x", "one_factorization"),
    ("pods", "q", "shift"), ("pods", "q", "one_factorization"), ("pods", "pod", "shift"),
]
MUX_IMPLS = ["xla", "round_robin", "one_factorization"]


def _grads():
    rng = np.random.default_rng(11)
    return {"w": rng.integers(0, 1 << 20, (N, 5, 3)).astype(np.int32),
            "b": rng.integers(0, 1 << 12, (N, 7)).astype(np.float32)}


def _blocks() -> np.ndarray:
    """Per-unit ``[8, 3]``: dim 0 divides the in-pod axis (4)."""
    return np.random.default_rng(12).integers(0, 1 << 20, (N, 8, 3)).astype(np.int32)


def _messages(A: int) -> np.ndarray:
    return np.random.default_rng(A).integers(0, 100, (N, A, 3)).astype(np.int32)


def _fold(acc, chunk, src):
    """Order-sensitive: acc * 3 + chunk * (src + 1)."""
    return acc * 3 + chunk * (src + 1)


def reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import exchange
    from repro.core.multiplexer import donate_buffers, make_multiplexer
    from repro.launch.mesh import make_test_mesh

    meshes = {"flat": make_test_mesh((N,), ("x",)),
              "pods": make_test_mesh((PODS, N // PODS), ("pod", "q"))}
    out = {}

    def run(mesh, spec, fn, *args):
        f = shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args), out_specs=spec,
                      check_vma=False)
        return np.asarray(jax.jit(f)(*args))

    pods, pod_spec = meshes["pods"], P(("pod", "q"))
    g = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:])) for k, v in _grads().items()}
    out["hier"] = run(pods, pod_spec, lambda w: exchange.hierarchical_psum(w, "q", "pod"),
                      jnp.asarray(_blocks().reshape(N * 8, 3)))
    for k in g:
        out[f"hier_tree_{k}"] = run(
            pods, pod_spec,
            lambda x: exchange.hierarchical_psum_tree({"x": x}, "q", "pod")["x"], g[k])
        out[f"flat_tree_{k}"] = run(
            pods, pod_spec, lambda x: exchange.flat_psum_tree({"x": x}, ("pod", "q"))["x"], g[k])
        out[f"mux_tree_pods_{k}"] = run(
            pods, pod_spec,
            lambda x: make_multiplexer(pods).psum_tree({"x": x}, ("pod", "q"))["x"], g[k])
        out[f"mux_tree_flat_{k}"] = run(
            meshes["flat"], P("x"),
            lambda x: make_multiplexer(meshes["flat"]).psum_tree({"x": x}, ("x",))["x"], g[k])
    for mname, axis, sched in CONSUME_CASES:
        mesh = meshes[mname]
        A = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
        spec = P(mesh.axis_names if mname == "pods" else "x")
        x = jnp.asarray(_messages(A).reshape(N * A, 3))
        out[f"consume_{mname}_{axis}_{sched}"] = run(
            mesh, spec,
            lambda v, axis=axis, sched=sched: exchange.scheduled_all_to_all_consume(
                v, axis, _fold, jnp.zeros((3,), v.dtype), schedule=sched)[None], x)
    for impl in MUX_IMPLS:
        mux = make_multiplexer(meshes["flat"], impl=impl)
        x = jnp.asarray(_messages(A_FLAT).reshape(N * A_FLAT, 3))
        out[f"mux_consume_{impl}"] = run(
            meshes["flat"], P("x"),
            lambda v, mux=mux: mux.shuffle_consume(v, "x", _fold, jnp.zeros((3,), v.dtype))[None],
            x)
    a, b = (jnp.asarray(v) for v in _donation_inputs())
    out["donate_a"], out["donate_s"] = (np.asarray(t) for t in donate_buffers(_donated, (0,))(a, b))
    np.savez(out_path, **out)


def _donation_inputs():
    rng = np.random.default_rng(5)
    return rng.integers(0, 100, (4, 6)).astype(np.int32), rng.integers(0, 100, (4, 6)).astype(np.int32)


def _donated(a, b):
    return a * 2 + b, (a + b).sum()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out)


def _mesh(name):
    from repro_torch.core.exchange import make_mesh

    return make_mesh(N, PODS if name == "pods" else 1)


def _axis(axis):
    return "q" if axis == "x" else axis


@pytest.mark.parametrize("leaf", ["w", "b"])
def test_psum_trees_equal_reference(reference, leaf):
    import torch

    from repro_torch.core import exchange
    from repro_torch.core.multiplexer import make_multiplexer

    x = torch.from_numpy(_grads()[leaf])
    pods = _mesh("pods")
    cases = {
        "hier_tree": exchange.hierarchical_psum_tree({"x": x}, pods, "q", "pod")["x"],
        "flat_tree": exchange.flat_psum_tree({"x": x}, pods, ("pod", "q"))["x"],
        "mux_tree_pods": make_multiplexer(pods).psum_tree({"x": x}, ("pod", "q"))["x"],
        "mux_tree_flat": make_multiplexer(_mesh("flat")).psum_tree({"x": x}, ("q",))["x"],
    }
    for name, got in cases.items():
        np.testing.assert_array_equal(got.numpy().reshape(reference[f"{name}_{leaf}"].shape),
                                      reference[f"{name}_{leaf}"], err_msg=name)


def test_hierarchical_psum_equals_reference(reference):
    import torch

    from repro_torch.core import exchange

    got = exchange.hierarchical_psum(torch.from_numpy(_blocks()), _mesh("pods"), "q", "pod")
    np.testing.assert_array_equal(got.numpy().reshape(reference["hier"].shape), reference["hier"])


@pytest.mark.parametrize("mesh_name,axis,sched", CONSUME_CASES)
def test_scheduled_all_to_all_consume_equals_reference(reference, mesh_name, axis, sched):
    import torch

    from repro_torch.core import exchange

    mesh = _mesh(mesh_name)
    A = mesh.size(_axis(axis))
    x = torch.from_numpy(_messages(A))
    got = exchange.scheduled_all_to_all_consume(
        x, mesh, _axis(axis), lambda acc, c, s: _fold(acc, c, s[:, None]),
        torch.zeros((N, 3), dtype=x.dtype), schedule=sched)
    np.testing.assert_array_equal(got.numpy(), reference[f"consume_{mesh_name}_{axis}_{sched}"])


@pytest.mark.parametrize("impl", MUX_IMPLS)
def test_shuffle_consume_equals_reference(reference, impl):
    import torch

    from repro_torch.core.multiplexer import make_multiplexer

    x = torch.from_numpy(_messages(A_FLAT))
    got = make_multiplexer(_mesh("flat"), impl=impl).shuffle_consume(
        x, "q", lambda acc, c, s: _fold(acc, c, s[:, None]), torch.zeros((N, 3), dtype=x.dtype))
    np.testing.assert_array_equal(got.numpy(), reference[f"mux_consume_{impl}"])


def test_shuffle_consume_refuses_the_pod_axis():
    import torch

    from repro_torch.core.multiplexer import make_multiplexer

    mux = make_multiplexer(_mesh("pods"))
    with pytest.raises(ValueError, match="large-network axis"):
        mux.shuffle_consume(torch.zeros((N, PODS, 3)), "pod", _fold, 0)


def test_donate_buffers_equals_reference_and_reuses_the_donated_tensor(reference):
    import torch

    from repro_torch.core.multiplexer import donate_buffers

    a, b = (torch.from_numpy(v) for v in _donation_inputs())
    got_a, got_s = donate_buffers(_donated, (0,))(a, b)
    assert got_a is a  # the result lives in the donated argument's storage
    np.testing.assert_array_equal(got_a.numpy(), reference["donate_a"])
    np.testing.assert_array_equal(got_s.numpy(), reference["donate_s"])
    # nothing donated with a matching shape: the result is fn's own
    c = torch.zeros(6, dtype=torch.int32)
    out_a, out_s = donate_buffers(_donated, (1,))(torch.ones(4, 6, dtype=torch.int32), c)
    assert out_a.data_ptr() != c.data_ptr() and out_s.data_ptr() != c.data_ptr()


if __name__ == "__main__":
    reference_main(sys.argv[1])
