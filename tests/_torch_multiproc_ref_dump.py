"""The reference's two-level shuffle and hierarchical psum across a REAL
2-process JAX cluster (2 x 4 fake CPU devices), dumped for the port's
tests to hold bit for bit against the port's cluster::

    python -m repro.launch.cluster --processes 2 --local-devices 4 \\
        tests/_torch_multiproc_ref_dump.py OUT.npz

The inputs are the port driver's (``tests/_torch_multiproc_driver.py``):
numpy-seeded keys and gradients, one row of ``[N, ...]`` per unit.
Process 0 writes ``OUT.npz``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.launch.cluster import init_cluster  # noqa: E402

INFO = init_cluster()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import fetch, shard_map  # noqa: E402
from repro.core import exchange  # noqa: E402
from repro.launch.mesh import make_pod_mesh  # noqa: E402


def two_level_shuffle() -> dict:
    mesh = make_pod_mesh()
    pods, n = mesh.devices.shape
    N, T = pods * n, 64
    keys = jnp.asarray(
        np.random.default_rng(3).integers(0, 10_000, (N, T)).astype(np.int32).reshape(-1))
    rows = jnp.stack([keys, keys * 2 + 1], axis=1)

    def shuffle(k, r):
        out_rows, out_valid, dropped = exchange.hash_shuffle_two_level(
            k, r, "q", "pod", capacity=T)
        return out_rows, out_valid, dropped[None]

    spec = P(("pod", "q"))
    fn = shard_map(shuffle, mesh=mesh, in_specs=(spec, spec),
                   out_specs=(spec, spec, spec), check_vma=False)
    r, v, d = jax.jit(fn)(keys, rows)
    return {"rows": np.asarray(fetch(r)).reshape(N, -1, 2),
            "valid": np.asarray(fetch(v)).reshape(N, -1),
            "dropped": np.asarray(fetch(d)).reshape(N)}


def hierarchical_psum() -> dict:
    mesh = make_pod_mesh(axes=("pod", "data"))
    n = mesh.devices.size
    out = {}
    for name, dtype, hi in (("int32", np.int32, 1 << 20), ("float32", np.float32, 1 << 12)):
        g = jnp.asarray(np.random.default_rng(0).integers(0, hi, (n, 4, 3))
                        .astype(dtype).reshape(n * 4, 3))

        def hier(g):
            return exchange.hierarchical_psum_tree({"g": g}, "data", "pod")["g"]

        spec = P(("pod", "data"))
        a = jax.jit(shard_map(hier, mesh=mesh, in_specs=spec, out_specs=spec))(g)
        out[f"psum_{name}"] = np.asarray(fetch(a)).reshape(n, 4, 3)
    return out


if __name__ == "__main__":
    got = {**{f"shuffle_{k}": v for k, v in two_level_shuffle().items()}, **hierarchical_psum()}
    if INFO.process_id == 0:
        np.savez(sys.argv[1], **got)
    print("PASS ref_dump")
