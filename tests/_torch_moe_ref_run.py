"""The reference's expert-parallel MoE body on 8 fake CPU devices, for the
port's tests.

    python tests/_torch_moe_ref_run.py <in.npz> <out.npz>

``in.npz`` holds the MoE layer's params (``router``, ``w_gate``, ``w_up``,
``w_down``), the tokens ``x [T, d]`` and the config fields ``top_k``,
``capacity_factor`` and, optionally, ``router_norm_topk``.  For a flat
8-unit mesh and a 2 pods x 4 mesh it runs ``repro.models.moe._ep_moe_local``
under ``shard_map`` over the joint unit axis and writes ``y_pods{P}`` ``[T,
d]`` and ``dropped_pods{P}`` ``[8]`` (per unit).  With the shared experts'
MLP in ``in.npz`` (``shared_w_gate``, ``shared_w_up``, ``shared_w_down``) it
also writes ``y_shared_pods{P}``: the EP output plus the shared MLP on every
token, as ``repro.models.moe.moe_ffn`` adds it after either path.  The fake-device flag must be set before JAX starts, so this
runs as a subprocess.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.compat import shard_map  # noqa: E402
from repro.configs.base import ModelConfig  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import layers as L  # noqa: E402
from repro.models import moe as M  # noqa: E402


def main(src: str, dst: str) -> None:
    data = np.load(src)
    params = {k: jax.numpy.asarray(data[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = jax.numpy.asarray(data["x"])
    E, d, f = data["w_gate"].shape
    cfg = ModelConfig(
        name="t", family="moe", num_layers=1, d_model=d, num_heads=4, num_kv_heads=4,
        d_ff=f, vocab_size=64, num_experts=E, top_k=int(data["top_k"]), moe_d_ff=f,
        capacity_factor=float(data["capacity_factor"]), dtype="float32",
        moe_impl="ep_shardmap",
        router_norm_topk=bool(data["router_norm_topk"]) if "router_norm_topk" in data else False,
    )
    shared = None
    if "shared_w_gate" in data:
        shared = {k: jax.numpy.asarray(data[f"shared_{k}"]) for k in ("w_gate", "w_up", "w_down")}
    out = {}
    for pods in (1, 2):
        if pods == 1:
            mesh, unit, pod = make_test_mesh((8,), ("model",)), "model", None
        else:
            mesh, unit, pod = make_test_mesh((2, 4), ("pod", "model")), ("pod", "model"), "pod"

        def body(p, xs, pod=pod):
            y, dropped = M._ep_moe_local(p, cfg, xs, "model", pod_axis=pod)
            return y, dropped.reshape(1)

        fn = shard_map(
            body, mesh=mesh,
            in_specs=({k: P(None, None) if k == "router" else P(unit, None, None)
                       for k in params}, P(unit, None)),
            out_specs=(P(unit, None), P(unit)),
            axis_names={"pod", "model"} if pod else {"model"},
            check_vma=False,
        )
        y, dropped = jax.jit(fn)(params, x)
        out[f"y_pods{pods}"] = np.asarray(y)
        out[f"dropped_pods{pods}"] = np.asarray(dropped)
        if shared is not None:
            out[f"y_shared_pods{pods}"] = np.asarray(y + L.mlp_block(shared, cfg, x[None])[0])
    np.savez(dst, **out)
    print("PASS torch_moe_ref")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
