"""The reference's expert-parallel training gradient at OLMoE's smoke config,
on 8 fake CPU devices, for the port's tests.

    python tests/_torch_moe_train_ref_run.py <out.npz>

Builds ``olmoe-1b-7b``'s smoke config with ``moe_impl="ep_shardmap"`` in
f32, draws its params from ``PRNGKey(0)`` and a batch of 4 x 16 tokens from
``numpy.random.default_rng(0)`` (``tokens``, ``labels``), and for a flat
8-unit mesh (``(1, 8)`` over ``data x model``) and a 2 pods x 4 mesh
(``(2, 1, 4)`` over ``pod x data x model``) takes ``jax.value_and_grad`` of
``train_loss`` under the mesh context (the MoE layer's ``shard_map`` over
the joint unit axis).  It also runs the forward once more, layer by layer
(``scan_layers=False``), to collect each MoE layer's input tokens, and counts each
unit's dropped tuples there with ``_ep_moe_local`` under ``shard_map``.
``out.npz`` holds ``param:<path>``, ``grad_pods{P}:<path>``,
``loss_pods{P}``, ``drops_pods{P}`` ``[layers, 8]`` and the batch.  The
fake-device flag must be set before JAX starts, so this runs as a
subprocess.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.compat import shard_map  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.distributed.sharding import MeshContext, default_rules, mesh_context  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import moe as M  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import transformer as T  # noqa: E402

BATCH = (4, 16)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _drop_counter(cfg, mesh, pod):
    """``(layer params, tokens [T, d]) -> dropped [8]``: ``_ep_moe_local``'s
    per-unit drop counts under ``shard_map`` over the joint unit axis."""
    unit = (pod, "model") if pod else "model"

    def body(p, xs):
        _, dropped = M._ep_moe_local(p, cfg, xs, "model", pod_axis=pod)
        return dropped.reshape(1)

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=({k: P(None, None) if k == "router" else P(unit, None, None)
                   for k in ("router", "w_gate", "w_up", "w_down")}, P(unit, None)),
        out_specs=P(unit), axis_names={pod, "model"} if pod else {"model"}, check_vma=False))


def main(dst: str) -> None:
    cfg = get_smoke_config("olmoe-1b-7b").scaled(moe_impl="ep_shardmap", dtype="float32")
    api = registry.build(cfg)
    params = jax.jit(api.init)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH[0], BATCH[1] + 1),
                                             dtype=np.int32)
    batch = {"tokens": jax.numpy.asarray(toks[:, :-1]), "labels": jax.numpy.asarray(toks[:, 1:])}
    out = {f"param:{k}": v for k, v in _flat(params)}
    out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
    for pods in (1, 2):
        if pods == 1:
            mesh, pod = make_test_mesh((1, 8), ("data", "model")), None
            ctx = MeshContext(mesh=mesh, rules=default_rules(False), exchange_axis="model")
        else:
            mesh, pod = make_test_mesh((2, 1, 4), ("pod", "data", "model")), "pod"
            ctx = MeshContext(mesh=mesh, rules=default_rules(True), exchange_axis="model",
                              data_axes=("pod", "data"), pod_axis="pod")
        with mesh_context(ctx):
            loss, grads = jax.jit(jax.value_and_grad(api.train_loss))(params, batch)
            out[f"loss_pods{pods}"] = np.asarray(loss)
            out.update({f"grad_pods{pods}:{k}": v for k, v in _flat(grads)})
            # each MoE layer's input, from a layer-by-layer forward
            ffn = T._ffn

            def inputs_of(params, batch):
                inputs = []

                def spy(p, cfg_, kind, x):
                    if kind == "moe":
                        inputs.append(x)
                    return ffn(p, cfg_, kind, x)

                T._ffn = spy
                try:
                    T.forward(params, cfg.scaled(scan_layers=False), batch)
                finally:
                    T._ffn = ffn
                return inputs

            inputs = jax.jit(inputs_of)(params, batch)
            count = _drop_counter(cfg, mesh, pod)
            ffn_np = {k: np.asarray(params["seg0"]["ffn"][k])
                      for k in ("router", "w_gate", "w_up", "w_down")}
            out[f"drops_pods{pods}"] = np.stack([np.asarray(count(
                {k: v[l] for k, v in ffn_np.items()}, h.reshape(-1, cfg.d_model)))
                for l, h in enumerate(inputs)])
    np.savez(dst, **out)
    print("PASS torch_moe_train_ref")


if __name__ == "__main__":
    main(sys.argv[1])
