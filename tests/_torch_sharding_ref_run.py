"""The reference's logical-axis trees and sharding resolution, for the port's
tests.

    python tests/_torch_sharding_ref_run.py <in.json> <out.json>

``in.json`` holds ``configs`` (``[arch, "smoke" | "full"]`` pairs) and
``pairs`` (``[shape, names]``: a leaf's shape and its logical axis names).
``out.json`` gets, for every config, the reference's ``specs(cfg)`` and
``cache_specs(cfg)`` (tuples as lists), and for every pair its
``NamedSharding.spec`` from ``repro.distributed.sharding.logical_sharding``
on the ``(4, 2)`` and ``(2, 4)`` ``data x model`` meshes
(``default_rules(False)``) and the ``(2, 2, 2)`` ``pod x data x model`` mesh
(``default_rules(True)``), with and without ``allow_uneven`` and
``strict``.  The meshes need 8 fake
devices, whose flag must be set before JAX starts, so this runs as a
subprocess.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.distributed.sharding import (  # noqa: E402
    MeshContext,
    default_rules,
    logical_sharding,
)
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import registry  # noqa: E402

MESHES = {"data4_model2": ((4, 2), ("data", "model"), False),
          "data2_model4": ((2, 4), ("data", "model"), False),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"), True)}


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return [None if a is None else a for a in tree]


def _spec(s) -> list:
    return [a if a is None or isinstance(a, str) else list(a) for a in s.spec]


def main(src: str, dst: str) -> None:
    with open(src) as f:
        job = json.load(f)
    out = {"specs": {}, "cache_specs": {}, "resolved": {}}
    for arch, size in job["configs"]:
        cfg = (get_smoke_config if size == "smoke" else get_config)(arch)
        m = registry._module(cfg)
        key = f"{arch}:{size}"
        out["specs"][key] = _plain(m.specs(cfg))
        out["cache_specs"][key] = _plain(m.cache_specs(cfg))
    for mesh_key, (shape, axes, multi_pod) in MESHES.items():
        mesh = make_test_mesh(shape, axes)
        for uneven in (False, True):
            rules = default_rules(multi_pod).replace(allow_uneven=uneven)
            ctx = MeshContext(mesh=mesh, rules=rules, exchange_axis="model",
                              pod_axis="pod" if multi_pod else None)
            for strict in (False, True):
                out["resolved"][f"{mesh_key}:{uneven}:{strict}"] = [
                    _spec(logical_sharding(tuple(shp), *names, ctx=ctx, strict=strict))
                    for shp, names in job["pairs"]]
    with open(dst, "w") as f:
        json.dump(out, f)
    print("PASS torch_sharding_ref")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
