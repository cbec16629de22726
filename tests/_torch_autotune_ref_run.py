"""The reference's ``calibrate_chip`` on 8 fake CPU devices, for the port's
tests.

    python tests/_torch_autotune_ref_run.py <in.json> <out.json>

``in.json`` holds a list of cases, each ``{"walls": [w0, w1, w2, w3],
"message_rows": [...], "row_bytes": int, "chip": {field: value} | null}``.
For each case ``repro.core.autotune._best_wall`` returns the four walls in
order (two link-law walls, then two pack-law walls), so the fit is the
reference's arithmetic on given walls; ``chip`` replaces fields of ``V5E``.
``out.json`` gets one dict of the returned ``ChipSpec``'s fields a case.
The fake-device flag must be set before JAX starts, so this runs as a
subprocess.
"""

import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.core import autotune  # noqa: E402
from repro.core.topology import V5E  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402


def main(src: str, dst: str) -> None:
    with open(src) as f:
        cases = json.load(f)
    mesh = make_test_mesh((8,), ("x",))
    out = []
    for case in cases:
        walls = iter(case["walls"])
        autotune._best_wall = lambda fn, *args, **kw: next(walls)
        chip = dataclasses.replace(V5E, **(case["chip"] or {}))
        got = autotune.calibrate_chip(
            mesh, "x", chip=chip, message_rows=tuple(case["message_rows"]),
            row_bytes=case["row_bytes"],
        )
        out.append(dataclasses.asdict(got))
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
