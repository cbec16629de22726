"""The port's simulated exchange fabric against the JAX package, bit for bit.

* In process: the port's batched pack (buffers, counts, drops) equals the
  reference's per-device ``pack_by_destination`` for every shard, with both
  pack implementations, and the port's transports all equal one transpose.
* In ONE subprocess that runs this file as a script with 8 fake XLA devices
  (the flag is never set in the pytest process): the reference's
  ``hash_shuffle`` (every transport, 1 and 2 pipeline chunks, transport
  chunks) and ``hash_shuffle_two_level`` (2 pods x 4) under ``shard_map``,
  plus the per-edge destination histograms of TPC-H Q17 (plain and salted)
  and Q3 on 8 shards.  Every shard's rows, valid mask and drops, and every
  histogram, must equal the port's.
"""

import os
import subprocess
import sys

if __name__ == "__main__":  # the reference side, on 8 fake devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

N = 8  # units
T = 64  # rows per unit
SHUFFLE_CONFIGS = [  # (impl, num_chunks, transport_chunks)
    ("xla", 1, 1),
    ("round_robin", 1, 1),
    ("round_robin", 2, 2),
    ("one_factorization", 2, 1),
]
TWO_LEVEL_CONFIGS = [("xla", 1), ("round_robin", 2), ("one_factorization", 2)]
DATASETS = {"uniform": 64, "skewed": 16}  # name -> capacity (skewed drops rows)


def _data(name: str):
    rng = np.random.default_rng(7)
    uniform = rng.integers(0, 10_000, N * T).astype(np.int32)
    skewed = np.where(rng.random(N * T) < 0.6, 7, uniform).astype(np.int32)
    keys = uniform if name == "uniform" else skewed
    rows = np.stack([keys, keys * 2 + 1, np.arange(N * T, dtype=np.int32)], axis=1)
    valid = rng.random(N * T) >= 0.15
    return keys, rows, valid


def _queries():
    """(name, query factory args, zipf kwargs) of the histogram cases."""
    return [
        ("q17", dict(), {}),
        ("q3", dict(), {}),
        ("q17_salted", dict(brand=11, container=25), dict(zipf_partkey=1.2)),
    ]


def reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import exchange
    from repro.launch.mesh import make_test_mesh
    from repro.relational import datagen
    from repro.relational import stats as rstats
    from repro.relational.planner import executor, tpch

    out = {}
    flat = make_test_mesh((N,), ("x",))
    pods = make_test_mesh((2, N // 2), ("pod", "q"))
    for name, cap in DATASETS.items():
        keys, rows, valid = map(jnp.asarray, _data(name))
        for impl, ch, tc in SHUFFLE_CONFIGS:
            fn = shard_map(
                lambda k, r, v, impl=impl, ch=ch, tc=tc, cap=cap: exchange.hash_shuffle(
                    k, r, "x", capacity=cap, impl=impl, valid=v, pack_impl="pallas",
                    num_chunks=ch, transport_chunks=tc,
                ),
                mesh=flat, in_specs=(P("x"),) * 3, out_specs=(P("x"), P("x"), P()),
                check_vma=False,
            )
            r, v, d = jax.jit(fn)(keys, rows, valid)
            out[f"shuffle/{name}/{impl}/{ch}/{tc}"] = (r, v, d)
        for impl, ch in TWO_LEVEL_CONFIGS:
            fn = shard_map(
                lambda k, r, v, impl=impl, ch=ch, cap=cap: exchange.hash_shuffle_two_level(
                    k, r, "q", "pod", capacity=cap, impl=impl, valid=v, pack_impl="xla",
                    num_chunks=ch,
                ),
                mesh=pods, in_specs=(P(("pod", "q")),) * 3,
                out_specs=(P(("pod", "q")), P(("pod", "q")), P()), check_vma=False,
            )
            r, v, d = jax.jit(fn)(keys, rows, valid)
            out[f"two_level/{name}/{impl}/{ch}"] = (r, v, d)
    arrays = {}
    for key, (r, v, d) in out.items():
        arrays[key + "/rows"], arrays[key + "/valid"] = np.asarray(r), np.asarray(v)
        arrays[key + "/dropped"] = np.asarray(d)
    for qname, args, zipf in _queries():
        tabs = datagen.gen_all(0.01, **zipf)
        pq = tpch.ALL_QUERIES[qname.split("_")[0]](**args)
        catalog = {t: tabs[t].capacity for t in pq.tables}
        stats = rstats.collect_stats({t: tabs[t] for t in pq.tables}) if zipf else None
        run = executor.compile_plan(pq.plan(catalog, N, stats=stats), tabs)
        _raw, qt = run.collect(run.dispatch())
        for edge in qt.edges:
            arrays[f"hist/{qname}/{edge.key}"] = np.asarray(edge.hist, np.int64)
            arrays[f"overload/{qname}/{edge.key}"] = np.asarray(
                [edge.plain_overload, edge.overload, float(edge.salted)], np.float32
            )
    np.savez(out_path, **arrays)


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import exchange as ref_exchange  # noqa: E402
from repro_torch.core import exchange  # noqa: E402
from repro_torch.core.exchange import make_mesh  # noqa: E402


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "reference.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(path)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(path))


def _port_inputs(name: str):
    keys, rows, valid = _data(name)
    return (
        torch.from_numpy(keys).reshape(N, T),
        torch.from_numpy(rows).reshape(N, T, 3),
        torch.from_numpy(valid).reshape(N, T),
    )


def _assert_same(ref, key, rows, valid, dropped):
    np.testing.assert_array_equal(rows.reshape(ref[key + "/rows"].shape).numpy(), ref[key + "/rows"])
    np.testing.assert_array_equal(valid.reshape(-1).numpy(), ref[key + "/valid"])
    assert set(dropped.tolist()) == {int(ref[key + "/dropped"])}


@pytest.mark.parametrize("pack", ["torch", "cuda"])
@pytest.mark.parametrize("impl,ch,tc", SHUFFLE_CONFIGS)
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_hash_shuffle_equals_reference(reference, name, impl, ch, tc, pack):
    keys, rows, valid = _port_inputs(name)
    r, v, d = exchange.hash_shuffle(
        keys, rows, make_mesh(N), "q", DATASETS[name], impl=impl, valid=valid,
        pack_impl=pack, num_chunks=ch, transport_chunks=tc,
    )
    _assert_same(reference, f"shuffle/{name}/{impl}/{ch}/{tc}", r, v, d)
    if name == "skewed":
        assert int(d[0]) > 0  # the capacity bound really bites


@pytest.mark.parametrize("pack", ["torch", "cuda"])
@pytest.mark.parametrize("impl,ch", TWO_LEVEL_CONFIGS)
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_two_level_shuffle_equals_reference(reference, name, impl, ch, pack):
    keys, rows, valid = _port_inputs(name)
    r, v, d = exchange.hash_shuffle_two_level(
        keys, rows, make_mesh(N, num_pods=2), "q", "pod", DATASETS[name], impl=impl,
        valid=valid, pack_impl=pack, num_chunks=ch,
    )
    _assert_same(reference, f"two_level/{name}/{impl}/{ch}", r, v, d)


@pytest.mark.parametrize("qname,args,zipf", _queries())
def test_edge_histograms_equal_reference(reference, qname, args, zipf):
    from repro_torch.relational import datagen, stats
    from repro_torch.relational.context import ExecutionContext
    from repro_torch.relational.planner import executor, tpch

    tabs = datagen.gen_all(0.01, device="cpu", **zipf)
    pq = tpch.ALL_QUERIES[qname.split("_")[0]](**args)
    catalog = {t: tabs[t].capacity for t in pq.tables}
    profile = stats.collect_stats({t: tabs[t] for t in pq.tables}) if zipf else None
    run = executor.compile_plan(pq.plan(catalog, N, stats=profile), tabs,
                                ExecutionContext(num_shards=N, device="cpu"))
    _result, dropped, reports = run.dispatch()
    assert int(dropped) == 0
    want = {k.split("/", 2)[2]: v for k, v in reference.items() if k.startswith(f"hist/{qname}/")}
    assert sorted(reports) == sorted(want) and want
    for key, rep in reports.items():
        np.testing.assert_array_equal(rep["hist"].numpy(), want[key])
        plain, over, salted = reference[f"overload/{qname}/{key}"]
        assert bool(rep["salted"]) == bool(salted)
        assert float(rep["plain_overload"]) == plain and float(rep["overload"]) == over
    if zipf:  # the skewed_q17 scenario: salting spreads the heavy key
        (rep,) = reports.values()
        assert float(rep["plain_overload"]) > 2.0 and float(rep["overload"]) < 1.3


@pytest.mark.parametrize("pack", ["torch", "cuda"])
@pytest.mark.parametrize("capacity", [4, 40])
def test_pack_by_destination_equals_reference_per_shard(pack, capacity):
    rng = np.random.default_rng(capacity)
    S, rows_per_shard, nd = 5, 300, 6
    dest = rng.integers(0, nd, (S, rows_per_shard)).astype(np.int32)
    rows = rng.integers(-1000, 1000, (S, rows_per_shard, 2)).astype(np.int32)
    valid = rng.random((S, rows_per_shard)) >= 0.2
    bufs, counts, dropped = exchange.pack_by_destination(
        torch.from_numpy(dest), torch.from_numpy(rows), nd, capacity,
        valid=torch.from_numpy(valid), impl=pack,
    )
    for s in range(S):
        for ref_pack in ("xla", "pallas"):
            wb, wc, wd = map(np.asarray, ref_exchange.pack_by_destination(
                jnp.asarray(dest[s]), jnp.asarray(rows[s]), nd, capacity,
                valid=jnp.asarray(valid[s]), impl=ref_pack,
            ))
            np.testing.assert_array_equal(bufs[s].numpy(), wb)
            np.testing.assert_array_equal(counts[s].numpy(), wc)
            assert int(dropped[s]) == int(wd)


@pytest.mark.parametrize("num_pods,axis", [(1, "q"), (2, "q"), (2, "pod"), (4, "pod")])
def test_transports_equal_one_transpose(num_pods, axis):
    mesh = make_mesh(8, num_pods)
    A = mesh.size(axis)
    x = torch.arange(8 * A * 4 * 2).reshape(8, A, 4, 2)
    want = exchange.xla_all_to_all(x, mesh, axis)
    g = x.reshape(num_pods, 8 // num_pods, A, 4, 2)
    # y[unit, j] = x[j-th unit of the same axis group, message for unit]
    for s in range(8):
        p, i = divmod(s, 8 // num_pods)
        for j in range(A):
            src = g[p, j] if axis == "q" else g[j, i]
            me = i if axis == "q" else p
            assert torch.equal(want[s, j], src[me])
    for impl in ("round_robin", "one_factorization"):
        for chunks in (1, 2, 4):
            got = exchange.all_to_all(x, mesh, axis, impl=impl, num_chunks=chunks)
            assert torch.equal(got, want), (impl, chunks)


@pytest.mark.parametrize("num_pods", [1, 2])
def test_broadcast_gathers_every_unit_in_order(num_pods):
    from repro_torch.core.multiplexer import make_multiplexer

    x = torch.arange(8 * 3).reshape(8, 3)
    for impl in ("xla", "round_robin"):
        mux = make_multiplexer(make_mesh(8, num_pods), impl=impl)
        got = mux.broadcast_global(x, "q").reshape(8, -1)
        assert torch.equal(got, x.reshape(1, -1).expand(8, -1))
