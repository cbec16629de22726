"""The port's pack kernels' plain versions against the JAX package.

Every comparison is bit-exact (integer outputs): the port's batched plain
versions (``repro_torch.kernels.ref`` / ``ops``), which the CUDA wrappers
run for CPU tensors, against the reference's jnp oracles and against its
Pallas kernels in interpret mode.  The ``gpu``-marked tests hold the CUDA
kernels to the plain versions on the card, and the query path on the card to
the same path on the CPU; they skip without a card.  The JAX package is
imported through a fixture, so the file also imports on a machine without
JAX (``python -m pytest -m gpu tests/test_torch_hash_partition.py`` on the
card).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import ops
from repro_torch.kernels import ref

S = 3  # shards per batched call


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's kernels, oracles and wrappers."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import hash_partition, ops as ref_ops, ref as ref_ref

    return types.SimpleNamespace(jnp=jnp, kernels=hash_partition, ops=ref_ops, ref=ref_ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _keys_valid(rng, T):
    keys = rng.integers(-(2**31), 2**31 - 1, (S, T), dtype=np.int32)
    valid = (rng.random((S, T)) >= 0.1).astype(np.int32)
    return keys, valid


def test_fibonacci_hash_matches_reference(jax_ref):
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, 4096, dtype=np.int32),
        np.array([0, 1, -1, 2**31 - 1, -(2**31)], np.int32),
    ])
    want = np.asarray(jax_ref.ref.fibonacci_hash_ref(jax_ref.jnp.asarray(keys))).astype(np.int64)
    got = ref.fibonacci_hash(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,P", [(256, 8), (512, 3), (1024, 4), (768, 1)])
def test_hash_partition_pack_matches_pallas_interpret(T, P, jax_ref):
    rng = np.random.default_rng(T + P)
    keys, valid = _keys_valid(rng, T)
    dest, hist, rank = hp.hash_partition_pack(
        torch.from_numpy(keys), torch.from_numpy(valid), P
    )
    assert hist.shape == (S, T // 256, P + 1)
    # block-local outputs: the shards laid end to end are one flat input
    k, v = jax_ref.jnp.asarray(keys.reshape(-1)), jax_ref.jnp.asarray(valid.reshape(-1))
    for want in (
        jax_ref.kernels.hash_partition_pack(k, v, P, interpret=True),
        jax_ref.ref.hash_partition_pack_ref(k, v, P),
    ):
        wd, wh, wr = map(np.asarray, want)
        np.testing.assert_array_equal(dest.numpy().reshape(-1), wd)
        np.testing.assert_array_equal(hist.numpy().reshape(-1, P + 1), wh)
        np.testing.assert_array_equal(rank.numpy().reshape(-1), wr)


@pytest.mark.parametrize("T,bins", [(256, 3), (512, 9), (1024, 65), (256, 1)])
def test_partition_pack_matches_pallas_interpret(T, bins, jax_ref):
    rng = np.random.default_rng(T * bins)
    # ids in [0, bins], where ``bins`` is the padding id that matches no bin
    dest = rng.integers(0, bins + 1, (S, T), dtype=np.int32)
    dest[:, -7:] = bins
    hist, rank = hp.partition_pack(torch.from_numpy(dest), bins)
    d = jax_ref.jnp.asarray(dest.reshape(-1))
    for want in (
        jax_ref.kernels.partition_pack(d, bins, interpret=True),
        jax_ref.ref.partition_pack_ref(d, bins),
    ):
        wh, wr = map(np.asarray, want)
        np.testing.assert_array_equal(hist.numpy().reshape(-1, bins), wh)
        np.testing.assert_array_equal(rank.numpy().reshape(-1), wr)
    assert int(hist.sum()) == int((dest < bins).sum())  # padding ids uncounted


@pytest.mark.parametrize("T", [1, 100, 256, 300, 1000, 2049])
def test_hash_partition_ranks_ragged_match_reference(T, jax_ref):
    rng = np.random.default_rng(T)
    keys, valid = _keys_valid(rng, T)
    P = 8
    dest, rank, counts = ops.hash_partition_ranks(
        torch.from_numpy(keys), torch.from_numpy(valid), P
    )
    for s in range(S):
        wd, wr, wc = map(np.asarray, jax_ref.ops.hash_partition_ranks(
            jax_ref.jnp.asarray(keys[s]), jax_ref.jnp.asarray(valid[s]), P
        ))
        np.testing.assert_array_equal(dest[s].numpy(), wd)
        np.testing.assert_array_equal(rank[s].numpy(), wr)
        np.testing.assert_array_equal(counts[s].numpy(), wc)


@pytest.mark.parametrize("T,bins", [(5, 3), (300, 3), (1000, 9), (513, 65)])
def test_partition_ranks_ragged_match_reference(T, bins, jax_ref):
    rng = np.random.default_rng(T + bins)
    dest = rng.integers(0, bins + 1, (S, T), dtype=np.int32)
    rank, counts = ops.partition_ranks(torch.from_numpy(dest), bins)
    for s in range(S):
        wr, wc = map(np.asarray, jax_ref.ops.partition_ranks(jax_ref.jnp.asarray(dest[s]), bins))
        in_range = dest[s] < bins  # out-of-range ids get an arbitrary rank
        np.testing.assert_array_equal(rank[s].numpy()[in_range], wr[in_range])
        np.testing.assert_array_equal(counts[s].numpy(), wc)


def test_cpu_tensors_take_the_plain_version_without_counting():
    hp.reset_launch_counts()
    keys = torch.arange(512, dtype=torch.int32).reshape(2, 256)
    valid = torch.ones_like(keys)
    got = hp.hash_partition_pack(keys, valid, 4)
    want = ref.hash_partition_pack_ref(keys, valid, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hp.partition_pack(got[0], 5)
    assert hp.LAUNCHES == {"hash_partition_pack": 0, "partition_pack": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("T,P,block", [(256, 8, 256), (750_080, 8, 256), (4096, 64, 256), (100, 3, 100)])
def test_cuda_kernels_match_plain_versions(cuda_device, T, P, block):
    rng = np.random.default_rng(T)
    keys, valid = _keys_valid(rng, T)
    k = torch.from_numpy(keys).to(cuda_device)
    v = torch.from_numpy(valid).to(cuda_device)
    hp.reset_launch_counts()
    got = hp.hash_partition_pack(k, v, P, block=block)
    want = ref.hash_partition_pack_ref(k, v, P, block=block)
    dest = torch.from_numpy(rng.integers(0, P + 2, (S, T), dtype=np.int32)).to(cuda_device)
    got2 = hp.partition_pack(dest, P + 1, block=block)
    want2 = ref.partition_pack_ref(dest, P + 1, block=block)
    torch.cuda.synchronize()
    for g, w in zip(got + got2, want + want2):
        assert torch.equal(g, w)
    assert hp.LAUNCHES == {"hash_partition_pack": 1, "partition_pack": 1}


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernel_cannot_take(cuda_device):
    dest = torch.zeros((2, 1024), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        hp.partition_pack(dest, hp.MAX_BINS + 1)
    with pytest.raises(ValueError, match="block"):
        hp.partition_pack(dest, 3, block=512)
    with pytest.raises(ValueError, match="contiguous int32"):
        hp.partition_pack(dest.to(torch.int64), 3)
    with pytest.raises(ValueError, match="contiguous int32"):
        hp.hash_partition_pack(dest[:, ::2], dest[:, ::2], 4)


@pytest.mark.gpu
@pytest.mark.parametrize("query,pods", [("q3", 1), ("q17", 1), ("q3", 2), ("q18", 2)])
def test_queries_on_the_card_equal_the_cpu(cuda_device, query, pods):
    """The main path on the card (CUDA pack kernels) against the same path
    on the CPU (plain versions): integer outputs exactly, f32 sums within
    rtol 1e-5 (atomic float sums on the card run in no fixed order)."""
    from repro_torch.relational import datagen
    from repro_torch.relational.context import ExecutionContext
    from repro_torch.relational.planner import tpch

    tabs = datagen.gen_all(0.01, device="cpu")
    results = {}
    for device in ("cpu", "cuda"):
        hp.reset_launch_counts()
        ctx = ExecutionContext(num_shards=8, num_pods=pods, device=device, pack_impl="cuda")
        results[device] = tpch.run_query(tpch.ALL_QUERIES[query](), tabs, ctx)
        launched = hp.LAUNCHES["hash_partition_pack"]
        assert launched > 0 if device == "cuda" else launched == 0
    got, want = results["cuda"], results["cpu"]
    if not isinstance(want, dict):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        return
    for k in want:
        if np.issubdtype(np.asarray(want[k]).dtype, np.integer):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
