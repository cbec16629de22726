"""The port's ``core/skew.py``, ``configs/paper.py`` and the table
functions against the JAX package.

* Every function of ``core/skew.py`` returns the reference's values on the
  same seeded numpy inputs (bit for bit: both are the same numpy code),
  the paper's 240-vs-6 partition numbers at z = 0.84 included, and raises
  where the reference raises (``tests/test_stats.py``'s rejection cases).
* ``configs/paper.py``'s ``CONFIG`` and ``SMOKE`` equal the reference's,
  field for field.
* ``Table.select``, ``encode``, ``rows_as_matrix``, ``from_matrix`` and
  ``shard_rows`` (interleaved and contiguous) equal the reference's bit for
  bit on the reference's TPC-H tables, handed over with
  ``table_from_numpy``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import paper as ref_paper
from repro.core import skew as ref_skew
from repro.relational import datagen as ref_datagen
from repro.relational import table as ref_table
from repro_torch.configs import paper
from repro_torch.core import skew
from repro_torch.relational.table import Table, pad_to, shard_rows, table_from_numpy


# ----------------------------------------------------------------------------
# core/skew.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("z", [0.5, 0.84, 1.0, 1.5])
@pytest.mark.parametrize("num_keys", [1, 10, 100_000])
def test_zipf_pmf_and_harmonic_match_reference(num_keys, z):
    np.testing.assert_array_equal(skew.zipf_pmf(num_keys, z), ref_skew.zipf_pmf(num_keys, z))
    for n in (num_keys, 5_600_000_000):
        assert skew.generalized_harmonic(n, z) == ref_skew.generalized_harmonic(n, z)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("parts", [6, 8, 240])
def test_partition_overload_matches_reference(parts, seed):
    assert skew.zipf_partition_overload(parts, 0.84, 50_000, seed) == \
        ref_skew.zipf_partition_overload(parts, 0.84, 50_000, seed)
    assert skew.zipf_partition_overload_analytic(parts, 0.84, seed=seed) == \
        ref_skew.zipf_partition_overload_analytic(parts, 0.84, seed=seed)
    assert skew.zipf_partition_overload_expected(parts, 0.84, 20_000, trials=3) == \
        ref_skew.zipf_partition_overload_expected(parts, 0.84, 20_000, trials=3)


def test_paper_partition_numbers_match_reference():
    """Zipf z = 0.84: over 2x at 240 partitions, ~2.8 % at 6 (paper §3.1)."""
    over_240 = skew.zipf_partition_overload_analytic(240, z=0.84)
    over_6 = skew.zipf_partition_overload_analytic(6, z=0.84)
    assert over_240 > 2.0 and over_6 < 1.06, (over_240, over_6)
    assert (over_240, over_6) == (ref_skew.zipf_partition_overload_analytic(240, z=0.84),
                                  ref_skew.zipf_partition_overload_analytic(6, z=0.84))


@pytest.mark.parametrize("num_salts", [1, 2, 8, 64])
def test_salting_matches_reference_and_round_trips(num_salts):
    rng = np.random.default_rng(num_salts)
    keys = (rng.zipf(1.8, size=20_000) % 1000).astype(np.int64)
    heavy = np.argsort(np.bincount(keys))[-8:]
    got = skew.salt_keys(keys, heavy, num_salts, seed=5)
    np.testing.assert_array_equal(got, ref_skew.salt_keys(keys, heavy, num_salts, seed=5))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(skew.unsalt_keys(got, num_salts), keys)
    np.testing.assert_array_equal(skew.unsalt_keys(got, num_salts),
                                  ref_skew.unsalt_keys(got, num_salts))
    loads = np.bincount((skew._hash_keys(got, 0) % np.uint64(8)).astype(np.int64), minlength=8)
    assert skew.straggler_excess(loads) == ref_skew.straggler_excess(loads)


@given(
    st.lists(st.integers(0, 2**64 - 1), min_size=1, max_size=64),
    st.integers(1, 512),
    st.integers(0, 2**31 - 1),
)
@settings(max_examples=50, deadline=None)
def test_salt_keys_round_trip_or_reject_like_reference(keys, num_salts, seed):
    keys = np.asarray(keys, dtype=np.uint64)
    heavy = keys[:: max(len(keys) // 3, 1)]
    if num_salts > 1 and int(keys.max()) >= 2**64 // num_salts:
        with pytest.raises(ValueError, match="overflow"):
            ref_skew.salt_keys(keys, heavy, num_salts, seed=seed)
        with pytest.raises(ValueError, match="overflow"):
            skew.salt_keys(keys, heavy, num_salts, seed=seed)
        return
    got = skew.salt_keys(keys, heavy, num_salts, seed=seed)
    np.testing.assert_array_equal(got, ref_skew.salt_keys(keys, heavy, num_salts, seed=seed))
    np.testing.assert_array_equal(skew.unsalt_keys(got, num_salts), keys)


@pytest.mark.parametrize("mod", [ref_skew, skew], ids=["reference", "port"])
def test_salt_keys_rejections(mod):
    with pytest.raises(ValueError, match="negative"):
        mod.salt_keys(np.asarray([3, -1], np.int64), [3], 4)
    with pytest.raises(ValueError, match="overflow"):
        mod.salt_keys(np.asarray([2**63], np.uint64), [], 4)
    with pytest.raises(ValueError, match="num_salts"):
        mod.salt_keys(np.asarray([1, 2], np.int64), [1], 0)


def test_straggler_excess_and_hash_match_reference():
    rng = np.random.default_rng(0)
    for loads in (rng.integers(1, 100, 8), np.ones(6), rng.random(240)):
        assert skew.straggler_excess(loads) == ref_skew.straggler_excess(loads)
    keys = rng.integers(0, 2**40, 1000)
    for seed in (0, 7):
        np.testing.assert_array_equal(skew._hash_keys(keys, seed), ref_skew._hash_keys(keys, seed))
    assert skew.__all__ == ref_skew.__all__


# ----------------------------------------------------------------------------
# configs/paper.py
# ----------------------------------------------------------------------------

def test_paper_config_matches_reference():
    for got, want in ((paper.CONFIG, ref_paper.CONFIG), (paper.SMOKE, ref_paper.SMOKE)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(paper.PaperConfig()) == dataclasses.asdict(ref_paper.PaperConfig())


# ----------------------------------------------------------------------------
# relational/table.py
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_tables():
    ref = ref_datagen.gen_all(0.004)
    port = {
        name: table_from_numpy({c: np.asarray(v) for c, v in t.columns.items()},
                               np.asarray(t.valid), "cpu", t.dictionaries)
        for name, t in ref.items()
    }
    return ref, port


def _assert_tables_equal(got: Table, want, shape=None):
    def conv(x):
        x = np.asarray(x)
        return x.reshape(shape + x.shape[1:]) if shape else x

    assert sorted(got.columns) == sorted(want.columns)
    for k in want.columns:
        g, w = got.columns[k].numpy(), conv(want.columns[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_array_equal(got.valid.numpy(), conv(want.valid))
    assert got.dictionaries == want.dictionaries


@pytest.mark.parametrize("name", ["lineitem", "orders", "customer", "part"])
def test_select_and_encode_match_reference(both_tables, name):
    ref, port = both_tables
    want, got = ref[name], port[name]
    cols = sorted(want.columns)[::2] + sorted(want.dictionaries)[:1]
    cols = list(dict.fromkeys(cols))
    _assert_tables_equal(got.select(cols), want.select(cols))
    for col, words in want.dictionaries.items():
        for w in (words[0], words[-1]):
            assert got.encode(col, w) == want.encode(col, w)
        with pytest.raises(ValueError):
            got.encode(col, "no such word")


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("name", ["lineitem", "orders"])
def test_rows_as_matrix_and_back_match_reference(both_tables, name, dtype):
    import jax.numpy as jnp

    ref, port = both_tables
    want, got = ref[name], port[name]
    cols = sorted(want.columns)[:5]
    m_want = want.rows_as_matrix(cols, dtype=getattr(jnp, dtype))
    m_got = got.rows_as_matrix(cols, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))
    assert m_got.numpy().dtype == np.asarray(m_want).dtype
    back_dtypes = {c: want.columns[c].dtype for c in cols[:3]}
    t_want = ref_table.Table.from_matrix(m_want, cols, want.valid, back_dtypes)
    t_got = Table.from_matrix(m_got, cols, got.valid,
                              {c: torch.from_numpy(np.zeros(0, d)).dtype
                               for c, d in back_dtypes.items()})
    _assert_tables_equal(t_got, t_want)
    # on a sharded table the row image keeps the shard dim
    sh = shard_rows(got, 8)
    m_sh = sh.rows_as_matrix(cols, dtype=getattr(torch, dtype))
    assert tuple(m_sh.shape) == (8, got.capacity // 8, len(cols))
    np.testing.assert_array_equal(m_sh.reshape(-1, len(cols)).numpy(),
                                  np.asarray(ref_table.shard_rows(want, 8).rows_as_matrix(
                                      cols, dtype=getattr(jnp, dtype))))


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("shards", [1, 4, 8])
@pytest.mark.parametrize("name", ["lineitem", "customer"])
def test_shard_rows_matches_reference(both_tables, name, shards, interleave):
    ref, port = both_tables
    want, got = ref[name], port[name]
    cap = -(-want.capacity // shards) * shards
    want, got = ref_table.pad_to(want, cap), pad_to(got, cap)
    s_want = ref_table.shard_rows(want, shards, interleave=interleave)
    s_got = shard_rows(got, shards, interleave=interleave)
    _assert_tables_equal(s_got, s_want, shape=(shards, cap // shards))
    if shards > 1:
        first = s_got.columns[sorted(want.columns)[0]][:, 0].numpy()
        col = np.asarray(want.columns[sorted(want.columns)[0]])
        step = 1 if interleave else cap // shards
        np.testing.assert_array_equal(first, col[::step][:shards])

