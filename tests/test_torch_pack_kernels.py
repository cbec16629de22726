"""The pack kernels' schedule, emulated lane by lane, against the plain
versions and the JAX package's Pallas kernels.

``csrc/hash_partition.cu`` gives warp ``w`` of ``W`` the row-blocks ``w, w
+ W, ...`` and has two paths through a row-block.  The packed path (up to 16 bins, block a
multiple of 4, 16-byte aligned tensors: every call of the main path) walks
it in rounds of 128 rows, lane ``l`` holding rows ``128 r + 4 l .. + 3``;
each lane counts its rows' bins in 8-bit fields, four bins a 32-bit word,
and an exclusive scan of the words over the lanes (shuffles) plus the
rows of round 0 gives every row's rank; lane 31's prefix and counts give
the round's histogram.  The match path (any other call) walks the row-block in rounds
of 32 rows, row ``32 r + lane`` in round ``r``, with ``__match_any_sync``
and a shared counter a bin that the group's lowest lane bumps.  Destinations
``h % P`` come from a multiply by a 64-bit magic number, not a division.

:func:`emulate` runs that schedule in numpy, warp by warp, with the
kernel's constants and its integer arithmetic (the scan's 32-bit words wrap
as on the card), so the algorithm is checked here, on the CPU, where the
kernel cannot run: bit for bit against ``ref.partition_pack_ref`` /
``ref.hash_partition_pack_ref`` / ``ref.hash_partition_ref`` and against the
Pallas kernels in interpret mode.  The ``gpu``-marked tests hold the CUDA
kernels to the plain versions on the card at the same shapes and at the main
path's, over repeated launches, on two streams at once and on tensors that
are not 16-byte aligned; they skip without a card.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import ref

# The kernel's constants (csrc/hash_partition.cu).
WARPS = 8  # a 256-thread block
BLOCKS_PER_SM = 4
ROWS = 8  # packed path: rows a lane holds, 4 in each of two rounds
ROUNDS = 8  # match path: 256 rows, 32 a round
PACKED_BINS = 16  # 4 words of four 8-bit fields
LANES = np.arange(32)
LOWER = ((np.uint64(1) << LANES.astype(np.uint64)) - np.uint64(1)).astype(np.uint32)
M32, M64 = (1 << 32) - 1, (1 << 64) - 1


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's Pallas kernels and jnp oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import hash_partition, ref as ref_ref

    return types.SimpleNamespace(jnp=jnp, kernels=hash_partition, ref=ref_ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def warp_blocks(num_blocks: int, sms: int) -> list[range]:
    """Each warp's row-blocks, in the order it takes them: the grid is at most
    ``BLOCKS_PER_SM`` blocks of ``WARPS`` warps an SM, and warp ``w`` of
    ``W`` takes ``w, w + W, w + 2 W, ...``."""
    grid = min(-(-num_blocks // WARPS), sms * BLOCKS_PER_SM)
    warps = grid * WARPS
    return [range(w, num_blocks, warps) for w in range(warps)]


def fast_mod(h: np.ndarray, P: int) -> np.ndarray:
    """``h % P`` as the kernel computes it: the high 64 bits of
    ``((magic * h) mod 2**64) * P``, ``magic = 2**64 // P + 1 mod 2**64``."""
    magic = np.uint64((M64 // P + 1) & M64)
    with np.errstate(over="ignore"):
        lo = magic * np.asarray(h, np.uint64)  # wraps mod 2**64, as on the card
    hi, low = lo >> np.uint64(32), lo & np.uint64(M32)
    P = np.uint64(P)  # (hi * 2**32 + low) * P >> 64, without a 128-bit product
    return ((hi * P + ((low * P) >> np.uint64(32))) >> np.uint64(32)).astype(np.int64)


def _destinations(mode, x, v, P):
    if mode == "pack":
        return x.astype(np.int64)
    h = ref.fibonacci_hash(torch.from_numpy(x.astype(np.int32))).numpy()
    d = fast_mod(h, P)
    return np.where(v != 0, d, P) if mode == "hash_pack" else d


def _ballot(pred: np.ndarray) -> int:
    return int(np.sum(pred.astype(np.uint64) << LANES.astype(np.uint64)))


def _popc(m: int) -> int:
    return bin(m).count("1")


def _field(word: int, b: int) -> int:
    return (int(word) >> ((b & 3) * 8)) & 0xFF


def _packed_block(mode, x, v, block, num_bins, P):
    """One row-block on the packed path: ``(d, rank, hist)``."""
    d = _destinations(mode, x, v, P)
    rank = np.zeros(ROWS * 32, np.int64)
    words = max(1, -(-num_bins // 4))
    carry = np.zeros(words, np.int64)  # round 0's rows, by bin
    hist = np.zeros(num_bins, np.int64)  # lane b's count of bin b
    for r in range(ROWS // 4):
        rows = 128 * r + 4 * LANES[:, None] + np.arange(4)  # lane l: 4 consecutive rows
        counts = np.zeros((32, words), np.int64)  # each lane's 32-bit words
        local = np.full((32, 4), -1, np.int64)
        for lane in LANES:
            for j in range(4):
                i = rows[lane, j]
                if i < block and 0 <= d[i] < num_bins:
                    w = int(d[i]) >> 2
                    local[lane, j] = _field(counts[lane, w], d[i])
                    counts[lane, w] = (counts[lane, w] + (1 << ((int(d[i]) & 3) * 8))) & M32
        # inclusive Kogge-Stone scan over the lanes (shfl_up), words wrap at 32 bits
        s = counts.copy()
        for off in (1, 2, 4, 8, 16):
            up = np.concatenate([s[:off], s[:-off]])  # shfl_up: lanes < off keep their own
            s = np.where((LANES >= off)[:, None], (s + up) & M32, s)
        before = (s - counts) & M32
        for lane in LANES:
            for j in range(4):
                if local[lane, j] >= 0:
                    i, w = rows[lane, j], int(d[rows[lane, j]]) >> 2
                    rank[i] = _field((carry[w] + before[lane, w]) & M32, d[i]) + local[lane, j]
        total = (before[31] + counts[31]) & M32  # the shuffle from lane 31
        carry = (carry + total) & M32
        hist += [_field(total[b >> 2], b) for b in range(num_bins)]
    return d[:block], rank[:block], hist


def _match_block(mode, x, v, block, num_bins, P, counts):
    """One row-block on the match path, with the warp's shared counters
    ``counts`` (zero on entry, zeroed again on exit): ``(d, rank, hist)``."""
    d_all = np.zeros(ROUNDS * 32, np.int64)
    rank = np.zeros(ROUNDS * 32, np.int64)
    for r in range(ROUNDS):
        i = r * 32 + LANES
        active = i < block
        d = _destinations(mode, x[r * 32:(r + 1) * 32], v[r * 32:(r + 1) * 32], P)
        d_all[i] = d
        counted = active & (d >= 0) & (d < num_bins)
        key = np.where(counted, d, -1)
        peers = [_ballot(key == key[lane]) for lane in LANES]  # __match_any_sync
        leader = [(p & -p).bit_length() - 1 for p in peers]
        before = np.zeros(32, np.int64)
        for lane in LANES:
            if counted[lane] and leader[lane] == lane:
                before[lane] = counts[d[lane]]
                counts[d[lane]] += _popc(peers[lane])
        for lane in LANES:
            if counted[lane]:
                rank[i[lane]] = before[leader[lane]] + _popc(peers[lane] & int(LOWER[lane]))
    hist = counts.copy()
    counts[:] = 0
    return d_all[:block], rank[:block], hist


def emulate(mode: str, src: np.ndarray, valid, block: int, num_bins: int,
            num_partitions: int = 0, sms: int = 1):
    """The kernel's schedule in numpy: ``(dest, hist, rank)`` as the CUDA
    kernel writes them for ``mode`` in ``("pack", "hash_pack", "hash")``
    (``dest`` is the input for "pack"; "hash" writes no rank).  The tensors
    are taken as 16-byte aligned."""
    S, T = src.shape
    xs = src.reshape(-1)
    vs = np.ones_like(xs) if valid is None else valid.reshape(-1)
    G = S * (T // block)
    dest = xs.astype(np.int32).copy()
    rank = np.zeros(S * T, np.int32)
    hist = np.zeros((G, num_bins), np.int32)
    packed = num_bins <= PACKED_BINS and block % 4 == 0
    for blocks in warp_blocks(G, sms):
        counts = np.zeros(num_bins, np.int64)  # the match path's shared counters
        for g in blocks:
            base = g * block
            x = np.zeros(ROUNDS * 32, np.int64)  # 256 rows; those past the block unread
            v = np.zeros(ROUNDS * 32, np.int64)
            x[:block], v[:block] = xs[base:base + block], vs[base:base + block]
            if packed:
                d, rk, h = _packed_block(mode, x, v, block, num_bins, num_partitions)
            else:
                d, rk, h = _match_block(mode, x, v, block, num_bins, num_partitions, counts)
            if mode != "pack":
                dest[base:base + block] = d
            if mode != "hash":
                rank[base:base + block] = rk
            hist[g] = h
    return dest.reshape(S, T), hist.reshape(S, T // block, num_bins), rank.reshape(S, T)


# (S, row-blocks a shard) with one SM emulated (32 warps): one row-block;
# 96 row-blocks, three to every warp; 101, three or four (a ragged tail)
SHAPES = {"one_block": (1, 1), "full_runs": (3, 32), "ragged_runs": (1, 101)}
# 100 and 256 take the packed path up to 16 bins; 50 (not a multiple of 4)
# always takes the match path
BLOCKS = [50, 100, 256]


def _dest(rng, S, T, bins, shape):
    """Ids in [-1, bins]: -1 and ``bins`` (the padding id) match no bin."""
    if shape == "all_padding":
        return np.full((S, T), bins, np.int32)
    d = rng.integers(0, bins + 1, (S, T), dtype=np.int32)
    d[rng.random((S, T)) < 0.02] = -1
    return d


def _keys_valid(rng, S, T):
    keys = rng.integers(-(2**31), 2**31 - 1, (S, T), dtype=np.int32)
    valid = (rng.random((S, T)) >= 0.1).astype(np.int32)
    return keys, valid


def test_fast_mod_equals_the_remainder():
    rng = np.random.default_rng(0)
    h = np.concatenate([rng.integers(0, 2**32, 2000, dtype=np.uint64),
                        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64)])
    for P in (1, 2, 3, 7, 8, 9, 64, 65, 1535, 1536, 2**31 - 1, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(fast_mod(h, P), h.astype(object) % P)


def test_warps_cover_every_row_block_once():
    for G, sms in ((1, 1), (96, 1), (101, 1), (23_440, 132), (7, 132), (1_000, 3)):
        warps = warp_blocks(G, sms)
        assert sorted(g for blocks in warps for g in blocks) == list(range(G))
        lengths = {len(blocks) for blocks in warps}
        assert max(lengths) - min(lengths) <= 1
        assert len(warps) <= sms * BLOCKS_PER_SM * WARPS


@pytest.mark.parametrize("shape", [*SHAPES, "all_padding"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("bins", [1, 3, 9, 16, 17, 65, 1536])
def test_emulated_partition_pack_matches_plain_and_pallas(bins, block, shape, jax_ref):
    S, nblk = SHAPES.get(shape, (2, 3))
    T = nblk * block
    rng = np.random.default_rng(bins * 1000 + block)
    dest = _dest(rng, S, T, bins, shape)
    _, hist, rank = emulate("pack", dest, None, block, bins)
    want_hist, want_rank = ref.partition_pack_ref(torch.from_numpy(dest), bins, block)
    np.testing.assert_array_equal(hist, want_hist.numpy())
    np.testing.assert_array_equal(rank, want_rank.numpy())
    # block-local outputs: the shards laid end to end are one flat input
    wh, wr = map(np.asarray, jax_ref.kernels.partition_pack(
        jax_ref.jnp.asarray(dest.reshape(-1)), bins, block=block, interpret=True))
    np.testing.assert_array_equal(hist.reshape(-1, bins), wh)
    np.testing.assert_array_equal(rank.reshape(-1), wr)
    if shape == "all_padding":
        assert not hist.any() and not rank.any()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("P", [1, 3, 8, 16, 17, 64, 1536])
def test_emulated_hash_partition_matches_plain_and_pallas(P, block, shape, jax_ref):
    S, nblk = SHAPES[shape]
    T = nblk * block
    keys, _ = _keys_valid(np.random.default_rng(P * 1000 + block), S, T)
    pid, hist, _ = emulate("hash", keys, None, block, P, P)
    want_pid, want_hist = ref.hash_partition_ref(torch.from_numpy(keys), P, block)
    np.testing.assert_array_equal(pid, want_pid.numpy())
    np.testing.assert_array_equal(hist, want_hist.numpy())
    wp, wh = map(np.asarray, jax_ref.kernels.hash_partition(
        jax_ref.jnp.asarray(keys.reshape(-1)), P, block=block, interpret=True))
    np.testing.assert_array_equal(pid.reshape(-1), wp)
    np.testing.assert_array_equal(hist.reshape(-1, P), wh)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("P", [1, 2, 8, 15, 16, 64])
def test_emulated_hash_partition_pack_matches_plain_and_pallas(P, block, shape, jax_ref):
    """P + 1 bins: 2, 3, 9, 16 (the packed path's last), 17 and 65."""
    S, nblk = SHAPES[shape]
    T = nblk * block
    keys, valid = _keys_valid(np.random.default_rng(P * 1000 + block), S, T)
    dest, hist, rank = emulate("hash_pack", keys, valid, block, P + 1, P)
    want = ref.hash_partition_pack_ref(torch.from_numpy(keys), torch.from_numpy(valid), P, block)
    for got, w in zip((dest, hist, rank), want):
        np.testing.assert_array_equal(got, w.numpy())
    wd, wh, wr = map(np.asarray, jax_ref.kernels.hash_partition_pack(
        jax_ref.jnp.asarray(keys.reshape(-1)), jax_ref.jnp.asarray(valid.reshape(-1)), P,
        block=block, interpret=True))
    np.testing.assert_array_equal(dest.reshape(-1), wd)
    np.testing.assert_array_equal(hist.reshape(-1, P + 1), wh)
    np.testing.assert_array_equal(rank.reshape(-1), wr)


# ---------------------------------------------------------------- on the card


def _card_shapes(block: int) -> dict[str, tuple[int, int]]:
    """(S, row-blocks a shard) on this card: one row-block; three for every
    warp of the grid; three or four (a ragged tail)."""
    warps = torch.cuda.get_device_properties(0).multi_processor_count * BLOCKS_PER_SM * WARPS
    return {"one_block": (1, 1), "full_runs": (8, 3 * warps // 8),
            "ragged_runs": (1, 3 * warps + 5)}


def _plain(fn, tensors, *args, block, bins):
    """A plain version over chunks of whole row-blocks: its one-hot is [rows,
    bins] int32, too large for the card at MAX_BINS bins and millions of
    rows, and its outputs are block-local, so the chunks join exactly."""
    S, T = tensors[0].shape
    step = max(block, 2**27 // (S * bins) // block * block)
    parts = [fn(*(t[:, i:i + step] for t in tensors), *args, block)
             for i in range(0, T, step)]
    return tuple(torch.cat(xs, dim=1) for xs in zip(*parts))


def _run_all(dev, S, T, bins, block, rng, shape="random", place=None):
    """Each kernel and its plain version on the same card tensors (``place``
    puts each input where the test wants it)."""
    place = place or (lambda a: torch.from_numpy(a).to(dev))
    dest = place(_dest(rng, S, T, bins, shape))
    keys, valid = (place(a) for a in _keys_valid(rng, S, T))
    P = max(bins - 1, 1)
    got = [hp.partition_pack(dest, bins, block), hp.hash_partition(keys, bins, block),
           hp.hash_partition_pack(keys, valid, P, block)]
    want = [_plain(ref.partition_pack_ref, [dest], bins, block=block, bins=bins),
            _plain(ref.hash_partition_ref, [keys], bins, block=block, bins=bins),
            _plain(ref.hash_partition_pack_ref, [keys, valid], P, block=block, bins=bins)]
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["one_block", "full_runs", "ragged_runs", "all_padding"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("bins", [1, 3, 9, 16, 17, 65, hp.MAX_BINS])
def test_cuda_pack_kernels_match_plain_versions(cuda_device, bins, block, shape):
    S, nblk = _card_shapes(block).get(shape, (8, 5))
    rng = np.random.default_rng(bins + block)
    hp.reset_launch_counts()
    got, want = _run_all(cuda_device, S, nblk * block, bins, block, rng, shape)
    torch.cuda.synchronize()
    for name, g, w in zip(("partition_pack", "hash_partition", "hash_partition_pack"), got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b), (name, bins, block, shape)
    assert hp.LAUNCHES == {"hash_partition_pack": 1, "partition_pack": 1, "hash_partition": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8])
def test_cuda_pack_kernels_at_the_main_path_shape(cuda_device, S):
    """One shard's lineitem rows at SF 1 (T=750,080), P=8 and 3 bins."""
    rng = np.random.default_rng(S)
    for bins in (3, 9):
        got, want = _run_all(cuda_device, S, 750_080, bins, 256, rng)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w)), (S, bins)


@pytest.mark.gpu
@pytest.mark.parametrize("bins", [3, 65])
def test_cuda_pack_kernels_are_deterministic_across_launches(cuda_device, bins):
    rng = np.random.default_rng(bins)
    dest = torch.from_numpy(_dest(rng, 8, 750_080, bins, "random")).to(cuda_device)
    keys, valid = (torch.from_numpy(a).to(cuda_device) for a in _keys_valid(rng, 8, 750_080))
    first = [hp.partition_pack(dest, bins), hp.hash_partition(keys, bins),
             hp.hash_partition_pack(keys, valid, bins - 1)]
    for _ in range(20):
        again = [hp.partition_pack(dest, bins), hp.hash_partition(keys, bins),
                 hp.hash_partition_pack(keys, valid, bins - 1)]
        for g, w in zip(again, first):
            assert all(torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.gpu
def test_cuda_pack_kernels_on_two_streams_at_once(cuda_device):
    rng = np.random.default_rng(2)
    inputs = [torch.from_numpy(_dest(rng, 8, 750_080, bins, "random")).to(cuda_device)
              for bins in (3, 65)]
    streams = [torch.cuda.Stream(cuda_device) for _ in inputs]
    torch.cuda.synchronize()
    outs = [[] for _ in inputs]
    for _ in range(5):
        for out, stream, dest, bins in zip(outs, streams, inputs, (3, 65)):
            with torch.cuda.stream(stream):
                out.append(hp.partition_pack(dest, bins))
    torch.cuda.synchronize()
    for out, dest, bins in zip(outs, inputs, (3, 65)):
        want = ref.partition_pack_ref(dest, bins)
        for got in out:
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("bins", [3, 65])
def test_cuda_pack_kernels_on_tensors_not_16_byte_aligned(cuda_device, bins):
    """Inputs 4 bytes past an aligned allocation take the match path."""
    S, T = 8, 40 * 256

    def shifted(a):
        buf = torch.empty(S * T + 1, dtype=torch.int32, device=cuda_device)
        out = buf[1:].view(S, T)
        out.copy_(torch.from_numpy(a))
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    got, want = _run_all(cuda_device, S, T, bins, 256, np.random.default_rng(bins),
                         place=shifted)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
