"""The port's MoE dispatch, token-routing fabric, tuner and expert-parallel
layer against the JAX package.

Integer outputs (slots, counts, drop counts, knobs) must be equal; the
permutations of the fabric bit-equal; float outputs within the reference's
own EP tolerance (``rtol=2e-4, atol=2e-5``, as its multi-device MoE scenario
holds ``moe_ep`` to ``moe_dense``).  Inputs are made with numpy from a seed
and handed to both.  The JAX package runs on the CPU: its Pallas kernel in
interpret mode, its ``shard_map`` path in a subprocess on 8 fake devices.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import autotune, exchange
from repro_torch.core.multiplexer import make_multiplexer, use_multiplexer
from repro_torch.distributed.sharding import MeshContext, mesh_context
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import moe as M

S = 3  # shards per batched dispatch call
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def jref():
    """The reference's MoE kernel, oracles, layer and tuner."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.configs import get_smoke_config as ref_get_smoke_config
    from repro.core import autotune as ref_autotune
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref
    from repro.models import moe as ref_moe

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, ops=ref_ops, ref=ref_ref, moe=ref_moe,
        autotune=ref_autotune, get_config=ref_get_config, get_smoke_config=ref_get_smoke_config,
    )


# ----------------------------------------------------------------------------
# moe_dispatch: plain version and both packs against the reference.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("E", [8, 64])
@pytest.mark.parametrize("T", [8, 300, 512])
def test_moe_dispatch_matches_reference(jref, T, E):
    rng = np.random.default_rng(T * 100 + E)
    dest = rng.integers(0, E, (S, T), dtype=np.int32)
    C = max(1, T // E)  # tight: most shards overflow some experts
    got_slot, got_counts = ops.moe_dispatch(torch.from_numpy(dest), E, C)
    packs = {p: M._dispatch_slots(torch.from_numpy(dest), E, C, p) for p in ("torch", "cuda")}
    for s in range(S):
        d = jref.jnp.asarray(dest[s])
        oracle = jref.ref.moe_dispatch_ref(d, E, C)
        with jref.ops.use_kernels(True):
            pallas = jref.ops.moe_dispatch(d, E, C)  # interpret mode, ragged T padded
        xla_slot, xla_kept = jref.moe._dispatch_slots(d, E, C, "xla")
        for want_slot, want_counts in (oracle, pallas):
            np.testing.assert_array_equal(got_slot[s].numpy(), np.asarray(want_slot))
            np.testing.assert_array_equal(got_counts[s].numpy(), np.asarray(want_counts))
        for slot, kept in packs.values():
            np.testing.assert_array_equal(slot[s].numpy(), np.asarray(xla_slot))
            np.testing.assert_array_equal(kept[s].numpy(), np.asarray(xla_kept))
    assert (got_slot == E * C).any(), "the case must drop rows"


def test_moe_dispatch_out_of_range_ids_land_in_the_drop_bin():
    dest = torch.tensor([[0, 4, -1, 0, 7, 4, 0]], dtype=torch.int32)
    slot, counts = ops.moe_dispatch(dest, 4, 2)
    assert slot.tolist() == [[0, 8, 8, 1, 8, 8, 8]]
    assert counts.tolist() == [[2, 0, 0, 0]]


def _staged_dispatch(dest: torch.Tensor, E: int, C: int, tile: int = md.TILE_ROWS):
    """``moe_dispatch`` in the kernel's stages: a shard of more than ``tile``
    rows is cut into tiles of ``tile`` rows (else one tile); in each tile,
    in-warp ranks (32 lanes), per-warp counts and their exclusive prefix
    over the warps give the in-tile rank and the tile's per-expert total;
    the exclusive prefix of the totals over the tiles (what the look-back
    sums) is added to it."""
    S, T = dest.shape
    tile = tile if T > tile else -(-max(T, 1) // 32) * 32
    tiles = -(-max(T, 1) // tile)
    d = dest.long()
    key = torch.where((d >= 0) & (d < E), d, E)  # E: no expert
    key = torch.cat([key, key.new_full((S, tiles * tile - T), E)], 1)
    onehot = (key.reshape(S, tiles, tile // 32, 32)[..., None]
              == torch.arange(E + 1)).long()                     # [S, tiles, warps, 32, E+1]
    in_warp = onehot.cumsum(3) - onehot                           # earlier lanes
    warp_counts = onehot.sum(3)                                   # [S, tiles, warps, E+1]
    warp_prefix = warp_counts.cumsum(2) - warp_counts
    totals = warp_counts.sum(2)                                   # [S, tiles, E+1]
    tile_base = totals.cumsum(1) - totals
    rank_all = in_warp + warp_prefix[:, :, :, None] + tile_base[:, :, None, None]
    rank = (rank_all * onehot).sum(-1).reshape(S, -1)[:, :T]
    key = key[:, :T]
    kept = (key < E) & (rank < C)
    slot = torch.where(kept, key * C + rank, E * C).to(torch.int32)
    counts = totals.sum(1)[:, :E].clamp(max=C).to(torch.int32)
    return slot, counts


# (S, T, E, C, tile): several tiles with a ragged tail, small tiles (many of
# them), one shard longer than a tile of 1024, a one-tile shard, 300 experts
DISPATCH_STAGED_CASES = [
    (2, 3000, 64, 40, md.TILE_ROWS),
    (3, 700, 8, 60, 64),
    (1, 5000, 300, 7, md.TILE_ROWS),
    (4, 96, 64, 1, md.TILE_ROWS),
    (2, 1000, 16, 0, 128),
]


@pytest.mark.parametrize("S,T,E,C,tile", DISPATCH_STAGED_CASES)
def test_staged_dispatch_matches_plain_version_and_reference(jref, S, T, E, C, tile):
    """The kernel's decomposition holds bit for bit: int64 ids as the router
    gives them, with ids out of range (negative, ``E``, beyond int32) and
    drops, against the plain version and the reference's oracle."""
    rng = np.random.default_rng(S * T + E)
    dest = rng.integers(-1, E + 2, (S, T)).astype(np.int64)
    dest[rng.random((S, T)) < 0.01] = 2**40
    got = _staged_dispatch(torch.from_numpy(dest), E, C, tile)
    want = kref.moe_dispatch_ref(torch.from_numpy(dest), E, C)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (got[0] == E * C).any() and got[0].dtype == torch.int32
    via_ops = ops.moe_dispatch(torch.from_numpy(dest), E, C)
    assert all(torch.equal(g, w) for g, w in zip(via_ops, want))
    # the reference takes ids in range only: its slots for the others are
    # not drops, so they are compared where the ids are experts
    d32 = np.where(dest > E, E + 1, dest).astype(np.int32)
    for s in range(S):
        slot, counts = jref.ref.moe_dispatch_ref(jref.jnp.asarray(d32[s]), E, C)
        expert = (dest[s] >= 0) & (dest[s] < E)
        np.testing.assert_array_equal(got[0][s].numpy()[expert], np.asarray(slot)[expert])
        np.testing.assert_array_equal(got[1][s].numpy(), np.asarray(counts))


def test_dispatch_shared_memory_and_scratch_sizes():
    """``MAX_EXPERTS`` (no fewer than the 372 of the one-block-a-shard kernel)
    fits the 227 KB a block may opt into at 1024 threads, above 48 KB from
    333 experts on; a shard of one tile needs no scratch."""
    assert md.MAX_EXPERTS == md.TILE_ROWS >= 372
    assert md._smem_ints(md.MAX_EXPERTS) <= 227 * 1024 // 4
    assert md._smem_ints(332) <= 12288 < md._smem_ints(333)
    assert md.scratch_ints(8, 1024, 64) == (0, 0)
    assert md.scratch_ints(8, 16_384, 64) == (1 + 8 + 8 * 16, 2 * 8 * 16 * 64)
    assert md.scratch_ints(1, 1025, 4) == (1 + 1 + 2, 2 * 2 * 4)


def test_cuda_pack_on_a_cpu_tensor_never_counts_a_launch():
    md.reset_launch_counts()
    M._dispatch_slots(torch.zeros((2, 16), dtype=torch.int32), 4, 4, "cuda")
    assert md.LAUNCHES["moe_dispatch"] == 0
    with pytest.raises(ValueError, match="pack impl"):
        M._dispatch_slots(torch.zeros((2, 16), dtype=torch.int32), 4, 4, "pallas")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,E,C,dtype", [
    (8, 64, 64, 4, torch.int32), (8, 64, 64, 4, torch.int64),
    (8, 16_384, 64, 320, torch.int32), (8, 16_384, 64, 320, torch.int64),
    (3, 300, 8, 5, torch.int32), (2, 1000, 64, 1, torch.int32), (1, 5000, 300, 7, torch.int32),
    (4, 2048, 64, 0, torch.int32),
    # one long shard (128 tiles), a ragged tail of one row, the most experts,
    # a case where most rows drop
    (1, 131_072, 64, 2560, torch.int32), (8, 16_385, 64, 320, torch.int64),
    (2, 4096, md.MAX_EXPERTS, 12, torch.int32), (2, 4096, 372, 12, torch.int64),
    (8, 64, md.MAX_EXPERTS, 4, torch.int64), (4, 8192, 16, 100, torch.int32),
])
def test_cuda_moe_dispatch_matches_plain_version(cuda_device, S, T, E, C, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    dest = torch.randint(-1, E + 2, (S, T), generator=gen, device=cuda_device, dtype=dtype)
    md.reset_launch_counts()
    got = md.moe_dispatch(dest, E, C)
    want = kref.moe_dispatch_ref(dest, E, C)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert md.LAUNCHES["moe_dispatch"] == 1
    with pytest.raises(ValueError, match="contiguous int32 or int64"):
        md.moe_dispatch(dest.to(torch.int16), E, C)
    with pytest.raises(ValueError, match="contiguous int32 or int64"):
        md.moe_dispatch(dest[:, ::2], E, C)
    with pytest.raises(ValueError, match="shared memory"):
        md.moe_dispatch(dest, md.MAX_EXPERTS + 1, C)


@pytest.mark.gpu
@pytest.mark.parametrize("units,tokens", [(4, 1), (4, 256), (2, 4), (2, 8192)])
def test_cuda_moe_dispatch_at_the_tensor_tables_shapes(cuda_device, units, tokens):
    """OLMoE's dispatch under the tensor table: a process packs its own
    units' router ids (``[units, tokens * 8]``, 64 experts, capacity factor
    1.25): chip_smoke.py phase 9c's decode step and 256-token group (4
    units a process, 8 slots), the four-card probe's (2 units a rank, 32
    slots: a decode step, a 2,048-token group)."""
    from repro_torch.core.autotune import ep_capacity

    E, k = 64, 8
    C = ep_capacity(tokens, k, E, 1.25)
    gen = torch.Generator(device=cuda_device).manual_seed(units * tokens)
    scores = torch.rand((units, tokens, E), generator=gen, device=cuda_device)
    dest = torch.topk(scores, k, dim=-1).indices.reshape(units, tokens * k).contiguous()
    md.reset_launch_counts()
    got = md.moe_dispatch(dest, E, C)
    want = kref.moe_dispatch_ref(dest, E, C)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert md.LAUNCHES["moe_dispatch"] == 1


@pytest.mark.gpu
def test_cuda_moe_dispatch_is_deterministic_across_launches(cuda_device):
    """The look-back's ordering: the prefill shape and one long shard give
    identical outputs over 20 launches (the scratch left clean each time)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for S, T, C in ((8, 16_384, 320), (1, 131_072, 2560)):
        dest = torch.randint(0, 64, (S, T), generator=gen, device=cuda_device)
        first = md.moe_dispatch(dest, 64, C)
        for _ in range(20):
            got = md.moe_dispatch(dest, 64, C)
            assert all(torch.equal(g, w) for g, w in zip(got, first))
        assert all(torch.equal(g, w) for g, w in zip(first, kref.moe_dispatch_ref(dest, 64, C)))


@pytest.mark.gpu
def test_cuda_moe_dispatch_on_two_streams_at_once(cuda_device):
    """Multi-tile launches on two streams may overlap: each stream has its
    own look-back scratch, so 20 rounds of launches on both, never
    synchronised between them, equal the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    shapes = ((8, 16_384, 320), (2, 40_000, 900))
    dests = [torch.randint(-1, 66, (S, T), generator=gen, device=cuda_device) for S, T, _ in shapes]
    wants = [kref.moe_dispatch_ref(d, 64, C) for d, (_, _, C) in zip(dests, shapes)]
    streams = [torch.cuda.Stream(cuda_device) for _ in shapes]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    outs = [[], []]
    for _ in range(20):
        for i, (s, d, (_, _, C)) in enumerate(zip(streams, dests, shapes)):
            with torch.cuda.stream(s):
                outs[i].append(md.moe_dispatch(d, 64, C))
    torch.cuda.synchronize()
    handles = {s.cuda_stream for s in streams}
    assert {k[1] for k in md._SCRATCH if k[0] == dests[0].device.index} >= handles
    for got_all, want in zip(outs, wants):
        for got in got_all:
            assert all(torch.equal(g, w) for g, w in zip(got, want))


# ----------------------------------------------------------------------------
# The token-routing fabric: two-level dispatch/combine == flat all-to-all.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("impl,chunks", [("round_robin", 1), ("round_robin", 2),
                                         ("one_factorization", 1), ("xla", 1)])
def test_two_level_dispatch_combine_equal_the_flat_all_to_all(impl, chunks):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 8, 6, 3)).astype(np.float32))
    flat = exchange.all_to_all(x, exchange.make_mesh(8), "q", impl="xla")
    pods = exchange.make_mesh(8, num_pods=2)
    got = exchange.dispatch_two_level(x, pods, "q", "pod", impl=impl, num_chunks=chunks)
    back = exchange.combine_two_level(x, pods, "q", "pod", impl=impl, num_chunks=chunks)
    assert torch.equal(got, flat) and torch.equal(back, flat)
    mux = make_multiplexer(pods, impl=impl, transport_chunks=chunks)
    assert torch.equal(mux.dispatch(x, "q"), flat) and torch.equal(mux.combine(x, "q"), flat)
    # one pod: the flat scheduled all-to-all itself
    one = make_multiplexer(exchange.make_mesh(8), impl=impl, transport_chunks=chunks)
    assert torch.equal(one.dispatch(x, "q"), flat)


# ----------------------------------------------------------------------------
# The tuner on decode-shaped EP stats: the reference's knobs.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("batch", [8, 64, 256])
def test_tune_multiplexer_matches_reference(jref, pods, batch):
    from repro_torch.configs import get_config

    cfg = get_config("olmoe-1b-7b")
    want_stats = jref.autotune.decode_table_stats(jref.get_config("olmoe-1b-7b"), batch, 8)
    got_stats = autotune.decode_table_stats(cfg, batch, 8)
    assert (got_stats.rows, got_stats.row_bytes) == (want_stats.rows, want_stats.row_bytes)
    axes, shape = (("pod", "model"), (2, 4)) if pods == 2 else (("data", "model"), (1, 8))
    ref_mesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    want = jref.autotune.tune_multiplexer(ref_mesh, [want_stats])
    got = autotune.tune_multiplexer(exchange.make_mesh(8, pods), [got_stats])
    pack = {"xla": "torch", "pallas": "cuda"}
    assert (got.impl, got.pack_impl, got.pipeline_chunks, got.transport_chunks) == (
        want.impl, pack[want.pack_impl], want.pipeline_chunks, want.transport_chunks
    )
    assert got.modeled_s == pytest.approx(want.modeled_s, rel=1e-12)
    mux = make_multiplexer(exchange.make_mesh(8, pods), auto=True, table_stats=[got_stats])
    assert mux.pack_impl == "cuda" and mux.plan.num_pods == pods
    # refine=True times the best modeled candidates on the simulated fabric
    # (here the CPU); on 2 x 4 it warns and keeps the analytical winner, as
    # the reference does
    if pods == 1:
        refined = autotune.tune_multiplexer(exchange.make_mesh(8), [got_stats], refine=True,
                                            refine_top_k=2, device="cpu")
        assert refined.measured_s is not None and refined.measured_s > 0
        assert refined.modeled_s in [c[4] for c in got.candidates[:2]]
    else:
        with pytest.warns(UserWarning, match="two-level"):
            refined = autotune.tune_multiplexer(exchange.make_mesh(8, 2), [got_stats],
                                                refine=True, device="cpu")
        assert refined == got


def test_ep_capacity_matches_reference(jref):
    for t, k, e, cf in [(2048, 8, 64, 1.25), (8, 8, 64, 1.25), (1, 2, 8, 8.0), (37, 4, 16, 1.0)]:
        assert autotune.ep_capacity(t, k, e, cf) == jref.autotune.ep_capacity(t, k, e, cf)


# ----------------------------------------------------------------------------
# The expert-parallel layer.
# ----------------------------------------------------------------------------

def _ep_case(jref, capacity_factor: float, T: int = 64):
    """The reference's multi-device MoE scenario config; its params from
    ``jax.random`` and tokens from numpy, each handed over as numpy."""
    ref_cfg = jref.moe.ModelConfig(
        name="t", family="moe", num_layers=1, d_model=32, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=64, num_experts=16, top_k=4, moe_d_ff=48,
        capacity_factor=capacity_factor, dtype="float32", moe_impl="ep_shardmap",
    )
    params = {k: np.array(v) for k, v in
              jref.moe.init_moe_layer(jref.jax.random.PRNGKey(1), ref_cfg).items()}
    x = np.random.default_rng(2).standard_normal((T, 32)).astype(np.float32)
    cfg = ModelConfig(**{f: getattr(ref_cfg, f) for f in ModelConfig.__dataclass_fields__})
    return ref_cfg, cfg, params, x


@pytest.mark.parametrize("via_mux", [False, True])
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("impl", ["round_robin", "xla"])
@pytest.mark.parametrize("pods", [1, 2])
def test_moe_ep_matches_reference_dense(jref, pods, impl, chunks, via_mux):
    ref_cfg, cfg, params, x = _ep_case(jref, capacity_factor=8.0)
    want = np.asarray(jref.moe.moe_dense(
        {k: jref.jnp.asarray(v) for k, v in params.items()}, ref_cfg, jref.jnp.asarray(x)
    ))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = exchange.make_mesh(8, pods)
    cfg = cfg.scaled(exchange_impl=impl, moe_async_chunks=chunks)
    with mesh_context(MeshContext(mesh)):
        if via_mux:
            mux = make_multiplexer(mesh, impl=impl, pack_impl="cuda", pipeline_chunks=chunks)
            with use_multiplexer(mux):
                got = M.moe_ep(tp, cfg, torch.from_numpy(x))
        else:
            got = M.moe_ep(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_ep_layer_hands_the_routers_int64_ids_to_the_kernel_pack(jref, monkeypatch):
    """The kernel pack gets ``torch.topk``'s int64 ids as they are: no cast
    runs between the router and the dispatch kernel."""
    _, cfg, params, x = _ep_case(jref, capacity_factor=1.0)
    seen = []
    real = md.moe_dispatch
    monkeypatch.setattr(md, "moe_dispatch",
                        lambda d, E, C: seen.append(d.dtype) or real(d, E, C))
    mesh = exchange.make_mesh(8, 1)
    mux = make_multiplexer(mesh, impl="xla", pack_impl="cuda")
    with mesh_context(MeshContext(mesh)), use_multiplexer(mux):
        M.moe_ep({k: torch.from_numpy(v) for k, v in params.items()}, cfg, torch.from_numpy(x))
    assert seen == [torch.int64]


def test_moe_ep_with_drops_matches_reference_shard_map(jref, tmp_path):
    """capacity_factor 1.0 drops rows: the outputs and per-unit drop counts
    of the reference's ``shard_map`` body on 8 fake devices (flat and
    2 x 4), run in a subprocess."""
    _, cfg, params, x = _ep_case(jref, capacity_factor=1.0, T=128)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, x=x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, **params)
    script = os.path.join(os.path.dirname(__file__), "_torch_moe_ref_run.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, script, str(src), str(dst)],
                          capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = np.load(dst)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for pods in (1, 2):
        mesh = exchange.make_mesh(8, pods)
        y, dropped = M._ep_moe_local(
            tp, cfg, torch.from_numpy(x).reshape(8, -1, 32), mesh, "q",
            pod_axis="pod" if pods > 1 else None,
        )
        assert dropped.sum() > 0, "the case must drop rows"
        np.testing.assert_array_equal(dropped.numpy(), want[f"dropped_pods{pods}"])
        np.testing.assert_allclose(y.reshape(-1, 32).numpy(), want[f"y_pods{pods}"],
                                   rtol=RTOL, atol=ATOL)


def test_deepseek_v2_lite_ep_matches_reference_shard_map(jref, tmp_path):
    """DeepSeek-V2-Lite's smoke MoE layer (top-2 of 8, ``router_norm_topk``,
    one shared expert) with ``moe_impl="ep_shardmap"`` on 8 units and on
    2 x 4: the reference's ``shard_map`` body's outputs and per-unit drops;
    then ``moe_ffn`` (EP, then the shared experts' MLP on every token)
    against the reference's EP output plus its shared MLP."""
    ref_cfg = jref.moe.ModelConfig(**{
        **{f: getattr(jref.get_smoke_config("deepseek-v2-lite-16b"), f)
           for f in ModelConfig.__dataclass_fields__},
        "moe_impl": "ep_shardmap"})
    cfg = ModelConfig(**{f: getattr(ref_cfg, f) for f in ModelConfig.__dataclass_fields__})
    assert cfg.router_norm_topk and cfg.num_shared_experts == 1 and cfg.top_k == 2
    params = jref.jax.tree.map(np.array,
                               jref.moe.init_moe_layer(jref.jax.random.PRNGKey(3), ref_cfg))
    d = cfg.d_model
    x = np.random.default_rng(4).standard_normal((128, d)).astype(np.float32)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, x=x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
             router_norm_topk=cfg.router_norm_topk,
             **{k: v for k, v in params.items() if k != "shared"},
             **{f"shared_{k}": v for k, v in params["shared"].items()})
    script = os.path.join(os.path.dirname(__file__), "_torch_moe_ref_run.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, script, str(src), str(dst)],
                          capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = np.load(dst)
    tp = {k: torch.from_numpy(v) for k, v in params.items() if k != "shared"}
    tp["shared"] = {k: torch.from_numpy(v) for k, v in params["shared"].items()}
    for pods in (1, 2):
        mesh = exchange.make_mesh(8, pods)
        y, dropped = M._ep_moe_local(
            tp, cfg, torch.from_numpy(x).reshape(8, -1, d), mesh, "q",
            pod_axis="pod" if pods > 1 else None,
        )
        assert dropped.sum() > 0, "the case must drop rows"
        np.testing.assert_array_equal(dropped.numpy(), want[f"dropped_pods{pods}"])
        np.testing.assert_allclose(y.reshape(-1, d).numpy(), want[f"y_pods{pods}"],
                                   rtol=RTOL, atol=ATOL)
        with mesh_context(MeshContext(mesh)):
            got = M.moe_ffn(tp, cfg, torch.from_numpy(x)[None])[0]
        np.testing.assert_allclose(got.numpy(), want[f"y_shared_pods{pods}"],
                                   rtol=RTOL, atol=ATOL)


def test_moe_ep_falls_back_and_refuses_like_the_reference(jref):
    _, cfg, params, x = _ep_case(jref, capacity_factor=8.0)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="mesh context"):
        M.moe_ep(tp, cfg, torch.from_numpy(x))
    pods = exchange.make_mesh(8, 2)
    with mesh_context(MeshContext(pods)):
        # 60 tokens do not split over 8 units: the dense path, exactly
        odd = torch.from_numpy(x[:60])
        assert torch.equal(M.moe_ep(tp, cfg, odd), M.moe_dense(tp, cfg, odd))
        flat_mux = make_multiplexer(exchange.make_mesh(8))
        with use_multiplexer(flat_mux), pytest.raises(ValueError, match="single-level"):
            M.moe_ep(tp, cfg, torch.from_numpy(x))
