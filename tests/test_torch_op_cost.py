"""The port's op counter (``repro_torch.launch.op_cost``) against the
reference's HLO cost analyzer (``repro.launch.hlo_cost``).

Each case of ``tests/test_hlo_cost.py`` runs on both sides: the reference
counts the compiled HLO of the JAX program (a ``scan`` multiplied by its
trip count), the port the dispatched aten ops of the same program in
PyTorch (a Python loop, unrolled).  Flops must be equal exactly.  In the
two gradient cases the loop's input requires grad on the port's side,
because XLA's program also computes the first step's ``dx`` (18 and 24
products; 17 and 23 without it).  Then the port's own cases: a matmul's
bytes, no collectives, every kernel wrapper counted by its formula on the
CPU and on ``meta`` alike, outputs bit-identical with the counter on and
off, and the process fabric's all-reduce bytes under a fake 4-rank group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.launch.hlo_cost import analyze as hlo_analyze
from repro_torch.core import exchange
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ssd_scan as sk
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import OpCounter, analyze
from repro_torch.train.step import process_mean

N = 128
MM_FLOPS = 2 * N**3


def _ref(fn, *args) -> dict:
    return hlo_analyze(jax.jit(fn).lower(*args).compile().as_text())


def _ones(*shape, grad=False):
    return torch.ones(shape, requires_grad=grad)


def _jax_loop(x, w):
    c, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=10)
    return c


def _torch_loop(x, w):
    for _ in range(10):
        x = x @ w
    return x


def _jax_nested(x, w):
    def outer(c, _):
        c, _ = jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None, length=5)
        return c, None

    c, _ = jax.lax.scan(outer, x, None, length=4)
    return c


def _torch_nested(x, w):
    for _ in range(4):
        for _ in range(5):
            x = x @ w
    return x


def _jax_tanh(w, x):
    c, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None, length=6)
    return (c**2).sum()


def _jax_tanh_remat(w, x):
    body = jax.checkpoint(lambda c, _: (jnp.tanh(c @ w), None))
    c, _ = jax.lax.scan(body, x, None, length=6)
    return (c**2).sum()


def _torch_tanh_grad(w, x, remat=False):
    c = x
    for _ in range(6):
        c = (checkpoint(lambda c: torch.tanh(c @ w), c, use_reentrant=False) if remat
             else torch.tanh(c @ w))
    (c**2).sum().backward()


def _jax_scan7(x, w):
    c, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=7)
    return c


def _torch_unrolled7(x, w):
    for _ in range(7):
        x = x @ w
    return x


def _gqa(q, k):
    return jnp.einsum("bhqd,bhkd->bhqk", q, k)


def _torch_gqa(q, k):
    return torch.einsum("bhqd,bhkd->bhqk", q, k)


X, W = jnp.ones((N, N)), jnp.ones((N, N))
Q, K = jnp.ones((2, 8, 64, 32)), jnp.ones((2, 8, 128, 32))
CASES = {
    "plain_matmul": (lambda: _ref(lambda x, w: x @ w, X, W),
                     lambda: analyze(lambda x, w: x @ w, _ones(N, N), _ones(N, N)), MM_FLOPS),
    "loop_10": (lambda: _ref(_jax_loop, X, W),
                lambda: analyze(_torch_loop, _ones(N, N), _ones(N, N)), 10 * MM_FLOPS),
    "nested_4x5": (lambda: _ref(_jax_nested, X, W),
                   lambda: analyze(_torch_nested, _ones(N, N), _ones(N, N)), 20 * MM_FLOPS),
    "grad_of_loop": (lambda: _ref(jax.grad(_jax_tanh), W, X),
                     lambda: analyze(_torch_tanh_grad, _ones(N, N, grad=True),
                                     _ones(N, N, grad=True)), 18 * MM_FLOPS),
    "grad_of_remat_loop": (lambda: _ref(jax.grad(_jax_tanh_remat), W, X),
                           lambda: analyze(_torch_tanh_grad, _ones(N, N, grad=True),
                                           _ones(N, N, grad=True), remat=True), 24 * MM_FLOPS),
    "looped_equals_unrolled": (lambda: _ref(_jax_scan7, X, W),
                               lambda: analyze(_torch_unrolled7, _ones(N, N), _ones(N, N)),
                               7 * MM_FLOPS),
    "gqa_einsum": (lambda: _ref(_gqa, Q, K),
                   lambda: analyze(_torch_gqa, _ones(2, 8, 64, 32), _ones(2, 8, 128, 32)),
                   2 * 2 * 8 * 64 * 128 * 32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flops_equal_the_reference_hlo_count(case):
    ref_fn, port_fn, want = CASES[case]
    ref, port = ref_fn(), port_fn()
    assert ref["flops"] == want
    assert port["flops"] == ref["flops"]
    assert port["unknown_trip_whiles"] == ref["unknown_trip_whiles"] == 0


def test_matmul_bytes_are_two_reads_and_a_write():
    r = analyze(lambda x, w: x @ w, _ones(N, N), _ones(N, N))
    assert r["bytes"] == 3 * N * N * 4
    assert r["peak_live_bytes"] == N * N * 4  # the product, made inside the window


def test_collective_free_program_has_none():
    r = analyze(lambda x: x * 2 + 1, _ones(N, N))
    assert r["collective_bytes"] == {} == r["async_collective_bytes"]
    assert _ref(lambda x: x * 2 + 1, X)["collective_bytes"] == {}


def _kernel_calls(device):
    """Each wrapper's call on ``device`` with its formula (flops, bytes)."""
    gen = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype).to(device)

    B, H, KH, S, D = 2, 4, 2, 40, 16
    q = t(gen.standard_normal((B, H, S, D)))
    k = t(gen.standard_normal((B, KH, S, D)))
    v = t(gen.standard_normal((B, KH, S, D)))
    L, SH, P, G, Nst, Qc = 32, 4, 8, 2, 16, 8
    x = t(gen.standard_normal((1, L, SH, P)))
    dt = t(np.exp(gen.uniform(-6, -2, (1, L, SH))))
    A = t(-gen.uniform(1, 4, SH))
    Bm = t(gen.standard_normal((1, L, G, Nst)))
    Cm = t(gen.standard_normal((1, L, G, Nst)))
    ids = t(gen.integers(0, 6, (2, 96)), torch.int64)
    keys = t(gen.integers(0, 1000, (2, 512)), torch.int32)
    valid = t(gen.integers(0, 2, (2, 512)), torch.int32)
    dest = t(gen.integers(0, 5, (2, 512)), torch.int32)
    flash_flops = fa.attention_flops(B, H, S, S, D, True)
    ssd_flops = sk.scan_flops(1, L, SH, P, Nst, Qc, G)
    return {
        "flash_attention": (lambda: fa.flash_attention(q, k, v, causal=True),
                            flash_flops, (2 * q.numel() + 2 * k.numel()) * 4),
        "ssd_scan": (lambda: sk.ssd_scan(x, dt, A, Bm, Cm, Qc), ssd_flops,
                     (2 * x.numel() + 2 * Bm.numel() + dt.numel() + A.numel()
                      + SH * P * Nst) * 4),
        "moe_dispatch": (lambda: md.moe_dispatch(ids, 6, 40), 0, 2 * 96 * (8 + 4) + 4 * 2 * 6),
        "hash_partition_pack": (lambda: hp.hash_partition_pack(keys, valid, 4, 128), 0,
                                4 * (4 * 2 * 512 + 2 * 4 * 5)),
        "partition_pack": (lambda: hp.partition_pack(dest, 5, 128), 0,
                           4 * (2 * 2 * 512 + 2 * 4 * 5)),
        "hash_partition": (lambda: hp.hash_partition(keys, 4, 128), 0,
                           4 * (2 * 2 * 512 + 2 * 4 * 4)),
    }


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan", "moe_dispatch",
                                  "hash_partition_pack", "partition_pack", "hash_partition"])
def test_kernel_wrappers_count_their_formula(name, device):
    fn, flops, nbytes = _kernel_calls(device)[name]
    counter = OpCounter()
    with counter.counting():
        out = fn()
    r = counter.result()
    assert r["kernels"] == {name: {"calls": 1, "flops": flops, "bytes": nbytes}}
    assert (r["flops"], r["bytes"]) == (flops, nbytes)  # the plain body's ops are not counted
    assert all(o.device.type == device for o in out if isinstance(o, torch.Tensor)) \
        if isinstance(out, tuple) else out.device.type == device
    if device == "meta":  # the shapes the plain version gives on the CPU
        cpu_out = _kernel_calls("cpu")[name][0]()
        cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
        out = out if isinstance(out, tuple) else (out,)
        assert [(o.shape, o.dtype) for o in out] == [(o.shape, o.dtype) for o in cpu_out]


def test_outputs_are_bit_identical_with_the_counter_on_and_off():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step

    cfg = get_smoke_config("train100m").scaled(head_dim=32, attn_impl="flash", remat="block")
    api = registry.build(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 65), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    step = make_train_step(api, AdamWConfig())
    state = TrainState.create(api, 0, device="cpu")
    plain, m_plain = step(state, batch)
    counter = OpCounter()
    with counter.counting():
        counted, m_counted = step(state, batch)
    # a forward and a remat recompute a layer
    assert counter.result()["kernels"]["flash_attention"]["calls"] == 2 * cfg.num_layers
    assert torch.equal(m_plain["loss"], m_counted["loss"])
    from repro_torch.tree import leaves

    assert all(torch.equal(a, b) for a, b in zip(leaves(plain), leaves(counted)))


def test_all_reduce_bytes_under_a_fake_group_equal_the_pod_hop():
    tree = {"a": torch.ones((3, 5)), "b": [torch.ones(7, dtype=torch.float64),
                                           torch.ones((2, 2), dtype=torch.bfloat16)]}
    with dryrun.fake_processes(4) as group:
        mesh = dryrun.layout_mesh(4, 2, group)
        exchange.reset_pod_hop()
        r = analyze(process_mean, tree, mesh)
        hop = dict(exchange.POD_HOP)
        kinds = exchange.pod_hop_kinds()
    want = 4 * (15 + 7 + 4)  # process_mean sums in f32
    assert r["collective_bytes"] == {"all-reduce": want} == kinds
    assert hop == {"messages": 3, "bytes": want}
    assert not torch.distributed.is_initialized()
