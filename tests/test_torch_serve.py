"""The port's GQA MoE transformer and serving engines against the JAX package.

At OLMoE-1B-7B's smoke config in f32: the reference's params (from
``jax.random``) go through :mod:`repro_torch.models.convert`; prompts are
made with numpy from a seed.  ``prefill``, ``decode_step`` and
``decode_step_slots`` must give the reference's logits and caches within
``rtol=1e-4, atol=1e-5`` (f32 sums in another order); greedy tokens must be
equal.  The port's continuous engine on 8 simulated units (the kernel pack
under a tuned multiplexer) must give its static engine's tokens (the plain
pack, no multiplexer).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.exchange import make_mesh
from repro_torch.distributed.sharding import MeshContext, mesh_context
from repro_torch.models import convert, registry
from repro_torch.obs.trace import Tracer
from repro_torch.serve import (
    ContinuousEngine,
    Request,
    ServeEngine,
    SlotAllocator,
    generate_bucketed,
    make_mixed_workload,
)

RTOL, ATOL = 1e-4, 1e-5
B, PLEN, CAP = 2, 8, 12


@pytest.fixture(scope="module")
def jref():
    """The reference's smoke model, its params and its engine."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import registry as ref_registry
    from repro.serve import Request as RefRequest
    from repro.serve import ServeEngine as RefServeEngine

    api = ref_registry.build(ref_smoke("olmoe-1b-7b"))
    params = api.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, api=api, params=params, np_params=np_params,
        Request=RefRequest, ServeEngine=RefServeEngine,
    )


@pytest.fixture(scope="module")
def port(jref):
    api = registry.build(get_smoke_config("olmoe-1b-7b"))
    return types.SimpleNamespace(api=api, params=convert.from_reference(jref.np_params))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _close_cache(got, want):
    for seg in want:
        for name in want[seg]:
            _close(got[seg][name].numpy(), want[seg][name])


def _pad_cache(cache, capacity):
    """Reference cache leaves ``[L, B, S, ...]`` padded to ``capacity`` positions."""
    def pad(a):
        a = np.asarray(a)
        width = [(0, 0)] * a.ndim
        width[2] = (0, capacity - a.shape[2])
        return np.pad(a, width)
    return {seg: {k: pad(v) for k, v in leaves.items()} for seg, leaves in cache.items()}


def _prompts(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, PLEN), dtype=np.int32)


def test_converter_keeps_every_leaf(jref, port):
    n_ref = sum(np.asarray(a).size for a in jref.jax.tree.leaves(jref.np_params))
    n_port = 0
    for name, sub in port.params.items():
        layers = sub if isinstance(sub, list) else [sub]
        for layer in layers:
            stack = [layer]
            while stack:
                node = stack.pop()
                for v in node.values():
                    if isinstance(v, dict):
                        stack.append(v)
                    else:
                        n_port += v.numel()
    assert n_port == n_ref
    assert len(port.params["seg0"]) == get_smoke_config("olmoe-1b-7b").num_layers


def test_prefill_matches_reference(jref, port):
    tokens = _prompts(port.api.cfg.vocab_size)
    want_logits, want_cache = jref.api.prefill(jref.params, {"tokens": jref.jnp.asarray(tokens)})
    got_logits, got_cache = port.api.prefill(port.params, {"tokens": torch.from_numpy(tokens)})
    _close(got_logits.numpy(), want_logits)
    _close_cache(got_cache, want_cache)


@pytest.mark.parametrize("slots", [False, True])
def test_decode_steps_match_reference(jref, port, slots):
    """One decode step after a prefill, against a capacity-CAP cache: the
    static step at one position, or the slot step at per-slot positions."""
    tokens = _prompts(port.api.cfg.vocab_size, seed=1)
    _, ref_cache = jref.api.prefill(jref.params, {"tokens": jref.jnp.asarray(tokens)})
    cache = _pad_cache(ref_cache, CAP)
    step = np.array([[3], [17]], np.int32)
    port_cache = {s: {k: torch.from_numpy(v.copy()) for k, v in d.items()} for s, d in cache.items()}
    jcache = jref.jax.tree.map(jref.jnp.asarray, cache)
    if slots:
        positions = np.array([PLEN, PLEN - 3], np.int32)
        want_logits, want_cache = jref.api.decode_step_slots(
            jref.params, jref.jnp.asarray(step), jcache, jref.jnp.asarray(positions))
        got_logits, got_cache = port.api.decode_step_slots(
            port.params, torch.from_numpy(step), port_cache, torch.from_numpy(positions))
    else:
        want_logits, want_cache = jref.api.decode_step(
            jref.params, jref.jnp.asarray(step), jcache, jref.jnp.int32(PLEN))
        got_logits, got_cache = port.api.decode_step(
            port.params, torch.from_numpy(step), port_cache, PLEN)
    _close(got_logits.numpy(), want_logits)
    _close_cache(got_cache, want_cache)


def test_static_greedy_tokens_match_reference(jref, port):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, port.api.cfg.vocab_size, PLEN, dtype=np.int32) for _ in range(3)]
    want = [jref.Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    jref.ServeEngine(jref.api, batch_size=4, capacity=24).generate(jref.params, want)
    got = [Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    engine = ServeEngine(port.api, batch_size=4, capacity=24, device="cpu")
    engine.generate(port.params, got)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert engine.stats["decode_steps"] == 5


@pytest.mark.parametrize("pods", [1, 2])
def test_continuous_equals_static_on_8_units(port, pods):
    """Expert parallelism over 8 simulated units (flat, then 2 pods x 4)
    with the smoke config's capacity factor, which drops rows: the static
    engine (no multiplexer: plain pack, round-robin) and the continuous
    engine (tuned multiplexer: kernel pack) give the same greedy tokens,
    and a mixed workload completes in fewer slot-steps."""
    cfg = port.api.cfg.scaled(moe_impl="ep_shardmap")
    api = registry.build(cfg)
    rng = np.random.default_rng(3)
    Bs, cap = 8, 48
    with mesh_context(MeshContext(make_mesh(8, pods))):
        same = [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32) for _ in range(Bs)]
        reqs_s = [Request(prompt=p.copy(), max_new_tokens=5) for p in same]
        reqs_c = [Request(prompt=p.copy(), max_new_tokens=5) for p in same]
        ServeEngine(api, batch_size=Bs, capacity=cap, device="cpu").generate(port.params, reqs_s)
        ce = ContinuousEngine(api, batch_size=Bs, capacity=cap, device="cpu")
        assert ce.mux is not None and ce.mux.pack_impl == "cuda"
        assert ce.mux.plan.num_pods == pods
        ce.serve(port.params, reqs_c)
        assert [r.out_tokens for r in reqs_c] == [r.out_tokens for r in reqs_s]
        assert ce.stats["prefill_calls"] == 1 and ce.stats["decode_steps"] == 4

        mixed = make_mixed_workload(cfg.vocab_size, 24, [8, 16], 9, rng, arrival_rate=2)
        mixed_s = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in mixed]
        se = ServeEngine(api, batch_size=Bs, capacity=cap, device="cpu")
        generate_bucketed(se, port.params, mixed_s)
        ce2 = ContinuousEngine(api, batch_size=Bs, capacity=cap, device="cpu")
        ce2.serve(port.params, mixed)
        ce2.alloc.check()
        assert all(r.done and 1 <= len(r.out_tokens) <= r.max_new_tokens for r in mixed)
        assert ce2.stats["admitted"] == ce2.stats["finished"] == len(mixed)
        assert ce2.stats["slot_steps"] < se.stats["slot_steps"], (ce2.stats, se.stats)


def test_slot_allocator_detects_a_leak():
    alloc = SlotAllocator(2)
    slot = alloc.admit(Request(prompt=np.zeros(2, np.int32), max_new_tokens=1))
    alloc.check()
    alloc._free.append(slot)
    with pytest.raises(AssertionError, match="leak"):
        alloc.check()


def test_entry_points_default_to_the_card():
    api = registry.build(get_smoke_config("olmoe-1b-7b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(api, batch_size=2, capacity=8)


def test_unported_archs_name_their_slice():
    with pytest.raises(NotImplementedError, match="Whisper slice"):
        get_config("whisper-medium")
    with pytest.raises(NotImplementedError, match="dense-model slice"):
        registry.build(get_config("olmoe-1b-7b").scaled(family="vlm"))
    # the telemetry slice has landed: the continuous engine takes a tracer
    tracer = Tracer()
    ce = ContinuousEngine(registry.build(get_smoke_config("olmoe-1b-7b")), 2, 8,
                          tracer=tracer, device="cpu")
    assert ce.tracer is tracer


def test_continuous_engine_spans_equal_reference(jref, port):
    """Under a tracer, the continuous engine records the reference's spans
    (``admission-round:``, ``prefill:len``, ``decode-step:``), in the same
    nesting and order, with the same arguments, on the same mixed workload
    (no early stop: the schedule does not depend on the tokens)."""
    from repro.obs.trace import Tracer as RefTracer
    from repro.serve import ContinuousEngine as RefContinuousEngine
    from repro.serve import make_mixed_workload as ref_make_mixed_workload

    vocab = port.api.cfg.vocab_size
    want_tr, got_tr = RefTracer(pid=0), Tracer(pid=0)
    want = ref_make_mixed_workload(vocab, 10, (8, 16), 6, np.random.default_rng(4),
                                   arrival_rate=2)
    got = make_mixed_workload(vocab, 10, (8, 16), 6, np.random.default_rng(4), arrival_rate=2)
    RefContinuousEngine(jref.api, batch_size=4, capacity=24, tracer=want_tr).serve(
        jref.params, want)
    ContinuousEngine(port.api, batch_size=4, capacity=24, tracer=got_tr, device="cpu").serve(
        port.params, got)

    def spans(tr):
        return [(s.name, s.cat, s.args, [c.name for c in s.children])
                for root in tr.spans for s in root.walk()]

    assert spans(got_tr) == spans(want_tr)
    families = {name.split(":")[0] for name, *_ in spans(got_tr)}
    assert families == {"admission-round", "prefill", "decode-step"}
    assert all(s.dur is not None and s.dur >= 0 for root in got_tr.spans for s in root.walk())


def test_launcher_runs_both_modes_on_the_cpu(capsys, tmp_path):
    import json

    from repro_torch.launch.serve import main

    main(["--arch", "olmoe-1b-7b", "--smoke", "--requests", "8", "--batch", "8",
          "--prompt-len", "8", "--max-new", "4", "--units", "8", "--pods", "2"], device="cpu")
    main(["--arch", "olmoe-1b-7b", "--smoke", "--continuous", "--requests", "24",
          "--batch", "8", "--prompt-len", "16", "--max-new", "9", "--arrival-rate", "2",
          "--units", "8", "--trace-dir", str(tmp_path)], device="cpu")
    out = capsys.readouterr().out
    assert "static: 8 requests" in out and "slot_steps: continuous=" in out
    with open(tmp_path / "serve-p0.json") as f:
        names = {e["name"].split(":")[0] for e in json.load(f)["traceEvents"] if e["ph"] == "B"}
    assert names == {"admission-round", "prefill", "decode-step"}


@pytest.mark.parametrize("arrival_rate", [0.0, 4.0])
def test_mixed_workload_matches_reference(arrival_rate):
    """The same generator state gives the reference's prompts, output
    budgets and arrival steps (``chip_smoke.py`` serves this workload)."""
    pytest.importorskip("jax")
    from repro.serve import make_mixed_workload as ref_make_mixed_workload

    want = ref_make_mixed_workload(50304, 24, (128, 256, 512), 32, np.random.default_rng(5),
                                   arrival_rate=arrival_rate)
    got = make_mixed_workload(50304, 24, (128, 256, 512), 32, np.random.default_rng(5),
                              arrival_rate=arrival_rate)
    assert [(r.prompt.tolist(), r.max_new_tokens, r.arrival_step) for r in got] == \
        [(r.prompt.tolist(), r.max_new_tokens, r.arrival_step) for r in want]
