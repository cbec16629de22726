"""End-to-end serving entry point of the port: static or continuous batching.

Static (the classic fixed-batch baseline):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke \\
      --requests 8 --prompt-len 32 --max-new 16

Continuous (slot map + admission between decode steps) on a MIXED-length
workload, with the static engine run on the same workload for comparison:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --continuous --units 8 --batch 64 --requests 128 --arrival-rate 4

The SSM models and Whisper serve through the static path only (their
caches are not per-position KV maps, so ``--continuous`` raises, as in the
reference):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --batch 8 --requests 16 --prompt-len 2048 --max-new 32

A VLM (``qwen2-vl-2b``) gets ``min(VLM_PATCHES, prompt_len // 2)`` random
patch rows before every prompt, one prompt length, and that much more cache.
Whisper (``whisper-medium``) gets ``prompt_len`` random frame rows a
request, and one prompt length.

Tensor-parallel (``--tensor``) across the processes of a launch: every
process serves the whole batch over its slices of the heads, ``d_ff``,
vocab, experts and SSM heads
(:func:`~repro_torch.distributed.sharding.tensor_rules`, one pod a process;
the transformer families, GQA or MLA, through either engine, the SSM,
hybrid and encoder-decoder families through the static one), drawn from
the seed as each layer is drawn:

  PYTHONPATH=src python -m repro_torch.launch.cluster --processes 4 \
      --local-units 1 --backend nccl -- -m repro_torch.launch.serve \
      --arch deepseek-67b --tensor --batch 8 --requests 8 --prompt-len 2048

  PYTHONPATH=src python -m repro_torch.launch.cluster --processes 4 \
      --local-units 2 --backend nccl -- -m repro_torch.launch.serve \
      --arch olmoe-1b-7b --tensor --continuous --batch 32 --requests 64 \
      --prompt-len 2048 --arrival-rate 4

  PYTHONPATH=src python -m repro_torch.launch.cluster --processes 4 \
      --local-units 1 --backend nccl -- -m repro_torch.launch.serve \
      --arch zamba2-7b --tensor --batch 8 --requests 8 --prompt-len 2048

  PYTHONPATH=src python -m repro_torch.launch.cluster --processes 4 \
      --local-units 2 --backend nccl -- -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --tensor --continuous --batch 8 --requests 16

  PYTHONPATH=src python -m repro_torch.launch.cluster --processes 4 \
      --local-units 1 --backend nccl -- -m repro_torch.launch.serve \
      --arch whisper-medium --tensor --batch 4 --requests 8 --prompt-len 1500

(``--backend gloo --device cpu`` and ``--smoke`` on the CPU.)  Each process
leaves the process group when it is done (``launch.cluster.leave_cluster``).  An
expert-parallel model's units are the launch's processes times its
``--local-units``.

The flags are the reference's (``repro.launch.serve``), plus ``--units``,
``--pods`` and ``--tensor``: the simulated mesh takes the place of the
devices a JAX process sees.  ``--trace-dir`` writes the continuous run's
admission-round, prefill and decode-step spans there as a Perfetto-loadable
JSON file.  With
more than one unit, an expert-parallel model (``moe_impl="ep_shardmap"``)
dispatches its tokens over ``--units`` units in ``--pods`` pods.  It runs
on the card; :func:`main` takes ``device="cpu"`` from Python.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np

from ..configs import get_config, get_smoke_config
from ..core.exchange import make_mesh
from ..distributed.sharding import MeshContext, mesh_context, tensor_place, tensor_rules
from ..models import registry as R
from ..models.registry import VLM_PATCHES
from ..obs.export import write_trace_dir
from ..obs.trace import Tracer
from ..serve import (
    ContinuousEngine,
    Request,
    ServeEngine,
    engine_record,
    generate_bucketed,
    make_mixed_workload,
)
from .cluster import init_cluster, leave_cluster
from .mesh import make_context, make_pod_mesh


def _extra_inputs(cfg, args, rng):
    """An encoder-decoder's frames ``[batch, prompt_len, d_model]`` or a
    VLM's patch embeddings ``[batch, P, d_model]``, drawn first from the
    run's generator, as the reference draws them."""
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        P = min(VLM_PATCHES, args.prompt_len // 2)
        return {"patches": rng.standard_normal(
            (args.batch, P, cfg.d_model)).astype(np.float32)}
    return None


def _prompt_lens(cfg, args) -> list[int]:
    """Two prefill buckets, except a family with fixed-shape side inputs
    (encoder-decoder frames, VLM patches), which keeps one prompt length:
    its imbalance then comes from the output lengths alone."""
    if cfg.family in ("encdec", "vlm"):
        return [args.prompt_len]
    return [max(args.prompt_len // 2, 4), args.prompt_len]


def _summarize(tag: str, reqs: list[Request], stats: dict, wall: float) -> dict:
    rec = engine_record(reqs, stats, wall)
    line = (f"{tag}: {rec['requests']} requests, {rec['new_tokens']} tokens "
            f"in {rec['wall_s']:.2f}s ({rec['tok_s']} tok/s), "
            f"decode_steps={rec['decode_steps']} slot_steps={rec['slot_steps']}")
    if "ttft_mean_s" in rec:
        line += (f", ttft mean={rec['ttft_mean_s']*1e3:.0f}ms "
                 f"p99={rec['ttft_p99_s']*1e3:.0f}ms")
    print(line)
    return rec


def main(argv=None, device: str = "cuda"):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching on a mixed-length workload, "
                        "with a static-batching comparison run")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="requests per decode step (0 = all queued up front); "
                        "continuous mode only")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--units", type=int, default=1,
                   help="simulated parallel units the expert-parallel dispatch spans")
    p.add_argument("--pods", type=int, default=1,
                   help="pods the units split into (two-level dispatch when > 1)")
    p.add_argument("--tensor", action="store_true",
                   help="tensor-parallel over the processes of a launch "
                        "(repro_torch.launch.cluster): heads, d_ff, vocab, experts and SSM "
                        "heads split")
    p.add_argument("--trace-dir", default=None,
                   help="write a Perfetto-loadable trace JSON per process "
                        "(admission/prefill/decode-step spans; continuous "
                        "mode)")
    args = p.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    api = R.build(cfg)
    if args.tensor:
        info = init_cluster()  # a no-op outside a launch: the context then raises
        device = info.device or device
        ctx = make_context(mesh=make_pod_mesh(), rules=tensor_rules())
        params = api.init(args.seed, device=device, place=tensor_place(api.param_specs, ctx,
                                                                  api.tensor_index))
    else:
        params = api.init(args.seed, device=device)
    capacity = args.prompt_len + args.max_new + 1
    if cfg.family == "vlm":
        # the VLM frontend prepends patch rows to the decode context
        capacity += min(VLM_PATCHES, args.prompt_len // 2)
    rng = np.random.default_rng(args.seed)
    extra = _extra_inputs(cfg, args, rng)
    if args.tensor:
        scope = mesh_context(ctx)
    elif args.units > 1:
        scope = mesh_context(MeshContext(make_mesh(args.units, args.pods)))
    else:
        scope = contextlib.nullcontext()

    with scope:
        _serve(args, cfg, api, params, capacity, rng, extra, device)
    if args.tensor:
        leave_cluster()


def _serve(args, cfg, api, params, capacity: int, rng, extra, device) -> None:
    """The requests through the engines (``--continuous``: the continuous
    engine, then the static one on the same workload), under the caller's
    mesh context."""
    if args.continuous:
        reqs = make_mixed_workload(
            cfg.vocab_size, args.requests, _prompt_lens(cfg, args), args.max_new, rng,
            arrival_rate=args.arrival_rate,
        )
        clone = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                         eos_id=r.eos_id) for r in reqs]
        tracer = Tracer() if args.trace_dir else None
        cont = ContinuousEngine(api, batch_size=args.batch, capacity=capacity,
                                temperature=args.temperature, seed=args.seed,
                                tracer=tracer, device=device)
        t0 = time.perf_counter()
        cont.serve(params, reqs, extra_inputs=extra)
        _summarize("continuous", reqs, cont.stats, time.perf_counter() - t0)
        if tracer is not None:
            print("trace:", write_trace_dir(tracer, args.trace_dir, basename="serve"))

        static = ServeEngine(api, batch_size=args.batch, capacity=capacity,
                             temperature=args.temperature, seed=args.seed,
                             device=device)
        t0 = time.perf_counter()
        generate_bucketed(static, params, clone, extra_inputs=extra)
        _summarize("static    ", clone, static.stats, time.perf_counter() - t0)

        c, s = cont.stats["slot_steps"], static.stats["slot_steps"]
        print(f"slot_steps: continuous={c} static={s} "
              f"({s / max(c, 1):.2f}x fewer slot-seconds)")
        if c >= s:
            raise SystemExit(
                f"continuous batching did not beat static on this workload "
                f"({c} vs {s} slot-steps); mixed-length workloads with more "
                f"requests than --batch are where refill pays"
            )
        return

    reqs = [
        Request(
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len, dtype=np.int32),
            max_new_tokens=args.max_new,
        )
        for _ in range(args.requests)
    ]
    engine = ServeEngine(api, batch_size=args.batch, capacity=capacity,
                         temperature=args.temperature, seed=args.seed, device=device)
    t0 = time.perf_counter()
    for i in range(0, len(reqs), args.batch):
        batch = reqs[i : i + args.batch]
        engine.generate(params, batch, extra_inputs=extra)
        print(f"batch {i // args.batch}: "
              + "; ".join(str(r.out_tokens[:8]) for r in batch))
    _summarize("static", reqs, engine.stats, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
