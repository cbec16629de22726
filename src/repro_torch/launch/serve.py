"""End-to-end serving entry point of the port: static or continuous batching.

Static (the classic fixed-batch baseline):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke \\
      --requests 8 --prompt-len 32 --max-new 16

Continuous (slot map + admission between decode steps) on a MIXED-length
workload, with the static engine run on the same workload for comparison:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --continuous --units 8 --batch 64 --requests 128 --arrival-rate 4

The SSM models serve through the static path only (their caches are not
per-position KV maps, so ``--continuous`` raises, as in the reference):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --batch 8 --requests 16 --prompt-len 2048 --max-new 32

The flags are the reference's (``repro.launch.serve``), plus ``--units``
and ``--pods``: the simulated mesh takes the place of the devices a JAX
process sees.  ``--trace-dir`` writes the continuous run's admission-round,
prefill and decode-step spans there as a Perfetto-loadable JSON file.  With
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
from ..distributed.sharding import MeshContext, mesh_context
from ..models import registry as R
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
    p.add_argument("--trace-dir", default=None,
                   help="write a Perfetto-loadable trace JSON per process "
                        "(admission/prefill/decode-step spans; continuous "
                        "mode)")
    args = p.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    api = R.build(cfg)
    params = api.init(args.seed, device=device)
    capacity = args.prompt_len + args.max_new + 1
    rng = np.random.default_rng(args.seed)
    scope = (
        mesh_context(MeshContext(make_mesh(args.units, args.pods)))
        if args.units > 1 else contextlib.nullcontext()
    )

    with scope:
        if args.continuous:
            prompt_lens = [max(args.prompt_len // 2, 4), args.prompt_len]
            reqs = make_mixed_workload(
                cfg.vocab_size, args.requests, prompt_lens, args.max_new, rng,
                arrival_rate=args.arrival_rate,
            )
            clone = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                             eos_id=r.eos_id) for r in reqs]
            tracer = Tracer() if args.trace_dir else None
            cont = ContinuousEngine(api, batch_size=args.batch, capacity=capacity,
                                    temperature=args.temperature, seed=args.seed,
                                    tracer=tracer, device=device)
            t0 = time.perf_counter()
            cont.serve(params, reqs)
            _summarize("continuous", reqs, cont.stats, time.perf_counter() - t0)
            if tracer is not None:
                print("trace:", write_trace_dir(tracer, args.trace_dir, basename="serve"))

            static = ServeEngine(api, batch_size=args.batch, capacity=capacity,
                                 temperature=args.temperature, seed=args.seed,
                                 device=device)
            t0 = time.perf_counter()
            generate_bucketed(static, params, clone)
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
            engine.generate(params, batch)
            print(f"batch {i // args.batch}: "
                  + "; ".join(str(r.out_tokens[:8]) for r in batch))
        _summarize("static", reqs, engine.stats, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
