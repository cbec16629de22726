#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--seed 0] [--profile]
                          [--queries q1,q6,q17,q3,q3_pods,q18_pods,q3_rr]

Phases, in order; any failure raises and the process exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions; a machine without CUDA exits 2 before printing any result;
2. build — ``nvcc`` builds ``csrc/hash_partition.cu``,
   ``csrc/moe_dispatch.cu``, ``csrc/flash_attention.cu`` and
   ``csrc/ssd_scan.cu`` for ``sm_90a``, all at once (seconds and ``-Xptxas
   -v`` printed);
3. kernels — every ported kernel at its main path's shapes, held against
   its plain PyTorch version on the card and timed with CUDA events (mean
   over 50 launches after warm-up, 20 for attention) beside the plain
   version and the bound: ``hash_partition_pack`` (P=8, 10 % invalid rows),
   ``partition_pack`` (3 bins, with padding ids) and ``hash_partition``
   (P=8) at S=8 shards x one shard's lineitem rows; ``moe_dispatch`` at
   OLMoE's decode shape (S=8, T=64, E=64, C=4) and prefill shape (S=8,
   T=16,384, C=320) and under the tensor table (a process's units: phase
   9c's decode S=4, T=8, C=4 and 256-token group S=4, T=2,048, C=40;
   phase 9e's DeepSeek-V2-Lite at top-6, S=4, T=6, C=4 and S=4, T=1,536,
   C=30), on the router's int64 expert ids, all bit for bit
   and bound by bytes over 3.35 TB/s, the three packs and ``moe_dispatch``
   also with one call's wall (host clock over 1,000 calls) beside its
   device time (profiler) and the bound's share of that;
   ``flash_attention`` at train100m's shape (B=8, H=12, KH=4, S=2,048,
   D=64, causal) in f32 and bf16, at Whisper-medium's encoder shape in
   training (B=8, H=KH=16, S=2,048, D=64, non-causal, bf16) and serving
   (B=4, S=1,500: a partial last q and key tile), one non-causal ``Sq !=
   Sk`` case, a ragged f32 causal case (B=1, H=4, KH=1, S=1,500) and a
   padded head dim (D=48, f32, S=192), phase 9b's prefill on a process's
   heads (B=4, H=32, KH=4, S=256, D=128, causal, f32), phase 9c's (B=8,
   H=KH=8, S=256, D=128, f32) and the four-card probe's bf16 ones (B=8,
   S=2,048, D=128: H=16 and KH=2, H=KH=10, H=KH=4), Zamba2-7B's rank
   shapes at D=112 (phase 9d's f32 B=2, H=KH=16, S=512; the probe's bf16
   B=8, H=KH=8, S=2,048), a rank's at its long_500k cell (B=1, H=KH=8,
   S=524,288, bf16, held in blocks of 256 query rows), phase 9e's
   Whisper encoder on a process's heads (B=2, H=KH=8, S=1,500, D=64,
   non-causal, f32) and phase 9f's Qwen2.5-3B training on a grid process's
   heads (B=4, H=8, KH=1, S=256, D=128, causal, f32), within
   the reference's tolerances
   (2e-5 f32, 2e-2 bf16), each printed beside the card's name and power
   limit and beside
   ``scaled_dot_product_attention`` (timed only) and bound by the larger of
   bytes over 3.35 TB/s and flops over 989 TFLOP/s (bf16) or three times
   the flops over 494.7 TFLOP/s (f32 in 3xTF32; one f32 FMA pass over 67
   TFLOP/s is printed beside it); ``ssd_scan`` at Mamba2-1.3B's
   prefill shape (B=8, L=2,048, H=64, P=64, N=128, chunk 256) in bf16 (y
   within 2e-2, one bf16 rounding; the state within 2e-4) and f32 (2e-4),
   and at batch 1 over a 32,768-token and a 524,288-token prompt (bf16:
   x of 2**31 elements; one timed plain call), at Zamba2-7B's (B=4, H=112,
   N=64), chained from a nonzero initial state and with two groups, against
   its plain version, bound by the larger of bytes and flops at the inputs'
   type's peak (bf16; f32 as 3xTF32, one f32 FMA pass printed beside it),
   with one call profiled for the device time of each of its three kernels;
4. queries — TPC-H at ``--sf`` through the port's planner and executor:
   Q1, Q6, Q17, Q3 on 8 shards, Q3 and Q18 on 2 pods x 4, and Q3 again
   with an explicit ``impl="round_robin", num_chunks=2``.  Every answer is
   checked against the port's numpy oracle at the reference tests'
   tolerances, every run must drop no row, and the launch counters must
   show each shuffle edge's pack went through the kernels.  The Q3 rerun
   must give the same order keys and revenues within rtol 1e-6
   (``scatter_add_`` on the card sums floats in no fixed order).  Then
   the hand-written queries (``relational/queries.py``) on the same tables
   as one-shard tables: ``q17_part_filter`` against the oracle's part rows,
   Q1, Q6, Q17, Q3, Q14 and Q19 against the oracle (rtol 1e-4; Q17 1e-3;
   Q3's revenues 1e-5; Q1's counts and Q3's order keys exactly), each
   query's wall beside the planned query's on one shard;
4b. out-of-core — host copies of phase 4's tables, lineitem streamed as a
   ``MorselView`` of 2**20-row morsels (6 a pass, the last padded), each
   pinned and copied on a side stream: the two pack kernels first checked
   bit for bit at a morsel's shard shape; Q1, Q17 and Q18 on 8 shards
   under a ``device_row_budget`` of half lineitem's shard slice, which
   ``compile_plan`` must refuse, one pipeline chunk a shuffle (so one
   pack a shuffle), equal to the oracle at phase 4's
   tolerances (Q17: 2 passes, 12 morsel steps); Q17 on 2 x 4, where every
   step launches ``partition_pack`` and ``spill=True`` must raise; Q18 with
   8,192-row messages, which must raise without spill and, with it, spill
   rows over at least 3 drain rounds to an answer bit-identical to the
   unpressured run, the same under the plain pack; every run's
   ``hash_partition_pack`` and ``partition_pack`` launches equal to what
   its plan and counters imply.  Then Q18 at TPC-H SF 30: lineitem from
   ``gen_lineitem_chunked(30, 43)`` (180 M rows, 8.64 GB of int32 columns,
   each chunk generated on the host as the stream reaches it), orders and
   customer resident, a budget and group state of 2**23 rows a shard; the
   two packs first checked again at its morsel's and its resident orders'
   shard shapes; the peak allocated over the run must stay below
   lineitem's bytes, the
   overlap fraction in [0, 1], and the answer equal to the oracle over
   ``src.materialize()`` on the host, where ``compile_plan`` must refuse
   the materialized table;
4c. query serving — on phase 4's SF 1 tables, ``QueryServeEngine`` under
   ``StatsMode.COLLECT`` with 4 slots, a ``Tracer`` and a ``PlanCache`` in
   a temporary directory.  The nine templates, prewarmed, served twice:
   the second pass must make 0 ``plan_physical`` calls and 0 executor
   misses, integers bit-identical and floats within rtol 1e-6 between the
   passes, every answer equal to the oracle.  The reference CLI's default
   mix (Q1, Q3, Q6, Q14, Q17), 64 requests from 4 tenants arriving over
   rounds 0-4, on 8 shards; Q3, Q17 and Q18, 16 requests, on 2 x 4: the
   slot invariant every round, no request queued over ``ceil(N / 4) + 4``
   rounds, every answer (integers exactly, floats within 1e-6) and every
   trace (keys, histograms, measured and modeled bytes, salting) equal to
   the template's solo traced ``run_query``, one ``request:`` span a
   request, one ``admission-round:`` span a round, one ``mux:shared``
   span, one ``exchange:`` span an edge, ``hash_partition_pack`` launches
   equal to the shuffle edges served times the shared knobs' pipeline
   chunks and ``partition_pack`` once a shuffle on 2 x 4.  The model check
   (``repro_torch.obs.model_check``) at TPC-H SF 0.1 on 8 shards, where the
   reference's CLI runs it, must give the reference's per-edge byte-model
   errors and hold the 2x bound for Q1, Q6, Q14 and Q17 (Q3's reference
   reads 2.61x; at SF 1 the reference's model misses Q3 and Q17 too, so
   the SF 1 errors are printed, not gated).  QPS,
   TTFR p50/p99 by tenant, the cache record, cold and warm TTFR of Q3 and
   Q17, the 8-shard stream one query at a time through ``run_query`` and
   the phase's peak allocated are printed.  Then ``python -m
   repro_torch.launch.qserve`` twice on one ``--cache-dir`` (SF 1, 8
   shards, 16 requests): the second process must read at least 5 plans
   from disk, plan 0 times and write a trace that loads as JSON with the
   serving spans;
4d. calibration — on phase 4's SF 1 tables, the autotuner's measured side.
   A base ``ChipSpec`` (``V5E``'s fields with the card's name, its bf16
   peak of 989 TFLOP/s and its memory) is fitted by ``calibrate_chip`` on
   the simulated 8-unit fabric at ``CAL_MESSAGE_ROWS`` (1,024 and 2**21
   rows of 16 B: the large point bound by the card's bandwidth, not by the
   host's launches): the four raw walls and the four fitted constants are
   printed; every constant must be finite and positive and neither slope
   at its floor.  ``tune_multiplexer(refine=True, refine_top_k=3)`` under
   the calibrated spec for 16-byte rows at 1,024-65,536 rows a unit and for
   Q3's and Q17's shuffle edges: the 3 best modeled candidates timed, the
   returned ``measured_s`` the least wall, each ``cuda`` candidate
   launching ``hash_partition_pack`` once a chunk in each of its 5 runs,
   modeled against measured printed with the winner's gap beside the
   reference's 2x bar (not gated), and one probe with the refined knobs
   delivering the plain ``xla``/``torch`` shuffle's rows to every
   destination with 0 drops; on 2 x 4 it must warn and return the
   analytical knobs.  ``QueryServeEngine(chip=<calibrated>)`` serves the
   nine templates and phase 4c's 64-request stream: every answer equal to
   the oracle, pack launches as the plans imply; the plans that moved from
   V5E's, QPS and TTFR beside phase 4c's, the V5E time-model errors of Q3
   and Q17, and each of their shuffle edges timed alone by
   ``measure_shuffle_config`` at its own stats and knobs beside its
   ``exchange_makespan`` under both specs are printed; then ``tune_ep_dispatch`` for OLMoE-1B-7B at batch 64 on 8
   units, flat and on 2 pods, under both specs;
4e. the process fabric — on phase 4's SF 1 tables, Q3 and Q17 on 2 x 4 in
   this process, then ``tests/_torch_multiproc_driver.py``'s ten scenarios
   in 2 worker processes x 4 units (one pod each) on this one card, launched
   by ``repro_torch.launch.cluster`` over Gloo (every pod-hop message staged
   through pinned host memory): TPC-H Q3 and Q17, salted Q17 (zipf 1.2) and
   Q17 streamed in morsels of 2**20 rows at ``--sf``, the other seven at the
   reference's sizes.  Every scenario must pass in each process and the
   processes agree bit for bit; Q3's order keys, every Q3 and Q17 edge's
   histogram, the drops (0) and ``explain()`` must equal this process's 2 x
   4 run, the answers the oracle's; salted overload below the unsalted; the
   stream equal to the in-memory run, spill refused.  Each worker asserts
   its pack launches against its plans and each must have launched
   ``hash_partition_pack``, ``partition_pack`` and ``moe_dispatch``.  The
   coarse hop alone of each Q3 and Q17 edge is timed in each process and
   printed beside ``exchange_makespan``'s DCI term under ``V5E`` and the
   fitted spec (whose DCI fields are ``V5E``'s) and the fitted in-card link
   law on the same messages;
5. serving — OLMoE-1B-7B at full width (random weights from ``--seed``, f32
   master params, bf16 compute), expert-parallel over 8 simulated units
   flat and over 2 pods x 4.  A uniform workload (64 requests x 256 prompt
   tokens x 16 new, batch 64) through the static engine (no multiplexer:
   plain pack, round-robin) and the continuous engine (tuned multiplexer:
   the ``moe_dispatch`` kernel pack) must give identical greedy tokens; one
   prefill's logits must be bit-identical between the two packs; the
   continuous runs must launch ``moe_dispatch`` once per MoE layer of every
   prefill and decode step, the static runs never.  A mixed workload
   (``make_mixed_workload``: prompts 128/256/512, 1-32 new tokens, 4
   arrivals a step; 64 requests flat, 32 on 2 x 4) must complete with ``alloc.check()`` holding and in
   fewer slot-steps than static batching.  Prefill and decode tokens/s,
   TTFT p50/p99 and peak memory are printed; one prefill and one decode
   step are profiled;
5b. serving across processes (``[serve-procs]``) — ``run_local_cluster``
   runs the driver's ``serve`` scenario in 2 worker processes x 4 units on
   this card over Gloo, f32 with TF32 off: OLMoE-1B-7B at full width, 2 of
   its 16 layers (8 x 256-token prompts + 8 new, batch 8, expert-parallel
   under a two-level multiplexer with the ``moe_dispatch`` kernel pack) and
   Mamba2-1.3B at full width and depth (8 x 2,048 + 8).  Process 0 first
   runs the one-process static engine on the whole batch over the same 8
   units; then each process serves its 4 rows (the engine's split batch:
   its rows of the prompts and the cache, the MoE layer under
   ``moe_tokens="local"``, every step's tokens gathered).  Gates: greedy
   tokens equal to the one-process run's and on both processes, the
   prefill's and every decode step's logits within 1e-4 of their max, the
   per-unit drops bit-exact, ``moe_dispatch`` once an expert-parallel call
   and ``ssd_scan`` 48 times a prefill a process, the pod hop's bytes equal
   to the gathered tokens plus, for OLMoE, the capacity buffers' trips
   (Mamba2 none).  Then the continuous engine's slots split the same way:
   OLMoE-1B-7B at full width and 2 layers, 8 slots (4 a process, each
   process holding only its slots' cache rows), 16 mixed requests (prompts
   of 128 and 256 tokens, 1-8 new, 2 arrivals a step), against process 0's
   one-process continuous engine over the same 8 units: greedy tokens,
   admission and finish steps, the stats' counters and the spans equal,
   logits within 1e-4 of their max, drops bit-exact, half the cache a
   process, the pod hop equal to the gathered tokens, the expert trips and
   the prefilled rows sent to their slot's process as derived from the
   one-process engine's slots, and ``moe_dispatch`` once a layer a prefill
   group and a decode step on each process; the SSM family must still
   refuse the continuous engine.  Prefill and decode ms, tokens/s, TTFT,
   the moved rows, the pod-hop bytes and the peak of each run are printed
   beside the card's name and power limit;
6. training — train100m at full width and depth (random weights from
   ``--seed``, f32, ``remat="block"``) with ``attn_impl="flash"``, batch 8 x
   2,048 tokens, 10 AdamW steps (lr 3e-4, 5 warm-up steps of a 20-step
   schedule), through the calls ``launch/train.py`` makes.  Every loss must
   be finite and the mean
   of the last 5 below the first; ``flash_attention`` must launch 2 x 12
   times a step (each layer's forward and its remat recompute; the
   backward recomputes through the chunked plain attention).  One step
   from the same state and batch under ``attn_impl="chunked"`` must give
   the same loss (rtol 1e-5) and grad norm (rtol 1e-4).  The CLI
   (``launch.train.main``, seq 512) runs 4 steps with a checkpoint every 2,
   then resumes to step 6 in the same directory; its last loss must equal
   an uninterrupted 6-step run's within rtol 1e-5 (the embedding
   gradient's ``index_put`` sums in no fixed order on the card).  Then the
   same model with bf16 compute over f32 master params (the reference's
   default dtypes), 5 steps of the same schedule: the loss must fall, 24
   ``flash_attention`` launches a step (the bf16 kernel: 120, counted apart
   from the f32 run's 480), and one step must equal the chunked path's
   within rtol 2**-7 (loss) and 2**-5 (grad norm), 4 and 16 units of bf16
   roundoff.  ms a step, tokens/s and peak memory are printed; one step of
   each run is profiled;
6b. data-parallel training (``[dp-train]``) — ``run_local_cluster`` runs
   ``tests/_torch_multiproc_driver.py``'s ``dp_train`` in 2 worker
   processes x 4 units on this one card over Gloo: train100m at full width
   and depth (f32, TF32 off, ``remat="block"``, flash), one global batch of
   8 x 2,048 tokens, 4 rows a process, 1 a unit.  Process 0 first runs the
   one-process step on the whole batch; then 3 steps under
   ``grad_sync="auto"`` and 3 under ``"hierarchical"`` from the same state,
   each mode's first gradient and step held to it (loss rtol 1e-5, grad
   norm 1e-4, every leaf within ``1e-4 * max |b|``), the params after 3
   steps bit-identical on both processes, ``flash_attention`` 24 launches
   a step a process (``"auto"``) or 24 x 4 (``"hierarchical"``), and the
   pod hop carrying the leaves' f32 bytes once a step (padded to the unit
   count under ``"hierarchical"``).  Each mode's step walls, the sync's wall
   alone and the bytes a process puts on the pod hop are printed beside the
   card's name and power limit.  After the ``"auto"`` steps each process
   takes one more step counted op by op (``launch/op_cost.py``) and one under
   ``torch.profiler``, and prints one line (``[dp-train] profiled step``)
   of JSON: the step's ms, its counted flops, bytes and collective bytes by
   kind, the trace's overlap fraction, idle share and device busy share
   (``launch/roofline.py``'s ``trace_overlap``), MFU against the bf16 peak,
   the counter's peak of live bytes beside the allocator's, and the
   ``nvidia-smi`` line.  Gates: the collective bytes equal the step's pod-hop
   bytes to the byte, and the flops equal the dry run's count of the same
   config, batch and 2 x 4 layout on ``meta`` (``launch/dryrun.py``'s
   ``count_cell`` under a fake 2-rank group, made here);
6c. MoE training across processes (``[moe-train]``) — ``run_local_cluster``
   runs the driver's ``moe_train`` in 2 worker processes x 4 units on this
   card over Gloo: OLMoE-1B-7B at full width, 2 of its 16 layers (f32, TF32
   off, ``remat="block"``, flash), one global batch of 8 x 1,024 tokens (a
   unit's capacity 160), under a two-level multiplexer with the
   ``moe_dispatch`` kernel pack.  Process 0 first runs the one-process step
   over the same 8 units (the whole state, 16.7 GB) and frees it; then each
   process holds only its 32 experts a layer (params, m and v, drawn layer
   by layer from the seed) and takes the gradient and 3 steps on its rows
   under ``grad_sync="auto"``: the loss within rel 1e-5, every gradient
   leaf within ``1e-4 * max |b|`` (each process's expert slice and the
   replicated leaves), the first step's grad norm within rel 1e-4, the
   per-unit drop counts bit-exact, the sharded init equal to the whole init
   sliced, the replicated params after 3 steps bit-identical on both
   processes, ``moe_dispatch`` and ``flash_attention`` 2 x 2 launches a
   step a process.  Step walls, the bytes each process puts on the pod hop
   (replicated gradient and expert-parallel trips) and the peak memory are
   printed beside the card's name and power limit; then one profiled step
   as in 6b (``[moe-train] profiled step``), its collective bytes split into
   the replicated gradient's ``all-reduce`` and the expert-parallel trips'
   ``collective-permute``, each gated to the byte, and its flops to the dry
   run's count;
7. SSM serving — Mamba2-1.3B (48 layers, d_model 2,048) and Zamba2-7B (81
   layers, d_model 3,584) at full width and depth (random weights from
   ``--seed``, f32 master params, bf16 compute) through the static engine:
   Mamba2 16 requests x 2,048 prompt tokens x 32 new at batch 8, then one
   request of 32,768 tokens x 8 new, then the reference's ``long_500k``
   cell: one request of 524,288 tokens x 8 new (each layer's scan one
   launch over 2,048 chunks, x of 2**31 elements), its peak memory printed
   beside the prefill's count on ``meta`` (``launch/op_cost.py``), then one
   ``decode_step`` at position 524,287 holding only the params and the
   cache, its peak beside the dry run's count of the cell; Zamba2 8 x 2,048
   x 16 new at batch 4.  ``ssd_scan`` must launch once per Mamba2 layer of
   every prefill (48, 81).  In f32 compute, a prefill must agree with a
   shorter prefill followed by decode steps (the plain token-by-token
   recurrence ``ssd_step``): Mamba2 2 x 2,048 against 1,792 + 256 steps and
   1 x 524,288 against 524,032 + 256 (the last step at position 524,287),
   Zamba2 1 x 512 against 256 + 256; the last logits and every layer's SSM
   state within 1e-3 of the largest magnitude, each check's peak memory
   beside its prefill's count.  Prefill and decode tokens/s, ms a decode
   step and peak memory are printed; one prefill and one decode step of
   each model are profiled;
8. SSM training — Mamba2-1.3B at full width and depth (48 layers, d_model
   2,048; random weights from ``--seed``, bf16 compute over f32 master
   params, ``remat="block"``), 4 AdamW steps at 8 x 2,048 tokens through
   the calls ``launch/train.py`` makes: every loss finite, the mean of the
   last 3 below the first, ``ssd_scan`` launched 2 x 48 times a step (each
   layer's forward and its remat recompute; the backward recomputes through
   the plain scan); one step profiled (the scan kernels' and the plain
   backward's shares of device time); one step from the same state and
   batch against the plain scan (``mamba2.ssd_chunked`` patched to
   ``ref.ssd_scan_ref`` for that step) in bf16 (loss and grad norm within
   ``TRAIN_BF16_RTOL``) and in f32 compute at 2 x 2,048 (loss rtol 1e-4,
   grad norm 1e-3).  Zamba2-7B at full width, depth cut to 13 layers for
   memory (two groups of 6 with the shared block, a tail of 1): 5 steps at 4
   x 2,048, finite and falling losses, 2 x 13 launches a step.  Then
   ``launch.train.main(["--arch", "mamba2-1.3b", "--steps", "2", ...])``
   without a checkpoint.  Step walls, tokens/s and peak memory printed;
9. transformer configs — MiniCPM-2B, Qwen2.5-3B, Qwen2-VL-2B (f32 params),
   DeepSeek-V2-Lite-16B (bf16 params) at full width and depth, Qwen1.5-32B
   at 24 of 64 layers and DeepSeek-67B at 20 of 95 (bf16 params; the
   four-card probe serves both whole, tensor-parallel), random weights from
   ``--seed``, bf16 compute, one at a
   time, each freed before the next loads.  A uniform workload (8 requests
   x 256 prompt tokens x 16 new at batch 4; Qwen2-VL with 128 patch rows
   before every prompt) through the static and the continuous engine must
   give identical greedy tokens.  No config runs a mixed workload here, for
   the script's time: phases 9b, 9c and 9e serve mixed requests (9e the MLA
   and expert-parallel slot path at unequal positions).
   DeepSeek-V2-Lite runs expert-parallel over 8 simulated units at batch 8
   (the units must divide a decode step's tokens): the continuous engine,
   under its tuned multiplexer, must launch ``moe_dispatch`` once per MoE
   layer (26) of every prefill group and decode step, the static engine
   never, and one prefill's logits must be bit-identical between the kernel
   pack and the plain pack.  In f32 compute (the exact dense MoE path) at
   batch 1, a 256-token prefill (after the VLM's patch rows) must equal a
   192-token prefill followed by 64 decode steps: the last logits and every
   cache leaf (KV, or MLA's compressed ``c`` and ``kr``) within 1e-3 of the
   largest magnitude.  Layers, param count and dtype, prefill tokens/s, ms a
   decode step, TTFT p50/p99 and peak memory printed for each;
9b. tensor-parallel serving — the ``tensor_serve`` scenario of
   ``tests/_torch_multiproc_driver.py`` in 2 worker processes on this card
   (Gloo) under the tensor table (``distributed.sharding.tensor_rules``):
   DeepSeek-67B at full width, 2 of its 95 layers, f32 params and compute
   (TF32 off), ``attn_impl="flash"``, 4 x 256-token prompts + 8 new through
   the static engine, every process the whole batch over its slices (32 q
   and 4 kv heads, half of ``d_ff`` and of the vocab), drawn from the seed
   through ``init``'s ``tensor_place``.  Process 0 first serves the whole
   tree in one process; its placed params must equal the whole tree's
   slices, every call's logits within ``rtol = atol = 2e-4`` (the
   reference's ``decode_sharded_equiv`` tolerance), the greedy tokens equal,
   the tokens equal on both processes, the all-reduce and all-gather bytes
   equal to the count from the shapes, and ``flash_attention`` launched 2
   times a prefill a process (D = 128; their sum is the JSON line's
   ``flash_attention[tensor]`` row).  The same tree then serves 8 mixed
   requests (128 and 256 tokens, 1-8 new, 2 a step) through the continuous
   engine on 4 slots (every slot's cache rows of the process's kv heads on
   every process, no row moved), against process 0's one-process continuous
   engine: tokens, admission and finish steps, stats and spans equal,
   logits within ``2e-4``, no slot leak, the static prompts' greedy tokens
   the static engine's; ``generate_bucketed``'s slot-steps printed beside
   the continuous engine's;
9c. (at once with 9b) OLMoE-1B-7B tensor-parallel with its experts split:
   the same scenario over 2 processes of 4 units (the reference's
   ``serve_continuous_ep`` layout), full width, 2 of 16 layers, f32 (TF32
   off), 8 q and 8 kv heads, 32 of 64 experts and half the vocab a
   process: the static engine on 8 x 256 + 8, then 16 mixed requests (128
   and 256 tokens, 1-8 new, 2 a step) through the continuous engine on 8
   slots, expert-parallel over the 8 units under its tuned two-level
   multiplexer with the ``moe_dispatch`` kernel pack, with 9b's gates and
   the drops equal to the one-process engine's; ``flash_attention`` once a
   layer a prefill and group, ``moe_dispatch`` once a layer an
   expert-parallel call (the JSON line's ``flash_attention[tensor-moe]``
   and ``moe_dispatch[tensor]`` rows);
9d. (at once with 9b and 9c) the SSM and hybrid families tensor-parallel:
   the same scenario over 2 processes of 2 units, f32 (TF32 off),
   ``attn_impl="flash"``, through the static engine (the continuous engine
   refuses both families, as the reference's), with the prefill's SSM
   states gated too (``--tp-states``): Mamba2-1.3B at full width and depth
   (32 of 64 SSM heads a process: its ``z``, ``x`` and ``dt`` columns, every
   ``B``/``C`` column, its conv channels and ``out_proj`` rows), 4 x 512 + 8
   new; then Zamba2-7B at full width, 13 of 81 layers (phase 8's cut; 56 of
   112 SSM heads, 16 q and 16 kv heads at D = 112, half of ``d_ff`` and the
   vocab a process), 2 x 512 + 8 new; each against process 0's one-process
   engine with 9b's gates; ``ssd_scan`` once a Mamba2 layer a prefill and
   ``flash_attention`` once a shared-block call (the JSON line's
   ``ssd_scan[tensor]`` and ``flash_attention[tensor-ssm]`` rows);
9e. (at once with 9b-9d) MLA and the encoder-decoder tensor-parallel: the
   same scenario over 2 processes of 4 units, f32 (TF32 off), each cell
   against process 0's one-process engine on the whole tree with 9b's
   gates: DeepSeek-V2-Lite-16B at full width, 3 of 27 layers (the dense
   first layer and 2 MoE layers), 8 of 16 MLA heads (``wq``, ``wk_b``,
   ``wv_b``, ``wo``; ``wkv_a`` and the compressed cache whole) and 32 of 64
   experts a process, expert-parallel, 8 x 256 + 8 through the static
   engine, then 8 mixed requests (128 and 256 tokens, 1-8 new, 2 a step) on
   8 slots through the continuous engine under its tuned two-level
   multiplexer with the ``moe_dispatch`` kernel pack; Whisper-medium at full
   width and depth, ``attn_impl="flash"``, 8 q and 8 kv heads a process, 2
   requests of 1,500 frame rows and an 8-token prompt + 8 new through the
   static engine, ``flash_attention`` once an encoder layer a prefill, the
   continuous engine refusing the family; the JSON line's
   ``moe_dispatch[tensor-mla]`` and ``flash_attention[tensor-encdec]`` rows.
   The card's used bytes over 9b-9e, every process's together, are printed
   beside its size;
9f. (after 9b-9e) dense training on a ``data x model`` grid: the
   ``grid_train`` scenario of ``tests/_torch_multiproc_driver.py`` in 4
   worker processes on this card (Gloo) as a 2 x 2 grid under the
   reference's ``default_rules(False)``: Qwen2.5-3B at full width, 4 of 36
   layers, f32 (TF32 off), flash attention, remat ``"block"``, 8 x 256
   tokens (each data column its 4 rows), each process drawing its pieces
   (heads, ``d_ff`` and vocab split over its model row, every ``fsdp`` dim
   over its data column); 2 AdamW steps against rank 0's one-process steps
   on the whole batch (loss rtol 1e-5, grad norm 1e-4, every gradient piece
   1e-4 of its leaf's max, params 1e-5), the replicated leaves bit-identical
   within their groups, each group's all-reduce, all-gather and
   reduce-scatter bytes equal to the count from the shapes; step walls,
   each rank's state and peak and the card's used bytes printed;
   ``flash_attention`` twice a layer a pass (the JSON line's
   ``flash_attention[tensor-train]`` row);
10. Whisper — Whisper-medium at full width and depth (24 encoder + 24
   decoder layers, d_model 1,024, 16 heads, vocab 51,865; random weights
   from ``--seed``, f32 master params, bf16 compute, ``attn_impl="flash"``).
   Serving through the static engine: 8 requests x 1,500 prompt tokens,
   each with 1,500 frame rows (Whisper's 30 s window), 32 new at batch 4,
   batch by batch and through ``generate_bucketed`` with identical greedy
   tokens; ``flash_attention`` must launch non-causally 24 times a prefill
   (the encoder), each with a partial last tile
   (``LAUNCHES["flash_attention[ragged]"]``), and never causally (the
   decoder's prefill runs ``sdpa``, as the reference's); the continuous
   engine must refuse the family.  Prefill
   tokens/s, ms a decode step, TTFT p50/p99 (all requests queued at once)
   and peak memory printed; one prefill and one decode step profiled.  In
   f32 at batch 1, calling the model directly: 1,500 frames, a prefill of
   1,436 tokens and 64 decode steps over the unpadded cross cache against
   ``decode_train`` at the last position, the logits within 1e-3 of the
   largest magnitude.  Training: 4 AdamW steps at 8 x 2,048 (and 2,048
   frames), ``remat="block"``, through the calls ``launch/train.py``
   makes: losses finite, the mean of the last 3 below the first, 96
   ``flash_attention`` launches a step (48 non-causal: each encoder layer's
   forward and remat recompute; 48 causal: the decoder's); one step
   against ``attn_impl="chunked"`` within ``TRAIN_BF16_RTOL``; one step
   profiled; then ``launch.train.main`` for 2 steps at 2 x 512;
11. a ``{"kernels": [...]}`` JSON line, then the card's name and power limit;
12. the last line: ``{"ok": true, "device": {...}}``.

Wall times are host clock around work that ends in
``torch.cuda.synchronize()``, taken on each query's second run and around
every prefill and decode step.  ``--profile`` adds a third run of each query
under ``torch.profiler`` and prints device time by kernel and the device's
busy share of the wall time.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# CUDA cores f32; dense tensor cores, tf32 and bf16
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
N_SHARDS = 8
ALL_RUNS = ("q1", "q6", "q17", "q3", "q3_pods", "q18_pods", "q3_rr")
# serving: batch, prompt tokens, new tokens, cache positions (the uniform
# workload); mixed requests on 8 units and on 2 x 4 (fewer, for time)
SERVE_SHAPE = (64, 256, 16, 545)
MIXED_REQUESTS = {1: 64, 2: 32}
# Phase 5b: the static engine's batch split over 2 worker processes x 4 units
# on this card (Gloo): arch:layers:BxSxNEW cells (layers 0: the config's), f32
# with TF32 off, logits within this fraction of their max of the one-process run
SERVE_PROCS, SERVE_UNITS = 2, 4
SERVE_PROCS_CELLS = "olmoe-1b-7b:2:8x256x8,mamba2-1.3b:0:8x2048x8"
# ... and the continuous engine's slots split the same way: OLMoE-1B-7B at 2
# of its 16 layers, arch:layers:SLOTSxREQUESTSxNEW (1 to NEW new tokens), the
# mixed workload's prompt lengths and arrivals a step
SERVE_PROCS_CONTINUOUS = ("olmoe-1b-7b:2:8x16x8", "128,256", 2)
SERVE_PROCS_TOL = 1e-4
SERVE_PROCS_TIMEOUT_S = 300
# training: batch, seq, steps; the length of every training run's lr schedule
# (5 warm-up steps over 20); the CLI resume check's seq.  train100m's f32 run
# takes 10 steps to keep the whole script near 1,100 s with phase 7's long_500k
# cell.
TRAIN_SHAPE = (8, 2048, 10)
TRAIN_SCHEDULE = 20
# data-parallel training (6b): worker processes and units each on this card,
# the global batch (rows, seq), the launcher's deadline
DP_PROCESSES, DP_UNITS = 2, 4
DP_SHAPE = (8, 2048)
DP_TIMEOUT_S = 240
# Phase 6c: OLMoE-1B-7B at full width, 2 of its 16 layers, its experts
# sharded over 2 worker processes x 4 units on this card (Gloo), f32.
MOE_PROCESSES, MOE_UNITS = 2, 4
MOE_LAYERS = 2
MOE_SHAPE = (8, 1024)
MOE_TIMEOUT_S = 300
CLI_SEQ = 512
# the bf16-compute run: steps, and flash against chunked within (loss, grad
# norm) rtols of 4 and 16 units of bf16 roundoff (u = 2**-9): the two paths
# round the probabilities at different points, about u in each layer's output
TRAIN_BF16_STEPS = 5
TRAIN_BF16_RTOL = (2.0**-7, 2.0**-5)
# SSM serving: requests, prompt tokens, new tokens, batch; each f32 check's
# batch, full length and split point
SSM_SERVE = {"mamba2-1.3b": (16, 2048, 32, 8), "zamba2-7b": (8, 2048, 16, 4)}
SSM_LONG = (32768, 8)  # Mamba2: one request of the reference's prefill_32k length
SSM_500K = (524_288, 8)  # Mamba2: one request of the reference's long_500k length
# The long f32 check is the long_500k prompt against 524,032 tokens and 256
# decode steps, the last at position 524,287 (the dry run's decode step); the
# 32,768-token prompt has no f32 check of its own, for the script's time.
SSM_CHECK = {"mamba2-1.3b": [(2, 2048, 1792), (1, SSM_500K[0], SSM_500K[0] - 256)],
             "zamba2-7b": [(1, 512, 256)]}
SSM_CHECK_TOL = 1e-3
# SSM training: Mamba2-1.3B at full width and depth (batch, seq, steps); its
# f32 step against the plain scan (batch, loss rtol, grad norm rtol: the two
# differ in f32 rounding through 48 layers); Zamba2-7B at full width with its
# depth cut to 13 layers for memory (two groups of 6 with the shared block, a
# tail of 1: 81 layers' ~6.7 B f32 params with their grads and AdamW moments
# take ~108 GB, 13 layers' ~22 GB), batch and steps; the CLI's run.  Mamba2
# trains 4 steps to keep the whole script near 1,100 s with phase 6c and phase
# 7's long_500k cell.
SSM_TRAIN = (8, 2048, 4)
SSM_TRAIN_F32 = (2, 1e-4, 1e-3)
ZAMBA_TRAIN = (13, 4, 5)
SSM_TRAIN_CLI = (2, 512, 2)  # steps, seq, batch
SSD_BACKWARD_SPAN = "ssd_scan.backward (plain)"
# transformer configs (phase 9): each at full width with random weights from
# --seed and bf16 compute: (layers run or None for all, param dtype).  f32
# params where they fit; DeepSeek-V2-Lite's f32 params alone would take
# 62.8 GB, so bf16.  Qwen1.5-32B and DeepSeek-67B, in bf16, do not fit one
# card whole (all 64 layers: 35,197,096,960 params, 70.4 GB; all 95:
# 67,425,001,472, 134.9 GB, counts from the port's ``param_count``); the
# four-card probe serves them whole, tensor-parallel
# (``tools/torch_cluster_probe.py serve --runs tensor``), so here they run
# cut to 24 and 20 layers (48 and 40 until the tensor-parallel phase 9b came,
# cut for the script's time).  No config runs a mixed workload here since
# phase 9e (the dense configs stopped with phase 9c, DeepSeek-V2-Lite with
# 9e, for the script's time): phases 9b, 9c and 9e serve mixed requests
# continuously, 9e the MLA + expert-parallel slot path at unequal positions.
TF_CONFIGS = {
    "minicpm-2b": (None, "float32"),
    "qwen2.5-3b": (None, "float32"),
    "qwen2-vl-2b": (None, "float32"),
    "deepseek-v2-lite-16b": (None, "bfloat16"),
    "qwen1.5-32b": (24, "bfloat16"),
    "deepseek-67b": (20, "bfloat16"),
}
# the uniform workload: requests, prompt tokens, new tokens, batch; a VLM adds
# min(VLM_PATCHES, prompt // 2) patch rows.  The expert-parallel model runs at
# batch 8: its 8 units must divide a decode step's tokens, or the MoE layer
# takes the dense path (as the reference's does).
TF_SERVE = (8, 256, 16, 4)
TF_EP_UNITS = 8
# the f32 check at batch 1: full prompt, split point (then one decode step a
# token to the full prompt), and the limit of the largest magnitude
TF_CHECK = (256, 192)
TF_CHECK_TOL = 1e-3
# Phase 9b: tensor-parallel serving (the tensor table) over 2 worker processes
# on this card (Gloo): DeepSeek-67B at full width cut to 2 of its 95 layers,
# f32 params and compute with TF32 off, attn_impl="flash" (32 q and 4 kv heads
# a process, D = 128), arch:layers:BxSxNEW; process 0's one-process engine on
# the whole tree first, the logits held within the reference's
# decode_sharded_equiv tolerance (TP_TOL in tests/_torch_multiproc_driver.py).
# Since PR 34 the same tree also serves a few mixed requests through the
# continuous engine (slots x requests x new, prompt lengths, arrivals a step),
# held to process 0's one-process continuous engine.  Two layers, not four:
# the eight processes of 9b-9e share the card, and at four
# layers process 0's whole tree beside its half (18 + 9 GB) took the card to
# 75-80 of its 85 GB and, in one run, past it.
TP_PROCS, TP_UNITS = 2, 2
TP_CELL = "deepseek-67b:2:4x256x8"
TP_MIXED = ("4x8x8", "128,256", "2")
TP_TIMEOUT_S = 300
# the workers of the clusters that share the card at once (9b-9e): the caching
# allocator grows its segments in place rather than keeping a reserved but
# unused block a size apart in each of eight processes
SHARED_CARD_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
# Phase 9c: OLMoE-1B-7B tensor-parallel with its experts split over the 2
# processes (4 units each: the reference's serve_continuous_ep layout, 8
# units), full width cut to 2 of its 16 layers (phase 5b's and 6c's cut), f32
# with TF32 off, attn_impl="flash" (8 q and 8 kv heads a process, D = 128),
# expert-parallel under the continuous engine's tuned two-level multiplexer
# with the moe_dispatch kernel pack: the static engine on 8 x 256 + 8, then
# phase 5b's continuous cell (8 slots, 16 mixed requests of 128 and 256
# tokens, 1-8 new, 2 arriving a step), each against process 0's one-process
# engine on the whole tree over the same 8 units.
TPM_PROCS, TPM_UNITS = 2, 4
TPM_CELL = "olmoe-1b-7b:2:8x256x8"
TPM_MIXED = ("8x16x8", "128,256", "2")
# the bf16 attention shapes a process runs in the four-card probe's full-depth
# prefills (8 x 2,048): DeepSeek-67B's 16 q and 2 kv heads, Qwen1.5-32B's 10
# and 10, OLMoE-1B-7B's 4 and 4, D = 128
TP_PROBE_FLASH = ((8, 16, 2, 2048, 128), (8, 10, 10, 2048, 128), (8, 4, 4, 2048, 128))
# moe_dispatch under the tensor table, (process's units, tokens a unit, C):
# phase 9c's decode step (8 slots over 8 units) and 256-token prefill group,
# OLMoE's capacity factor of 1.25 (the four-card probe's shapes are the gpu
# cases of tests/test_torch_moe.py)
TP_MOE = (("decode", 4, 1, 4), ("prefill", 4, 256, 40))
# Phase 9d: the SSM and hybrid families tensor-parallel over 2 worker
# processes on this card (Gloo) of 2 units: Mamba2-1.3B at full width and
# depth (48 layers, 32 of its 64 SSM heads a process), then Zamba2-7B at full
# width cut to 13 layers (phase 8's cut: 2 groups of 6 with the shared block,
# a tail of 1; 56 of 112 SSM heads, 16 q and 16 kv heads at D = 112 a
# process), f32 with TF32 off, attn_impl="flash"; each against process 0's
# one-process engine on the whole tree (logits, tokens, the prefill's SSM
# states).  TPS_SSD and TPS_FLASH are the shapes a process's prefill gives the
# kernels there (B, L, H, P, N and B, H, KH, S, D), held in phase 3.
TPS_PROCS, TPS_UNITS = 2, 2
TPS_CELLS = "mamba2-1.3b:0:4x512x8,zamba2-7b:13:2x512x8"
TPS_SSD = ((4, 512, 32, 64, 128), (2, 512, 56, 64, 64))
TPS_FLASH = (2, 16, 16, 512, 112)
# the bf16 shapes a rank runs in the four-card probe's 8 x 2,048 prefills
# (tools/torch_cluster_probe.py serve --runs tensor_ssm): ssd_scan on
# Mamba2-1.3B's 16 and Zamba2-7B's 28 SSM heads a rank, and Zamba2's shared
# attention on 8 q and 8 kv heads at D = 112
TP_PROBE_SSD = ((8, 2048, 16, 64, 128), (8, 2048, 28, 64, 64))
TP_PROBE_SSM_FLASH = (8, 8, 8, 2048, 112)
# and a rank's shared-block prefill at Zamba2-7B's long_500k cell over four
# cards (--runs tensor_long_500k): B, H, KH, S, D
TP_PROBE_LONG_FLASH = (1, 8, 8, 524_288, 112)
# Phase 9e: MLA and the encoder-decoder under the tensor table, over 2 worker
# processes on this card (Gloo) of 4 units (so that the 8 units divide a
# decode step's 8 tokens), f32 with TF32 off, each cell against process 0's
# one-process engine on the whole tree: DeepSeek-V2-Lite-16B at full width,
# 3 of 27 layers (the dense first layer and 2 MoE layers, phase 9c's cut of an
# MoE model; 6.68 GB of f32 params whole, counted on meta), 8 of 16 MLA heads
# and 32 of 64 experts a process, expert-parallel (the continuous engine under
# its tuned two-level multiplexer with the moe_dispatch kernel pack): 8 x 256
# + 8 through the static engine, then 8 slots and 8 mixed requests (128 and
# 256 tokens, 1-8 new, 2 a step) through the continuous one; Whisper-medium at
# full width and depth (24 + 24 layers, 3.25 GB of f32 params whole),
# attn_impl="flash", 8 q and 8 kv heads a process, 2 requests of 1,500 frame
# rows and an 8-token prompt + 8 new through the static engine (the
# continuous engine must refuse it, as the reference's).  TPE_FLASH is the
# encoder's kernel shape a process runs there (B, H, KH, S, D), held in phase
# 3, and TPE_MOE the dispatch shapes (a process's units, tokens a unit, C at
# the config's capacity factor of 1.25, top-6).
TPE_PROCS, TPE_UNITS = 2, 4
TPE_CELLS = "deepseek-v2-lite-16b:3:8x256x8:0:ep,whisper-medium:0:2x8x8"
TPE_MIXED = ("8x8x8", "128,256", "2")
TPE_FRAMES = 1500
TPE_FLASH = (2, 8, 8, TPE_FRAMES, 64)
TPE_MOE = (("decode", 4, 1, 4), ("prefill", 4, 256, 30))
# Phase 9f: dense training on a data x model grid of 4 worker processes on
# this card (Gloo), the reference's default_rules(False) (heads, d_ff and
# vocab over the model row, every fsdp dim and the batch over the data
# column): Qwen2.5-3B at full width (d_model 2,048, 16 q and 2 kv heads of
# 128, d_ff 11,008, vocab 151,936), cut to TT_LAYERS of its 36 layers (the
# phase's time: every FSDP gather and its reduce-scatter are staged through
# host memory under Gloo, and rank 0 holds the whole one-process state beside
# its piece), f32 (TF32 off), flash attention, remat "block", one global
# batch of TT_SHAPE (each data column its half), 2 AdamW steps, held to rank
# 0's one-process step on the same seed and batch.  TT_FLASH is the kernel
# shape a process runs there (B, H, KH, S, D: its column's rows, its row's 8
# q heads and 1 kv head), held in phase 3.
TT_GRID = (2, 2)
TT_LAYERS = 4
TT_SHAPE = (8, 256)
TT_FLASH = (TT_SHAPE[0] // TT_GRID[0], 16 // TT_GRID[1], 2 // TT_GRID[1], TT_SHAPE[1], 128)
TT_TIMEOUT_S = 300
# Whisper-medium (phase 10): requests, prompt tokens (and as many frame rows),
# new tokens, batch; the f32 check's frames and full length, and its split
# point (then one decode step a token); training batch, seq (and frames),
# steps; the CLI's steps, seq, batch.  Serving runs Whisper's own 1,500-frame
# window, which the flash kernel takes with a partial last tile.  Training
# takes 4 steps (5 until phase 9e came, 10 until phase 7's long_500k cell) to
# keep the whole script near 1,080 s.
WHISPER_SERVE = (8, 1500, 32, 4)
WHISPER_CHECK = (1500, 1436)
WHISPER_TRAIN = (8, 2048, 4)
WHISPER_TRAIN_CLI = (2, 512, 2)
# Ported kernels no main path calls (the reference calls hash_partition
# only from its tests): checked and timed, never required to launch.
OFF_PATH = ("hash_partition",)
# out-of-core: global morsel rows at SF 1, the message bound that forces
# spill there, and Q18 at TPC-H SF 30 (lineitem in 43 chunks of ~4.19 M
# rows, 524,288 a shard; 2**23 rows a device for the budget and the group
# state, against 22.5 M of lineitem a shard)
OOC_MORSEL = 2**20
OOC_SPILL_ROWS = 8192
OOC_SF = 30
OOC_CHUNKS = 43
OOC_BUDGET = 2**23
# query serving: slots, tenants; the reference CLI's default mix and its
# requests on 8 shards; the pod mix and its requests; the templates whose
# reference CLI holds the 2x byte-model bound at TPC-H SF 0.1 on 8 shards
# (q3's orders shuffle reads 2.61x there; q1, q6 and q14 ship no shuffle)
QS_SLOTS = 4
QS_TENANTS = ("tenant0", "tenant1", "tenant2", "tenant3")
QS_MIX = ("q1", "q3", "q6", "q14", "q17")
QS_REQUESTS = 64
QS_POD_MIX = ("q3", "q17", "q18")
QS_POD_REQUESTS = 16
QS_BYTE_BOUND = ("q1", "q6", "q14", "q17")
# the reference CLI's per-edge byte-model errors there (its plans ship no
# shuffle for q1, q6 and q14)
QS_REF_BYTE_ERR = {
    "q3": {"shuffle[l_orderkey]#1": 1.0124212938249406,
           "shuffle[o_orderkey]#0": 2.6084076777507432},
    "q17": {"shuffle[l_partkey]#0": 1.7615384615384615},
}
# calibration: the message rows of calibrate_chip's two laws.  The large
# point must be bound by the card's bandwidth, not by the host's launches:
# at the reference's 65,536 rows one all-to-all of [8, 8, rows, 4] int32
# moves 67 MB, tens of µs of copies on the card, about what its 7 phases'
# launches cost, so the fitted slope could sit at its floor.  2**21 rows
# move 2.1 GB (~1.3 ms of reads and writes at 3.35 TB/s), far above the
# launches; 1,024 keeps the reference's sweep of 1,024-65,536 rows inside
# the calibrated range.  The sweep, its row width, the candidates timed, the
# reference's 2x model-accuracy bar (printed, not gated: the pack law is the
# plain pack's) and the rows of each equality probe.
CAL_MESSAGE_ROWS = (1024, 2**21)
CAL_SWEEP_ROWS = (1024, 4096, 16384, 65536)
CAL_ROW_BYTES = 16
CAL_TOP_K = 3
CAL_ACCURACY_BAR = 2.0
CAL_PROBE_ROWS = 65536
# the process fabric: two worker processes of 4 units on the one card, one
# pod each; their scenarios and the launcher's deadline
CLUSTER_PROCESSES, CLUSTER_UNITS = 2, 4
CLUSTER_SCENARIOS = (
    "hierarchical_psum", "exchange_over_dci_raises", "two_level_shuffle", "production_mesh",
    "tuner_dci_aware", "tpch_pod_mesh", "ep_dispatch_two_level", "salted_pod_shuffle",
    "oocore_pod_stream", "trace_merge",
)
CLUSTER_TIMEOUT_S = 400


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as sk

    hp.reset_launch_counts()
    md.reset_launch_counts()
    fa.reset_launch_counts()
    sk.reset_launch_counts()


def _counts() -> dict:
    """Every kernel's launches since the last :func:`_reset_counts`."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as sk

    return {**hp.LAUNCHES, **md.LAUNCHES, **fa.LAUNCHES, **sk.LAUNCHES}


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def _kernel_row(name, replaces, source, label, nbytes, kern, plain, note=""):
    """Run a kernel and its plain version once, require bit-equality, time
    both with CUDA events and compute the bytes bound."""
    import torch

    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} ({label}): kernel disagrees with its plain version "
                             f"(max |err| {err})")
    ms = _time_ms(kern)
    plain_ms = _time_ms(plain)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(
        f"[kernels] {name}: {label} bit-exact{note}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({nbytes} B), "
        f"{100 * bound_ms / ms:.2f}% of bound"
    )
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, match=True,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None,
    )


def _flash_row(B, H, KH, Sq, Sk, D, causal, dtype, seed, smi: str) -> dict:
    """The attention kernel against its plain version within the reference's
    tolerance, timed beside the plain version and SDPA (never used by the
    port); bound by the larger of bytes and flops, both at the call's own
    ``D`` (a padded head dim's zero columns are not the function's work)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, KH, Sk, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, KH, Sk, D), generator=gen, device="cuda").to(dt)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash_attention {dtype} {(B, H, KH, Sq, Sk, D, causal)}: "
                             f"disagrees with its plain version (max |err| {err})")
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal), iters=20)
    plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), iters=20)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), iters=20)
    flops, nbytes = fa.attention_work(q, k, causal)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # f32 runs three tf32 products (3xTF32) on the tensor cores; one f32 FMA
    # pass on the CUDA cores is the other bound printed
    ops_ms = (3 * flops / PEAK_FLOPS["tf32"] if dtype == "float32"
              else flops / PEAK_FLOPS[dtype]) * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    label = f"B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} D={D} {'causal' if causal else 'full'} {dtype}"
    extra = {}
    fma = ""
    if dtype == "float32":
        extra["bound_f32_fma_ms"] = max(bytes_ms, flops / PEAK_FLOPS["float32"] * 1e3)
        fma = (f"; f32 FMA bound {extra['bound_f32_fma_ms']:.4f} ms, "
               f"{100 * extra['bound_f32_fma_ms'] / ms:.2f}% of it")
    print(
        f"[kernels] flash_attention: {label} within {tol} (max |err| {err:.3g}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"by {bound_by}{' (3xTF32)' if dtype == 'float32' else ''} ({flops} flop, {nbytes} B), "
        f"{100 * bound_ms / ms:.2f}% of bound{fma} ({smi})"
    )
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:100", match=True, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, **extra,
    )


def _flash_long_row(B, H, KH, S, D, seed, smi: str, q_block: int = 256) -> None:
    """The attention kernel at a long causal bf16 prompt (a rank's shared
    block at Zamba2-7B's long_500k cell), held block by block against its
    plain version: each ``q_block`` of query rows is
    ``ref.flash_attention_ref``'s arithmetic on those rows and the keys they
    see (the whole ``[S, S]`` logits never exist), within the reference's
    bf16 tolerance (2e-2); timed beside SDPA (never used by the port) and
    bound as ``_flash_row`` bounds it.  Printed only: the JSON line's rows
    are the main path's launch keys."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, KH, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, KH, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    t0 = time.perf_counter()
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    scale, G, tol, err = 1.0 / math.sqrt(D), H // KH, 2e-2, 0.0
    t0 = time.perf_counter()
    for s0 in range(0, S, q_block):
        e = s0 + q_block
        qg = q[:, :, s0:e].reshape(B, KH, G, q_block, D)
        logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k[:, :, :e]).float() * scale
        mask = torch.arange(s0, e, device="cuda")[:, None] >= torch.arange(e, device="cuda")
        w = torch.softmax(logits.masked_fill_(~mask, float("-inf")), dim=-1).to(v.dtype)
        del logits
        want = torch.einsum("bkgqs,bksd->bkgqd", w, v[:, :, :e]).reshape(B, H, q_block, D)
        g = got[:, :, s0:e].float()
        err = max(err, float((g - want.float()).abs().max()))
        if not torch.allclose(g, want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention bf16 {(B, H, KH, S, D)}: query rows "
                                 f"{s0}-{e - 1} disagree with the plain version (max |err| "
                                 f"{err})")
        del w, want
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=2, warmup=1)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True),
                          iters=2, warmup=1)
    flops, nbytes = fa.attention_work(q, k, True)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(
        f"[kernels] flash_attention: B={B} H={H} KH={KH} Sq=Sk={S} D={D} causal bfloat16, every "
        f"query row within {tol} of the plain version in blocks of {q_block} (max |err| "
        f"{err:.3g}; first call {first_s:.2f} s, check {check_s:.1f} s); kernel {ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops} flop, "
        f"{nbytes} B), {100 * bound_ms / ms:.2f}% of bound ({smi})"
    )
    del q, k, v, got
    torch.cuda.empty_cache()


def _ssd_row(B, L, H, P, N, Q, G, dtype, seed, initial_state=False, plain_iters=3) -> dict:
    """The chunk-scan kernel against its plain version (y within 2e-4 in
    f32 and 2e-2 in bf16, the f32 state within 2e-4), timed beside the plain
    version (``plain_iters`` calls after one warm-up); bound by the larger of
    bytes and flops at the inputs' type's peak (bf16; f32 as three tf32
    products, as ``_flash_row`` counts it, with one f32 FMA pass printed
    beside it).  The inputs follow the model's distributions: dt log-uniform
    in [1e-3, 1e-1], A uniform in [-16, -1]."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    x = torch.randn((B, L, H, P), generator=gen, device="cuda").to(dt_)
    dt = torch.exp(uniform((B, L, H), math.log(1e-3), math.log(1e-1)))
    A = -uniform((H,), 1.0, 16.0)
    Bm = torch.randn((B, L, G, N), generator=gen, device="cuda").to(dt_)
    Cm = torch.randn((B, L, G, N), generator=gen, device="cuda").to(dt_)
    s0 = torch.randn((B, H, P, N), generator=gen, device="cuda") if initial_state else None
    y, fin = sk.ssd_scan(x, dt, A, Bm, Cm, Q, s0)
    want_y, want_fin = ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q, s0)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 2e-2
    err = float((y.float() - want_y.float()).abs().max())
    err_s = float((fin - want_fin).abs().max())
    if not (torch.allclose(y.float(), want_y.float(), rtol=tol, atol=tol)
            and torch.allclose(fin, want_fin, rtol=2e-4, atol=2e-4)):
        raise AssertionError(f"ssd_scan {dtype} {(B, L, H, P, N, Q, G)}: disagrees with its "
                             f"plain version (max |err| y {err}, state {err_s})")
    del want_y, want_fin
    ms = _time_ms(lambda: sk.ssd_scan(x, dt, A, Bm, Cm, Q, s0), iters=10, warmup=2)
    plain_ms = _time_ms(lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q, s0), iters=plain_iters,
                        warmup=1)
    flops, nbytes = sk.scan_work(x, dt, A, Bm, Q, s0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (3 * flops / PEAK_FLOPS["tf32"] if dtype == "float32"
              else flops / PEAK_FLOPS[dtype]) * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    label = (f"B={B} L={L} H={H} P={P} N={N} Q={Q} G={G} {dtype}"
             + (" from an initial state" if initial_state else ""))
    extra = {}
    fma = ""
    if dtype == "float32":
        extra["bound_f32_fma_ms"] = max(bytes_ms, flops / PEAK_FLOPS["float32"] * 1e3)
        fma = (f"; f32 FMA bound {extra['bound_f32_fma_ms']:.4f} ms, "
               f"{100 * extra['bound_f32_fma_ms'] / ms:.2f}% of it")
    print(
        f"[kernels] ssd_scan: {label}: y within {tol} (max |err| {err:.3g}), state within "
        f"2e-4 ({err_s:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}{' (3xTF32)' if dtype == 'float32' else ''} "
        f"({flops} flop, {nbytes} B), {100 * bound_ms / ms:.2f}% of bound{fma}"
    )
    _profile_call(f"ssd_scan {label}", lambda: sk.ssd_scan(x, dt, A, Bm, Cm, Q, s0),
                  kernel=("ssd_", "ssd_scan"), top=3)  # its three kernels apart
    return dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:135", match=True, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None, **extra,
    )


def _topk_expert_ids(S: int, tokens: int, E: int, k: int, gen):
    """Expert ids ``[S, tokens * k]`` as the router gives them: each token's
    k distinct experts in descending-score order, tokens in arrival order,
    int64 (``torch.topk``'s index dtype, which the kernel reads)."""
    import torch

    scores = torch.rand((S, tokens, E), generator=gen, device="cuda")
    return torch.topk(scores, k, dim=-1).indices.reshape(S, tokens * k).contiguous()


def _wall_and_device_ms(fn, kernel: str, calls: int = 1000) -> tuple[float, float]:
    """One call's wall (host clock over ``calls`` back-to-back calls, then a
    synchronise) and its device time (``torch.profiler`` over 50 calls, the
    device kernels whose name holds ``kernel``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA" and kernel in e.key)
    return wall_ms, us / 50 / 1e3


def phase_kernels(sf: float, seed: int, smi: str) -> list[dict]:
    """Every ported kernel at the shapes its main path gives it, against its
    plain version.  Returns the rows of the JSON line: one per kernel, the
    MoE dispatch at its decode and prefill shapes, attention in f32 and
    bf16."""
    import numpy as np
    import torch

    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    from repro_torch.relational.datagen import table_capacity

    S = N_SHARDS
    T = math.ceil(table_capacity("lineitem", sf) / S / 256) * 256
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    keys = torch.from_numpy(rng.integers(0, 2**31 - 1, (S, T), dtype=np.int32)).to(dev)
    valid = torch.from_numpy((rng.random((S, T)) >= 0.1).astype(np.int32)).to(dev)
    # the pod hop: bins 0..2 (2 pods + overflow), 3 is the padding id
    dest = torch.from_numpy(rng.integers(0, 4, (S, T), dtype=np.int32)).to(dev)
    hp_src = "src/repro_torch/kernels/csrc/hash_partition.cu"
    packs = [
        ("hash_partition_pack", "src/repro/kernels/hash_partition.py:161",
         f"S={S} T={T} P=8", S * T * 16 + S * (T // 256) * 9 * 4,
         lambda: hp.hash_partition_pack(keys, valid, 8),
         lambda: ref.hash_partition_pack_ref(keys, valid, 8)),
        ("partition_pack", "src/repro/kernels/hash_partition.py:111",
         f"S={S} T={T} bins=3", S * T * 8 + S * (T // 256) * 3 * 4,
         lambda: hp.partition_pack(dest, 3),
         lambda: ref.partition_pack_ref(dest, 3)),
        ("hash_partition", "src/repro/kernels/hash_partition.py:81",
         f"S={S} T={T} P=8", S * T * 8 + S * (T // 256) * 8 * 4,
         lambda: hp.hash_partition(keys, 8),
         lambda: ref.hash_partition_ref(keys, 8)),
    ]
    rows = []
    for name, replaces, label, nbytes, kern, plain in packs:
        row = _kernel_row(name, replaces, hp_src, label, nbytes, kern, plain)
        # the host's part and the device's part of a call, apart
        row["wall_ms"], row["device_ms"] = _wall_and_device_ms(kern, "_kernel<")
        print(f"[kernels] {name}: one call {row['wall_ms']:.4f} ms of wall (1000 calls, "
              f"host clock), {row['device_ms']:.4f} ms of device time (profiler), "
              f"{100 * row['bound_ms'] / row['device_ms']:.2f}% of bound by device time")
        rows.append(row)
    # OLMoE-1B-7B: 64 experts, top-8, on 8 units.  Decode: 64 slots -> 8
    # tokens a unit, C = 4.  Prefill: 64 x 256 prompt tokens -> 2048 a unit,
    # C = 320.  Both with capacity factor 1.25, so some rows drop.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, k = 64, 8

    def moe_row(phase, units, tokens, C, k=k):
        ids = _topk_expert_ids(units, tokens, E, k, gen)
        T_m = tokens * k
        dropped = int((md.moe_dispatch(ids, E, C)[0] == E * C).sum())
        row = _kernel_row(
            "moe_dispatch", "src/repro/kernels/moe_dispatch.py:68",
            "src/repro_torch/kernels/csrc/moe_dispatch.cu",
            f"{phase} S={units} T={T_m} E={E} C={C} int64 ids", units * T_m * 12 + units * E * 4,
            lambda: md.moe_dispatch(ids, E, C), lambda: ref.moe_dispatch_ref(ids, E, C),
            note=f", {dropped} of {units * T_m} rows to the drop bin",
        )
        row["wall_ms"], row["device_ms"] = _wall_and_device_ms(
            lambda: md.moe_dispatch(ids, E, C), "dispatch_kernel")
        print(f"[kernels] moe_dispatch: {phase} one call "
              f"{row['wall_ms']:.4f} ms of wall (1000 calls, host clock), "
              f"{row['device_ms']:.4f} ms of device time (profiler)")
        return row

    moe_rows = [moe_row(phase, S, tokens, C) for phase, tokens, C in (("decode", 8, 4),
                                                                      ("prefill", 2048, 320))]
    # under the tensor table: a process packs its own units' ids
    tensor_moe = [moe_row(f"tensor {phase}", *shape) for phase, *shape in TP_MOE]
    for row in tensor_moe:
        row["launch_key"] = "moe_dispatch[tensor]"
    # phase 9e's DeepSeek-V2-Lite: 64 experts, top-6, a process's 4 units
    tensor_mla = [moe_row(f"tensor-mla {phase}", *shape, k=6) for phase, *shape in TPE_MOE]
    for row in tensor_mla:
        row["launch_key"] = "moe_dispatch[tensor-mla]"
    # train100m's attention: the training shape in f32 (the row) and bf16,
    # and the reference test's non-causal Sq != Sk case
    B, S_t = TRAIN_SHAPE[:2]
    flash = [_flash_row(B, 12, 4, S_t, S_t, 64, True, "float32", seed, smi),
             _flash_row(B, 12, 4, S_t, S_t, 64, True, "bfloat16", seed, smi),
             _flash_row(2, 4, 1, 128, 256, 64, False, "float32", seed, smi)]
    # Whisper-medium's encoder self-attention at its training shape, and at
    # serving (1,500 frames: a partial last tile, the main path's ragged
    # launches); a ragged f32 causal case with GQA 4:1 and a padded head dim
    wb, ws = WHISPER_TRAIN[:2]
    encoder = _flash_row(wb, 16, 16, ws, ws, 64, False, "bfloat16", seed, smi)
    encoder["launch_key"] = "flash_attention[noncausal]"
    frames, wbatch = WHISPER_SERVE[1], WHISPER_SERVE[3]
    serving = _flash_row(wbatch, 16, 16, frames, frames, 64, False, "bfloat16", seed, smi)
    serving["launch_key"] = "flash_attention[ragged]"
    _flash_row(1, 4, 1, frames, frames, 64, True, "float32", seed, smi)
    _flash_row(2, 8, 2, 192, 192, 48, True, "float32", seed, smi)
    # tensor-parallel serving at D = 128: phase 9b's prefill on a process's
    # heads (f32, the row), and the four-card probe's bf16 shapes
    tp_b, tp_s = (int(v) for v in TP_CELL.split(":")[2].split("x")[:2])
    tensor = _flash_row(tp_b, 64 // TP_PROCS, 8 // TP_PROCS, tp_s, tp_s, 128, True, "float32",
                        seed, smi)
    tensor["launch_key"] = "flash_attention[tensor]"
    # phase 9c's OLMoE prefill on a process's 8 q and 8 kv heads (f32)
    tpm_b, tpm_s = (int(v) for v in TPM_CELL.split(":")[2].split("x")[:2])
    tensor_olmoe = _flash_row(tpm_b, 16 // TPM_PROCS, 16 // TPM_PROCS, tpm_s, tpm_s, 128, True,
                              "float32", seed, smi)
    tensor_olmoe["launch_key"] = "flash_attention[tensor-moe]"
    for b, h, kh, s_, d in TP_PROBE_FLASH:
        _flash_row(b, h, kh, s_, s_, d, True, "bfloat16", seed, smi)
    # phase 9d's Zamba2 prefill on a process's heads at D = 112 (f32; the
    # wrapper pads to 128), and the four-card probe's bf16 rank shape
    b, h, kh, s_, d = TPS_FLASH
    tensor_ssm = _flash_row(b, h, kh, s_, s_, d, True, "float32", seed, smi)
    tensor_ssm["launch_key"] = "flash_attention[tensor-ssm]"
    b, h, kh, s_, d = TP_PROBE_SSM_FLASH
    _flash_row(b, h, kh, s_, s_, d, True, "bfloat16", seed, smi)
    # phase 9e's Whisper encoder on a process's 8 heads: 1,500 frames (a
    # partial last tile), non-causal, f32
    b, h, kh, s_, d = TPE_FLASH
    tensor_encdec = _flash_row(b, h, kh, s_, s_, d, False, "float32", seed, smi)
    tensor_encdec["launch_key"] = "flash_attention[tensor-encdec]"
    _flash_long_row(*TP_PROBE_LONG_FLASH, seed, smi)
    # phase 9f's Qwen2.5-3B training on a grid process's heads (its data
    # column's rows, its model row's 8 q heads and 1 kv head), f32
    b, h, kh, s_, d = TT_FLASH
    tensor_train = _flash_row(b, h, kh, s_, s_, d, True, "float32", seed, smi)
    tensor_train["launch_key"] = "flash_attention[tensor-train]"
    # the SSM prefills: Mamba2-1.3B at batch 8 (bf16 is the row), its
    # prefill_32k prompt at batch 1 (64 blocks, the state carried over 128
    # chunks) and its long_500k prompt (x of 2**31 elements, 2,048 chunks);
    # Zamba2-7B
    L_long = SSM_LONG[0]
    ssd = [_ssd_row(8, 2048, 64, 64, 128, 256, 1, "bfloat16", seed),
           _ssd_row(8, 2048, 64, 64, 128, 256, 1, "float32", seed),
           _ssd_row(1, L_long, 64, 64, 128, 256, 1, "bfloat16", seed),
           _ssd_row(1, L_long, 64, 64, 128, 256, 1, "float32", seed),
           _ssd_row(1, SSM_500K[0], 64, 64, 128, 256, 1, "bfloat16", seed, plain_iters=1),
           _ssd_row(4, 2048, 112, 64, 64, 256, 1, "bfloat16", seed),
           _ssd_row(2, 1024, 64, 64, 128, 256, 1, "float32", seed, initial_state=True),
           _ssd_row(2, 1024, 64, 64, 128, 256, 2, "float32", seed)]
    # under the tensor table: phase 9d's f32 prefills on a process's heads
    # (Mamba2-1.3B's is the row), the four-card probe's bf16 rank shapes
    tensor_ssd = [_ssd_row(*shape, 256, 1, "float32", seed) for shape in TPS_SSD]
    tensor_ssd[0]["launch_key"] = "ssd_scan[tensor]"
    for shape in TP_PROBE_SSD:
        _ssd_row(*shape, 256, 1, "bfloat16", seed)
    # the bf16 causal launches: train100m's bf16 run and Whisper's decoder
    flash[1]["launch_key"] = "flash_attention[bfloat16]"
    return (rows + moe_rows + tensor_moe + tensor_mla
            + [flash[0], flash[1], encoder, serving, tensor, tensor_olmoe, tensor_ssm,
               tensor_encdec, tensor_train, ssd[0], tensor_ssd[0]])


def _close(got, want, rtol) -> bool:
    import numpy as np

    return bool(np.allclose(np.asarray(got, np.float64), want, rtol=rtol, atol=0.0))


def check_answer(q: str, got, want) -> None:
    """The reference tests' tolerances (tests/test_planner.py)."""
    if q == "q1":
        ok = all(_close(got[k], want[k], 1e-4) for k in want)
    elif q == "q6":
        ok = _close(float(got), want, 1e-4)
    elif q == "q17":
        ok = _close(float(got), want, 1e-3)
    elif q == "q3":
        ok = [int(k) for k in got["o_orderkey"]] == [int(k) for k in want["o_orderkey"]] \
            and _close(got["revenue"], want["revenue"], 1e-5)
    elif q == "q18":
        def as_map(r):
            return {int(k): (int(tp), float(sq)) for k, tp, sq in
                    zip(r["o_orderkey"], r["o_totalprice"], r["sum_qty"])}
        ok = len(want["o_orderkey"]) > 0 and as_map(got) == as_map(want)
    elif q == "q14":
        ok = _close(float(got), want, 1e-3)
    elif q == "q19":
        ok = _close(float(got), want, 1e-4)
    elif q == "q4":
        ok = int(want.sum()) > 0 and [int(x) for x in got["order_count"]] == \
            [int(x) for x in want]
    elif q == "q12":
        ok = all([int(x) for x in got[k]] == [int(x) for x in want[k]] for k in want)
    else:
        raise ValueError(q)
    if not ok:
        raise AssertionError(f"{q}: result disagrees with the numpy oracle:\n{got}\n{want}")


def _profile(run: str, runner, wall_s: float) -> None:
    """A third run under ``torch.profiler``: device time by kernel name and
    the device's busy share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {run}: wall {wall * 1e3:.2f} ms under the profiler "
          f"({wall_s * 1e3:.2f} ms without); device busy {busy_us / 1e3:.2f} ms "
          f"= {100 * busy_us / 1e6 / wall:.1f}% of wall")
    for e in rows[:10]:
        print(f"[profile] {run}:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:100]}")


def phase_queries(sf: float, seed: int, runs: list[str], profile: bool = False) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import hash_partition as hp
    from repro_torch.relational import datagen, oracle
    from repro_torch.relational.context import ExecutionContext
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.executor import compile_plan

    t0 = time.perf_counter()
    tabs = datagen.gen_all(sf, seed, device="cuda")
    torch.cuda.synchronize()
    print(f"[queries] TPC-H SF {sf} seed {seed}: lineitem {tabs['lineitem'].capacity} rows, "
          f"generated in {time.perf_counter() - t0:.2f} s")
    li, pt, od, cu = tabs["lineitem"], tabs["part"], tabs["orders"], tabs["customer"]
    oracles = {
        "q1": lambda: oracle.q1_oracle(li),
        "q6": lambda: oracle.q6_oracle(li),
        "q17": lambda: oracle.q17_oracle(li, pt),
        "q3": lambda: oracle.q3_oracle(cu, od, li),
        "q18": lambda: oracle.q18_oracle(li, od, cu),
    }
    specs = {
        "q1": ("q1", dict()),
        "q6": ("q6", dict()),
        "q17": ("q17", dict()),
        "q3": ("q3", dict()),
        "q3_pods": ("q3", dict(num_pods=2)),
        "q18_pods": ("q18", dict(num_pods=2)),
        "q3_rr": ("q3", dict(impl="round_robin", num_chunks=2)),
    }
    wants: dict = {}
    results: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the main path starts here
    for run in runs:
        q, knobs = specs[run]
        ctx = ExecutionContext(num_shards=N_SHARDS, device="cuda", **knobs)
        pq = tpch.ALL_QUERIES[q]()
        plan = tpch.plan_query(pq, tabs, ctx)
        before = dict(hp.LAUNCHES)
        runner = compile_plan(plan, tabs, ctx)
        out = runner.dispatch()
        dropped = int(out[1])
        got = runner.finalize(out)
        got = pq.finalize(got) if pq.finalize else got
        delta = {k: hp.LAUNCHES[k] - before[k] for k in ("hash_partition_pack", "partition_pack")}
        mux = runner.mux
        edges = len(plan.shuffle_stats)
        # every shuffle packs through the kernels: one hash_partition_pack
        # launch per pipeline chunk of each shuffle edge (a chunk count that
        # does not divide the edge's rows runs it unchunked), one
        # partition_pack per edge for the pod hop
        C = mux.pipeline_chunks
        want_hpp = sum(C if (st.rows * ctx.num_pods) % C == 0 else 1 for st in plan.shuffle_stats)
        want_pp = edges if ctx.num_pods > 1 else 0
        if edges and mux.pack_impl != "cuda":
            raise AssertionError(f"{run}: {edges} shuffle edges on the plain pack ({mux.describe()})")
        if dropped != 0:
            raise AssertionError(f"{run}: {dropped} rows dropped")
        if delta != {"hash_partition_pack": want_hpp, "partition_pack": want_pp}:
            raise AssertionError(
                f"{run}: kernel launches {delta}, expected hash_partition_pack="
                f"{want_hpp} partition_pack={want_pp} ({edges} shuffle edges, {mux.describe()})"
            )
        if q not in wants:
            wants[q] = oracles[q]()
        check_answer(q, got, wants[q])
        # second run: the timed one (its launches count toward the main path too)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if profile:
            _profile(run, runner, wall)
        results[run] = got
        print(
            f"[queries] {run}: ok vs oracle, dropped=0, shuffles={edges}, "
            f"knobs={mux.describe()}, launches={delta}, wall(2nd run)={wall * 1e3:.2f} ms"
        )
    if "q3" in results and "q3_rr" in results:
        a, b = results["q3"], results["q3_rr"]
        if list(map(int, a["o_orderkey"])) != list(map(int, b["o_orderkey"])) or not np.allclose(
            a["revenue"], b["revenue"], rtol=1e-6, atol=0.0
        ):
            raise AssertionError("q3 round_robin x2 chunks disagrees with the tuned run")
        print("[queries] q3_rr: same order keys as the tuned q3, revenues within rtol 1e-6 "
              "(scatter_add_ on the card sums floats in no fixed order)")
    launches = _counts()
    print(f"[queries] launches over the main path: {launches}")
    print(f"[queries] torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    return launches, tabs, wants


# the hand-written queries' tolerances against the oracle (tests/test_relational.py)
HANDWRITTEN_RTOL = {"q1": 1e-4, "q6": 1e-4, "q17": 1e-3, "q3": 1e-5, "q14": 1e-4, "q19": 1e-4}


def phase_handwritten(tabs: dict, wants: dict, smi: str) -> None:
    """The hand-written queries (``relational/queries.py``) on phase 4's
    tables as one-shard tables on the card: ``q17_part_filter`` against the
    oracle's part mask, then Q1, Q6, Q17, Q3, Q14 and Q19 against the
    oracle at ``HANDWRITTEN_RTOL`` (Q1's counts and Q3's ten order keys
    exactly), each query's wall (second run) beside the planned query's on
    one shard (the compiled plan's second run).  The hand-written queries
    launch no kernel (one shard has no exchange), and the script checks it."""
    import numpy as np
    import torch

    from repro_torch.relational import oracle
    from repro_torch.relational import queries as Q
    from repro_torch.relational.context import ExecutionContext
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.executor import compile_plan
    from repro_torch.relational.table import shard_rows

    t_phase = time.perf_counter()
    one = {n: shard_rows(t, 1, interleave=False) for n, t in tabs.items()}
    li, pt, od, cu = (one[n] for n in ("lineitem", "part", "orders", "customer"))
    fl, fp, fo, fc = (tabs[n] for n in ("lineitem", "part", "orders", "customer"))
    oracles = {"q1": lambda: oracle.q1_oracle(fl), "q6": lambda: oracle.q6_oracle(fl),
               "q17": lambda: oracle.q17_oracle(fl, fp), "q3": lambda: oracle.q3_oracle(fc, fo, fl),
               "q14": lambda: oracle.q14_oracle(fl, fp), "q19": lambda: oracle.q19_oracle(fl, fp)}
    for q, fn in oracles.items():
        if q not in wants:
            wants[q] = fn()

    p = {k: v.cpu().numpy() for k, v in tabs["part"].columns.items()}
    want_mask = tabs["part"].valid.cpu().numpy() & (p["p_brand"] == 12) & (p["p_container"] == 2)
    got_mask = Q.q17_part_filter(pt, 12, 2).valid[0].cpu().numpy()
    if not (want_mask.any() and np.array_equal(got_mask, want_mask)):
        raise AssertionError("q17_part_filter: its mask differs from the oracle's part rows")
    print(f"[handwritten] q17_part_filter: {int(got_mask.sum())} part rows, the oracle's")

    runs = {
        "q1": lambda: Q.q1_finalize({k: v.sum(0).cpu().numpy() for k, v in Q.q1_local(li).items()}),
        "q6": lambda: float(Q.q6_local(li).sum(0)),
        "q17": lambda: float(Q.q17_local(li, pt).sum(0)),
        "q3": lambda: {k: v[0].cpu().numpy() for k, v in Q.q3_local(cu, od, li).items()},
        "q14": lambda: float(Q.q14_finalize(*(x.sum(0).cpu().numpy() for x in Q.q14_local(li, pt)))),
        "q19": lambda: float(Q.q19_local(li, pt).sum(0)),
    }
    for q, run in runs.items():
        before = _counts()
        got = run()
        want, rtol = wants[q], HANDWRITTEN_RTOL[q]
        if q == "q1":
            ok = np.array_equal(np.asarray(got["count_order"], np.int64),
                                np.asarray(want["count_order"]).astype(np.int64)) and \
                all(_close(got[k], want[k], rtol) for k in want)
        elif q == "q3":
            got_map = dict(zip(got["o_orderkey"].tolist(), got["revenue"].tolist()))
            want_map = dict(zip(want["o_orderkey"].tolist(), want["revenue"].tolist()))
            ok = len(got_map) == 10 and set(got_map) == set(want_map) and \
                all(_close(got_map[k], v, rtol) for k, v in want_map.items())
        else:
            ok = want != 0.0 and _close(got, want, rtol)
        if not ok:
            raise AssertionError(f"hand-written {q}: disagrees with the oracle at rtol {rtol}:\n"
                                 f"{got}\n{want}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if _counts() != before:
            raise AssertionError(f"hand-written {q} launched kernels: {before} -> {_counts()}")
        ctx = ExecutionContext(num_shards=1, device="cuda")
        pq = tpch.ALL_QUERIES[q]()
        runner = compile_plan(tpch.plan_query(pq, tabs, ctx), tabs, ctx)
        runner()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner()
        torch.cuda.synchronize()
        planned = time.perf_counter() - t0
        print(f"[handwritten] {q}: ok vs oracle at rtol {rtol}; wall (2nd run) {wall * 1e3:.2f} ms, "
              f"the planned query on one shard {planned * 1e3:.2f} ms ({smi})")
    del one, li, pt, od, cu
    torch.cuda.empty_cache()
    print(f"[handwritten] phase in {time.perf_counter() - t_phase:.1f} s")


def _stream_pack_launches(run, steps: int) -> tuple[int, int]:
    """The (``hash_partition_pack``, ``partition_pack``) launches that a
    streamed run's plan and counters imply, with one pipeline chunk a
    shuffle: the runner's ``shuffles_per_step`` names the shuffles of each
    pass's morsel step (``steps`` a pass), resident step and drain round
    (phase 4b's plans drain in one pass at most); each packs once through
    ``hash_partition_pack`` and, on a pod mesh, once more through
    ``partition_pack`` for the coarse hop.  The plain pack launches
    neither."""
    if run.mux.pack_impl != "cuda":
        return 0, 0
    if run.mux.pipeline_chunks != 1:
        raise AssertionError(f"streamed run with {run.mux.describe()}: expected one chunk")
    sched = run.shuffles_per_step
    packs = sum(steps * s["streamed"] + s["resident"] for s in sched)
    drains = run.stats["drain_rounds"] * max(s["drain"] for s in sched)
    return packs + drains, packs if run.plan.num_pods > 1 else 0


def _pack_check(T: int, seed: int, what: str) -> None:
    """The two pack kernels at a shape the streamed path gives them (``T``
    rows a shard, padded to the 256-row block as the ranks wrapper pads
    them), bit for bit against their plain versions; not counted on the
    main path."""
    import numpy as np
    import torch

    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import ref

    rng = np.random.default_rng(seed)
    Tp = math.ceil(T / 256) * 256
    keys = torch.from_numpy(rng.integers(0, 2**31 - 1, (N_SHARDS, Tp), dtype=np.int32)).cuda()
    valid = torch.from_numpy((rng.random((N_SHARDS, Tp)) >= 0.1).astype(np.int32)).cuda()
    dest = torch.from_numpy(rng.integers(0, 4, (N_SHARDS, Tp), dtype=np.int32)).cuda()
    for name, got, want in (
        ("hash_partition_pack", hp.hash_partition_pack(keys, valid, 8),
         ref.hash_partition_pack_ref(keys, valid, 8)),
        ("partition_pack", hp.partition_pack(dest, 3), ref.partition_pack_ref(dest, 3)),
    ):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} at S={N_SHARDS} T={Tp}: kernel disagrees with plain")
        print(f"[oocore] {name}: S={N_SHARDS} T={Tp} ({what}) bit-exact against its "
              "plain version")


def phase_oocore(tabs: dict, wants: dict, seed: int) -> dict:
    """Out-of-core TPC-H: chunked lineitem streamed through the card morsel
    by morsel (pinned host memory, a side stream), spill and drain, and Q18
    at TPC-H SF ``OOC_SF``.  Returns every kernel's launches over the
    streamed runs (the main path: counts set to 0 just before each run and
    read just after)."""
    import numpy as np
    import torch

    from repro_torch.relational import datagen, oracle
    from repro_torch.relational.context import ExecutionContext
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.executor import compile_plan
    from repro_torch.relational.planner.stream import compile_plan_streamed
    from repro_torch.relational.source import MorselView, as_source

    main_path = dict.fromkeys(_counts(), 0)
    host = {name: t.to("cpu") for name, t in tabs.items()}  # chunks stay on the host
    li = host["lineitem"]
    budget = math.ceil(li.capacity / N_SHARDS) // 2  # half lineitem's per-shard slice
    oracles = {"q1": lambda: oracle.q1_oracle(li),
               "q17": lambda: oracle.q17_oracle(li, host["part"]),
               "q18": lambda: oracle.q18_oracle(li, host["orders"], host["customer"])}
    for q in oracles:
        if q not in wants:
            wants[q] = oracles[q]()
    _pack_check(math.ceil(OOC_MORSEL / N_SHARDS), seed, "an SF 1 morsel's shard slice")

    def streamed(q, pods=1, tag=None, **knobs):
        """One streamed run on the main path; returns (answer, runner,
        launches, wall s)."""
        pq = tpch.ALL_QUERIES[q]()
        sources = {t: as_source(host[t]) for t in pq.tables}
        sources["lineitem"] = MorselView(li, OOC_MORSEL)
        catalog = {t: sources[t].capacity for t in pq.tables}
        plan = pq.plan(catalog, N_SHARDS, num_pods=pods, morsel_rows=OOC_MORSEL)
        ctx = ExecutionContext(num_shards=N_SHARDS, num_pods=pods, device="cuda",
                               device_row_budget=budget, num_chunks=1, **knobs)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        run = compile_plan_streamed(plan, sources, ctx)
        got = pq.finalize(run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        for k, v in launches.items():
            main_path[k] += v
        want_hpp, want_pp = _stream_pack_launches(run, sources["lineitem"].num_chunks)
        got_hpp, got_pp = launches["hash_partition_pack"], launches["partition_pack"]
        if (got_hpp, got_pp) != (want_hpp, want_pp):
            raise AssertionError(
                f"{tag or q}: hash_partition_pack {got_hpp}, partition_pack {got_pp}; the "
                f"plan and stats imply {want_hpp}, {want_pp} ({run.stats}, {run.mux.describe()})")
        st = run.stats
        print(f"[oocore] {tag or q}: SF 1 on {N_SHARDS if pods == 1 else f'{pods} x {N_SHARDS // pods}'}"
              f", morsels of {OOC_MORSEL} rows ({sources['lineitem'].num_chunks} a pass), budget "
              f"{budget} rows/device: {st['passes']} passes, {st['morsels']} morsel steps, "
              f"spilled {st['spilled_rows']} rows over {st['drain_rounds']} drain rounds, "
              f"overlap {st['prefetch_overlap_fraction']:.4f}; hash_partition_pack {got_hpp} "
              f"(the plan and stats imply {want_hpp}), partition_pack {got_pp}; knobs "
              f"{run.mux.describe()}; wall {wall * 1e3:.2f} ms")
        return got, run, launches, wall, plan, sources, ctx

    # 1. SF 1 on 8 shards, lineitem streamed; the in-memory path refused
    answers = {}
    for q in ("q1", "q17", "q18"):
        got, run, _l, _w, plan, sources, ctx = streamed(q)
        in_memory = {t: host[t] for t in plan.scans}
        try:
            compile_plan(plan, in_memory, ctx)
        except ValueError as e:
            if "device_row_budget" not in str(e):
                raise
        else:
            raise AssertionError(f"{q}: in-memory compile_plan ran over device_row_budget")
        check_answer(q, got, wants[q])
        steps = 2 * sources["lineitem"].num_chunks  # SF 1: 2 passes x 6 morsels
        if q == "q17" and (run.stats["passes"], run.stats["morsels"]) != (2, steps):
            raise AssertionError(f"q17: {run.stats}, expected 2 passes and {steps} morsel steps")
        answers[q] = got
    print("[oocore] q1, q17, q18 streamed: ok vs oracle; in-memory compile_plan refused "
          f"under device_row_budget={budget}")

    # 2. Q17 streamed on 2 x 4: every step launches partition_pack
    got, run, launches, _w, plan, sources, ctx = streamed("q17", pods=2, tag="q17_pods")
    check_answer("q17", got, wants["q17"])
    if launches["partition_pack"] < run.stats["morsels"]:
        raise AssertionError(f"q17_pods: partition_pack {launches['partition_pack']} "
                             f"< {run.stats['morsels']} steps")
    try:
        compile_plan_streamed(plan, sources, ctx.with_(spill=True))
    except NotImplementedError:
        print("[oocore] q17_pods: ok vs oracle; spill on the pod mesh refused")
    else:
        raise AssertionError("q17_pods: spill on a pod mesh did not raise")

    # 3. spill at SF 1: Q18 with 8,192-row messages
    try:
        streamed("q18", tag="q18_no_spill", exchange_rows=OOC_SPILL_ROWS)
    except RuntimeError as e:
        if "dropped" not in str(e):
            raise
        print(f"[oocore] q18 with exchange_rows={OOC_SPILL_ROWS}, no spill: raised ({e})")
    else:
        raise AssertionError("q18: exchange overflow without spill did not raise")
    spill = {}
    for pack in ("cuda", "torch"):
        got, run, _l, wall, *_ = streamed("q18", tag=f"q18_spill[{pack}]", pack_impl=pack,
                                          exchange_rows=OOC_SPILL_ROWS, spill=True)
        st = run.stats
        if st["spilled_rows"] <= 0 or st["drain_rounds"] < 3:
            raise AssertionError(f"q18_spill[{pack}]: {st}: expected spill over >= 3 rounds")
        for k in answers["q18"]:
            if not np.array_equal(np.asarray(got[k]), np.asarray(answers["q18"][k])):
                raise AssertionError(f"q18_spill[{pack}]: {k} differs from the unpressured run")
        spill[pack] = (st["spilled_rows"], st["drain_rounds"])
        print(f"[oocore] q18_spill[{pack}]: {st['spilled_rows']} rows spilled, "
              f"{st['drain_rounds']} drain rounds, answer bit-identical to the unpressured "
              f"run; wall {wall * 1e3:.2f} ms")
    if spill["cuda"] != spill["torch"]:
        raise AssertionError(f"q18_spill: the packs disagree on (rows, rounds): {spill}")

    # 4. Q18 at TPC-H SF OOC_SF: lineitem never on the card whole
    del tabs, host, li
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    orders = datagen.gen_orders(OOC_SF, seed + 3, device="cpu")
    customer = datagen.gen_customer(OOC_SF, seed + 2, device="cpu")
    src = datagen.gen_lineitem_chunked(OOC_SF, num_chunks=OOC_CHUNKS, seed=seed + 4)
    li_bytes = src.capacity * len(datagen.lineitem_columns(0.0001)) * 4
    print(f"[oocore] SF {OOC_SF}: lineitem {src.capacity} rows in {src.num_chunks} chunks of "
          f"{src.chunk_rows} ({li_bytes} B of int32 columns), orders {orders.capacity}, customer "
          f"{customer.capacity} rows; orders and customer generated in "
          f"{time.perf_counter() - t0:.2f} s")
    pq = tpch.q18()
    sources = {"lineitem": src, "orders": orders, "customer": customer}
    plan = pq.plan({t: sources[t].capacity for t in pq.tables}, N_SHARDS,
                   morsel_rows=src.chunk_rows)
    ctx = ExecutionContext(num_shards=N_SHARDS, device="cuda", device_row_budget=OOC_BUDGET,
                           group_state_rows=OOC_BUDGET, num_chunks=1)
    # the packs at this run's shapes: a morsel's shard slice, and the
    # resident orders' slice that pass 2 shuffles
    _pack_check(math.ceil(src.chunk_rows / N_SHARDS), seed, f"an SF {OOC_SF} morsel's shard slice")
    _pack_check(math.ceil(orders.capacity / N_SHARDS), seed, f"SF {OOC_SF} orders' shard slice")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    run = compile_plan_streamed(plan, sources, ctx)
    got = pq.finalize(run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    for k, v in launches.items():
        main_path[k] += v
    peak = torch.cuda.max_memory_allocated()
    stream_peak = run.pass_peak_bytes[0]
    st = run.stats
    want_hpp, _ = _stream_pack_launches(run, src.num_chunks)
    if launches["hash_partition_pack"] != want_hpp:
        raise AssertionError(f"q18 SF {OOC_SF}: hash_partition_pack "
                             f"{launches['hash_partition_pack']}, expected {want_hpp}")
    if not 0.0 <= st["prefetch_overlap_fraction"] <= 1.0:
        raise AssertionError(f"q18 SF {OOC_SF}: overlap {st['prefetch_overlap_fraction']}")
    if peak >= li_bytes:
        raise AssertionError(f"q18 SF {OOC_SF}: {peak} B allocated over the run, not below "
                             f"lineitem's {li_bytes} B")
    print(f"[oocore] q18 SF {OOC_SF}: wall {wall:.3f} s; {st['morsels']} morsels of "
          f"{src.chunk_rows} rows; prefetch wait {st['prefetch_wait_s']:.3f} of "
          f"{st['prefetch_total_s']:.3f} s, overlap {st['prefetch_overlap_fraction']:.4f}; "
          f"peak allocated {peak} B over the run, {stream_peak} B of it by the end of the "
          f"stream (pass 1; lineitem {li_bytes} B); hash_partition_pack "
          f"{launches['hash_partition_pack']} (the plan and stats imply {want_hpp}); knobs "
          f"{run.mux.describe()}")
    del run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whole = src.materialize()  # the streaming oracle, on the host
    try:
        compile_plan(plan, {"lineitem": whole, "orders": orders, "customer": customer}, ctx)
    except ValueError as e:
        if "device_row_budget" not in str(e):
            raise
    else:
        raise AssertionError(f"q18 SF {OOC_SF}: in-memory compile_plan ran over the budget")
    want = oracle.q18_oracle(whole, orders, customer)
    check_answer("q18", got, want)
    print(f"[oocore] q18 SF {OOC_SF}: ok vs the oracle over src.materialize() "
          f"({len(want['o_orderkey'])} orders; materialized and checked in "
          f"{time.perf_counter() - t0:.2f} s); in-memory compile_plan refused under "
          f"device_row_budget={OOC_BUDGET}")
    del whole
    print(f"[oocore] launches over the main path: {main_path}")
    return main_path


def _same_answer(got, want, rtol: float) -> bool:
    """Integers bit-identical, floats within ``rtol`` (``scatter_add_`` on
    the card sums floats in no fixed order)."""
    import numpy as np

    got = got if isinstance(got, dict) else {"result": got}
    want = want if isinstance(want, dict) else {"result": want}
    if sorted(got) != sorted(want):
        return False
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape:
            return False
        if w.dtype.kind in "iub":
            if not np.array_equal(g, w):
                return False
        elif not np.allclose(g, w, rtol=rtol, atol=0.0):
            return False
    return True


def _qserve_plan(engine, pq):
    """The plan the engine serves ``pq`` with, read from its cache (a lookup
    counts nothing)."""
    from repro_torch.relational.planner.plan_cache import plan_key

    catalog = {t: engine.tables[t].capacity for t in pq.tables}
    stats = {t: engine.stats[t] for t in pq.tables} if engine.stats else None
    return engine.cache.lookup(plan_key(pq.logical, catalog, engine.num_shards,
                                        num_pods=engine.num_pods, chip=engine.chip,
                                        topology=engine.topology, stats=stats))


def _qserve_pack_launches(engine, done) -> tuple[int, int]:
    """(``hash_partition_pack``, ``partition_pack``) launches that the
    served requests' plans and the shared knobs imply: each shuffle edge
    packs once a pipeline chunk (a chunk count that does not divide the
    edge's rows runs it unchunked) and, on a pod mesh, once more for the
    coarse hop."""
    mux = engine._mux
    C, pods = mux.pipeline_chunks, engine.num_pods
    hpp = pp = 0
    for r in done:
        stats = _qserve_plan(engine, r.query).shuffle_stats
        hpp += sum(C if (st.rows * pods) % C == 0 else 1 for st in stats)
        pp += len(stats) if pods > 1 else 0
    return (hpp, pp) if mux.pack_impl == "cuda" else (0, 0)


def _ttfr_line(rec: dict) -> str:
    per = "; ".join(f"{t} p50 {v['ttfr_p50_s'] * 1e3:.2f} p99 {v['ttfr_p99_s'] * 1e3:.2f}"
                    for t, v in rec["tenants"].items())
    return (f"TTFR ms overall p50 {rec['ttfr_p50_s'] * 1e3:.2f} p99 "
            f"{rec['ttfr_p99_s'] * 1e3:.2f}; {per}")


def phase_qserve(tabs: dict, wants: dict, seed: int, smi: str) -> tuple[dict, dict]:
    """Multi-tenant query serving on phase 4's SF 1 tables: the nine
    templates warm through the plan cache, a 64-request mix on 8 shards and
    a 16-request mix on 2 x 4, each against solo runs, then the launcher
    twice on one cache directory.  Returns every kernel's launches over the
    engines' serves (counts set to 0 just before each and read just after)
    and the 8-shard stream's QPS, TTFR and shared knobs."""
    import numpy as np
    import torch

    from repro_torch.obs import model_check
    from repro_torch.obs.model_check import BYTE_MODEL_BOUND, model_report
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational import oracle
    from repro_torch.relational.context import ExecutionContext, StatsMode
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.physical import plan_physical
    from repro_torch.relational.planner.plan_cache import PlanCache
    from repro_torch.serve import QueryRequest, QueryServeEngine, make_query_mix

    main_path = dict.fromkeys(_counts(), 0)
    li, pt, od, cu = tabs["lineitem"], tabs["part"], tabs["orders"], tabs["customer"]
    oracles = {
        "q1": lambda: oracle.q1_oracle(li), "q3": lambda: oracle.q3_oracle(cu, od, li),
        "q4": lambda: oracle.q4_oracle(li, od), "q6": lambda: oracle.q6_oracle(li),
        "q12": lambda: oracle.q12_oracle(li, od), "q14": lambda: oracle.q14_oracle(li, pt),
        "q17": lambda: oracle.q17_oracle(li, pt), "q18": lambda: oracle.q18_oracle(li, od, cu),
        "q19": lambda: oracle.q19_oracle(li, pt),
    }
    for q, fn in oracles.items():
        if q not in wants:
            wants[q] = fn()
    templates = [tpch.ALL_QUERIES[q]() for q in sorted(tpch.ALL_QUERIES)]
    cache_dir = tempfile.TemporaryDirectory(prefix="qserve-")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def engine_for(pods, tracer, names):
        ctx = ExecutionContext(num_shards=N_SHARDS, num_pods=pods, device="cuda",
                               stats_mode=StatsMode.COLLECT, trace=tracer)
        return QueryServeEngine(tabs, ctx, num_slots=QS_SLOTS, cache=PlanCache(cache_dir.name),
                                templates=[tpch.ALL_QUERIES[q]() for q in names])

    def serve(engine, reqs):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        done = engine.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        for k, v in launches.items():
            main_path[k] += v
        engine.alloc.check()
        return done, wall, launches

    # 1. the nine templates, twice: the second pass plans and builds nothing
    engine = engine_for(1, Tracer(), sorted(tpch.ALL_QUERIES))
    cold, _w, _l = serve(engine, [QueryRequest("t", pq) for pq in templates])
    calls, misses = plan_physical.calls, engine.cache.executor_misses
    warm, _w, _l = serve(engine, [QueryRequest("t", pq) for pq in templates])
    if (plan_physical.calls, engine.cache.executor_misses) != (calls, misses):
        raise AssertionError(f"warm pass: {plan_physical.calls - calls} plan_physical calls, "
                             f"{engine.cache.executor_misses - misses} executor misses")
    if not all(r.plan_cache_hit and r.executor_cache_hit for r in warm):
        raise AssertionError("warm pass: a request missed the plan or executor cache")
    first = {r.query.name: r for r in cold}
    for r in warm:
        if not _same_answer(r.result, first[r.query.name].result, 1e-6):
            raise AssertionError(f"{r.query.name}: the warm answer differs from the cold one")
        check_answer(r.query.name, r.result, wants[r.query.name])
    later = {r.query.name: r for r in warm}
    print(f"[qserve] nine templates on {N_SHARDS} shards (StatsMode.COLLECT, {QS_SLOTS} slots), "
          "served twice: ok vs oracle, warm pass 0 plan_physical calls and 0 executor misses, "
          f"integers bit-identical and floats within rtol 1e-6; cache {engine.cache.record()}; "
          f"cold/warm TTFR q3 {first['q3'].ttfr_s * 1e3:.2f}/{later['q3'].ttfr_s * 1e3:.2f} ms, "
          f"q17 {first['q17'].ttfr_s * 1e3:.2f}/{later['q17'].ttfr_s * 1e3:.2f} ms ({smi})")
    del engine, cold, warm, first, later

    def stream(pods, names, n_req, tag):
        """A seeded mix through a fresh engine (the cache's plans are warm,
        its runners are the engine's own), against solo traced runs."""
        tracer = Tracer()
        engine = engine_for(pods, tracer, names)
        mix = [tpch.ALL_QUERIES[q]() for q in names]
        reqs = make_query_mix(mix, QS_TENANTS, n_req, seed=seed, max_arrival_round=4)
        done, wall, launches = serve(engine, reqs)
        rec = engine.record()
        bound = math.ceil(n_req / QS_SLOTS) + len(QS_TENANTS)
        if len(done) != n_req or max(r.queue_rounds for r in done) > bound:
            raise AssertionError(f"{tag}: {len(done)} served, worst queue "
                                 f"{max(r.queue_rounds for r in done)} rounds > {bound}")
        want_hpp, want_pp = _qserve_pack_launches(engine, done)
        got = (launches["hash_partition_pack"], launches["partition_pack"])
        if engine._mux.pack_impl != "cuda" or got != (want_hpp, want_pp) or (pods > 1) != (
                want_pp > 0):
            raise AssertionError(f"{tag}: pack launches {got}, the plans and the shared knobs "
                                 f"imply {(want_hpp, want_pp)} ({engine._mux.describe()})")
        solo = {}
        for pq in mix:
            tr = Tracer()
            ctx = engine.ctx.with_(stats_mode=StatsMode.PROFILE, trace=tr,
                                   stats_profile={t: engine.stats[t] for t in pq.tables})
            solo[pq.name] = (tpch.run_query(pq, tabs, ctx), tr.query_traces[-1])
        for r in done:
            want, qt = solo[r.query.name]
            if not _same_answer(r.result, want, 1e-6):
                raise AssertionError(f"{tag}: {r.query.name} differs from its solo run")
            fields = [(e.key, e.hist, e.measured_bytes, e.modeled_wire_bytes, e.salted)
                      for e in r.trace.edges]
            if fields != [(e.key, e.hist, e.measured_bytes, e.modeled_wire_bytes, e.salted)
                          for e in qt.edges]:
                raise AssertionError(f"{tag}: {r.query.name}'s trace differs from its solo run")
        span_names = [s.name for root in tracer.spans for s in root.walk()]
        spans = [n.split(":")[0] for n in span_names] + [
            n for n in span_names if n == "mux:shared"]
        n_edges = sum(len(r.trace.edges) for r in done)
        counts = {k: spans.count(k)
                  for k in ("request", "admission-round", "mux:shared", "exchange")}
        if counts != {"request": n_req, "admission-round": engine.rounds, "mux:shared": 1,
                      "exchange": n_edges}:
            raise AssertionError(f"{tag}: spans {counts}; expected {n_req} requests, "
                                 f"{engine.rounds} rounds, 1 shared mux, {n_edges} edges")
        print(f"[qserve] {tag}: {n_req} requests of {names} from {len(QS_TENANTS)} tenants over "
              f"{engine.rounds} rounds, {QS_SLOTS} slots: slot invariant held, worst queue "
              f"{max(r.queue_rounds for r in done)} rounds (bound {bound}); every answer and "
              f"trace equal to its solo run; hash_partition_pack {got[0]}, partition_pack "
              f"{got[1]} (the plans and shared knobs {engine._mux.describe()} imply "
              f"{(want_hpp, want_pp)}); spans {counts}")
        print(f"[qserve] {tag}: {n_req / wall:.2f} QPS ({wall:.3f} s); {_ttfr_line(rec)}; cache "
              f"{rec['cache']} ({smi})")
        return engine, done, solo, wall

    # 2. the reference CLI's default mix on 8 shards
    engine, done, solo, wall = stream(1, QS_MIX, QS_REQUESTS, f"stream {N_SHARDS}")
    rec = engine.record()
    v5e = dict(qps=QS_REQUESTS / wall, ttfr_p50_s=rec["ttfr_p50_s"],
               ttfr_p99_s=rec["ttfr_p99_s"], knobs=engine._mux.describe())
    for q, (_want, qt) in solo.items():
        rep = model_report(qt)
        errs = {k: v["byte_model_err"] for k, v in rep["edges"].items()}
        print(f"[qserve] {q} (phase 4's tables): byte errors {errs}; not gated: at SF 1 "
              "the reference's model misses Q3 and Q17 too")
    # the byte model's 2x bound where the reference's CLI holds it: the
    # model check at TPC-H SF 0.1 on 8 shards, its ratios the reference's
    for q in QS_MIX:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            model_check.main(["--query", q, "--sf", "0.1", "--shards", str(N_SHARDS),
                              "--bound", str(BYTE_MODEL_BOUND if q in QS_BYTE_BOUND else 0)],
                             device="cuda")
        rep = json.loads(buf.getvalue())
        errs = {k: v["byte_model_err"] for k, v in rep["edges"].items()}
        if errs != QS_REF_BYTE_ERR.get(q, {}):
            raise AssertionError(f"model check {q} SF 0.1: byte errors {errs}, the "
                                 f"reference's {QS_REF_BYTE_ERR.get(q, {})}")
        print(f"[qserve] model check {q} SF 0.1: byte errors {errs} (the reference's)"
              + (f", within {BYTE_MODEL_BOUND}x" if q in QS_BYTE_BOUND else ", not held"))
    # the same stream, one query at a time through run_query (no cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in sorted(done, key=lambda r: r.arrival_round):
        ctx = engine.ctx.with_(stats_mode=StatsMode.PROFILE, trace=None,
                               stats_profile={t: engine.stats[t] for t in r.query.tables})
        tpch.run_query(r.query, tabs, ctx)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    print(f"[qserve] stream {N_SHARDS}, one query at a time through run_query: "
          f"{len(done) / one:.2f} QPS ({one:.3f} s), against {len(done) / wall:.2f} through the "
          f"engine ({smi})")
    del engine, done, solo

    # 3. a pod mesh: partition_pack on every hop-1 shuffle
    engine, done, solo, wall = stream(2, QS_POD_MIX, QS_POD_REQUESTS, "stream 2 x 4")
    del engine, done, solo
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[qserve] peak torch.cuda.max_memory_allocated over the phase: {peak} B ({smi})")
    torch.cuda.empty_cache()

    # 4. the launcher twice on one cache directory: the second plans nothing
    with tempfile.TemporaryDirectory(prefix="qserve-cli-") as tmp:
        recs = []
        for i in range(2):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.qserve", "--sf", "1",
                 "--num-shards", str(N_SHARDS), "--requests", "16", "--stats",
                 "--trace-dir", f"{tmp}/trace{i}", "--cache-dir", f"{tmp}/cache"],
                capture_output=True, text=True, timeout=600, cwd=ROOT,
                env={**os.environ, "PYTHONPATH": str(SRC)},
            )
            if out.returncode != 0:
                raise AssertionError(f"qserve CLI run {i}: exit {out.returncode}\n{out.stderr}")
            rec = json.loads(out.stdout)
            recs.append(rec)
            print(f"[qserve] CLI run {i} ({time.perf_counter() - t0:.1f} s with start-up): "
                  f"{rec['qps']:.2f} QPS, plan_physical_calls {rec['plan_physical_calls']}, "
                  f"cache {rec['cache']} ({smi})")
        second = recs[1]
        if second["cache"]["plan_disk_hits"] < 5 or second["plan_physical_calls"] != 0:
            raise AssertionError(f"qserve CLI: the second process planned ({second['cache']}, "
                                 f"plan_physical_calls {second['plan_physical_calls']})")
        with open(second["trace_path"]) as f:
            events = json.load(f)["traceEvents"]
        names = {e["name"].split(":")[0] for e in events if e["ph"] == "B"}
        if not {"mux", "admission-round", "request", "exchange"} <= names:
            raise AssertionError(f"qserve CLI: trace span names {sorted(names)}")
        print(f"[qserve] CLI: the second process reads {second['cache']['plan_disk_hits']} plans "
              f"from disk and plans 0 times; its trace loads with spans {sorted(names)}")
    cache_dir.cleanup()
    print(f"[qserve] launches over the main path: {main_path}")
    return main_path, v5e


def _plan_shape(plan) -> dict:
    """What a plan decides: each exchange's placement and key, the tuned
    knobs and the cross-pod strategy."""
    t = plan.tuned
    return dict(exchanges=[(e["kind"], e["key"]) for e in plan.exchange_summary()],
                knobs=(t.impl, t.pack_impl, t.pipeline_chunks, t.transport_chunks),
                cross_pod=t.cross_pod)


def _rows_by_destination(rows_out, valid_out) -> list:
    """Each destination's delivered rows, sorted (a multiset)."""
    import numpy as np

    r, v = rows_out.cpu().numpy(), valid_out.cpu().numpy()
    out = []
    for s in range(r.shape[0]):
        got = r[s][v[s]]
        out.append(got[np.lexsort(got.T[::-1])])
    return out


def _probe_shuffle(mesh, tuned, rows: int, width: int, seed: int) -> None:
    """The refined knobs' shuffle delivers the same multiset of rows to
    every destination as the plain ``impl="xla", pack_impl="torch"``
    shuffle, with 0 drops (seeded keys; each row image carries its key)."""
    import numpy as np
    import torch

    from repro_torch.core.multiplexer import make_multiplexer

    step = tuned.pipeline_chunks * tuned.transport_chunks
    rows = max(step, rows - rows % step)
    gen = torch.Generator("cuda").manual_seed(seed)
    S = mesh.num_units
    keys = torch.randint(0, 1 << 30, (S, rows), dtype=torch.int32, device="cuda", generator=gen)
    data = torch.randint(0, 1 << 20, (S, rows, width), dtype=torch.int32, device="cuda",
                         generator=gen)
    data[..., 0] = keys
    got = {}
    for tag, knobs in (("refined", dict(impl=tuned.impl, pack_impl=tuned.pack_impl,
                                        pipeline_chunks=tuned.pipeline_chunks,
                                        transport_chunks=tuned.transport_chunks)),
                       ("plain", dict(impl="xla", pack_impl="torch"))):
        r, v, dropped = make_multiplexer(mesh, **knobs).hash_shuffle(keys, data, "q", rows)
        if int(dropped.sum()) != 0:
            raise AssertionError(f"probe {tag} {knobs}: {int(dropped.sum())} rows dropped")
        got[tag] = _rows_by_destination(r, v)
    if not all(np.array_equal(a, b) for a, b in zip(got["refined"], got["plain"])):
        raise AssertionError(f"probe: the refined shuffle {tuned} delivers other rows than "
                             "the plain one")
    if sum(len(a) for a in got["plain"]) != S * rows:
        raise AssertionError("probe: rows lost")


def phase_calibration(tabs: dict, wants: dict, seed: int, smi: str, v5e: dict) -> dict:
    """The autotuner's measured side on the card, on phase 4's SF 1 tables:
    calibrate the cost model on the simulated 8-unit fabric, refine the
    multiplexer's knobs by measuring them, serve TPC-H under the calibrated
    prices, and price OLMoE's EP dispatch with them.  Returns every
    kernel's launches over the refinements and the serves (counts set to 0
    just before each and read just after)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import autotune
    from repro_torch.core.autotune import (
        TableStats, calibrate_chip, exchange_makespan, tune_ep_dispatch, tune_multiplexer,
    )
    from repro_torch.core.exchange import make_mesh
    from repro_torch.core.schedule import make_schedule, schedule_ring_loads
    from repro_torch.core.topology import V5E
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.obs.model_check import model_report
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational.context import ExecutionContext, StatsMode
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.physical import plan_physical
    from repro_torch.serve import QueryRequest, QueryServeEngine, make_query_mix

    main_path = dict.fromkeys(_counts(), 0)

    def drive(fn):
        """Run ``fn`` with the counts set to 0 just before; add them to the
        main path's just after.  Returns ``fn``'s result and the counts."""
        torch.cuda.synchronize()
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _counts()
        for k, v in counts.items():
            main_path[k] += v
        return out, counts

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mesh8 = make_mesh(N_SHARDS)
    n = mesh8.size("q")

    # a. the base spec: the card's name, bf16 peak and memory on V5E's fields
    base = dataclasses.replace(V5E, name=torch.cuda.get_device_name(0),
                               peak_flops_bf16=PEAK_FLOPS["bfloat16"],
                               hbm_bytes=torch.cuda.get_device_properties(0).total_memory)

    # b. calibrate, with the raw walls recorded
    walls = []
    best_wall = autotune._best_wall

    def recorded_wall(fn, *args, **kw):
        walls.append(best_wall(fn, *args, **kw))
        return walls[-1]

    autotune._best_wall = recorded_wall
    try:
        t0 = time.perf_counter()
        cal = calibrate_chip(mesh8, "q", chip=base, message_rows=CAL_MESSAGE_ROWS,
                             row_bytes=CAL_ROW_BYTES)
        cal_s = time.perf_counter() - t0
    finally:
        autotune._best_wall = best_wall
    width = max(1, CAL_ROW_BYTES // 4)
    lo, hi = CAL_MESSAGE_ROWS[0], CAL_MESSAGE_ROWS[-1]
    slope = (walls[1] - walls[0]) / ((hi - lo) * width * 4)
    pk_bytes = [r * 12 * (n + 1) + 8 * r + 2 * r * CAL_ROW_BYTES for r in (lo, hi)]
    pk_slope = (walls[3] - walls[2]) / (pk_bytes[1] - pk_bytes[0])
    fitted = {f: getattr(cal, f) for f in ("ici_link_bandwidth", "ici_launch_latency",
                                          "hbm_bandwidth", "kernel_launch_latency")}
    print(f"[calib] calibrate_chip(make_mesh(8), 'q', message_rows={CAL_MESSAGE_ROWS}, "
          f"row_bytes={CAL_ROW_BYTES}) in {cal_s:.2f} s: walls (min of 5 after 2 warm-up) "
          f"all_to_all {walls[0] * 1e3:.4f} / {walls[1] * 1e3:.4f} ms, pack "
          f"{walls[2] * 1e3:.4f} / {walls[3] * 1e3:.4f} ms; slopes {slope:.6e} s/B (link), "
          f"{pk_slope:.6e} s/B (pack); fitted {cal.name}: link {cal.ici_link_bandwidth:.6e} B/s, "
          f"launch {cal.ici_launch_latency * 1e6:.3f} us a phase, HBM "
          f"{cal.hbm_bandwidth:.6e} B/s, pack dispatch {cal.kernel_launch_latency * 1e6:.3f} "
          f"us (V5E: {V5E.ici_link_bandwidth:.3e}, {V5E.ici_launch_latency * 1e6:.1f}, "
          f"{V5E.hbm_bandwidth:.3e}, {V5E.kernel_launch_latency * 1e6:.1f}) ({smi})")
    if not all(math.isfinite(v) and v > 0 for v in fitted.values()):
        raise AssertionError(f"calibration: a fitted constant is not finite and positive: {fitted}")
    if not (slope > 1e-15 and pk_slope > 1e-15):
        raise AssertionError(f"calibration: a slope sits at its 1e-15 floor (link {slope}, "
                             f"pack {pk_slope}): the large point is bound by the host")
    load_sum = sum(schedule_ring_loads(make_schedule(n, "shift")))
    if abs(cal.ici_link_bandwidth - load_sum / slope) > 1e-9 * cal.ici_link_bandwidth:
        raise AssertionError("calibration: the recorded walls do not give the fitted link law")

    # c. refine: time the best modeled candidates; every cuda candidate packs
    # through hash_partition_pack, warm-up 2 + 3 timed runs, once a chunk
    timed = []
    measure = autotune.measure_shuffle_config

    def recorded_measure(mesh, axis, stats, **kw):
        before = hp.LAUNCHES["hash_partition_pack"]
        wall = measure(mesh, axis, stats, **kw)
        timed.append((kw["impl"], kw["pack_impl"], kw["pipeline_chunks"],
                      kw["transport_chunks"], wall, hp.LAUNCHES["hash_partition_pack"] - before))
        return wall

    cases = [(f"sweep {r} rows", [TableStats(r, CAL_ROW_BYTES)]) for r in CAL_SWEEP_ROWS]
    for q in ("q3", "q17"):
        pq = tpch.ALL_QUERIES[q]()
        plan = plan_physical(pq.logical, {t: tabs[t].capacity for t in pq.tables}, N_SHARDS,
                             chip=cal, name=q)
        cases.append((f"{q}'s shuffle edges", list(plan.shuffle_stats)))
    autotune.measure_shuffle_config = recorded_measure
    try:
        for tag, stats in cases:
            analytical = tune_multiplexer(mesh8, stats, chip=cal)
            timed.clear()
            refined, _ = drive(lambda: tune_multiplexer(mesh8, stats, chip=cal, refine=True,
                                                        refine_top_k=CAL_TOP_K))
            modeled = {c[:4]: c[4] for c in analytical.candidates}
            want_n = min(CAL_TOP_K, len(analytical.candidates))
            if [t[:4] for t in timed] != [c[:4] for c in analytical.candidates[:want_n]]:
                raise AssertionError(f"refine {tag}: timed {[t[:4] for t in timed]}, not the "
                                     f"{want_n} best modeled")
            best = min(timed, key=lambda t: t[4])
            if refined.measured_s != best[4] or (refined.impl, refined.pack_impl,
                                                 refined.pipeline_chunks,
                                                 refined.transport_chunks) != best[:4]:
                raise AssertionError(f"refine {tag}: returned {refined}, the least measured "
                                     f"wall is {best}")
            for impl, pack, C, t, wall, launched in timed:
                want_l = 5 * C if pack == "cuda" else 0
                if launched != want_l:
                    raise AssertionError(f"refine {tag}: {impl}/{pack}/C{C}/t{t} launched "
                                         f"hash_partition_pack {launched} times, not {want_l}")
            gap = max(refined.modeled_s / refined.measured_s,
                      refined.measured_s / refined.modeled_s)
            probe = max(stats, key=lambda s: s.rows * s.row_bytes)
            print(f"[calib] refine {tag} (probe {probe.rows} rows x {probe.row_bytes} B): "
                  f"analytical {analytical.impl}/{analytical.pack_impl}/"
                  f"C{analytical.pipeline_chunks}/t{analytical.transport_chunks}, refined "
                  f"{refined.impl}/{refined.pack_impl}/C{refined.pipeline_chunks}/"
                  f"t{refined.transport_chunks}; winner modeled {refined.modeled_s * 1e3:.4f} ms "
                  f"vs measured {refined.measured_s * 1e3:.4f} ms, gap {gap:.3f}x (the "
                  f"reference's bar {CAL_ACCURACY_BAR}x: "
                  f"{'within' if gap <= CAL_ACCURACY_BAR else 'outside'}; not gated) ({smi})")
            for impl, pack, C, t, wall, launched in timed:
                m = modeled[(impl, pack, C, t)]
                print(f"[calib]   {impl}/{pack}/C{C}/t{t}: modeled {m * 1e3:.4f} ms, measured "
                      f"{wall * 1e3:.4f} ms (modeled/measured {m / wall:.3f}), "
                      f"hash_partition_pack {launched}")
            _probe_shuffle(mesh8, refined, min(probe.rows, CAL_PROBE_ROWS),
                           max(2, probe.row_bytes // 4), seed)
    finally:
        autotune.measure_shuffle_config = measure
    print(f"[calib] every refined shuffle delivers the plain xla/torch shuffle's rows to every "
          f"destination, 0 drops (probes of up to {CAL_PROBE_ROWS} rows a unit)")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pod = tune_multiplexer(make_mesh(N_SHARDS, 2), cases[-1][1], chip=cal, refine=True)
    pod_want = tune_multiplexer(make_mesh(N_SHARDS, 2), cases[-1][1], chip=cal)
    said = [str(w.message) for w in caught if "two-level" in str(w.message)]
    if pod != pod_want or not said:
        raise AssertionError(f"refine on 2 x 4: {pod} (warnings {caught}); want the analytical "
                             f"{pod_want} and a warning")
    print(f"[calib] refine on 2 x 4 warns ({said[0]}) and returns the analytical "
          f"knobs {pod.impl}/{pod.pack_impl}/C{pod.pipeline_chunks}/t{pod.transport_chunks}")

    # d. serve the nine templates and the 8-shard stream under the calibrated prices
    def engine_for(names, tracer=None):
        ctx = ExecutionContext(num_shards=N_SHARDS, device="cuda",
                               stats_mode=StatsMode.COLLECT, trace=tracer)
        return QueryServeEngine(tabs, ctx, num_slots=QS_SLOTS, chip=cal,
                                templates=[tpch.ALL_QUERIES[q]() for q in names])

    names = sorted(tpch.ALL_QUERIES)
    engine = engine_for(names)
    done, counts = drive(
        lambda: engine.serve([QueryRequest("t", tpch.ALL_QUERIES[q]()) for q in names]))
    for r in done:
        check_answer(r.query.name, r.result, wants[r.query.name])
    if (counts["hash_partition_pack"], counts["partition_pack"]) != _qserve_pack_launches(
            engine, done):
        raise AssertionError(f"nine templates under {cal.name}: pack launches {counts}, the "
                             f"plans imply {_qserve_pack_launches(engine, done)}")
    moved = []
    for q in names:
        pq = tpch.ALL_QUERIES[q]()
        stats = {t: engine.stats[t] for t in pq.tables}
        v5e_plan = plan_physical(pq.logical, {t: tabs[t].capacity for t in pq.tables},
                                 N_SHARDS, stats=stats, name=q)
        a, b = _plan_shape(v5e_plan), _plan_shape(_qserve_plan(engine, pq))
        diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
        if diff:
            moved.append(q)
            print(f"[calib] {q}: the calibrated plan moved from V5E's: "
                  + "; ".join(f"{k} {x} -> {y}" for k, (x, y) in diff.items()))
    print(f"[calib] nine templates on {N_SHARDS} shards under {cal.name}: every answer equal to "
          f"the oracle, no row dropped (the runners raise on any); hash_partition_pack "
          f"{counts['hash_partition_pack']} as the plans imply; plans moved: {moved or 'none'}; "
          f"shared knobs {engine._mux.describe()} (V5E: {v5e['knobs']})")
    del engine, done

    tracer = Tracer()
    engine = engine_for(QS_MIX, tracer)
    mix = [tpch.ALL_QUERIES[q]() for q in QS_MIX]
    reqs = make_query_mix(mix, QS_TENANTS, QS_REQUESTS, seed=seed, max_arrival_round=4)

    def serve_stream():
        t0 = time.perf_counter()
        out = engine.serve(reqs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (done, wall), counts = drive(serve_stream)
    for r in done:
        check_answer(r.query.name, r.result, wants[r.query.name])
    want_hpp, want_pp = _qserve_pack_launches(engine, done)
    if (counts["hash_partition_pack"], counts["partition_pack"]) != (want_hpp, want_pp):
        raise AssertionError(f"stream under {cal.name}: pack launches {counts}, the plans and "
                             f"shared knobs imply {(want_hpp, want_pp)}")
    rec = engine.record()
    print(f"[calib] stream {N_SHARDS} under {cal.name}: {QS_REQUESTS} requests of {QS_MIX}, every "
          f"answer equal to the oracle, 0 drops; {QS_REQUESTS / wall:.2f} QPS ({wall:.3f} s), "
          f"TTFR p50 {rec['ttfr_p50_s'] * 1e3:.2f} p99 {rec['ttfr_p99_s'] * 1e3:.2f} ms; V5E's "
          f"plans in phase 4c: {v5e['qps']:.2f} QPS, TTFR p50 {v5e['ttfr_p50_s'] * 1e3:.2f} p99 "
          f"{v5e['ttfr_p99_s'] * 1e3:.2f} ms; hash_partition_pack {want_hpp}, partition_pack "
          f"{want_pp}, as the plans and shared knobs imply ({smi})")
    reported = set()
    for r in done:
        q = r.query.name
        if q not in ("q3", "q17") or q in reported:
            continue
        reported.add(q)
        errs = {k: v["time_model_err"] for k, v in model_report(r.trace)["edges"].items()}
        print(f"[calib] {q}: model_report time_model_err under V5E {errs} (its measured side is "
              f"the query's wall by V5E's predicted share, not a per-edge time)")
        t = engine.shared_tuned  # the knobs that carried the served shuffles
        knobs = dict(impl=t.impl, pack_impl=t.pack_impl, pipeline_chunks=t.pipeline_chunks,
                     transport_chunks=t.transport_chunks)
        for i, st in enumerate(_qserve_plan(engine, r.query).shuffle_stats):
            wall, counts = drive(lambda: autotune.measure_shuffle_config(mesh8, "q", st, **knobs))
            want_l = 5 * t.pipeline_chunks if t.pack_impl == "cuda" else 0
            if counts["hash_partition_pack"] != want_l:
                raise AssertionError(f"{q} edge {i}: hash_partition_pack "
                                     f"{counts['hash_partition_pack']}, not {want_l}")
            preds = {c.name: exchange_makespan(st, n, t.impl, t.pack_impl, t.pipeline_chunks,
                                               t.transport_chunks, chip=c) for c in (cal, V5E)}
            print(f"[calib] {q} shuffle edge {i} ({st.rows} rows x {st.row_bytes} B, "
                  f"{t.impl}/{t.pack_impl}/C{t.pipeline_chunks}/t{t.transport_chunks}): "
                  f"measure_shuffle_config {wall * 1e3:.4f} ms; exchange_makespan "
                  + ", ".join(f"{k} {v * 1e3:.4f} ms ({max(v / wall, wall / v):.3f}x)"
                              for k, v in preds.items())
                  + f"; hash_partition_pack {counts['hash_partition_pack']} ({smi})")
    del engine, done

    # e. EP dispatch priced with the calibrated spec
    olmoe = get_config("olmoe-1b-7b")
    for pods in (1, 2):
        for chip in (cal, V5E):
            ep = tune_ep_dispatch(olmoe, 64, N_SHARDS, num_pods=pods, chip=chip)
            print(f"[calib] tune_ep_dispatch(olmoe-1b-7b, batch 64, {N_SHARDS} units, "
                  f"num_pods={pods}, {chip.name}): chunks {ep['chunks']}, serial "
                  f"{ep['serial_s'] * 1e6:.3f} us, async {ep['async_s'] * 1e6:.3f} us, overlap "
                  f"fraction {ep['overlap_fraction']:.4f}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[calib] phase 4d in {time.perf_counter() - t_phase:.1f} s; peak "
          f"torch.cuda.max_memory_allocated {peak} B ({smi})")
    print(f"[calib] launches over the main path: {main_path}")
    return main_path, cal


def _cluster_integers(r: dict) -> dict:
    """What every process of a cluster run must agree on, bit for bit."""
    tp = r["tpch_pod_mesh"]
    return {
        "two_level_shuffle": r["two_level_shuffle"],
        "hierarchical_psum": r["hierarchical_psum"],
        "q3_orderkeys": tp["q3"]["orderkeys"],
        "edges": {q: tp[q]["edges"] for q in ("q3", "q17")},
        "dropped": [tp[q]["dropped"] for q in ("q3", "q17")],
        "salted": (r["salted_pod_shuffle"]["edges"], r["salted_pod_shuffle"]["edges_unsalted"]),
        "oocore_reports": r["oocore_pod_stream"]["reports"],
        "ep_tokens": r["ep_dispatch_two_level"]["tokens"],
    }


def _hop_ms(st, pods: int, transport: str, chip, network: str = "dci") -> float:
    """``exchange_makespan``'s coarse hop for one shuffle edge, skew 1: the
    pod message and the counts over ``pods - 1`` phases of ``network``."""
    from repro_torch.core.topology import shuffle_time

    pod_msg = -(-st["rows"] // pods) * st["row_bytes"]
    return 1e3 * (shuffle_time(pods, pod_msg, chip, transport, 1, "switch", network=network)
                  + shuffle_time(pods, 4, chip, transport, 1, "switch", network=network))


def phase_cluster(tabs: dict, wants: dict, sf: float, smi: str, fitted) -> dict:
    """The pod axis across real processes, on phase 4's SF 1 tables: Q3 and
    Q17 on 2 x 4 in this process (the integers to hold the cluster to),
    then ``tests/_torch_multiproc_driver.py``'s ten scenarios in 2 worker
    processes x 4 units on this one card over Gloo (TPC-H, salting and the
    stream at ``sf``, morsels of ``OOC_MORSEL``).  Returns every
    kernel's launches: this process's and each worker's from its start."""
    import shutil

    import torch

    from repro_torch.core.topology import V5E
    from repro_torch.launch.cluster import run_local_cluster
    from repro_torch.relational.context import ExecutionContext
    from repro_torch.relational.planner import tpch
    from repro_torch.relational.planner.executor import compile_plan

    torch.cuda.synchronize()
    _reset_counts()
    t_phase = time.perf_counter()
    # a. in this process: the integers (and explain) the cluster must give
    ctx = ExecutionContext(num_shards=N_SHARDS, num_pods=CLUSTER_PROCESSES, device="cuda")
    local = {}
    for q in ("q17", "q3"):
        pq = tpch.ALL_QUERIES[q]()
        plan = tpch.plan_query(pq, tabs, ctx)
        run = compile_plan(plan, tabs, ctx)
        out = run.dispatch()
        dropped = int(out[1])
        raw, qt = run.collect(out)
        got = pq.finalize(raw) if pq.finalize else raw
        check_answer(q, got, wants[q])
        local[q] = {"explain": plan.explain(), "dropped": dropped,
                    "hists": {e.key: [int(h) for h in e.hist] for e in qt.edges},
                    "orderkeys": [int(k) for k in got["o_orderkey"]] if q == "q3" else None}
    torch.cuda.synchronize()
    launches = _counts()

    # b. the cluster: two processes on this card, Gloo over localhost
    dump = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    t0 = time.perf_counter()
    try:
        outs = run_local_cluster(
            [str(ROOT / "tests" / "_torch_multiproc_driver.py"), "all", "--sf", str(sf),
             "--morsel-rows", str(OOC_MORSEL), "--time-hop", "--dump", dump],
            num_processes=CLUSTER_PROCESSES, local_units=CLUSTER_UNITS,
            timeout_s=CLUSTER_TIMEOUT_S, echo=False, backend="gloo", device="cuda",
        )
        dumps = [json.loads(Path(dump, f"p{p}.json").read_text())
                 for p in range(CLUSTER_PROCESSES)]
    finally:
        shutil.rmtree(dump, ignore_errors=True)
    wall = time.perf_counter() - t0
    for pid, out in enumerate(outs):
        missing = [s for s in CLUSTER_SCENARIOS if f"PASS {s}" not in out]
        if missing:
            raise AssertionError(f"cluster process {pid}: no PASS for {missing}\n{out[-4000:]}")
    res = [d["results"] for d in dumps]
    for pid, r in enumerate(res[1:], 1):
        if _cluster_integers(r) != _cluster_integers(res[0]):
            raise AssertionError(f"cluster: process {pid} disagrees with process 0")
    tp = res[0]["tpch_pod_mesh"]
    for q in ("q17", "q3"):
        for pid, r in enumerate(res):
            rec = r["tpch_pod_mesh"][q]
            hists = {k: e["hist"] for k, e in rec["edges"].items()}
            if (rec["explain"], rec["dropped"], hists) != (
                    local[q]["explain"], local[q]["dropped"], local[q]["hists"]):
                raise AssertionError(f"cluster {q} (process {pid}): explain, drops or edge "
                                     "histograms differ from the in-process 2 x 4 run")
            if q == "q3":
                if rec["orderkeys"] != local[q]["orderkeys"]:
                    raise AssertionError(f"cluster q3 (process {pid}): order keys differ from "
                                         "the in-process 2 x 4 run")
                check_answer("q3", {"o_orderkey": rec["orderkeys"], "revenue": rec["revenue"]},
                             wants["q3"])
            else:
                check_answer("q17", rec["answer"], wants["q17"])
    print(f"[cluster] {CLUSTER_PROCESSES} processes x {CLUSTER_UNITS} units on this card over "
          f"Gloo: every scenario passed in each ({wall:.1f} s, launcher wall); q3 and q17 at SF "
          f"{sf} equal the oracle, and their order keys, every edge's histogram "
          f"({sum(len(v['hists']) for v in local.values())} edges) and drops (0) equal this "
          f"process's 2 x 4 run; seconds a scenario on process 0: "
          + ", ".join(f"{k} {v:.2f}" for k, v in dumps[0]["seconds"].items()))
    sp = res[0]["salted_pod_shuffle"]
    print(f"[cluster] salted q17 (zipf 1.2): l_partkey edge's overload {sp['overload'][0]:.4f} "
          f"salted against {sp['overload'][1]:.4f} unsalted; answer {sp['answer']} (oracle-checked in each "
          f"process); streamed q17: {res[0]['oocore_pod_stream']['morsels']} morsel steps, "
          f"answer {res[0]['oocore_pod_stream']['answer']} = in-memory "
          f"{res[0]['oocore_pod_stream']['answer_in_memory']} within rtol 1e-3, spill refused")
    for pid, d in enumerate(dumps):
        w = d["launches"]
        if min(w["hash_partition_pack"], w["partition_pack"], w["moe_dispatch"]) <= 0:
            raise AssertionError(f"cluster process {pid}: a pack kernel never launched: {w}")
        for k, v in w.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[cluster] process {pid} launches (each run asserted against its plan): {w}")
    for q in ("q17", "q3"):
        for e in tp[q]["coarse_hop"]:
            walls = [r["tpch_pod_mesh"][q]["coarse_hop"][e["edge"]]["wall_s"] * 1e3 for r in res]
            models = {f"{c.name} DCI": _hop_ms(e, CLUSTER_PROCESSES, e["transport"], c)
                      for c in (V5E, fitted)}
            # the fitted in-card link law (phase 4d) priced on the same messages
            models[f"{fitted.name} ICI"] = _hop_ms(e, CLUSTER_PROCESSES, e["transport"], fitted,
                                                   "ici")
            print(f"[cluster] {q} edge {e['edge']} coarse hop ({e['rows']} rows x "
                  f"{e['message_bytes'] // e['rows']} B a message, {e['transport']}, staged "
                  f"through host memory): " + " / ".join(f"{w:.4f}" for w in walls)
                  + " ms by process; exchange_makespan's hop "
                  + ", ".join(f"{k} {v:.4f} ms ({max(walls) / v:.1f}x)" for k, v in models.items())
                  + f" ({smi})")
    print(f"[cluster] phase 4e in {time.perf_counter() - t_phase:.1f} s; launches over the main "
          f"path: {launches}")
    return launches


class _Timed:
    """Wall seconds of every call of a model-API function, each ended by
    ``torch.cuda.synchronize()`` (the engines wait for every step's tokens
    anyway, so the syncs cost nothing extra), and each call's end on the
    host clock."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls, self.tokens, self.ends = fn, 0.0, 0, 0, []

    def __call__(self, params, batch, *rest, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(params, batch, *rest, **kw)
        torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        self.seconds += self.ends[-1] - t0
        self.calls += 1
        # prefill: every row of the batch, padding rows included
        self.tokens += batch["tokens"].numel() if isinstance(batch, dict) else batch.shape[0]
        return out


def _timed_api(api):
    import dataclasses

    return dataclasses.replace(
        api, prefill=_Timed(api.prefill), decode_step=_Timed(api.decode_step),
        decode_step_slots=api.decode_step_slots and _Timed(api.decode_step_slots),
    )


def _serving_line(tag: str, api, reqs, stats: dict) -> None:
    import numpy as np

    slots = api.decode_step_slots
    pre, dec = api.prefill, slots if slots is not None and slots.calls else api.decode_step
    padded_prefill_tokens = pre.tokens
    decode_tokens = sum(len(r.out_tokens) - 1 for r in reqs)
    ttft = [r.ttft_s for r in reqs if r.ttft_s is not None]
    line = (
        f"[serving] {tag}: {len(reqs)} requests; prefill {pre.calls} calls, "
        f"{stats['prefill_tokens']} prompt tokens ({padded_prefill_tokens} with padding rows) "
        f"in {pre.seconds:.3f} s = {stats['prefill_tokens'] / pre.seconds:.1f} prompt tok/s "
        f"({padded_prefill_tokens / pre.seconds:.1f} tok/s processed); decode {dec.calls} steps, "
        f"{decode_tokens} tokens in {dec.seconds:.3f} s = {decode_tokens / dec.seconds:.1f} tok/s "
        f"({1e3 * dec.seconds / max(dec.calls, 1):.2f} ms/step); slot_steps={stats['slot_steps']}"
    )
    if ttft:
        line += (f"; TTFT p50 {1e3 * float(np.quantile(ttft, 0.5)):.1f} ms, "
                 f"p99 {1e3 * float(np.quantile(ttft, 0.99)):.1f} ms")
    print(line)


def _profile_call(tag: str, fn, kernel: tuple[str, str] = ("dispatch_kernel", "moe_dispatch"),
                     top: int = 8, span: str | None = None) -> None:
    """One call under ``torch.profiler``: device busy share of its wall time,
    the top device kernels, and the device time of ``kernel`` (the key
    substring, summed over every device kernel it matches, and the name to
    print; ``ssd_scan`` is three kernels); with ``span``, also the device
    time of every kernel launched inside ``record_function(span)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.key != span]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {tag}: wall {wall * 1e3:.2f} ms under the profiler; device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / 1e6 / wall:.1f}% of wall")
    for e in rows[:top]:
        print(f"[profile] {tag}:   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    key, name = kernel
    matched = [e for e in rows if key in e.key]
    if matched:
        us = sum(e.self_device_time_total for e in matched)
        calls = max(e.count for e in matched)
        print(f"[profile] {tag}: {name} device time {us / 1e3:.4f} ms over {calls} calls = "
              f"{us / 1e3 / calls:.4f} ms each, {100 * us / busy_us:.1f}% of device time ("
              + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.4f} ms" for e in matched)
              + ")")
    if span:
        ranges = [e for e in prof.key_averages() if e.key == span and e.device_type.name == "CPU"]
        us = sum(e.device_time_total for e in ranges)
        if us > 0:
            calls = sum(e.count for e in ranges)
            print(f"[profile] {tag}: {span} device time {us / 1e3:.4f} ms over {calls} calls = "
                  f"{100 * us / busy_us:.1f}% of device time")
        else:
            print(f"[profile] {tag}: {span} device time not measured (the profiler attributed "
                  f"no device time to the range)")


def phase_serving(seed: int) -> dict:
    """OLMoE-1B-7B at full width in bf16, expert-parallel over 8 simulated
    units, flat and 2 pods x 4, through both engines.  Returns every
    kernel's launches over the continuous runs (the main path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.exchange import make_mesh
    from repro_torch.core.multiplexer import use_multiplexer
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import registry
    from repro_torch.serve import (ContinuousEngine, Request, ServeEngine, generate_bucketed,
                                   make_mixed_workload)
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("olmoe-1b-7b")
    base_api = registry.build(cfg)
    t0 = time.perf_counter()
    params = base_api.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"[serving] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_experts} experts top-{cfg.top_k}, vocab {cfg.vocab_size}, {cfg.dtype} compute; "
          f"{n_params} f32 params ({4 * n_params} B) from seed {seed} in "
          f"{time.perf_counter() - t0:.2f} s")
    L = cfg.num_layers
    B, plen, new, cap = SERVE_SHAPE
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, plen, dtype=np.int32) for _ in range(B)]
    main_path = dict.fromkeys(_counts(), 0)

    def continuous(api, reqs, tag):
        """One continuous run on the main path: counts set to 0 just before
        it and read just after; ``moe_dispatch`` once per MoE layer of
        every prefill and decode step."""
        _reset_counts()
        ce = ContinuousEngine(api, batch_size=B, capacity=cap)
        ce.serve(params, reqs)
        counts = _counts()
        want = L * (ce.stats["prefill_calls"] + ce.stats["decode_steps"])
        if counts["moe_dispatch"] != want or ce.mux.pack_impl != "cuda":
            raise AssertionError(f"{tag}: moe_dispatch launched {counts['moe_dispatch']} times, "
                                 f"expected {want} ({ce.mux.describe()})")
        for k, v in counts.items():
            main_path[k] += v
        return ce, counts["moe_dispatch"]

    def static(api, reqs, tag, bucketed):
        _reset_counts()
        se = ServeEngine(api, batch_size=B, capacity=cap)
        generate_bucketed(se, params, reqs) if bucketed else se.generate(params, reqs)
        if _counts()["moe_dispatch"] != 0:
            raise AssertionError(f"{tag}: the static engine launched moe_dispatch")
        return se

    for pods in (1, 2):
        tag = "8 units" if pods == 1 else "2 pods x 4"
        with mesh_context(MeshContext(make_mesh(N_SHARDS, pods))):
            # -- uniform: static (plain pack) vs continuous (kernel pack) --
            s_api = _timed_api(base_api)
            reqs_s = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
            se = static(s_api, reqs_s, f"{tag} uniform", bucketed=False)
            _serving_line(f"{tag} uniform static", s_api, reqs_s, se.stats)

            c_api = _timed_api(base_api)
            reqs_c = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
            ce, launched = continuous(c_api, reqs_c, f"{tag} uniform")
            _serving_line(f"{tag} uniform continuous", c_api, reqs_c, ce.stats)
            if [r.out_tokens for r in reqs_c] != [r.out_tokens for r in reqs_s]:
                raise AssertionError(f"{tag}: continuous and static greedy tokens differ")
            print(f"[serving] {tag}: static and continuous greedy tokens identical "
                  f"({B} x {new}); moe_dispatch launched {launched} = {L} layers x "
                  f"({ce.stats['prefill_calls']} prefills + {ce.stats['decode_steps']} decode steps), "
                  f"0 in the static run; knobs {ce.mux.describe()}")

            # -- one prefill: kernel pack vs plain pack, bit for bit --------
            batch = {"tokens": torch.from_numpy(np.stack(prompts)).cuda()}
            with use_multiplexer(ce.mux):
                k_logits, _ = base_api.prefill(params, batch)
            with use_multiplexer(dataclasses.replace(ce.mux, pack_impl="torch")):
                p_logits, _ = base_api.prefill(params, batch)
            if not torch.equal(k_logits, p_logits):
                raise AssertionError(f"{tag}: prefill logits differ between the packs")
            if not torch.isfinite(k_logits).all():
                raise AssertionError(f"{tag}: non-finite logits")
            print(f"[serving] {tag}: prefill logits [{B}, {cfg.vocab_size}] bit-identical, "
                  f"kernel pack vs plain pack; all finite")
            del k_logits, p_logits
            if pods == 1:
                with use_multiplexer(ce.mux):
                    _profile_call(f"{tag} prefill [{B}, {plen}]",
                                     lambda: base_api.prefill(params, batch))
                    cache = base_api.init_cache(B, cap)
                    toks = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
                    pos = torch.full((B,), plen, dtype=torch.int32, device="cuda")
                    _profile_call(f"{tag} decode step B={B}",
                                     lambda: base_api.decode_step_slots(params, toks, cache, pos))
                    del cache
            del batch

            # -- mixed: lengths 128/256/512, 1-32 new, 4 arrivals a step ----
            mixed = make_mixed_workload(cfg.vocab_size, MIXED_REQUESTS[pods],
                                        (plen // 2, plen, 2 * plen), 2 * new, rng, arrival_rate=4)
            mixed_s = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in mixed]
            m_api = _timed_api(base_api)
            ce2, launched = continuous(m_api, mixed, f"{tag} mixed")
            ce2.alloc.check()
            if not all(r.done and 1 <= len(r.out_tokens) <= r.max_new_tokens for r in mixed):
                raise AssertionError(f"{tag} mixed: a request did not complete")
            _serving_line(f"{tag} mixed continuous", m_api, mixed, ce2.stats)
            sm_api = _timed_api(base_api)
            st = static(sm_api, mixed_s, f"{tag} mixed", bucketed=True)
            _serving_line(f"{tag} mixed static", sm_api, mixed_s, st.stats)
            c, s_ = ce2.stats["slot_steps"], st.stats["slot_steps"]
            if c >= s_:
                raise AssertionError(f"{tag} mixed: continuous {c} slot-steps, static {s_}")
            print(f"[serving] {tag} mixed: alloc.check() holds; slot_steps continuous={c} "
                  f"static={s_} ({s_ / c:.2f}x fewer); moe_dispatch launched {launched} = {L} x "
                  f"({ce2.stats['prefill_calls']} prefills + {ce2.stats['decode_steps']} decode steps)")
    print(f"[serving] launches over the main path: {main_path}")
    print(f"[serving] torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    del params
    torch.cuda.empty_cache()
    return main_path


def phase_serve_procs(smi: str) -> dict:
    """The static serving engine with its batch split over ``SERVE_PROCS``
    worker processes of ``SERVE_UNITS`` units on this card (Gloo): the
    ``serve`` scenario of ``tests/_torch_multiproc_driver.py``, which asserts
    every gate in the workers; printed and checked again here from their
    dumps.  Returns the workers' ``moe_dispatch`` and ``ssd_scan`` launches
    over the split runs (the main path)."""
    import shutil

    from repro_torch.launch.cluster import run_local_cluster

    dump = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    t0, launched_at = time.perf_counter(), time.time()
    try:
        outs = run_local_cluster(
            [str(ROOT / "tests" / "_torch_multiproc_driver.py"), "serve", "--serve-full",
             "--serve-cells", SERVE_PROCS_CELLS, "--serve-tol", str(SERVE_PROCS_TOL),
             "--serve-dtype", "float32", "--serve-param-dtype", "float32", "--dump", dump,
             "--serve-continuous", SERVE_PROCS_CONTINUOUS[0],
             "--serve-prompts", SERVE_PROCS_CONTINUOUS[1],
             "--serve-rate", str(SERVE_PROCS_CONTINUOUS[2])],
            num_processes=SERVE_PROCS, local_units=SERVE_UNITS, timeout_s=SERVE_PROCS_TIMEOUT_S,
            echo=False, backend="gloo", device="cuda",
        )
        recs = [json.loads(Path(dump, f"p{p}.json").read_text())["results"]["serve"]
                for p in range(SERVE_PROCS)]
    finally:
        shutil.rmtree(dump, ignore_errors=True)
    wall = time.perf_counter() - t0
    for pid, out in enumerate(outs):
        if "PASS serve" not in out:
            raise AssertionError(f"serve-procs process {pid}: no PASS\n{out[-4000:]}")
    launched = {"moe_dispatch": 0, "ssd_scan": 0}
    for arch, r0 in recs[0]["archs"].items():
        B, S, new = r0["shape"]
        one = r0["one_process"]
        if not (r0["tokens_equal"] and max(r0["logit_rel"]) <= SERVE_PROCS_TOL
                and r0.get("drops_equal", True)):
            raise AssertionError(f"serve-procs {arch}: against the one-process engine {r0}")
        print(f"[serve-procs] {arch} full width, {r0['layers']} layers, f32 (TF32 off): {B} x "
              f"{S}-token prompts + {new} new over {SERVE_PROCS} processes x {SERVE_UNITS} units "
              f"on this card over Gloo, {B // SERVE_PROCS} rows a process ({r0['rows']}); "
              f"greedy tokens equal to process 0's one-process engine over the same 8 units; "
              f"logits within {max(r0['logit_rel']):.3g} of their max ({SERVE_PROCS_TOL}) over "
              f"{len(r0['logit_rel'])} calls; drops "
              + (f"bit-exact over {r0['expert_calls']} expert-parallel calls ({sum(r0['drops'])}"
                 " dropped)" if "drops" in r0 and r0["expert_calls"] else "none (no "
                 "expert-parallel call)") + f" ({smi})")
        print(f"[serve-procs] {arch} one process (8 units, whole batch): prefill "
              f"{one['prefill_s'][0] * 1e3:.1f} ms, decode {sum(one['decode_s']) * 1e3:.1f} ms "
              f"over {len(one['decode_s'])} steps, peak {one['peak']} B, launches "
              f"{one['launches']}")
        for pid, rec in enumerate(recs):
            r = rec["archs"][arch]
            h = r["want_hop"]
            print(f"[serve-procs] {arch} process {pid}: prefill {r['prefill_s'][-1][0] * 1e3:.1f}"
                  f" ms, decode {sum(r['decode_s'][-1]) * 1e3:.1f} ms over "
                  f"{len(r['decode_s'][-1])} steps ({1e3 * sum(r['decode_s'][-1]) / max(len(r['decode_s'][-1]), 1):.2f} ms a step); "
                  f"pod hop {r['hop_bytes']} B = gathered tokens {h['gathers']} B (4 B x "
                  f"{B // SERVE_PROCS} rows x {1 + r['stats']['decode_steps']} calls) + "
                  f"expert-parallel trips {h['expert_trips']} B (2 x U x (N - U) x E / N x C x d "
                  f"x itemsize a MoE layer's call) {r['hop_kinds']}; peak {r['peak']} B; "
                  f"launches {r['launches']} ({smi})")
            if r["hop_bytes"] != h["total"] or not r["tokens_equal_on_every_process"]:
                raise AssertionError(f"serve-procs {arch} process {pid}: {r}")
            if arch.startswith("mamba2") and h["expert_trips"]:
                raise AssertionError(f"serve-procs {arch}: expert trips on the pod hop")
            for k in launched:
                launched[k] += r["launches"][k]
    for arch in recs[0]["continuous"]:
        _serve_procs_continuous(arch, recs, launched, smi)
    if not recs[0]["continuous_raises"]:
        raise AssertionError("serve-procs: the continuous engine took an SSM across processes")
    print(f"[serve-procs] the continuous engine still refuses the SSM family: "
          f"{recs[0]['continuous_raises'][:100]}...")
    for pid, rec in enumerate(recs):
        parts = {"start-up": rec["started_at"] - launched_at,
                 **{a: r["seconds"] for a, r in rec["archs"].items()},
                 **{f"{a} continuous": r["seconds"] for a, r in rec["continuous"].items()}}
        print(f"[serve-procs] process {pid}'s seconds: "
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    print(f"[serve-procs] phase 5b in {wall:.1f} s (launcher wall); launches over the split "
          f"runs: {launched}")
    return launched


def _serve_procs_continuous(arch: str, recs: list, launched: dict, smi: str) -> None:
    """Phase 5b's continuous cell, from the workers' dumps: against process
    0's one-process engine (tokens, admission and finish steps, the stats'
    counters, spans, logits, drops), half the cache a process, the pod hop
    equal to the count derived from the one-process engine's schedule, and
    ``moe_dispatch`` once a MoE layer a prefill group and a decode step on
    each process; each process's numbers printed beside the one process's.
    Adds the workers' launches to ``launched``."""
    r0 = recs[0]["continuous"][arch]
    one = r0["one_process"]
    slots, n_req, new = r0["shape"]
    if not (r0["tokens_equal"] and r0["steps_equal"] and r0["stats_equal"] and r0["spans_equal"]
            and max(r0["logit_rel"]) <= SERVE_PROCS_TOL and r0["drops_equal"]):
        raise AssertionError(f"serve-procs {arch} continuous: against the one-process engine "
                             f"{ {k: v for k, v in r0.items() if k != 'tokens'} }")
    st = r0["stats"]
    print(f"[serve-procs] {arch} continuous, full width, {r0['layers']} layers, f32 (TF32 off): "
          f"{slots} slots ({slots // SERVE_PROCS} a process), {n_req} mixed requests (prompts "
          f"{r0['prompts']}, 1-{new} new, {r0['rate']} arrivals a step) over {SERVE_PROCS} "
          f"processes x {SERVE_UNITS} units on this card over Gloo ({r0['rows']}): "
          f"{st['prefill_calls']} prefill groups, {st['decode_steps']} decode steps, "
          f"{st['moved_rows']} prefilled rows moved to their slot's process; greedy tokens, "
          f"admission and finish steps, stats and spans equal to process 0's one-process engine "
          f"over the same 8 units; logits within {max(r0['logit_rel']):.3g} of their max "
          f"({SERVE_PROCS_TOL}) over {len(r0['logit_rel'])} calls; drops bit-exact over "
          f"{r0['expert_calls']} expert-parallel calls ({sum(r0['drops'])} dropped); "
          f"multiplexer {r0['mux']} ({smi})")
    n_one = len(one["decode_s"])
    print(f"[serve-procs] {arch} continuous one process (8 units, {slots} slots): prefill "
          f"{[round(v * 1e3, 2) for v in one['prefill_s']]} ms a group, decode "
          f"{1e3 * sum(one['decode_s']) / max(n_one, 1):.2f} ms a step over {n_one} steps, "
          f"{one['record']} cache {one['cache_bytes']} B, peak {one['peak']} B, launches "
          f"{one['launches']} ({smi})")
    for pid, rec in enumerate(recs):
        r = rec["continuous"][arch]
        h, s = r["want_hop"], r["stats"]
        calls = s["prefill_calls"] + s["decode_steps"]
        want_launch = r0["layers"] * calls  # every OLMoE layer is a MoE layer
        n = len(r["decode_s"])
        print(f"[serve-procs] {arch} continuous process {pid}: prefill "
              f"{[round(v * 1e3, 2) for v in r['prefill_s']]} ms a group, decode "
              f"{1e3 * sum(r['decode_s']) / max(n, 1):.2f} ms a step over {n} steps, "
              f"{r['record']}; moved rows sent {h['sent_rows']} ({h['moved_row_bytes']} B); pod "
              f"hop {r['hop_bytes']} B = gathered tokens {h['gathers']} B + expert trips "
              f"{h['expert_trips']} B + moved rows {h['moved_row_bytes']} B {r['hop_kinds']}; "
              f"cache {r['cache_bytes']} B (one process {r['whole_cache_bytes']} B); peak "
              f"{r['peak']} B; launches {r['launches']} ({smi})")
        bad = [k for k, b in (
            ("pod hop", r["hop_bytes"] != h["total"]),
            ("cache", r["cache_bytes"] * SERVE_PROCS != r["whole_cache_bytes"]),
            ("equal on every process", not all(r["equal_on_every_process"].values())),
            ("moe_dispatch", r["launches"]["moe_dispatch"] != want_launch
             or r["expert_calls"] != want_launch),
        ) if b]
        if bad:
            raise AssertionError(f"serve-procs {arch} continuous process {pid}: {bad}")
        for k in launched:
            launched[k] += r["launches"][k]


def _train_run(cfg, seed: int, steps: int, tag: str, shape=TRAIN_SHAPE[:2],
               kernel: str = "flash_attention", tail: int = 5):
    """``steps`` AdamW steps (lr 3e-4, 5 warm-up steps over a 20-step
    schedule) of ``cfg`` at a batch of ``shape`` from ``seed``, through the
    calls ``launch/train.py`` makes; every step must launch ``kernel`` once a
    layer, twice under remat (every layer of train100m runs attention, every
    layer of Mamba2 and Zamba2 the scan, every encoder and decoder layer of
    Whisper the attention kernel), every loss must be finite and the mean
    of the last ``tail`` below the first.  Returns the
    state, the step function, the optimizer, the batch source and every
    kernel's launches over the steps (a main path)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import Prefetcher, make_batch_iterator
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S = shape
    api = registry.build(cfg)
    opt = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=TRAIN_SCHEDULE,
                      schedule=cfg.lr_schedule)
    step_fn = make_train_step(api, opt)
    state = TrainState.create(api, seed)
    n_params = sum(t.numel() for t in leaves(state.params))
    layers = cfg.num_layers + cfg.encoder_layers
    per_step = layers * (1 if cfg.remat == "none" else 2)
    enc = f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else ""
    print(f"[training] {tag}: {cfg.name}, {cfg.num_layers} layers{enc}, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"tied {cfg.tie_embeddings}, {cfg.dtype} compute over {cfg.param_dtype} params, "
          f"remat={cfg.remat}, attn_impl={cfg.attn_impl}; {n_params} params from seed {seed}; "
          f"batch {B} x {S}; TF32 off")
    it = Prefetcher(make_batch_iterator(cfg, ShapeSpec("chip", S, B, "train"), seed=seed), depth=2)

    def next_batch():
        return {k: torch.from_numpy(v).to("cuda") for k, v in next(it).items()}

    losses, walls = [], []
    _reset_counts()  # the main path starts here
    for i in range(steps):
        batch = next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = _counts()[kernel]
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launched = _counts()[kernel] - before
        if launched != per_step:
            raise AssertionError(f"{tag} step {i}: {kernel} launched {launched} times, "
                                 f"expected {per_step}")
    launches = _counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite loss: {losses}")
    last = float(np.mean(losses[-tail:]))
    if not last < losses[0]:
        raise AssertionError(f"{tag}: the loss did not fall: first {losses[0]}, last {tail} "
                             f"mean {last}")
    steady = float(np.mean(walls[1:]))
    print(f"[training] {tag} losses: {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"[training] {tag} loss {losses[0]:.4f} -> mean of the last {tail} {last:.4f}; all "
          f"finite")
    print(f"[training] {tag} {kernel} launched {launches[kernel]} = {steps} steps x {per_step} "
          f"({per_step // layers} x {layers} layers: forward"
          f"{' + remat recompute' if cfg.remat != 'none' else ''})")
    print(f"[training] {tag} step wall: first {walls[0] * 1e3:.1f} ms; steps 2-{steps} mean "
          f"{steady * 1e3:.1f} ms (min {min(walls[1:]) * 1e3:.1f}, max {max(walls[1:]) * 1e3:.1f}) "
          f"= {B * S / steady:.1f} tokens/s; peak memory {torch.cuda.max_memory_allocated()} B")
    return state, step_fn, opt, next_batch, launches


def _flash_vs_chunked(cfg, opt, step_fn, state, batch, tag: str, rtol_loss: float,
                      rtol_norm: float) -> None:
    """One step from one state and batch under ``attn_impl="flash"`` and
    ``"chunked"``: the loss and the grad norm within the given rtols."""
    from repro_torch.models import registry
    from repro_torch.train import make_train_step

    _, m_flash = step_fn(state, batch)
    chunked = registry.build(cfg.scaled(attn_impl="chunked"))
    _, m_chunk = make_train_step(chunked, opt)(state, batch)
    d_loss = abs(float(m_flash["loss"]) - float(m_chunk["loss"])) / abs(float(m_chunk["loss"]))
    d_norm = abs(float(m_flash["grad_norm"]) - float(m_chunk["grad_norm"])) / float(m_chunk["grad_norm"])
    print(f"[training] {tag} flash vs chunked, one step from one state and batch: loss "
          f"{float(m_flash['loss']):.6f} vs {float(m_chunk['loss']):.6f} (rel {d_loss:.3g}, "
          f"rtol {rtol_loss:.3g}), grad norm {float(m_flash['grad_norm']):.6f} vs "
          f"{float(m_chunk['grad_norm']):.6f} (rel {d_norm:.3g}, rtol {rtol_norm:.3g})")
    if d_loss > rtol_loss or d_norm > rtol_norm:
        raise AssertionError(f"{tag}: flash and chunked attention disagree beyond rtol "
                             f"{rtol_loss:.3g} / {rtol_norm:.3g}")


def phase_training(seed: int) -> dict:
    """train100m at full width with the flash kernel: 10 steps in f32, the
    chunked cross-check, the CLI's checkpoint resume, one profiled step;
    then 5 steps with bf16 compute over f32 master params, its own chunked
    cross-check and profiled step.  Returns every kernel's launches over the
    two runs (the main path), the bf16 run's ``flash_attention`` launches
    under ``flash_attention[bfloat16]``."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the f32 checks below assume full f32")
    B, S, steps = TRAIN_SHAPE
    cfg = get_config("train100m").scaled(attn_impl="flash")
    state, step_fn, opt, next_batch, launches = _train_run(cfg, seed, steps, "f32")
    batch = next_batch()
    _flash_vs_chunked(cfg, opt, step_fn, state, batch, "f32", 1e-5, 1e-4)
    _profile_call(f"f32 train step [{B}, {S}]", lambda: step_fn(state, batch),
                  kernel=("flash_fwd_f32", "flash_attention"), top=10)
    del state, batch
    torch.cuda.empty_cache()

    # the CLI: 4 steps with a checkpoint every 2, resume to 6, against 6 straight
    common = ["--arch", "train100m", "--seq-len", str(CLI_SEQ), "--batch", str(B),
              "--seed", str(seed), "--log-every", "1"]
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d2:
        runs = {}
        for tag, argv in (("4 steps", ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"]),
                          ("resumed to 6", ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2"]),
                          ("6 straight", ["--steps", "6", "--ckpt-dir", d2])):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                st, last = train_cli.main(common + argv)
            runs[tag] = (st, last, out.getvalue(), time.perf_counter() - t0)
    st, last, log, _ = runs["resumed to 6"]
    if "resumed from checkpoint at step 4" not in log or int(st.step) != 6:
        raise AssertionError(f"the CLI did not resume at step 4:\n{log}")
    want = runs["6 straight"][1]["loss"]
    if not math.isfinite(want) or abs(last["loss"] - want) > 1e-5 * abs(want):
        raise AssertionError(f"resumed last loss {last['loss']} vs uninterrupted {want}")
    print(f"[training] CLI seq {CLI_SEQ}: " + "; ".join(
        f"{tag} {r[3]:.2f} s, last loss {r[1]['loss']:.6f}" for tag, r in runs.items())
        + f"; resumed at step 4, |diff| {abs(last['loss'] - want):.3g} (rtol 1e-5)")
    del runs, st
    torch.cuda.empty_cache()

    # bf16 compute over f32 master params (the reference's default dtypes);
    # the tolerances are TRAIN_BF16_RTOL's, from bf16 rounding
    cfg16 = get_config("train100m").scaled(dtype="bfloat16", attn_impl="flash")
    state, step_fn, opt, next_batch, launches16 = _train_run(cfg16, seed, TRAIN_BF16_STEPS,
                                                             "bf16")
    batch = next_batch()
    _flash_vs_chunked(cfg16, opt, step_fn, state, batch, "bf16", *TRAIN_BF16_RTOL)
    _profile_call(f"bf16 train step [{B}, {S}]", lambda: step_fn(state, batch),
                  kernel=("flash_fwd_bf16", "flash_attention"), top=10)
    print(f"[training] flash_attention launches: f32 {launches['flash_attention']}, bf16 "
          f"{launches16['flash_attention']}")
    del state, batch
    torch.cuda.empty_cache()
    launches16["flash_attention[bfloat16]"] = launches16.pop("flash_attention")
    return {k: launches.get(k, 0) + launches16.get(k, 0) for k in {*launches, *launches16}}


_META_COUNTS = []  # the one thread that counts on meta, made at first use


def _count_on_meta(cfg, shape: tuple, layout: tuple):
    """The dry run's count (``launch/dryrun.py``'s ``count_cell``) of ``cfg``
    at the global batch ``shape`` (B, S) on ``layout`` (processes, units),
    rank 0 on ``meta`` under a fake process group, with the model flops of
    the batch (6 N D): a future, counted in a thread of this process while
    its workers run (it only waits on them).  One thread takes every count
    in turn: each holds the process's one default (fake) group while it
    counts."""
    from concurrent.futures import ThreadPoolExecutor

    def count():
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import dryrun
        from repro_torch.launch import roofline as RL
        from repro_torch.models import registry

        spec = ShapeSpec("train", shape[1], shape[0], "train")
        meta = dryrun.count_cell(cfg, spec, *layout)
        meta["model_flops"] = RL.model_flops(cfg, spec, registry.param_count(cfg, active_only=True))
        return meta

    if not _META_COUNTS:
        _META_COUNTS.append(ThreadPoolExecutor(1))
    return _META_COUNTS[0].submit(count)


def _profiled_steps(tag: str, meta_future, layout: tuple, chips: int, recs: list,
                    want_collective: dict, dtype: str, smi: str) -> list[dict]:
    """Each process's profiled step (the driver's ``--profile``: one step
    counted op by op, one under ``torch.profiler``) against the dry run's
    count of the same config, batch and ``layout`` on ``meta``
    (:func:`_count_on_meta`): its flops and collective bytes must equal the
    count's, its collective bytes by kind ``want_collective`` and the step's
    pod-hop bytes.  MFU (``roofline.measured_row``) sets the model flops of
    the global batch (6 N D) on ``chips`` cards against ``H100_SXM``'s bf16
    peak over the mean of the plain steps after the first.  Prints and
    returns one JSON line a process."""
    from repro_torch.core.topology import H100_SXM
    from repro_torch.launch import roofline as RL

    meta = meta_future.result()
    model = meta["model_flops"]
    terms = RL.RooflineTerms(
        arch=tag, shape="train", mesh=f"{layout[0]}x{layout[1]}",
        flops_per_chip=meta["flops"] * layout[0] / chips,
        bytes_per_chip=meta["bytes"] * layout[0] / chips,
        coll_bytes_per_chip=meta["collective_bytes"], model_flops_global=model, chips=chips,
        chip=H100_SXM)
    print(f"[{tag}] the dry run's count on meta, {layout[0]} x {layout[1]} under a fake group: "
          f"{meta['flops']} flops, {meta['bytes']} B, collectives {meta['collective_bytes']}, "
          f"peak live {meta['peak_live_bytes']} B, in {meta['count_s']:.1f} s (beside the "
          f"workers)")
    lines = []
    for pid, r in enumerate(recs):
        p = r["profile"]
        coll = p["collective_bytes"]
        if coll != want_collective or sum(coll.values()) != p["pod_hop_bytes"] \
                or coll != meta["collective_bytes"]:
            raise AssertionError(f"{tag} process {pid}: collective bytes {coll}, the step's pod "
                                 f"hop {p['pod_hop_bytes']} B, want {want_collective}, the "
                                 f"count on meta {meta['collective_bytes']}")
        if p["flops"] != meta["flops"]:
            raise AssertionError(f"{tag} process {pid}: {p['flops']} flops counted on the card, "
                                 f"{meta['flops']} on meta")
        step_s = sum(r["step_s"][1:]) / len(r["step_s"][1:])
        measured = RL.measured_row(terms, step_s)
        ov = p["overlap"]
        line = {
            "process": pid, "step_ms": step_s * 1e3, "profiled_step_ms": p["step_s"] * 1e3,
            "flops": p["flops"], "bytes": p["bytes"], "collective_bytes": coll,
            "overlap_fraction": ov["overlap_fraction"], "idle_share": ov["idle_share"],
            "device_busy": ov["device_busy"], "window_ms": ov["window_s"] * 1e3,
            "collective_ms": ov["collective_s"] * 1e3, "compute_ms": ov["compute_s"] * 1e3,
            "overlapped_ms": ov["overlapped_s"] * 1e3,
            "mfu": measured["mfu"], "ideal_over_step": measured["ideal_over_step"],
            "mfu_of": f"6 N D = {model:.6g} flops on {chips} card(s) against the bf16 peak of "
                      f"{H100_SXM.peak_flops_bf16:.4g} flop/s; the step computes in {dtype}",
            "peak_live_bytes": p["peak_live_bytes"],
            "max_memory_allocated": p["max_memory_allocated"],
            "allocated_before": p.get("allocated_before"), "nvidia_smi": smi,
        }
        print(f"[{tag}] profiled step process {pid}: {json.dumps(line)}")
        lines.append(line)
    return lines


def phase_dp_train(smi: str) -> dict:
    """train100m data-parallel over ``DP_PROCESSES`` worker processes of
    ``DP_UNITS`` units on this card (Gloo): the ``dp_train`` scenario of
    ``tests/_torch_multiproc_driver.py``, which asserts every gate in the
    workers; printed here from their dumps.  Returns the workers' ``flash_attention`` launches over
    the data-parallel gradients and steps (the main path)."""
    import shutil

    from repro_torch.launch.cluster import run_local_cluster

    from repro_torch.configs import get_config

    B, S = DP_SHAPE
    dump = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    t0 = time.perf_counter()
    meta = _count_on_meta(get_config("train100m").scaled(attn_impl="flash"), DP_SHAPE,
                          (DP_PROCESSES, DP_UNITS))
    try:
        outs = run_local_cluster(
            [str(ROOT / "tests" / "_torch_multiproc_driver.py"), "dp_train", "--dp-archs",
             "train100m", "--dp-full", "--dp-shape", f"{B}x{S}", "--dump", dump,
             "--profile", dump],
            num_processes=DP_PROCESSES, local_units=DP_UNITS, timeout_s=DP_TIMEOUT_S,
            echo=False, backend="gloo", device="cuda",
        )
        recs = [json.loads(Path(dump, f"p{p}.json").read_text())["results"]["dp_train"]["train100m"]
                for p in range(DP_PROCESSES)]
    finally:
        shutil.rmtree(dump, ignore_errors=True)
    wall = time.perf_counter() - t0
    for pid, out in enumerate(outs):
        if "PASS dp_train" not in out:
            raise AssertionError(f"dp-train process {pid}: no PASS\n{out[-4000:]}")
    r0 = recs[0]
    print(f"[dp-train] train100m f32, {r0['params']} params in {r0['leaves']} leaves, global "
          f"batch {B} x {S} over {DP_PROCESSES} processes x {DP_UNITS} units on this card over "
          f"Gloo; one-process gradient on process 0 {r0['one_process_grad_s'] * 1e3:.1f} ms "
          f"({smi})")
    launched = 0
    for mode, m in r0["modes"].items():
        print(f"[dp-train] {mode}: against the one-process step, loss rel {m['loss_rel']:.3g} "
              f"(1e-5), worst leaf {m['leaf_rel']:.3g} of its max (1e-4), first step's loss "
              f"{m['step_loss_rel'][0]:.3g}, grad norm {m['step_norm_rel'][0]:.3g} (1e-4); "
              f"steps 2-3 loss {m['step_loss_rel'][1]:.3g}, {m['step_loss_rel'][2]:.3g}; params "
              f"after 3 steps within {m['params_abs']:.3g}, bit-identical on both processes")
        for pid, r in enumerate(recs):
            mr = r["modes"][mode]
            print(f"[dp-train] {mode} process {pid}: step walls "
                  + ", ".join(f"{w * 1e3:.1f}" for w in mr["step_s"])
                  + f" ms; first gradient (warm-up included) {mr['grad_s'] * 1e3:.1f} ms; the "
                  f"sync alone {mr['sync_s'] * 1e3:.1f} ms; {mr['step_hop_bytes'][0]} B a step "
                  f"on the pod hop in {mr['sync_hop']['messages']} messages (the leaves' f32 bytes "
                  f"{r['leaf_bytes']}); flash_attention {mr['launches']} a step "
                  f"({mr['per_step']} implied) ({smi})")
            launched += mr["grad_launches"] + sum(mr["launches"])
    _profiled_steps("dp-train", meta, (DP_PROCESSES, DP_UNITS), 1,
                    [r["modes"]["auto"] for r in recs], {"all-reduce": r0["leaf_bytes"]},
                    "float32", smi)
    print(f"[dp-train] phase 6b in {time.perf_counter() - t0:.1f} s (the launcher's wall "
          f"{wall:.1f} s); flash_attention launches over the data-parallel steps: {launched}")
    return {"flash_attention": launched}


def phase_moe_train(smi: str) -> dict:
    """OLMoE-1B-7B training with its experts sharded over ``MOE_PROCESSES``
    worker processes of ``MOE_UNITS`` units on this card (Gloo): the
    ``moe_train`` scenario of ``tests/_torch_multiproc_driver.py``, which
    asserts every gate in the workers; printed here from their dumps.
    Returns the workers' ``moe_dispatch`` and ``flash_attention`` launches
    over the sharded gradient and steps (the main path)."""
    import shutil

    from repro_torch.launch.cluster import run_local_cluster

    B, S = MOE_SHAPE
    dump = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    t0, launched_at = time.perf_counter(), time.time()
    meta = _count_on_meta(moe_train_config(MOE_LAYERS), MOE_SHAPE, (MOE_PROCESSES, MOE_UNITS))
    try:
        outs = run_local_cluster(
            [str(ROOT / "tests" / "_torch_multiproc_driver.py"), "moe_train", "--moe-full",
             "--moe-layers", str(MOE_LAYERS), "--moe-shape", f"{B}x{S}", "--dump", dump,
             "--profile", dump],
            num_processes=MOE_PROCESSES, local_units=MOE_UNITS, timeout_s=MOE_TIMEOUT_S,
            echo=False, backend="gloo", device="cuda",
        )
        recs = [json.loads(Path(dump, f"p{p}.json").read_text())["results"]["moe_train"]["check"]
                for p in range(MOE_PROCESSES)]
    finally:
        shutil.rmtree(dump, ignore_errors=True)
    wall = time.perf_counter() - t0
    for pid, out in enumerate(outs):
        if "PASS moe_train" not in out:
            raise AssertionError(f"moe-train process {pid}: no PASS\n{out[-4000:]}")
    r0 = recs[0]
    print(f"[moe-train] OLMoE-1B-7B full width, {r0['layers']} of 16 layers, f32 (TF32 off), "
          f"remat block, flash; global batch {B} x {S} over {MOE_PROCESSES} processes x "
          f"{MOE_UNITS} units on this card over Gloo, the moe_dispatch kernel pack; capacity "
          f"{r0['capacity']} a unit ({smi})")
    print(f"[moe-train] one-process step on process 0 (8 units, whole state): gradient "
          f"{r0['one_process_grad_s'] * 1e3:.1f} ms (first call), steps "
          + ", ".join(f"{w * 1e3:.1f}" for w in r0["one_process"]["step_s"])
          + f" ms, peak {r0['one_process_peak']} B")
    print(f"[moe-train] against it: loss rel {r0['loss_rel']:.3g} (1e-5), worst leaf "
          f"{r0['leaf_rel']:.3g} of its max (1e-4; replicated {r0['replicated_rel']:.3g}, expert "
          f"slices " + ", ".join(f"process {k} {v:.3g}" for k, v in
                                 r0["expert_slice_rel"].items())
          + f"), first step's grad norm {r0['step_norm_rel'][0]:.3g} (1e-4), steps 2-3 loss "
          f"{r0['step_loss_rel'][1]:.3g}, {r0['step_loss_rel'][2]:.3g}; drops bit-exact "
          f"{r0['drops_equal']} ({sum(r0['drops'])} over {len(r0['drops'])} calls); the "
          f"sharded init equals the whole init sliced: {r0['init_equal']}; params after 3 "
          f"steps within {r0['params_abs']:.3g}; replicated params bit-identical on every "
          f"process")
    launched = {"moe_dispatch": 0, "flash_attention": 0}
    for pid, r in enumerate(recs):
        hop = r["step_hop_bytes"][0]
        ep = hop - r["replicated_bytes"]
        print(f"[moe-train] process {pid}: state {r['state_bytes']} B ({r['expert_leaves']} "
              f"expert leaves of its {r['experts'] // MOE_PROCESSES} experts "
              f"a layer); step walls " + ", ".join(f"{w * 1e3:.1f}" for w in r["step_s"])
              + f" ms; first gradient (warm-up included) {r['grad_s'] * 1e3:.1f} ms; pod hop "
              f"{hop} B a step: replicated gradient {r['replicated_bytes']} B, expert-parallel "
              f"trips {ep} B ({ep / r['trip_bytes']:.2f} trips of {r['trip_bytes']} B); peak "
              f"{r['peak']} B; launches a step {r['launches'][0]} ({smi})")
        for got in r["launches"] + [r["grad_launches"]]:
            for k in launched:
                launched[k] += got[k]
    print(f"[moe-train] phase 6c in {wall:.1f} s (launcher wall); launches over the sharded "
          f"gradient and steps: {launched}")
    for pid, r in enumerate(recs):  # where the phase's wall goes, process by process
        parts = {"start-up": r["started_at"] - launched_at, **r["parts_s"]}
        print(f"[moe-train] process {pid}'s seconds: "
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
              + f"; the rest (exit, the launcher) {wall - sum(parts.values()):.1f}")
    _profiled_steps("moe-train", meta, (MOE_PROCESSES, MOE_UNITS), 1, recs,
                    moe_collectives(r0), "float32", smi)
    print(f"[moe-train] phase 6c with the profiled step and the count on meta: "
          f"{time.perf_counter() - t0:.1f} s")
    return launched


def moe_train_config(layers: int):
    """The driver's ``moe_train`` config: OLMoE-1B-7B at full width, ``layers``
    of its 16, f32, expert-parallel, ``remat="block"``, flash."""
    from repro_torch.configs import get_config

    return get_config("olmoe-1b-7b").scaled(num_layers=layers, moe_impl="ep_shardmap",
                                            remat="block", attn_impl="flash", dtype="float32",
                                            param_dtype="float32")


def moe_collectives(rec: dict) -> dict:
    """What a sharded MoE step hands the pod hop, by kind: the replicated
    gradient (with the loss and the norm's scalar) in all-reduces, and 6
    expert-parallel trips a layer (dispatch and combine, their remat
    recompute, their backward) as the scheduled sends."""
    return {"all-reduce": rec["replicated_bytes"],
            "collective-permute": 6 * rec["layers"] * rec["trip_bytes"]}


def _rel_err(got, want) -> float:
    """``max |got - want|`` over the largest ``|want|``."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _prefill_count(cfg, nb: int, length: int) -> int:
    """The dry run's counter (``launch/op_cost.py``) on ``meta``: the most
    bytes a prefill of ``nb`` x ``length`` tokens holds at once, plus the
    params' bytes, which ``torch.cuda.max_memory_allocated`` sees too."""
    import torch

    from repro_torch.launch import op_cost
    from repro_torch.models import registry
    from repro_torch.tree import leaves

    params, _ = registry.param_shape_specs(cfg)
    tokens = torch.empty((nb, length), dtype=torch.int32, device="meta")
    with torch.no_grad():
        res = op_cost.analyze(registry.build(cfg).prefill, params, {"tokens": tokens})
    return res["peak_live_bytes"] + sum(t.numel() * t.element_size() for t in leaves(params))


def _ssm_check(api32, params, seed: int, arch: str, nb: int, full: int, split: int,
               smi: str) -> None:
    """In f32 compute: one prefill of ``nb`` prompts of ``full`` tokens
    against a prefill of their first ``split`` followed by one decode step a
    token (the plain recurrence ``ssd_step``).  The last logits and every
    layer's SSM state must agree within ``SSM_CHECK_TOL`` of the largest
    magnitude: the two sides differ only in f32 rounding, compounded through
    the layers (and, at batch 1, through the chunks of a long prompt).  The
    check's peak memory is printed beside the full prefill's count on
    ``meta``."""
    import numpy as np
    import torch

    from repro_torch.serve import grow_cache
    from repro_torch.tree import leaves_with_paths

    counted = _prefill_count(api32.cfg, nb, full)
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(0, api32.cfg.vocab_size, (nb, full), dtype=np.int32)).cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want_logits, want_cache = api32.prefill(params, {"tokens": tokens})
    _, cache = api32.prefill(params, {"tokens": tokens[:, :split]})
    cache = grow_cache(api32, cache, nb, full)
    for pos in range(split, full):
        logits, cache = api32.decode_step(params, tokens[:, pos : pos + 1], cache, pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(logits).all() and torch.isfinite(want_logits).all()):
        raise AssertionError(f"{arch} f32 check: non-finite logits")
    err_logits = _rel_err(logits, want_logits)
    want_states = {p: w for p, w in leaves_with_paths(want_cache) if "ssm" in p}
    err_state = 0.0
    for path, got in leaves_with_paths(cache):
        if "ssm" in path:
            flat_got = got.reshape(-1, *got.shape[-4:])
            flat_want = want_states[path].reshape(flat_got.shape)
            err_state = max(err_state, *(_rel_err(g, w) for g, w in zip(flat_got, flat_want)))
    n_states = sum(w.reshape(-1, *w.shape[-4:]).shape[0] for w in want_states.values())
    print(f"[ssm] {arch} f32 check: prefill of {nb} x {full} against a prefill of {split} "
          f"and {full - split} decode steps (the last at position {full - 1}): last logits rel "
          f"err {err_logits:.3g}, the worst of {n_states} layers' SSM states {err_state:.3g} "
          f"(limit {SSM_CHECK_TOL}); {wall:.2f} s; peak torch.cuda.max_memory_allocated {peak} B "
          f"against {counted} B counted on meta (the f32 prefill's peak live + params) ({smi})")
    if err_logits > SSM_CHECK_TOL or err_state > SSM_CHECK_TOL:
        raise AssertionError(f"{arch}: prefill and prefill + decode disagree beyond "
                             f"{SSM_CHECK_TOL}")


def _ssm_serve(api, params, rng, arch: str, tag: str, n: int, plen: int, new: int, batch: int,
               keep: dict | None = None) -> dict:
    """``n`` requests of ``plen`` random tokens and ``new`` new ones through
    the static engine at ``batch``: ``ssd_scan`` once a layer a prefill,
    every request its tokens.  With ``keep``, ``keep["cache"]`` is the last
    prefill's cache (the engine's decode steps update it in place).
    Returns every kernel's launches over the run."""
    import dataclasses

    import numpy as np

    from repro_torch.serve import Request, ServeEngine

    prefill = api.prefill
    if keep is not None:
        def prefill(params, batch_, **kw):
            logits, keep["cache"] = api.prefill(params, batch_, **kw)
            return logits, keep["cache"]

    cfg, L = api.cfg, api.cfg.num_layers  # every layer of both models is a Mamba2 layer
    t_api = _timed_api(dataclasses.replace(api, prefill=prefill))
    engine = ServeEngine(t_api, batch_size=batch, capacity=plen + new)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, plen, dtype=np.int32),
                    max_new_tokens=new) for _ in range(n)]
    _reset_counts()
    for i in range(0, n, batch):
        engine.generate(params, reqs[i : i + batch])
    counts = _counts()
    if counts["ssd_scan"] != L * t_api.prefill.calls:
        raise AssertionError(f"{arch} {tag}: ssd_scan launched {counts['ssd_scan']} times, "
                             f"expected {L} x {t_api.prefill.calls} prefills")
    if not all(len(r.out_tokens) == new and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
               for r in reqs):
        raise AssertionError(f"{arch} {tag}: a request did not get {new} tokens")
    _serving_line(f"{arch} {tag}", t_api, reqs, engine.stats)
    print(f"[ssm] {arch} {tag}: ssd_scan launched {counts['ssd_scan']} = {L} layers x "
          f"{t_api.prefill.calls} prefills; prefill {1e3 * t_api.prefill.seconds / t_api.prefill.calls:.1f} "
          f"ms a call")
    return counts


def _long_500k(api, params, rng, smi: str) -> dict:
    """The reference's ``long_500k`` cell for Mamba2-1.3B: one request of
    524,288 tokens and 8 new through the static engine (each layer's scan
    one ``ssd_scan`` launch over 2,048 chunks), its peak memory beside the
    prefill's count on ``meta``; then, holding only the params and the
    cache, one ``decode_step`` at position 524,287, its peak beside the dry
    run's count of the cell (arguments + peak live).  Returns every kernel's
    launches over the serving run."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    arch, shape = api.cfg.name, SHAPES["long_500k"]
    plen, new = SSM_500K
    counted = _prefill_count(api.cfg, 1, plen)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    keep = {}
    counts = _ssm_serve(api, params, rng, arch, f"1 x {plen} + {new} new (long_500k)", 1, plen,
                        new, 1, keep=keep)
    peak = torch.cuda.max_memory_allocated()
    print(f"[ssm] {arch} long_500k: peak torch.cuda.max_memory_allocated {peak} B over the run "
          f"({before} B allocated before it) against {counted} B counted on meta (the "
          f"{api.cfg.dtype} prefill's peak live + params) ({smi})")
    cache = keep.pop("cache")
    cell = dryrun.count_cell(api.cfg, shape, 1, 8)
    token = torch.zeros((1, 1), dtype=torch.int32, device=cache["ssm"].device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = api.decode_step(params, token, cache, shape.seq_len - 1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (1, api.cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} long_500k decode step: logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    print(f"[ssm] {arch} long_500k decode step at position {shape.seq_len - 1}: {ms:.2f} ms; "
          f"peak torch.cuda.max_memory_allocated {peak} B ({before} B of params and cache "
          f"before it) against the dry run's {cell['argument_bytes'] + cell['peak_live_bytes']} B "
          f"(arguments {cell['argument_bytes']} + peak live {cell['peak_live_bytes']}; "
          f"{cell['flops']} flops) ({smi})")
    del cache, logits
    torch.cuda.empty_cache()
    return counts


def _ssm_model(arch: str, seed: int, smi: str) -> dict:
    """One SSM model at full width through the static engine.  Returns
    every kernel's launches over its serving runs (the main path)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    api = registry.build(cfg)
    t0 = time.perf_counter()
    params = api.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"[ssm] {arch}: {cfg.num_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"H={cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} "
          f"P={cfg.ssm_head_dim} N={cfg.ssm_state} chunk {cfg.ssm_chunk}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype} compute; {n_params} f32 params ({4 * n_params} B) "
          f"from seed {seed} in {time.perf_counter() - t0:.2f} s")
    n_req, plen, new, batch = SSM_SERVE[arch]
    rng = np.random.default_rng(seed)
    runs = [(f"{n_req} x {plen} + {new} new, batch {batch}", n_req, plen, new, batch)]
    if arch == "mamba2-1.3b":
        runs.append((f"1 x {SSM_LONG[0]} + {SSM_LONG[1]} new", 1, *SSM_LONG, 1))
    main_path = dict.fromkeys(_counts(), 0)
    for tag, n, plen_r, new_r, b in runs:
        for k, v in _ssm_serve(api, params, rng, arch, tag, n, plen_r, new_r, b).items():
            main_path[k] += v
    print(f"[ssm] {arch}: torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    if arch == "mamba2-1.3b":
        for k, v in _long_500k(api, params, rng, smi).items():
            main_path[k] += v
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, plen), dtype=np.int32)).cuda()
    _profile_call(f"{arch} prefill [{batch}, {plen}]",
                  lambda: api.prefill(params, {"tokens": tokens}),
                  kernel=("ssd_", "ssd_scan"), top=10)
    cache = api.init_cache(batch, plen + 1)
    _profile_call(f"{arch} decode step B={batch}",
                  lambda: api.decode_step(params, tokens[:, :1], cache, plen),
                  kernel=("ssd_", "ssd_scan"), top=5)
    del cache
    torch.cuda.empty_cache()
    api32 = registry.build(cfg.scaled(dtype="float32"))
    for nb, full, split in SSM_CHECK[arch]:
        _ssm_check(api32, params, seed, arch, nb, full, split, smi)
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return main_path


def phase_ssm(seed: int, smi: str) -> dict:
    """Mamba2-1.3B (with the ``long_500k`` cell), then Zamba2-7B; every
    kernel's launches over both."""
    t_phase = time.perf_counter()
    runs = [_ssm_model(arch, seed, smi) for arch in SSM_SERVE]
    print(f"[ssm] phase 7 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {k: sum(r[k] for r in runs) for k in runs[0]}


@contextlib.contextmanager
def _plain_scan():
    """``mamba2.ssd_chunked`` as the plain scan, forward and backward through
    ``ref.ssd_scan_ref``, while the block lasts: the check's other side."""
    from repro_torch.kernels import ref
    from repro_torch.models import mamba2 as MB

    real = MB.ssd_chunked
    MB.ssd_chunked = ref.ssd_scan_ref
    try:
        yield
    finally:
        MB.ssd_chunked = real


@contextlib.contextmanager
def _ranged_scan_backward():
    """``_SSDScan.backward`` (the recompute and autograd through the plain
    scan) inside ``record_function(SSD_BACKWARD_SPAN)`` while the block
    lasts, so a profile gives its device time."""
    import torch
    from repro_torch.models import mamba2 as MB

    real = MB._SSDScan.backward

    def backward(ctx, *grads):
        with torch.profiler.record_function(SSD_BACKWARD_SPAN):
            return real(ctx, *grads)

    MB._SSDScan.backward = staticmethod(backward)
    try:
        yield
    finally:
        MB._SSDScan.backward = staticmethod(real)


def _scan_vs_plain(step_fn, state, batch, tag: str, rtol_loss: float, rtol_norm: float) -> None:
    """One step from one state and batch through the kernel and through the
    plain scan: the loss and the grad norm within the given rtols; the
    kernel step launches ``ssd_scan`` twice a layer (forward and remat
    recompute), the plain step never.  A check: its launches join no main
    path."""
    per_step = 2 * len(state.params["layers"])
    _reset_counts()
    m_kern = step_fn(state, batch)[1]
    kern = _counts()["ssd_scan"]
    with _plain_scan():
        m_plain = step_fn(state, batch)[1]
    plain = _counts()["ssd_scan"] - kern
    if kern != per_step or plain:
        raise AssertionError(f"{tag}: ssd_scan launched {kern} times in the kernel step and "
                             f"{plain} in the plain one, expected {per_step} and 0")
    got = [float(m_kern[k]) for k in ("loss", "grad_norm")]
    want = [float(m_plain[k]) for k in ("loss", "grad_norm")]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"[ssm-train] {tag} kernel vs plain scan, one step from one state and batch of "
          f"{tuple(batch['tokens'].shape)}: loss {got[0]:.6f} vs {want[0]:.6f} (rel {rel[0]:.3g}, "
          f"rtol {rtol_loss:.3g}), grad norm {got[1]:.6f} vs {want[1]:.6f} (rel {rel[1]:.3g}, "
          f"rtol {rtol_norm:.3g})")
    if rel[0] > rtol_loss or rel[1] > rtol_norm:
        raise AssertionError(f"{tag}: the kernel and the plain scan disagree beyond rtol "
                             f"{rtol_loss:.3g} / {rtol_norm:.3g}")


def phase_ssm_training(seed: int) -> dict:
    """Mamba2-1.3B at full width and depth: 4 steps, one profiled step, one
    step against the plain scan in bf16 and one in f32; Zamba2-7B at full
    width and 13 layers: 5 steps; the CLI: 2 steps.  Returns every kernel's
    launches over the three runs (the main path)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    B, S, steps = SSM_TRAIN
    cfg = get_config("mamba2-1.3b")
    state, step_fn, opt, next_batch, launches = _train_run(
        cfg, seed, steps, "mamba2", shape=(B, S), kernel="ssd_scan", tail=steps - 1)
    batch = next_batch()
    with _ranged_scan_backward():
        _profile_call(f"mamba2 train step [{B}, {S}]", lambda: step_fn(state, batch),
                      kernel=("ssd_", "ssd_scan"), top=10, span=SSD_BACKWARD_SPAN)
    _scan_vs_plain(step_fn, state, batch, f"mamba2 {cfg.dtype}", *TRAIN_BF16_RTOL)
    nb, rtol_loss, rtol_norm = SSM_TRAIN_F32
    step32 = make_train_step(registry.build(cfg.scaled(dtype="float32")), opt)
    _scan_vs_plain(step32, state, {k: v[:nb] for k, v in batch.items()}, "mamba2 float32",
                   rtol_loss, rtol_norm)
    del state, batch, step_fn, step32, next_batch
    torch.cuda.empty_cache()

    layers, zb, zsteps = ZAMBA_TRAIN
    zcfg = get_config("zamba2-7b").scaled(num_layers=layers)
    zstate, *_, z_launches = _train_run(zcfg, seed, zsteps, f"zamba2 ({layers} layers)",
                                        shape=(zb, S), kernel="ssd_scan")
    del zstate
    torch.cuda.empty_cache()

    cli_steps, cli_seq, cli_batch = SSM_TRAIN_CLI
    argv = ["--arch", "mamba2-1.3b", "--steps", str(cli_steps), "--seq-len", str(cli_seq),
            "--batch", str(cli_batch)]
    _reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        st, last = train_cli.main(argv)
    cli = _counts()
    want = 2 * cfg.num_layers * cli_steps
    if int(st.step) != cli_steps or not math.isfinite(last["loss"]) or cli["ssd_scan"] != want:
        raise AssertionError(f"the CLI ({' '.join(argv)}): step {int(st.step)}, loss "
                             f"{last.get('loss')}, ssd_scan launched {cli['ssd_scan']} times "
                             f"(expected {want}):\n{out.getvalue()}")
    print(f"[ssm-train] CLI {' '.join(argv)}: {time.perf_counter() - t0:.2f} s, last loss "
          f"{last['loss']:.6f}, ssd_scan launched {cli['ssd_scan']}")
    del st
    torch.cuda.empty_cache()
    runs = (launches, z_launches, cli)
    print(f"[ssm-train] phase in {time.perf_counter() - t_phase:.1f} s; ssd_scan launches "
          f"{' + '.join(str(r['ssd_scan']) for r in runs)}")
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def _tf_config(arch: str):
    """The config phase 9 runs: full width, ``TF_CONFIGS``' depth and
    param dtype."""
    from repro_torch.configs import get_config

    layers, pdtype = TF_CONFIGS[arch]
    cfg = get_config(arch).scaled(param_dtype=pdtype)
    return cfg.scaled(num_layers=layers) if layers else cfg


def _tf_check(api32, params, seed: int, arch: str, extra: dict) -> None:
    """In f32 compute at batch 1: a prefill of ``TF_CHECK[0]`` tokens (after
    the VLM's patch rows) against a prefill of the first ``TF_CHECK[1]`` and
    one decode step a token.  The last logits and every cache leaf (KV, or
    MLA's compressed ``c`` and ``kr``) within ``TF_CHECK_TOL`` of the largest
    magnitude: the two differ only in f32 rounding."""
    import numpy as np
    import torch

    from repro_torch.serve import grow_cache
    from repro_torch.tree import leaves_with_paths

    full, split = TF_CHECK
    side = extra["patches"].shape[1] if extra else 0
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(0, api32.cfg.vocab_size, (1, full),
                                           dtype=np.int32)).cuda()
    t0 = time.perf_counter()
    want_logits, want_cache = api32.prefill(params, {"tokens": tokens, **extra})
    _, cache = api32.prefill(params, {"tokens": tokens[:, :split], **extra})
    cache = grow_cache(api32, cache, 1, side + full)
    for pos in range(split, full):
        logits, cache = api32.decode_step(params, tokens[:, pos : pos + 1], cache, side + pos)
    wall = time.perf_counter() - t0
    if not (torch.isfinite(logits).all() and torch.isfinite(want_logits).all()):
        raise AssertionError(f"{arch} f32 check: non-finite logits")
    err_logits = _rel_err(logits, want_logits)
    want = dict(leaves_with_paths(want_cache))
    errs = {"/".join(map(str, p)): _rel_err(got, want[p]) for p, got in leaves_with_paths(cache)}
    worst = max(errs, key=errs.get)
    print(f"[tf] {arch} f32 check: prefill of 1 x {full}{f' after {side} patch rows' if side else ''} "
          f"against {split} + {full - split} decode steps: last logits rel err {err_logits:.3g}, "
          f"worst of {len(errs)} cache leaves {errs[worst]:.3g} ({worst}; limit {TF_CHECK_TOL}); "
          f"{wall:.2f} s")
    if err_logits > TF_CHECK_TOL or errs[worst] > TF_CHECK_TOL:
        raise AssertionError(f"{arch}: prefill and prefill + decode disagree beyond "
                             f"{TF_CHECK_TOL}")


def _tf_model(arch: str, seed: int, smi: str) -> dict:
    """One transformer config at full width through both engines (a uniform
    workload), the expert-parallel model over ``TF_EP_UNITS`` simulated
    units, then the f32 check.  Returns every kernel's launches
    over its continuous runs (the main path)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.core.exchange import make_mesh
    from repro_torch.core.multiplexer import use_multiplexer
    from repro_torch.distributed.sharding import MeshContext, mesh_context
    from repro_torch.models import registry
    from repro_torch.configs import get_config
    from repro_torch.models.registry import VLM_PATCHES
    from repro_torch.models.transformer import segments_for
    from repro_torch.serve import ContinuousEngine, Request, ServeEngine
    from repro_torch.tree import leaves

    t_model = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _tf_config(arch)
    api = registry.build(cfg)
    ep = cfg.moe_impl == "ep_shardmap"
    n_req, plen, new, B = TF_SERVE
    B = TF_EP_UNITS if ep else B
    t0 = time.perf_counter()
    params = api.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{arch}: {n_params} params, param_count says {cfg.param_count()}")
    full_layers = get_config(arch).num_layers
    print(f"[tf] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{'MLA' if cfg.attn_kind == 'mla' else f'{cfg.num_heads}/{cfg.num_kv_heads} heads'}"
          f"{', M-RoPE' if cfg.rope_kind == 'mrope' else ''}{', q/k/v biases' if cfg.qkv_bias else ''}"
          f"{f', {cfg.num_experts} experts top-{cfg.top_k} + {cfg.num_shared_experts} shared' if cfg.num_experts else ''}, "
          f"vocab {cfg.vocab_size}; {n_params} {cfg.param_dtype} params "
          f"({n_params * {'float32': 4, 'bfloat16': 2}[cfg.param_dtype]} B; "
          f"{'all' if cfg.num_layers == full_layers else 'cut from'} {full_layers} layers), "
          f"{cfg.dtype} compute, from seed {seed} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    side = min(VLM_PATCHES, plen // 2) if cfg.family == "vlm" else 0
    extra = ({"patches": rng.standard_normal((B, side, cfg.d_model)).astype(np.float32)}
             if side else None)
    cap = plen + new + 1 + side
    prompts = [rng.integers(0, cfg.vocab_size, plen, dtype=np.int32) for _ in range(n_req)]
    main_path = dict.fromkeys(_counts(), 0)
    L = sum(seg.count for seg in segments_for(cfg) if seg.kind == "moe")

    def continuous(reqs, tag):
        """A continuous run on the main path: counts set to 0 just before it
        and read just after; under EP ``moe_dispatch`` once per MoE layer of
        every prefill group and decode step."""
        t_api = _timed_api(api)
        _reset_counts()
        ce = ContinuousEngine(t_api, batch_size=B, capacity=cap)
        ce.serve(params, reqs, extra_inputs=extra)
        counts = _counts()
        want = L * (ce.stats["prefill_calls"] + ce.stats["decode_steps"]) if ep else 0
        if counts["moe_dispatch"] != want or (ep and ce.mux.pack_impl != "cuda"):
            raise AssertionError(f"{arch} {tag}: moe_dispatch launched {counts['moe_dispatch']} "
                                 f"times, expected {want}")
        for k, v in counts.items():
            main_path[k] += v
        return ce, t_api

    def static(reqs, tag):
        t_api = _timed_api(api)
        _reset_counts()
        se = ServeEngine(t_api, batch_size=B, capacity=cap)
        for i in range(0, len(reqs), B):
            se.generate(params, reqs[i : i + B], extra_inputs=extra)
        if _counts()["moe_dispatch"] != 0:
            raise AssertionError(f"{arch} {tag}: the static engine launched moe_dispatch")
        return se, t_api

    scope = (mesh_context(MeshContext(make_mesh(TF_EP_UNITS))) if ep
             else contextlib.nullcontext())
    with scope:
        # -- uniform: static vs continuous, identical greedy tokens ----------
        reqs_s = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
        se, s_api = static(reqs_s, "uniform")
        _serving_line(f"{arch} uniform static", s_api, reqs_s, se.stats)
        reqs_c = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
        ce, c_api = continuous(reqs_c, "uniform")
        _serving_line(f"{arch} uniform continuous", c_api, reqs_c, ce.stats)
        if [r.out_tokens for r in reqs_c] != [r.out_tokens for r in reqs_s]:
            raise AssertionError(f"{arch}: continuous and static greedy tokens differ")
        if not all(len(r.out_tokens) == new for r in reqs_c):
            raise AssertionError(f"{arch}: a uniform request did not get {new} tokens")
        print(f"[tf] {arch} uniform: static and continuous greedy tokens identical ({n_req} x "
              f"{new}, batch {B}{f', {side} patch rows' if side else ''}); prefill "
              f"{1e3 * c_api.prefill.seconds / c_api.prefill.calls:.2f} ms a call, decode "
              f"{1e3 * c_api.decode_step_slots.seconds / c_api.decode_step_slots.calls:.2f} ms a "
              f"step (continuous), {1e3 * s_api.decode_step.seconds / s_api.decode_step.calls:.2f} "
              f"(static)"
              + (f"; moe_dispatch launched {L} MoE layers x ({ce.stats['prefill_calls']} prefills "
                 f"+ {ce.stats['decode_steps']} decode steps), 0 in the static run; knobs "
                 f"{ce.mux.describe()}" if ep else ""))

        # -- EP: one prefill's logits, kernel pack vs plain pack, bit for bit
        if ep:
            batch = {"tokens": torch.from_numpy(np.stack(prompts[:B])).cuda()}
            with use_multiplexer(ce.mux):
                k_logits, _ = api.prefill(params, batch)
            with use_multiplexer(dataclasses.replace(ce.mux, pack_impl="torch")):
                p_logits, _ = api.prefill(params, batch)
            if not torch.equal(k_logits, p_logits) or not torch.isfinite(k_logits).all():
                raise AssertionError(f"{arch}: prefill logits differ between the packs")
            print(f"[tf] {arch}: prefill logits [{B}, {cfg.vocab_size}] bit-identical, kernel "
                  f"pack vs plain pack over {TF_EP_UNITS} units; all finite")
            del k_logits, p_logits, batch

    peak = torch.cuda.max_memory_allocated()

    # -- f32: prefill against prefill + decode (the exact MoE path) ----------
    api32 = registry.build(cfg.scaled(dtype="float32", moe_impl="dense"))
    _tf_check(api32, params, seed, arch,
              {"patches": torch.from_numpy(extra["patches"][:1]).cuda()} if side else {})
    print(f"[tf] {arch}: peak torch.cuda.max_memory_allocated {peak} B over serving, "
          f"{torch.cuda.max_memory_allocated()} B with the f32 check ({smi}); "
          f"{time.perf_counter() - t_model:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return main_path


def phase_transformers(seed: int, smi: str) -> dict:
    """The six transformer configs of ROADMAP A.12, one at a time, each freed
    before the next loads; every kernel's launches over their main paths."""
    t_phase = time.perf_counter()
    runs = [_tf_model(arch, seed, smi) for arch in TF_CONFIGS]
    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    print(f"[tf] phase 9 in {time.perf_counter() - t_phase:.1f} s; launches over the main "
          f"path: {total}")
    return total


def _tensor_cluster(procs: int, units: int, cell: str, mixed: tuple | None,
                    extra: tuple = ()) -> tuple[list, float, float]:
    """The ``tensor_serve`` scenario of ``tests/_torch_multiproc_driver.py``
    over ``procs`` worker processes of ``units`` units on this card (Gloo):
    ``cell`` through the static engine, then ``mixed`` (slots x requests x
    new, prompt lengths, arrivals a step; ``None``: none) through the
    continuous one, each against process 0's one-process engines on the
    whole tree, with the driver's ``extra`` arguments; every gate asserted in
    the workers.  Returns each process's record, the launch's wall clock at
    its start and its seconds."""
    import shutil

    from repro_torch.launch.cluster import run_local_cluster

    dump = tempfile.mkdtemp(prefix="chip_smoke_tensor_")
    t0, launched_at = time.perf_counter(), time.time()
    if mixed is not None:
        shape, prompts, rate = mixed
        extra = ("--tp-mixed", shape, "--serve-prompts", prompts, "--serve-rate", rate) + extra
    try:
        outs = run_local_cluster(
            [str(ROOT / "tests" / "_torch_multiproc_driver.py"), "tensor_serve", "--tp-full",
             "--tp-cells", cell, "--tp-ref", "whole", "--tp-dtype", "float32",
             "--tp-param-dtype", "float32", *extra, "--dump", dump],
            num_processes=procs, local_units=units, timeout_s=TP_TIMEOUT_S, echo=False,
            backend="gloo", device="cuda", env=SHARED_CARD_ENV,
        )
        recs = [json.loads(Path(dump, f"p{p}.json").read_text())["results"]["tensor_serve"]
                for p in range(procs)]
    finally:
        shutil.rmtree(dump, ignore_errors=True)
    for pid, out in enumerate(outs):
        if "PASS tensor_serve" not in out:
            raise AssertionError(f"tensor-serve process {pid}: no PASS\n{out[-4000:]}")
    for pid, rec in enumerate(recs):
        rec["launched_at"] = launched_at
    return recs, launched_at, time.perf_counter() - t0


def _heads_line(ls: dict) -> str:
    """What a process holds of a cell's attention, from its leaf shapes."""
    if "seg0/0/attn/wk_b" in ls:  # MLA
        return (f"{ls['seg0/0/attn/wq'][1]} MLA heads of wq, wk_b, wv_b and wo, wkv_a "
                f"{ls['seg0/0/attn/wkv_a']} and the compressed cache whole")
    if "encoder/0/attn/wq" in ls:  # the encoder-decoder
        return (f"{ls['encoder/0/attn/wq'][1]} q and {ls['encoder/0/attn/wk'][1]} kv heads in "
                "each of its three attentions")
    return f"{ls['seg0/0/attn/wq'][1]} q and {ls['seg0/0/attn/wk'][1]} kv heads"


def _tensor_lines(tag: str, recs: list, procs: int, smi: str) -> dict:
    """Check and print one tensor-parallel cluster's dumps: the static run
    and the continuous one against process 0's one-process engines (a
    family the continuous engine refuses: its refusal under the tensor
    table), each process's pod hop against the count from the shapes, its
    kernels' launches against what its runs imply; the continuous run must
    leave no slot leak and take fewer slot-steps than ``generate_bucketed``.
    Returns the launches over the tensor runs (the main path) by kernel and
    cell."""
    launched = {}
    for arch, r0 in recs[0]["archs"].items():
        B, S, new = r0["shape"]
        one, c0 = r0["one_process"], r0.get("continuous")
        oc = c0["one_process"] if c0 is not None else None
        if not (r0["rows"] == "tensor" and r0["logits_close"] and r0["tokens_equal"]
                and r0["params_equal_slices"]
                and (c0 is not None or "continuous_refused" in r0)
                and (c0 is None or (
                    c0["rows"] == "tensor" and oc["logits_close"] and oc["tokens_equal"]
                    and oc["steps_equal"] and oc["stats_equal"] and oc["spans_equal"]
                    and oc["drops_equal"] and c0["leak_free"] and c0["uniform_equal_static"]
                    and c0["stats"]["slot_steps"] < c0["bucketed"]["slot_steps"]))):
            raise AssertionError(f"{tag} {arch}: against the one-process engines "
                                 f"{ {k: v for k, v in r0.items() if k != 'leaf_shapes'} }")
        ls = r0["leaf_shapes"]
        experts = next((f", {ls[k][0]} of {ls[k.replace('w_gate', 'router')][1]} experts"
                        for k in ("seg0/0/ffn/w_gate", "seg1/0/ffn/w_gate")
                        if k.replace("w_gate", "router") in ls), "")
        print(f"{tag} {arch} full width, {r0['layers']} layers, f32 (TF32 off), "
              f"attn_impl={r0['attn_impl']}: {B} x {S}-token prompts + {new} new over "
              f"{procs} processes on this card over Gloo ({r0['rows']}: {_heads_line(ls)}"
              f"{experts} a process); greedy tokens equal to process 0's one-process engine on "
              f"the whole tree; logits within max |err| {max(r0['logit_abs']):.3g} (allclose "
              f"rtol = atol = {r0['tol']}) over {len(r0['logit_abs'])} calls; MoE paths "
              f"{r0['paths']}; process 0's params equal the whole tree's slices ({smi})")
        print(f"{tag} {arch} one process (whole tree): prefill "
              f"{one['prefill_s'][0] * 1e3:.1f} ms, decode {sum(one['decode_s']) * 1e3:.1f} ms "
              f"over {len(one['decode_s'])} steps, peak {one['peak']} B, launches "
              f"{one['launches']}")
        if c0 is None:
            print(f"{tag} {arch} continuous: refused under the tensor table, as the "
                  f"reference's engine refuses the family: {r0['continuous_refused']}")
        else:
            slots, n_req, cnew = c0["shape"]
            print(f"{tag} {arch} continuous: {slots} slots, {n_req} mixed requests (prompts "
                  f"{c0['prompts']}, 1-{cnew} new, {c0['rate']} a step) in {c0['groups']} "
                  f"prefill groups and {c0['stats']['decode_steps']} decode steps: tokens, "
                  f"admission and finish steps, stats, spans and drops "
                  f"({sum(oc.get('drops') or [])} rows over {len(oc.get('drops') or [])} "
                  f"expert-parallel calls) equal to process 0's one-process continuous engine; "
                  f"first-token logits of each prefill group within max |err| "
                  f"{max(oc['prefill_logit_abs']):.3g}, every call's served rows "
                  f"{max(oc['logit_abs']):.3g} (allclose {r0['tol']}), every row's (padding and "
                  f"dead slots too) {max(oc['all_rows_logit_abs']):.3g}; no slot leak, no row "
                  f"moved; slot_steps {c0['stats']['slot_steps']} against generate_bucketed's "
                  f"{c0['bucketed']['slot_steps']}; the static prompts' greedy tokens equal the "
                  f"static engine's; MoE paths {c0['paths']}; multiplexer {c0['mux']}; one "
                  f"process: {r0['one_process_continuous']['record']}")
        got = launched.setdefault(arch, {"flash_attention": 0, "moe_dispatch": 0})
        for pid, rec in enumerate(recs):
            r = rec["archs"][arch]
            c = r.get("continuous")
            h = r["want_hop"]
            n = len(r["decode_s"][-1])
            line = (f"{tag} {arch} process {pid}: static prefill "
                    f"{r['prefill_s'][-1][0] * 1e3:.1f} ms, "
                    f"{1e3 * sum(r['decode_s'][-1]) / max(n, 1):.2f} ms a decode step; pod hop "
                    f"{r['hop_kinds']} = derived {h['all-reduce']} B all-reduce + "
                    f"{h['all-gather']} B all-gather + {h['trips']} B expert trips; params "
                    f"{r['param_bytes_counted']} B and cache {r['cache_bytes_counted']} B "
                    f"counted on meta, peak {r['peak']} B")
            bad = (r["hop_bytes"] != h["total"] or not r["tokens_equal_on_every_process"]
                   or r["launches"]["flash_attention"] != r["want_flash"])
            if c is not None:
                hc = c["want_hop"]
                steps = len(c["decode_s"])
                line += (f"; continuous: prefill groups "
                         f"{[round(p * 1e3, 1) for p in c['prefill_s']]} ms, "
                         f"{1e3 * sum(c['decode_s']) / max(steps, 1):.2f} ms a decode step, "
                         f"record {c['record']}, pod hop {c['hop_bytes']} B = derived "
                         f"{hc['total']} B ({c['hop_kinds']}); cache {c['cache_bytes_counted']} B "
                         f"counted on meta, peak {c['peak']} B")
                bad = bad or (c["hop_bytes"] != hc["total"]
                              or not all(c["equal_on_every_process"].values())
                              or any(c["launches"][k] != v
                                     for k, v in c["want_launches"].items()))
            print(f"{line}; launches static {r['launches']}"
                  + (f", continuous {c['launches']}" if c is not None else "") + f" ({smi})")
            if bad:
                raise AssertionError(f"{tag} {arch} process {pid}: "
                                     f"{ {k: v for k, v in r.items() if k != 'leaf_shapes'} }")
            for k in got:
                got[k] += r["launches"][k] + (c["launches"][k] if c is not None else 0)
    for pid, rec in enumerate(recs):
        parts = {"start-up": rec["started_at"] - rec["launched_at"],
                 **{a: r["seconds"] for a, r in rec["archs"].items()}}
        print(f"{tag} process {pid}'s seconds: "
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return launched


def _summed(by_cell: dict) -> dict:
    """Launches by kernel, summed over a cluster's cells."""
    out: dict = {}
    for launched in by_cell.values():
        for k, v in launched.items():
            out[k] = out.get(k, 0) + v
    return out


def _tensor_ssm_lines(tag: str, recs: list, procs: int, smi: str) -> dict:
    """Check and print phase 9d's dumps: each cell against process 0's
    one-process engine (logits, greedy tokens, the placed params the whole
    tree's slices) and every process's prefill SSM states against its heads
    of the one-process run's; each process's pod hop against the count from
    the shapes, its peak beside its params and cache counted on ``meta``, its
    launches (the workers gate ``ssd_scan`` once a Mamba2 layer and
    ``flash_attention`` once a shared-block call a prefill).  Returns the
    launches over the tensor runs (the main path) by kernel."""
    launched = {"ssd_scan": 0, "flash_attention": 0}
    for arch, r0 in recs[0]["archs"].items():
        B, S, new = r0["shape"]
        one = r0["one_process"]
        if not (r0["rows"] == "tensor" and r0["logits_close"] and r0["tokens_equal"]
                and r0["params_equal_slices"]):
            raise AssertionError(f"{tag} {arch}: against the one-process engine "
                                 f"{ {k: v for k, v in r0.items() if k != 'leaf_shapes'} }")
        ls = r0["leaf_shapes"]
        block = "layers/0/mamba" if "layers/0/mamba/A_log" in ls else "groups/0/0/mamba"
        attn = (f", {ls['shared/attn/wq'][1]} q and {ls['shared/attn/wk'][1]} kv heads at D = "
                f"{ls['shared/attn/wq'][2]}" if "shared/attn/wq" in ls else "")
        print(f"{tag} {arch} full width, {r0['layers']} layers, f32 (TF32 off), "
              f"attn_impl={r0['attn_impl']}: {B} x {S}-token prompts + {new} new over {procs} "
              f"processes on this card over Gloo ({r0['rows']}: {ls[block + '/A_log'][0]} SSM "
              f"heads, in_proj {ls[block + '/in_proj']}{attn} a process); greedy tokens equal to "
              f"process 0's one-process engine on the whole tree; logits within max |err| "
              f"{max(r0['logit_abs']):.3g} (allclose rtol = atol = {r0['tol']}) over "
              f"{len(r0['logit_abs'])} calls; process 0's params equal the whole tree's slices "
              f"({smi})")
        print(f"{tag} {arch} one process (whole tree): prefill {one['prefill_s'][0] * 1e3:.1f} "
              f"ms, decode {sum(one['decode_s']) * 1e3:.1f} ms over {len(one['decode_s'])} steps, "
              f"peak {one['peak']} B, launches {one['launches']}")
        for pid, rec in enumerate(recs):
            r = rec["archs"][arch]
            if not (r["states_close"] and r["tokens_equal_on_every_process"]):
                raise AssertionError(f"{tag} {arch} process {pid}: states {r['state_abs']}, "
                                     f"tokens equal {r['tokens_equal_on_every_process']}")
            h = r["want_hop"]
            print(f"{tag} {arch} process {pid}: prefill {r['prefill_s'][-1][0] * 1e3:.1f} ms, "
                  f"decode {sum(r['decode_s'][-1]) * 1e3:.1f} ms over "
                  f"{len(r['decode_s'][-1])} steps; prefill SSM states within {r['state_abs']} of "
                  f"its heads of the one-process run's (allclose {r['tol']}); pod hop "
                  f"{r['hop_kinds']} = {r['hop_bytes']} B, the shapes' count {h['total']} B "
                  f"({h['reduces_a_call']} all-reduces a prefill); peak {r['peak']} B (params "
                  f"{r['param_bytes_counted']} + cache {r['cache_bytes_counted']} B counted on "
                  f"meta); launches {r['launches']}")
            for k in launched:
                launched[k] += r["launches"][k]
    return launched


class _DeviceMemory:
    """The card's used bytes over a span, every process's together: the
    driver's free-memory count (``torch.cuda.mem_get_info``), polled from a
    thread of this process until :meth:`stop`."""

    def __init__(self, every_s: float = 0.25):
        import threading

        import torch

        self.free, self.total = torch.cuda.mem_get_info()
        self.most = self.total - self.free
        self._stop = threading.Event()
        self._every = every_s
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        import torch

        while not self._stop.wait(self._every):
            free, total = torch.cuda.mem_get_info()
            self.most = max(self.most, total - free)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        return self.most


def phase_tensor_serve(smi: str) -> dict:
    """Tensor-parallel serving on this card over worker processes (Gloo),
    the four clusters at once: phase 9b, DeepSeek-67B at ``TP_CELL`` over
    ``TP_PROCS`` processes, and phase 9c, OLMoE-1B-7B at ``TPM_CELL`` over
    ``TPM_PROCS`` (its experts split), each through both engines against
    process 0's one-process engines (``_tensor_cluster``); phase 9d,
    Mamba2-1.3B and Zamba2-7B at ``TPS_CELLS`` over ``TPS_PROCS`` (their SSM
    heads split) through the static engine; phase 9e, DeepSeek-V2-Lite-16B
    (MLA, both engines) and Whisper-medium (the static engine; the
    continuous one must refuse it) at ``TPE_CELLS`` over ``TPE_PROCS``.  The
    card's used bytes over the phase, every process's together, are printed
    beside the card's size.  Returns the workers' launches over the tensor
    runs (the main path): ``flash_attention[tensor]`` (9b),
    ``flash_attention[tensor-moe]`` and ``moe_dispatch[tensor]`` (9c),
    ``ssd_scan[tensor]`` and ``flash_attention[tensor-ssm]`` (9d),
    ``moe_dispatch[tensor-mla]`` and ``flash_attention[tensor-encdec]``
    (9e)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    memory = _DeviceMemory()
    with ThreadPoolExecutor(4) as pool:
        dense = pool.submit(_tensor_cluster, TP_PROCS, TP_UNITS, TP_CELL, TP_MIXED)
        moe = pool.submit(_tensor_cluster, TPM_PROCS, TPM_UNITS, TPM_CELL, TPM_MIXED)
        ssm = pool.submit(_tensor_cluster, TPS_PROCS, TPS_UNITS, TPS_CELLS, None,
                          ("--tp-states",))
        mla = pool.submit(_tensor_cluster, TPE_PROCS, TPE_UNITS, TPE_CELLS, TPE_MIXED,
                          ("--tp-frames", str(TPE_FRAMES)))
        (b_recs, _, b_wall), (c_recs, _, c_wall) = dense.result(), moe.result()
        (d_recs, _, d_wall), (e_recs, _, e_wall) = ssm.result(), mla.result()
    used = memory.stop()
    b = _summed(_tensor_lines("[tensor-serve]", b_recs, TP_PROCS, smi))
    c = _summed(_tensor_lines("[tensor-moe]", c_recs, TPM_PROCS, smi))
    d = _tensor_ssm_lines("[tensor-ssm]", d_recs, TPS_PROCS, smi)
    e = _tensor_lines("[tensor-mla]", e_recs, TPE_PROCS, smi)
    mla_key, encdec_key = (cell.split(":")[0] for cell in TPE_CELLS.split(","))
    e_mla, e_encdec = e[next(k for k in e if k.startswith(mla_key))], e[encdec_key]
    if c["moe_dispatch"] <= 0:
        raise AssertionError("[tensor-moe] moe_dispatch never launched under the tensor table")
    if d["ssd_scan"] <= 0 or d["flash_attention"] <= 0:
        raise AssertionError(f"[tensor-ssm] a kernel never launched under the tensor table: {d}")
    if e_mla["moe_dispatch"] <= 0 or e_encdec["flash_attention"] <= 0:
        raise AssertionError(f"[tensor-mla] a kernel never launched under the tensor table: {e}")
    print(f"[tensor-serve] phases 9b, 9c, 9d and 9e in {time.perf_counter() - t0:.1f} s at once "
          f"(launcher walls {b_wall:.1f}, {c_wall:.1f}, {d_wall:.1f} and {e_wall:.1f} s); the "
          f"card's used bytes at most {used} B of {memory.total} B over the phase, every "
          f"process's together; launches over the tensor runs: 9b {b}, 9c {c}, 9d {d}, 9e {e}")
    return {"flash_attention[tensor]": b["flash_attention"],
            "flash_attention[tensor-moe]": c["flash_attention"],
            "moe_dispatch[tensor]": c["moe_dispatch"],
            "ssd_scan[tensor]": d["ssd_scan"],
            "flash_attention[tensor-ssm]": d["flash_attention"],
            "moe_dispatch[tensor-mla]": e_mla["moe_dispatch"],
            "flash_attention[tensor-encdec]": e_encdec["flash_attention"]}


def phase_tensor_train(smi: str) -> dict:
    """Dense training on a ``TT_GRID`` (data x model) grid of worker
    processes on this card (Gloo), after phases 9b-9e have freed it: the
    ``grid_train`` scenario of ``tests/_torch_multiproc_driver.py`` at
    Qwen2.5-3B's full width, ``TT_LAYERS`` layers, f32, flash attention,
    ``TT_SHAPE`` tokens, 2 steps, each process drawing its pieces of the
    state already cut.  Rank 0 first takes the one-process steps on the
    whole batch; the workers assert every gate (the loss within rtol 1e-5
    and the grad norm within 1e-4 of it on each step, every gradient piece
    within 1e-4 of its leaf's max, the params after each step within 1e-5,
    rank 0's broadcast a leaf at a time; the replicated leaves bit-identical
    within their groups; each group's bytes by kind equal to the count from
    the shapes; ``flash_attention`` once a layer a forward pass and again in
    the remat recompute).  Printed here from their dumps: the step walls,
    each rank's state bytes beside the whole state's and its peak, the
    groups' bytes.  Returns the workers' ``flash_attention`` launches over
    the grid's gradient and steps (the main path), as
    ``flash_attention[tensor-train]``."""
    import shutil

    from repro_torch.launch.cluster import run_local_cluster

    D, M = TT_GRID
    B, S = TT_SHAPE
    procs = D * M
    dump = tempfile.mkdtemp(prefix="chip_smoke_grid_")
    t0 = time.perf_counter()
    memory = _DeviceMemory()
    try:
        outs = run_local_cluster(
            [str(ROOT / "tests" / "_torch_multiproc_driver.py"), "grid_train", "--grid-full",
             "--grid-cells", f"qwen2.5-3b:{TT_LAYERS}", "--grid-layouts", f"{D}x{M}",
             "--grid-shape", f"{B}x{S}", "--grid-ref", "rank0", "--grid-steps", "2",
             "--dump", dump],
            num_processes=procs, local_units=1, timeout_s=TT_TIMEOUT_S, echo=False,
            backend="gloo", device="cuda",
        )
        recs = [json.loads(Path(dump, f"p{p}.json").read_text())["results"]["grid_train"]
                ["qwen2.5-3b"] for p in range(procs)]
    finally:
        shutil.rmtree(dump, ignore_errors=True)
    used = memory.stop()
    wall = time.perf_counter() - t0
    for pid, out in enumerate(outs):
        if "PASS grid_train" not in out:
            raise AssertionError(f"tensor-train process {pid}: no PASS\n{out[-4000:]}")
    tag = f"{D}x{M}"
    r0, c = recs[0]["layouts"][tag], recs[0]["config"]
    print(f"[tensor-train] Qwen2.5-3B full width (d_model {c['d_model']}, {c['heads']} q and "
          f"{c['kv_heads']} kv heads, d_ff {c['d_ff']}, vocab {c['vocab']}), {c['layers']} of 36 "
          f"layers, {c['dtype']}, remat {c['remat']}, flash; global batch {B} x {S} on a {D} x "
          f"{M} data x model grid of {procs} processes on this card over Gloo ({smi})")
    print(f"[tensor-train] rank 0's one-process step on the whole batch: gradient "
          f"{recs[0]['one_process_grad_s'] * 1e3:.1f} ms (first call), steps "
          + ", ".join(f"{w * 1e3:.1f}" for w in recs[0]["one_process_step_s"])
          + f" ms, peak {recs[0]['one_process_peak']} B; the whole f32 state (params, grads, m, "
          f"v) {recs[0]['whole_state_bytes']} B")
    print(f"[tensor-train] against it: loss rel {r0['loss_rel']:.3g} (1e-5), worst gradient "
          f"piece {r0['grad_rel']:.3g} of its leaf's max (1e-4), steps' loss rel "
          + ", ".join(f"{v:.3g}" for v in r0["step_loss_rel"]) + " (1e-5), grad norm rel "
          + ", ".join(f"{v:.3g}" for v in r0["step_norm_rel"]) + " (1e-4), params within "
          + ", ".join(f"{v:.3g}" for v in r0["params_abs"]) + " (1e-5); losses "
          + ", ".join(f"{m['loss']:.6f}" for m in r0["metrics"]) + " (one process "
          + ", ".join(f"{m['loss']:.6f}" for m in recs[0]["one_process"]) + ")")
    launched = 0
    for pid, rec in enumerate(recs):
        r = rec["layouts"][tag]
        rank_rel = (f"worst gradient piece {r['grad_rel']:.3g}, params within "
                    + ", ".join(f"{v:.3g}" for v in r["params_abs"]))
        print(f"[tensor-train] process {pid} at (data, model) {tuple(r['coords'])}: state "
              f"{r['state_bytes']} B (params, m, v; the whole f32 state with grads "
              f"{rec['whole_state_bytes']} B); create {r['create_s'] * 1e3:.1f} ms; gradient "
              f"{r['grad_s'] * 1e3:.1f} ms (first call); steps "
              + ", ".join(f"{w * 1e3:.1f}" for w in r["step_s"])
              + f" ms; peak {r['peak']} B; {rank_rel}; replicated leaves identical "
              f"{r['identical']}; bytes a step by group and kind {r['step_hop'][0]} (the shapes' "
              f"count {r['hop_want']}); flash_attention {r['grad_launches']} + {r['launches']} "
              f"({smi})")
        launched += r["grad_launches"] + sum(r["launches"])
    if launched <= 0:
        raise AssertionError("[tensor-train] flash_attention never launched on the grid")
    print(f"[tensor-train] phase 9f in {wall:.1f} s; the card's used bytes at most {used} B of "
          f"{memory.total} B, every process's together; flash_attention launches over the "
          f"grid's gradient and steps: {launched}")
    return {"flash_attention[tensor-train]": launched}


def _whisper_check(cfg, params, seed: int) -> None:
    """In f32 compute at batch 1, the model called directly: a prefill of
    the first ``WHISPER_CHECK[1]`` tokens over ``WHISPER_CHECK[0]`` frames,
    then one decode step a token to ``WHISPER_CHECK[0]`` over the unpadded
    cross cache, against ``decode_train`` over the same memory at the last
    position: the logits within ``TF_CHECK_TOL`` of the largest magnitude."""
    import numpy as np
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.models import whisper
    from repro_torch.serve import grow_cache

    full, split = WHISPER_CHECK
    cfg32 = cfg.scaled(dtype="float32")
    api32 = registry.build(cfg32)
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, full), dtype=np.int32)).cuda()
    frames = torch.from_numpy(rng.standard_normal((1, full, cfg.d_model),
                                                  dtype=np.float32)).cuda()
    t0 = time.perf_counter()
    memory = whisper.encode(params, cfg32, frames)
    h = whisper.decode_train(params, cfg32, tokens, memory)
    want = L.unembed(params["embedding"], cfg32, h[:, -1:])[:, 0]
    _, cache = api32.prefill(params, {"tokens": tokens[:, :split], "frames": frames})
    cache = grow_cache(api32, cache, 1, full)  # the self KV grows; the cross KV is full already
    for pos in range(split, full):
        logits, cache = api32.decode_step(params, tokens[:, pos : pos + 1], cache, pos)
    wall = time.perf_counter() - t0
    if not (torch.isfinite(logits).all() and torch.isfinite(want).all()):
        raise AssertionError("whisper f32 check: non-finite logits")
    err = _rel_err(logits, want)
    print(f"[whisper] f32 check: {full} frames; prefill of 1 x {split} + {full - split} decode "
          f"steps over the unpadded cross cache against decode_train at position {full - 1}: "
          f"last logits rel err {err:.3g} (limit {TF_CHECK_TOL}); {wall:.2f} s")
    if err > TF_CHECK_TOL:
        raise AssertionError(f"whisper: decode and decode_train disagree beyond {TF_CHECK_TOL}")


def _whisper_serving(cfg, params, seed: int, smi: str) -> dict:
    """Whisper-medium at full width through the static engine, batch by
    batch and through ``generate_bucketed`` (the same tokens); 24
    non-causal ``flash_attention`` launches a prefill (the encoder), none
    causal (the decoder's prefill runs ``sdpa``, as the reference's); the
    continuous engine refused.  Returns every kernel's launches over both
    runs (a main path)."""
    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.serve import (ContinuousEngine, Request, ServeEngine, generate_bucketed,
                                   grow_cache)

    n_req, plen, new, B = WHISPER_SERVE
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, plen, dtype=np.int32) for _ in range(n_req)]
    extra = {"frames": rng.standard_normal((B, plen, cfg.d_model)).astype(np.float32)}
    cap = plen + new + 1
    api = registry.build(cfg)
    main_path = dict.fromkeys(_counts(), 0)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for tag in ("batches", "bucketed"):
        t_api = _timed_api(api)
        se = ServeEngine(t_api, batch_size=B, capacity=cap)
        reqs = [Request(prompt=p.copy(), max_new_tokens=new) for p in prompts]
        _reset_counts()
        t0 = time.perf_counter()
        if tag == "bucketed":
            generate_bucketed(se, params, reqs, extra_inputs=extra)
        else:
            for i in range(0, n_req, B):
                se.generate(params, reqs[i : i + B], extra_inputs=extra)
        counts = _counts()
        for i, r in enumerate(reqs):  # all queued at t0: the batch's first token
            r.ttft_s = t_api.prefill.ends[i // B] - t0
        for k, v in counts.items():
            main_path[k] += v
        calls = t_api.prefill.calls
        ragged = counts["flash_attention[noncausal]"] if plen % 64 else 0  # a partial tile
        if counts["flash_attention[noncausal]"] != cfg.encoder_layers * calls or \
                counts["flash_attention"] != counts["flash_attention[noncausal]"] or \
                counts["flash_attention[ragged]"] != ragged:
            raise AssertionError(f"whisper {tag}: flash_attention launched {counts} over {calls} "
                                 f"prefills; expected {cfg.encoder_layers} non-causal a prefill, "
                                 f"{'all' if ragged else 'none'} of them ragged")
        if not all(len(r.out_tokens) == new and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
                   for r in reqs):
            raise AssertionError(f"whisper {tag}: a request did not get {new} tokens")
        _serving_line(f"whisper-medium {tag}, {n_req} x {plen} + {plen} frames + {new} new, "
                      f"batch {B}", t_api, reqs, se.stats)
        print(f"[whisper] {tag}: flash_attention launched {counts['flash_attention[noncausal]']} "
              f"times non-causally = {cfg.encoder_layers} encoder layers x {calls} prefills "
              f"({counts['flash_attention[ragged]']} over {plen} frames, a partial tile), "
              f"0 causally; prefill {1e3 * t_api.prefill.seconds / calls:.1f} ms a call, decode "
              f"{1e3 * t_api.decode_step.seconds / t_api.decode_step.calls:.2f} ms a step")
        runs[tag] = reqs
    if [r.out_tokens for r in runs["batches"]] != [r.out_tokens for r in runs["bucketed"]]:
        raise AssertionError("whisper: generate_bucketed's greedy tokens differ")
    try:
        ContinuousEngine(api, batch_size=B, capacity=cap)
    except NotImplementedError as e:
        print(f"[whisper] the continuous engine refuses encdec: {e}")
    else:
        raise AssertionError("whisper: the continuous engine took the encdec family")
    print(f"[whisper] serving: identical greedy tokens batch by batch and through "
          f"generate_bucketed ({n_req} x {new}); peak torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B ({smi})")
    batch = {"tokens": torch.from_numpy(np.stack(prompts[:B])).cuda(),
             "frames": torch.from_numpy(extra["frames"]).cuda()}
    _profile_call(f"whisper prefill [{B}, {plen}]", lambda: api.prefill(params, batch),
                  kernel=("flash_fwd_bf16", "flash_attention"), top=10)
    _, cache = api.prefill(params, batch)
    cache = grow_cache(api, cache, B, cap)
    _profile_call(f"whisper decode step B={B}",
                  lambda: api.decode_step(params, batch["tokens"][:, :1], cache, plen),
                  kernel=("flash_fwd_bf16", "flash_attention"), top=5)
    del cache, batch
    return main_path


def phase_whisper(seed: int, smi: str) -> dict:
    """Whisper-medium at full width and depth (24 + 24 layers, random
    weights from ``seed``, f32 master params, bf16 compute, flash
    attention): static serving, the f32 decode check, 4 train steps with
    96 ``flash_attention`` launches each (48 non-causal), one step against
    chunked attention, one profiled step and the training CLI.  Returns
    every kernel's launches over serving and training (the main path), the
    non-causal ones under ``flash_attention[noncausal]`` and the causal bf16
    ones under ``flash_attention[bfloat16]``."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-medium").scaled(attn_impl="flash")
    api = registry.build(cfg)
    t0 = time.perf_counter()
    params = api.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"whisper: {n_params} params, param_count says {cfg.param_count()}")
    print(f"[whisper] {cfg.name}: {cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params} {cfg.param_dtype} params ({4 * n_params} B) from seed "
          f"{seed} in {time.perf_counter() - t0:.2f} s; {cfg.dtype} compute, "
          f"attn_impl={cfg.attn_impl}")
    serve = _whisper_serving(cfg, params, seed, smi)
    _whisper_check(cfg, params, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    B, S, steps = WHISPER_TRAIN
    state, step_fn, opt, next_batch, train = _train_run(cfg, seed, steps, "whisper bf16",
                                                        shape=(B, S), tail=3)
    want = steps * 2 * cfg.encoder_layers
    if train["flash_attention[noncausal]"] != want:
        raise AssertionError(f"whisper training: {train['flash_attention[noncausal]']} non-causal "
                             f"flash_attention launches, expected {want}")
    print(f"[whisper] training: flash_attention launched {train['flash_attention']} = "
          f"{train['flash_attention[noncausal]']} non-causal (2 x {cfg.encoder_layers} encoder "
          f"layers a step) + {train['flash_attention'] - train['flash_attention[noncausal]']} "
          f"causal (2 x {cfg.num_layers} decoder layers a step) over {steps} steps")
    batch = next_batch()
    _flash_vs_chunked(cfg, opt, step_fn, state, batch, "whisper bf16", *TRAIN_BF16_RTOL)
    _profile_call(f"whisper train step [{B}, {S}]", lambda: step_fn(state, batch),
                  kernel=("flash_fwd_bf16", "flash_attention"), top=10)
    del state, batch, step_fn, next_batch
    gc.collect()
    torch.cuda.empty_cache()

    cli_steps, cli_seq, cli_batch = WHISPER_TRAIN_CLI
    argv = ["--arch", "whisper-medium", "--steps", str(cli_steps), "--seq-len", str(cli_seq),
            "--batch", str(cli_batch), "--seed", str(seed)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        st, last = train_cli.main(argv)
    if int(st.step) != cli_steps or not math.isfinite(last["loss"]):
        raise AssertionError(f"the CLI ({' '.join(argv)}): step {int(st.step)}, loss "
                             f"{last.get('loss')}:\n{out.getvalue()}")
    print(f"[whisper] CLI {' '.join(argv)}: {time.perf_counter() - t0:.2f} s, last loss "
          f"{last['loss']:.6f}")
    del st
    gc.collect()
    torch.cuda.empty_cache()
    total = {k: serve[k] + train[k] for k in serve}
    noncausal = total.pop("flash_attention[noncausal]")
    causal = total.pop("flash_attention") - noncausal
    total.update({"flash_attention": 0, "flash_attention[noncausal]": noncausal,
                  "flash_attention[bfloat16]": causal})
    print(f"[whisper] phase 10 in {time.perf_counter() - t_phase:.1f} s; launches over the main "
          f"path: {total}")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", default=",".join(ALL_RUNS))
    ap.add_argument("--profile", action="store_true",
                    help="profile a third run of each query (device time by kernel)")
    args = ap.parse_args()
    runs = [r for r in args.queries.split(",") if r]
    if unknown := sorted(set(runs) - set(ALL_RUNS)):
        ap.error(f"unknown runs {unknown}; choose from {ALL_RUNS}")

    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # 1. device
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] {kind}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build: one nvcc per source, all at once
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as sk

    libs = (hp.LIBRARY, md.LIBRARY, fa.LIBRARY, sk.LIBRARY)
    t0 = time.perf_counter()
    build.build_all(libs)
    print(f"[build] {len(libs)} libraries built and loaded in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"[build] {lib.info['path']}: nvcc {lib.info['seconds']:.2f} s")
        for line in lib.info["log"].splitlines():
            print(f"[build] {line}")

    # 3. kernels against their plain versions
    kernels = phase_kernels(args.sf, args.seed, smi)

    # 4. queries (the relational main path)
    q_launches, tabs, wants = phase_queries(args.sf, args.seed, runs, args.profile)
    phase_handwritten(tabs, wants, smi)

    # 4b. out-of-core (the streamed relational main path)
    o_launches = phase_oocore(tabs, wants, args.seed)

    # 4c. query serving (the multi-tenant relational main path)
    c_launches, v5e_stream = phase_qserve(tabs, wants, args.seed, smi)

    # 4d. calibration (the measured tuner and serving at the card's prices)
    d_launches, fitted = phase_calibration(tabs, wants, args.seed, smi, v5e_stream)

    # 4e. the pod axis across two processes (the relational main path's process fabric)
    e_launches = phase_cluster(tabs, wants, args.sf, smi, fitted)
    del tabs

    # 5. serving (the MoE main path)
    s_launches = phase_serving(args.seed)

    # 5b. serving with the batch split across two processes
    b_launches = phase_serve_procs(smi)

    # 6. training (the training main path)
    t_launches = phase_training(args.seed)

    # 6b. data-parallel training across two processes (the training main path's sync)
    p_launches = phase_dp_train(smi)

    # 6c. MoE training with its experts sharded across two processes
    x_launches = phase_moe_train(smi)

    # 7. SSM serving (the SSM main path)
    m_launches = phase_ssm(args.seed, smi)

    # 8. SSM training (the SSM training main path)
    r_launches = phase_ssm_training(args.seed)

    # 9. the six transformer configs (the dense, VLM and MLA serving main path)
    f_launches = phase_transformers(args.seed, smi)

    # 9b-9e. tensor-parallel serving across two processes (the dense, MoE and
    # MLA serving main paths with their heads, d_ff, vocab and experts split,
    # through the static and continuous engines; the SSM, hybrid and
    # encoder-decoder ones through the static engine)
    g_launches = phase_tensor_serve(smi)

    # 9f. dense training on a data x model grid of processes (the training
    # main path under the reference's default_rules: heads, d_ff and vocab
    # over the model row, FSDP and the batch over the data column)
    h_launches = phase_tensor_train(smi)

    # 10. Whisper (the encoder-decoder serving and training main path)
    w_launches = phase_whisper(args.seed, smi)
    paths = (q_launches, o_launches, c_launches, d_launches, e_launches, s_launches,
             b_launches, t_launches, p_launches, x_launches, m_launches, r_launches, f_launches,
             g_launches, h_launches, w_launches)
    launches = {k: sum(p.get(k, 0) for p in paths) for k in {k for p in paths for k in p}}
    for k in kernels:
        k["launches"] = launches[k.pop("launch_key", k["name"])]
        if k["launches"] <= 0 and k["name"] not in OFF_PATH:
            raise AssertionError(f"{k['name']} was never launched on the main path")

    # 10-11. results
    print(json.dumps({"kernels": kernels}))
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
