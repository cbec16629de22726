"""PyTorch/CUDA port of the reproduction of "High-Speed Query Processing
over High-Speed Networks".

The JAX package ``repro`` is the reference; this package mirrors it module
for module and imports nothing of it.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.

- ``core``        — schedules, cost model, tuner, exchange fabric, multiplexer
- ``kernels``     — hand-written Hopper kernels and their plain versions
- ``relational``  — tables, datagen, stats, operators, planner, TPC-H
- ``configs``     — model configs (OLMoE-1B-7B, train100m)
- ``distributed`` — the mesh context the model code reads
- ``models``      — GQA dense and MoE transformers, expert parallelism over
                    the fabric
- ``serve``       — static and continuous-batching engines
- ``train``       — AdamW, schedules, the microbatched train step
- ``data``        — deterministic token streams and prefetch
- ``checkpoint``  — crash-consistent checkpoints
- ``tree``        — nested containers of tensors (params, optimizer state)
- ``launch``      — command-line serving and training entry points
"""
