"""PyTorch/CUDA port of the reproduction of "High-Speed Query Processing
over High-Speed Networks".

The JAX package ``repro`` is the reference; this package mirrors it module
for module and imports nothing of it.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.

- ``core``       — schedules, cost model, tuner, exchange fabric, multiplexer
- ``kernels``    — hand-written Hopper kernels and their plain versions
- ``relational`` — tables, datagen, stats, operators, planner, TPC-H
"""
