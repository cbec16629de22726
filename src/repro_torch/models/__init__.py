"""Models of the port (counterpart of ``repro.models``).

- ``layers``      — norms, RoPE, GQA attention (plain, query-chunked and
                    the flash kernel), MLPs, embeddings, the loss
- ``moe``         — MoE layer: dense oracle and expert parallelism over the
                    simulated fabric (``moe_dispatch`` kernel pack)
- ``transformer`` — the decoder stack: forward and training loss, prefill,
                    decode, per-slot decode
- ``registry``    — the uniform ``ModelApi``
- ``convert``     — the reference's params into the port's layout
"""

from . import convert, layers, moe, registry, transformer

__all__ = ["convert", "layers", "moe", "registry", "transformer"]
