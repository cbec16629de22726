"""Model/shape config dataclasses (port of ``repro.configs.base``).

A copy of the reference's dataclasses: the port keeps its own, so it
imports nothing of the JAX package.  ``param_count`` and
``active_param_count`` count the leaves of the port's own params (built on
the ``meta`` device, so nothing is allocated).  ``SHAPES`` and
:func:`shapes_for` are the reference's assigned shape cells, which the dry
run (:mod:`repro_torch.launch.dryrun`) counts.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A complete architecture description (decoder LM unless noted).

    Only a subset of fields applies per family; unused fields stay at their
    zero defaults.  All assigned configs instantiate this exactly as printed
    on the assignment sheet; reduced smoke variants use ``scaled(...)``.
    """

    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---------------------------------------------------------
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    attn_kind: Literal["gqa", "mla"] = "gqa"
    rope_kind: Literal["rope", "mrope", "sinusoidal", "none"] = "rope"
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w rope splits

    # --- MLA (deepseek-v2) -------------------------------------------------
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # deepseek: layer 0 is a dense FFN
    router_norm_topk: bool = False  # normalize top-k probs to sum 1
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # --- hybrid (zamba2) -----------------------------------------------------
    attn_every: int = 0  # apply the shared attention block every k-th layer

    # --- embeddings / output --------------------------------------------------
    tie_embeddings: bool = False
    emb_scale: float = 1.0        # minicpm scale_emb
    residual_scale: float = 1.0   # minicpm scale_depth / sqrt(num_layers)
    logits_scale: float = 1.0     # minicpm: d_model / dim_model_base
    norm_eps: float = 1e-5
    act: Literal["silu", "gelu"] = "silu"

    # --- enc-dec (whisper) ----------------------------------------------------
    encoder_layers: int = 0
    is_encoder_decoder: bool = False

    # --- training schedule (assignment sheet: minicpm uses WSD) ----------------
    lr_schedule: Literal["cosine", "wsd"] = "cosine"

    # --- execution policy (not architecture) -----------------------------------
    dtype: str = "bfloat16"        # activation/param compute dtype
    param_dtype: str = "float32"   # master params
    scan_layers: bool = True
    remat: Literal["none", "block", "full"] = "block"
    attn_impl: Literal["auto", "sdpa", "chunked", "flash"] = "auto"
    attn_q_block: int = 512
    num_microbatches: int = 1
    moe_impl: Literal["dense", "gspmd", "ep_shardmap"] = "dense"
    exchange_impl: str = "round_robin"
    # Async overlap of exchange with expert compute: split the EP capacity
    # buffers into this many chunks and double-buffer dispatch against the
    # expert FFN (bit-identical for any divisor of the capacity; an ambient
    # multiplexer's tuned pipeline_chunks takes precedence).
    moe_async_chunks: int = 1
    # Unroll factor for the layer scan (transformer decode/prefill) and the
    # microbatch accumulation scan: > 1 interleaves consecutive iterations'
    # HLO so the latency-hiding scheduler can start layer k+1's dispatch
    # while layer k's expert compute runs.  Numerics-neutral.
    overlap_unroll: int = 1
    grad_sync: Literal["auto", "hierarchical"] = "auto"
    # §Perf levers (off in the paper-faithful baseline)
    grad_shard_constraint: bool = False  # pin grads to param sharding (AR->RS)
    uneven_shards: bool = False          # keep constraints on non-divisible dims
    sequence_parallel: bool = False      # residual seq dim -> model (RS/AG not AR)
    dp_only: bool = False                # ZeRO-3: batch over BOTH axes, no TP (dense parts)
    exchange_over_data: bool = False     # EP exchange over the data axis (paper topology)

    # -----------------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) archs."""
        return self.family in ("ssm", "hybrid")

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def param_count(self) -> int:
        """Every parameter of the model (``registry.param_count``)."""
        from ..models import registry  # local import to avoid a cycle

        return registry.param_count(self)

    def active_param_count(self) -> int:
        """The parameters one token uses: expert leaves at ``top_k /
        num_experts`` of their size."""
        from ..models import registry

        return registry.param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (the training data pipeline reads ``seq_len``
    and ``global_batch``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """The assigned shape set for one arch (long_500k only if sub-quadratic)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out


__all__ = ["ModelConfig", "Family", "ShapeSpec", "SHAPES", "shapes_for"]
