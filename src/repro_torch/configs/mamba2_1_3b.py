"""Mamba2-1.3B [arXiv:2405.21060]: pure SSD (state-space duality), attn-free."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,      # attention-free; placeholder
    num_kv_heads=1,
    d_ff=0,           # mamba blocks subsume the FFN
    vocab_size=50_280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_ngroups=1,
    rope_kind="none",
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=64, ssm_state=16, ssm_head_dim=8, ssm_chunk=8,
    vocab_size=491, dtype="float32", remat="none",
)
