"""Zamba2-7B [arXiv:2411.15242]: mamba2 backbone + shared attention block.

81 layers = 13 groups of 6 mamba2 blocks (attn_every=6), each followed by
the ONE weight-shared transformer block, + a 3-layer mamba tail.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_ngroups=1,
    attn_every=6,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=5, attn_every=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=467, ssm_state=16, ssm_head_dim=8,
    ssm_chunk=8, dtype="float32", remat="none",
)
