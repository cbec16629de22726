"""Qwen2-VL-2B [arXiv:2409.12191]: M-RoPE backbone; vision frontend STUB.

A batch carries precomputed patch embeddings (``batch["patches"]``,
``[B, P, d_model]``) that the model prepends to the token stream; M-RoPE
splits each rotary half into (temporal, height, width) sections (16, 24,
24) over head_dim 128.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    mrope_sections=(2, 3, 3), d_ff=128, vocab_size=457,
    dtype="float32", remat="none",
)
