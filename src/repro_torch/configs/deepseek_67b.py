"""DeepSeek-67B [arXiv:2401.02954]: llama-arch dense, GQA kv=8, 95 layers."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=102_400,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=4, d_model=96, num_heads=8, num_kv_heads=2, d_ff=192,
    vocab_size=499, dtype="float32", remat="none",
)
