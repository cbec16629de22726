"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B, sheet]: MHA (kv=40), QKV bias."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=80, num_heads=5, num_kv_heads=5, d_ff=208,
    vocab_size=487, dtype="float32", remat="none",
)
