"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B]: GQA kv=2, QKV bias, tied embeddings."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=509, dtype="float32", remat="none",
)
