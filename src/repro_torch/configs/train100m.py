"""~100M-parameter llama-family config for the end-to-end training example."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="train100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32_000,
    tie_embeddings=True,
    dtype="float32",
    remat="block",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=503, remat="none")
