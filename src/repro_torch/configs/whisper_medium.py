"""Whisper-medium [arXiv:2212.04356]: encoder-decoder backbone; conv frontend STUB.

24 encoder + 24 decoder layers.  A batch carries precomputed frame
embeddings (``batch["frames"]``, ``[B, S, d_model]``: what the two conv
layers would produce); both streams take sinusoidal positions.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    qkv_bias=True,
    act="gelu",
    rope_kind="sinusoidal",
)

SMOKE = CONFIG.scaled(
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=463, dtype="float32", remat="none",
)
