"""MiniCPM-2B [arXiv:2404.06395]: llama-like dense, mu-p scaling, WSD schedule.

scale_emb=12, scale_depth=1.4 (residual scale 1.4/sqrt(L)), logits divided by
d_model/dim_model_base = 2304/256 = 9.
"""

import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    tie_embeddings=True,
    emb_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logits_scale=256.0 / 2304.0,
    rope_theta=10_000.0,
    lr_schedule="wsd",
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=72, num_heads=6, num_kv_heads=6, d_ff=144,
    vocab_size=503, residual_scale=1.4 / math.sqrt(3),
    logits_scale=256.0 / 72.0, dtype="float32", remat="none",
)
