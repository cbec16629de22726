"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts, top-8, all layers MoE."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    num_experts=64,
    top_k=8,
    moe_d_ff=1024,
    router_norm_topk=False,
    rope_theta=10_000.0,
    moe_impl="ep_shardmap",
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=48,
    vocab_size=479, num_experts=8, top_k=2, moe_d_ff=48,
    dtype="float32", remat="none", moe_impl="dense",
)
