"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434]: MLA + fine-grained MoE.

Sheet says "MoE 64e top-6 ... 2 shared+160 routed"; 160 routed belongs to
full V2 — V2-Lite is 64 routed + 2 shared, top-6.  Layer 0 is a dense FFN
(published intermediate 10944); MoE expert width 1408.
MLA: kv_lora_rank 512, qk_nope 128, qk_rope 64, v_head 128.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10_944,          # the dense first layer's FFN
    vocab_size=102_400,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    router_norm_topk=True,
    rope_theta=10_000.0,
    moe_impl="ep_shardmap",
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=176,
    vocab_size=497, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, num_experts=8, top_k=2, moe_d_ff=48, num_shared_experts=1,
    dtype="float32", remat="none", moe_impl="dense",
)
