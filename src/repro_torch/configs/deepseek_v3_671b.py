"""deepseek-v3-671b — MLA + MoE (1 shared + 256 routed, top-8) + MTP
[arXiv:2412.19437].

MLA: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.
First 3 layers dense (d_ff 18432); layers 4..61 MoE with expert d_ff 2048.
256 experts / EP=16 = 16 experts per device on the production mesh (the
advisor's experts_div_ep rule).  Expert GEMM n-dim 2048 is lane-aligned.
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    mlp_type="swiglu",
    attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, head_dim=192,
    num_experts=256, num_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3, moe_capacity_factor=1.25,
    mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    mlp_type="swiglu",
    attn_type="mla", q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, head_dim=24,
    num_experts=8, num_shared_experts=1, top_k=2, moe_d_ff=32,
    first_dense_layers=1, mtp_depth=1, dtype="float32",
)

register(FULL, SMOKE)
