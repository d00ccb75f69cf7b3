"""llama4-maverick-400b-a17b — MoE top-1, 128 experts, MoE every 2nd layer,
early-fusion multimodal [hf:meta-llama/Llama-4-Maverick-17B-128E].

Dense layers use d_ff 16384; MoE layers route top-1 over 128 experts
(d_ff 8192) plus one always-on shared expert.  Early fusion is modeled with
the VLM patch-embedding stub (precomputed patch embeddings prepended).
128 experts / EP=16 = 8 per device.
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=16384, vocab_size=202048,
    mlp_type="swiglu",
    num_experts=128, num_shared_experts=1, top_k=1, moe_d_ff=8192,
    moe_every=2, moe_capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=256,
    mlp_type="swiglu",
    num_experts=8, num_shared_experts=1, top_k=1, moe_d_ff=64,
    moe_every=2, dtype="float32",
)

register(FULL, SMOKE)
