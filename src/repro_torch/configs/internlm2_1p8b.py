"""internlm2-1.8b — dense GQA [arXiv:2403.17297].  head_dim = 128 (aligned)."""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92544,
    mlp_type="swiglu",
)

SMOKE = ModelConfig(
    name="internlm2-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256,
    mlp_type="swiglu", dtype="float32",
)

register(FULL, SMOKE)
