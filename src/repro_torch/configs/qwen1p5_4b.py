"""qwen1.5-4b — dense MHA with QKV bias [hf:Qwen/Qwen1.5-4B].

head_dim = 2560/20 = 128 — fully lane-aligned on TPU v5e.  The QKV bias only
changes the GEMM epilogue (β-term), not its shape (paper §III-A).
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936,
    mlp_type="swiglu", qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab_size=256,
    mlp_type="swiglu", qkv_bias=True, dtype="float32",
)

register(FULL, SMOKE)
