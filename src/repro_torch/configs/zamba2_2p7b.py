"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers with a single *shared-weight* attention block applied every
6th layer (9 applications).  head_dim = 2560/32 = 80 — the same misalignment
the paper's GPT-3 2.7B case study targets (pow2 factor 16 < 128 lane width);
the advisor flags it.  Runs long_500k (sub-quadratic backbone).
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    # Published Zamba2 shape: head_dim 80 is the misalignment under study
    # (see module docstring) — reproduce it, don't "fix" it.
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,  # repro: noqa[SHP102]
    d_ff=10240, vocab_size=32000,
    mlp_type="gelu", attn_type="gqa",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    mlp_type="gelu", attn_type="gqa",
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
    hybrid_attn_every=2, dtype="float32",
)

register(FULL, SMOKE)
