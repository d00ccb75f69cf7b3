"""command-r-plus-104b — dense GQA, no biases, PARALLEL attn+MLP blocks
[hf:CohereForAI/c4ai-command-r-plus].

Parallel layers are the paper's §VI-C1 architectural modification — the
residual form y = x + Attn(N(x)) + MLP(N(x)) with a single input norm.
head_dim = 12288/96 = 128 (aligned).
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    mlp_type="swiglu", parallel_layers=True, norm_type="layernorm",
)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=256,
    mlp_type="swiglu", parallel_layers=True, norm_type="layernorm",
    dtype="float32",
)

register(FULL, SMOKE)
