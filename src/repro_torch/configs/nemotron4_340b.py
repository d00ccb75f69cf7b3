"""nemotron-4-340b — dense GQA with squared-ReLU MLP [arXiv:2402.16819].

head_dim = 18432/96 = 192 (1.5 MXU lanes — the advisor notes the half-tile);
d_ff = 4h = 73728 is fully aligned.  Squared ReLU is pointwise (no GEMM-shape
impact, paper §VI-C).
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    mlp_type="relu2",
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=384, vocab_size=512,
    mlp_type="relu2", dtype="float32",
)

register(FULL, SMOKE)
