"""mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060].

d_inner = 2*1536 = 3072, 48 SSD heads of P=64, state N=128 (lane-aligned ✓),
chunk Q=256 (lane-aligned ✓).  No attention and no MLP: each layer is one
Mamba2 block (d_ff=0).  The paper's BMM rules apply to the SSD chunk BMMs
with (Q, P, N) as the shape knobs (DESIGN.md §Arch-applicability).
Runs long_500k.
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    attn_type="none", mlp_type="gelu",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256,
    attn_type="none", mlp_type="gelu",
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
    tie_embeddings=True, dtype="float32",
)

register(FULL, SMOKE)
