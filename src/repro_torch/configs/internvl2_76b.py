"""internvl2-76b — VLM: InternViT frontend (STUB) + LLaMA-3-70B-class backbone
[arXiv:2404.16821].

Per the task spec the modality frontend is a stub: `input_specs()` provides
precomputed patch embeddings (b, n_patches, d_model) prepended to the token
stream; the backbone is a dense GQA transformer (head_dim 128, aligned).
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    mlp_type="swiglu",
    num_patches=1024,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=256,
    mlp_type="swiglu", num_patches=8, dtype="float32",
)

register(FULL, SMOKE)
