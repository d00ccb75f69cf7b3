"""whisper-small — encoder-decoder with conv audio frontend (STUB)
[arXiv:2212.04356].

The conv frontend is stubbed per the task spec: `input_specs()` provides
precomputed frame embeddings (b, 1500, 768).  12 encoder + 12 decoder layers,
LayerNorm, GELU, learned positions.  The paper notes its analysis "largely
does not apply to encoder-decoder models" (§III-C) — we apply it per-stack
(see DESIGN.md §Arch-applicability).  decode_32k is lowered structurally
(whisper's real max target length is 448).
"""
from .base import ModelConfig
from .registry import register

FULL = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    mlp_type="gelu", norm_type="layernorm", pos_emb="learned",
    is_encoder_decoder=True, num_encoder_layers=12, encoder_seq=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    mlp_type="gelu", norm_type="layernorm", pos_emb="learned",
    is_encoder_decoder=True, num_encoder_layers=2, encoder_seq=32,
    dtype="float32",
)

register(FULL, SMOKE)
