"""GPT-3 2.7B shape case study (paper Fig. 1).

C0 is Brown et al.'s original shape (a=32, head_dim 80 — misaligned, copied
by GPT-Neo/OPT/RedPajama/Pythia).  C1/C2 are the paper's variants; C3 (a=20,
head_dim 128) is the paper's recommended fix and the TPU-optimal one.
"""

from .base import ModelConfig
from .registry import register


def _variant(tag: str, heads: int) -> ModelConfig:
    return ModelConfig(
        name=f"gpt3-2.7b-{tag}", family="dense",
        num_layers=32, d_model=2560, num_heads=heads, num_kv_heads=heads,
        d_ff=10240, vocab_size=50257,
        mlp_type="gelu", norm_type="layernorm",
        # Paper case-study shapes: C0's head_dim 80 / vocab 50257 are the
        # misalignments under study, not a deployment target — keep the
        # static shape audit (SHP1xx) from gating CI on them.
        production=False,
    )


C0 = _variant("c0", 32)  # original: head_dim 80
C1 = _variant("c1", 64)  # paper Fig.1 C1: head_dim 40
C2 = _variant("c2", 40)  # paper Fig.1 C2: head_dim 64
C3 = _variant("c3", 20)  # paper text fix: head_dim 128

SMOKE = ModelConfig(
    name="gpt3-smoke", family="dense",
    num_layers=2, d_model=80, num_heads=4, num_kv_heads=4,  # head_dim 20: misaligned on purpose
    d_ff=320, vocab_size=251,  # vocab not divisible by 64/128 on purpose
    mlp_type="gelu", norm_type="layernorm", dtype="float32",
)

register(C0, SMOKE)
VARIANTS = {"c0": C0, "c1": C1, "c2": C2, "c3": C3}
