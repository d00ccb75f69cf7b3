"""Model / run configuration schema.

Every assigned architecture is expressed as a `ModelConfig`; input-shape cells
as `ShapeConfig`; parallelism as `MeshConfig`.  Configs are frozen dataclasses
(hashable — usable as jit static args) and carry enough structure for the
co-design engine (core/) to enumerate their GEMMs without instantiating
parameters.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads; 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # block variants ------------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu | gelu | relu2
    qkv_bias: bool = False
    parallel_layers: bool = False  # Wang&Komatsuzaki parallel attn+MLP (§VI-C1)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    pos_emb: str = "rotary"  # rotary | learned | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # attention variant ----------------------------------------------------
    attn_type: str = "gqa"  # gqa | mla | none
    # "naive" = paper Table II score/AOV BMM decomposition (faithful baseline)
    # "blocked" = streaming online-softmax (§VI-C3 FlashAttention; XLA twin
    #             of kernels/flash_attention, used by the §Perf hillclimb)
    # "flash" = Pallas flash kernel with fused custom-VJP backward
    #           (kernels/flash_attention) — the differentiable TPU training
    #           path; consults the autotuning cache (tuned=True) and honors
    #           $REPRO_KERNEL_INTERPRET
    # "paged" = Pallas paged decode kernel over the serving slot pool
    attn_impl: str = "naive"
    attn_block_kv: int = 1024
    # linear-execution dispatch for every dense projection GEMM (qkv/output,
    # MLP, lm_head, MoE experts) — all routed through repro.models.linear:
    # "jnp"    = XLA x @ w (CPU/dry-run default)
    # "pallas" = tile-aligned Pallas matmul kernel at its 128^3 defaults
    # "tuned"  = Pallas + per-(m, k, n, dtype, hw) autotuning-cache blocks
    # "fused"  = tuned dispatch + the fused SwiGLU/MLP Pallas kernel for the
    #            MLP gate/up pair (kernels/fused_mlp; the §VII-B hot path)
    # "quantized" = int8 weight path (kernels/quantized): per-channel weight
    #            scales, dynamic per-row activation quantization, i32
    #            accumulate, f32 de-scale — inference-first; gradients fall
    #            back to the high-precision tuned matmul route
    linear_impl: str = "jnp"
    # KV-cache storage dtype for serving pools and decode caches:
    # "auto" = the compute dtype; "int8" = quantized KV (int8 payload plus
    # per-(token, kv_head) f32 scale leaves — see models/blocks and the
    # dequantizing paged-decode kernels).  Engine(kv_dtype=...) sets this.
    kv_dtype: str = "auto"
    # Megatron-style sequence parallelism: residual-stream activations are
    # sequence-sharded on the model axis between TP blocks (norms/adds run
    # 1/t-sharded; XLA converts the TP all-reduce into all-gather +
    # reduce-scatter of the same volume).
    seq_parallel: bool = False
    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE -------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1  # MoE layer every k-th layer (llama4: 2)
    first_dense_layers: int = 0  # deepseek-v3: first 3 layers dense
    moe_capacity_factor: float = 1.25
    # "auto" = XLA-chosen collectives (models/moe.py);
    # "shard_map" = explicit EP schedule: local dispatch + one psum combine
    moe_dispatch: str = "auto"

    # SSM / Mamba2 ----------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    conv_width: int = 4

    # hybrid (zamba2): shared attention block applied every k SSM blocks ----
    hybrid_attn_every: int = 0

    # encoder-decoder (whisper) ----------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed frame embeddings length (conv stub)

    # vlm (internvl / llama4 early fusion): patch-embedding stub -------------
    num_patches: int = 0

    # multi-token prediction (deepseek-v3) -----------------------------------
    mtp_depth: int = 0

    dtype: str = "bfloat16"

    # Deployment intent, consumed by the static shape audit
    # (repro.analysis.shape_audit): error-severity shape findings gate CI
    # only for production configs.  Pedagogical / deliberately-misaligned
    # configs (the GPT-3 2.7B case-study variants, the smoke configs) set
    # False so they stay usable in tests and examples while still being
    # *flagged* (at warn severity).
    production: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.attn_type == "none"

    @property
    def padded_vocab_size(self) -> int:
        """Embedding/logit rows padded to a multiple of 128 (paper §VI-B:
        'vocab divisible by 64' — 128 on TPU lanes, and it also satisfies
        v % tp == 0 for any power-of-two TP).  E.g. 50257 -> 50304, the
        nanoGPT +25% trick.  Logits over padded ids are masked to -inf."""
        v = self.vocab_size
        return -(-v // 128) * 128

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    def is_moe_layer(self, layer: int) -> bool:
        if self.num_experts == 0:
            return False
        if layer < self.first_dense_layers:
            return False
        return (layer - self.first_dense_layers) % self.moe_every == 0

    @property
    def num_moe_layers(self) -> int:
        return sum(1 for i in range(self.num_layers) if self.is_moe_layer(i))

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing => long_500k cell is runnable."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive stack

    def param_count(self) -> int:
        """Exact-ish parameter count (embeddings + per-layer weights).

        Mirrors the paper's P = 12h^2 L + 13hL + (v+s)h for the vanilla
        architecture, generalized to GQA/MLA/MoE/SSM variants.
        """
        h = self.d_model
        n = 0
        # embeddings (+ untied output head)
        n += self.vocab_size * h
        if not self.tie_embeddings:
            n += self.vocab_size * h
        if self.pos_emb == "learned":
            n += 8192 * h  # nominal max positions
        for layer in range(self.num_layers):
            n += self._layer_params(layer)
        if self.family == "hybrid":
            # zamba2 shared attention+MLP block (weights tied across uses)
            n += self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                # encoder: self-attn + mlp
                n += self._attn_params() + self._mlp_params(self.d_ff) + 2 * h
            # decoder cross-attention blocks
            n += self.num_layers * (self._attn_params() + h)
        n += self.num_layers * 2 * h  # norms (approx 2 per layer)
        n += h  # final norm
        if self.mtp_depth:
            n += self.mtp_depth * (self._layer_params(self.num_layers - 1) + 2 * h * h)
        return n

    def _attn_params(self) -> int:
        h = self.d_model
        if self.attn_type == "mla":
            qdim = self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
            p = h * self.q_lora_rank + self.q_lora_rank * qdim
            p += h * (self.kv_lora_rank + self.qk_rope_dim)
            p += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
            p += self.num_heads * self.v_head_dim * h
            return p
        hd = self.head_dim
        p = h * (self.num_heads * hd) + h * (2 * self.num_kv_heads * hd)
        p += (self.num_heads * hd) * h
        if self.qkv_bias:
            p += (self.num_heads + 2 * self.num_kv_heads) * hd
        return p

    def _mlp_params(self, d_ff: int) -> int:
        h = self.d_model
        mats = 3 if self.mlp_type == "swiglu" else 2
        return mats * h * d_ff

    def _ssm_params(self) -> int:
        h, di, ds = self.d_model, self.ssm_d_inner, self.ssm_state
        ng, nh = self.ssm_ngroups, self.ssm_nheads
        p = h * (2 * di + 2 * ng * ds + nh)  # in_proj (z,x,B,C,dt)
        p += self.conv_width * (di + 2 * ng * ds)  # conv1d
        p += nh * 2  # A_log, D
        p += di * h  # out_proj
        return p

    def _layer_params(self, layer: int) -> int:
        h = self.d_model
        fam_attn = 0
        fam_mix = 0
        if self.family in ("ssm", "hybrid"):
            # hybrid (zamba2): layers are pure Mamba2 blocks; the shared
            # attention+MLP block's params are counted once in param_count().
            fam_mix = self._ssm_params()
            if self.family == "ssm" and self.d_ff:
                fam_mix += self._mlp_params(self.d_ff)
            return fam_mix
        fam_attn = self._attn_params()
        if self.is_moe_layer(layer):
            e = self.num_experts * self._mlp_params(self.moe_d_ff)
            e += self.num_shared_experts * self._mlp_params(self.moe_d_ff)
            e += h * self.num_experts  # router
            return fam_attn + e
        return fam_attn + self._mlp_params(self.d_ff)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only routed top_k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        n = self.param_count()
        per_expert = self._mlp_params(self.moe_d_ff)
        inactive = self.num_moe_layers * (self.num_experts - self.top_k) * per_expert
        return n - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


# The four assigned input-shape cells -------------------------------------------------
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism plan over the physical mesh."""

    data: int = 1
    model: int = 1
    pod: int = 1
    pod_role: str = "data"  # data | pipeline
    fsdp: bool = True  # shard params/optimizer over the data axis, gathered where used

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pod

    @property
    def tp(self) -> int:
        return self.model

    @property
    def dp(self) -> int:
        return self.data * (self.pod if self.pod_role == "data" else 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatch_per_device: int = 1
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adamw8bit
    remat: str = "full"  # none | full | dots
    seed: int = 0
    checkpoint_every: int = 200
    # under $TMPDIR (the JAX package's /tmp/repro_ckpt where it is unset)
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep_checkpoints: int = 3
