"""Transformer → GEMM decomposition (paper Table II), generalized (a copy of
the JAX package's `core/transformer_gemms.py`: pure arithmetic on
`ModelConfig`, for every registered family, the ones the port does not run
yet included).

The paper enumerates the GEMMs of a vanilla decoder layer.  We extend the
mapping to every assigned architecture family so the same analytic machinery
(cost model, advisor, roofline) covers GQA, MLA, MoE, SSD, hybrid and
enc-dec stacks.  All sizes are *per-shard* with `t`-way tensor parallelism,
mirroring the paper's "hidden size per GPU" convention (§III-C).

Modes:
  train/prefill: m = b*s tokens flow through every projection;
  decode:        m = b (one new token), attention BMMs read an s-long cache.
"""
from __future__ import annotations

import math
from typing import List

from ..configs.base import ModelConfig
from .gemm_model import GEMM
from .quantization import ceil_div


def _attn_gemms(cfg: ModelConfig, b: int, s: int, t: int, decode: bool,
                prefix: str = "", count: int = 1) -> List[GEMM]:
    """GQA/MHA attention GEMMs for one layer (Table II rows 3-6)."""
    h = cfg.d_model
    hd = cfg.head_dim
    a = max(cfg.num_heads // t, 1)
    kv = max(cfg.num_kv_heads // t, 1)
    m = b * (1 if decode else s)
    s_kv = s  # cache length in decode; sequence length otherwise
    out: List[GEMM] = [
        GEMM(prefix + "qkv_transform", m, h, (a + 2 * kv) * hd, count=count),
        GEMM(prefix + "attn_score", (1 if decode else s), hd, s_kv, batch=b * a, count=count),
        GEMM(prefix + "attn_over_value", (1 if decode else s), s_kv, hd, batch=b * a,
             weight_is_b=False, count=count),
        GEMM(prefix + "attn_out_proj", m, a * hd, h, count=count),
    ]
    return out


def _mla_gemms(cfg: ModelConfig, b: int, s: int, t: int, decode: bool) -> List[GEMM]:
    """DeepSeek-V3 Multi-head Latent Attention GEMMs.

    Train/prefill uses the naive (decompressed) path; decode uses the
    weight-absorbed path against the rank-(kv_lora+rope) latent cache.
    """
    h = cfg.d_model
    a = max(cfg.num_heads // t, 1)
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    vd = cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    m = b * (1 if decode else s)
    g: List[GEMM] = [
        GEMM("mla_q_down", m, h, qr),
        GEMM("mla_q_up", m, qr, a * (nope + rope)),
        GEMM("mla_kv_down", m, h, kvr + rope),
    ]
    if decode:
        # absorbed path: queries hit the latent cache directly
        g += [
            GEMM("mla_q_absorb", 1, nope, kvr, batch=b * a),
            GEMM("mla_score_latent", 1, kvr + rope, s, batch=b * a),
            GEMM("mla_attn_over_latent", 1, s, kvr, batch=b * a, weight_is_b=False),
            GEMM("mla_v_absorb", 1, kvr, vd, batch=b * a),
        ]
    else:
        g += [
            GEMM("mla_k_up", m, kvr, a * nope),
            GEMM("mla_v_up", m, kvr, a * vd),
            GEMM("mla_score", s, nope + rope, s, batch=b * a),
            GEMM("mla_attn_over_value", s, s, vd, batch=b * a, weight_is_b=False),
        ]
    g.append(GEMM("mla_out_proj", m, a * vd, h))
    return g


def _mlp_gemms(cfg: ModelConfig, b: int, s: int, t: int, decode: bool,
               d_ff: int | None = None, prefix: str = "", count: int = 1) -> List[GEMM]:
    h = cfg.d_model
    f = max((d_ff if d_ff is not None else cfg.d_ff) // t, 1)
    m = b * (1 if decode else s)
    g = [GEMM(prefix + "mlp_up", m, h, f, count=count)]
    if cfg.mlp_type == "swiglu":
        g.append(GEMM(prefix + "mlp_gate", m, h, f, count=count))
    g.append(GEMM(prefix + "mlp_down", m, f, h, count=count))
    return g


def _moe_gemms(cfg: ModelConfig, b: int, s: int, t: int, decode: bool) -> List[GEMM]:
    """MoE layer: router + routed experts (EP over `t`) + shared experts."""
    h = cfg.d_model
    m = b * (1 if decode else s)
    e_local = max(cfg.num_experts // t, 1)
    cap = cfg.moe_capacity_factor
    tokens_per_expert = max(int(math.ceil(m * cfg.top_k * cap / cfg.num_experts)), 1)
    f = cfg.moe_d_ff  # experts are NOT tp-sharded internally under EP
    g = [GEMM("moe_router", m, h, cfg.num_experts)]
    mats_up = 2 if cfg.mlp_type == "swiglu" else 1
    g.append(GEMM("moe_expert_up", tokens_per_expert, h, f, batch=e_local, count=mats_up))
    g.append(GEMM("moe_expert_down", tokens_per_expert, f, h, batch=e_local))
    if cfg.num_shared_experts:
        g += _mlp_gemms(cfg, b, s, t, decode, d_ff=cfg.moe_d_ff * cfg.num_shared_experts,
                        prefix="moe_shared_")
    return g


def _ssd_gemms(cfg: ModelConfig, b: int, s: int, t: int, decode: bool) -> List[GEMM]:
    """Mamba2 SSD (state-space duality) chunked dual form.

    The intra-chunk computation is exactly an attention-like pair of BMMs with
    chunk length Q in place of s and (head_dim P, state N) in place of
    (h/a, h/a) — the paper's BMM sizing rules apply with Q, P, N as the knobs.
    """
    h = cfg.d_model
    di = max(cfg.ssm_d_inner // t, 1)
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    nh = max(di // P, 1)
    ng = cfg.ssm_ngroups
    proj_in = 2 * di + 2 * ng * N + nh  # z, x, B, C, dt
    if decode:
        # recurrent single-step: state update is (nh) batched (P,N) outer
        # products + dot; dominated by in/out projections.
        return [
            GEMM("ssd_in_proj", b, h, proj_in),
            GEMM("ssd_state_update", P, 1, N, batch=b * nh, weight_is_b=False),
            GEMM("ssd_state_read", P, N, 1, batch=b * nh, weight_is_b=False),
            GEMM("ssd_out_proj", b, di, h),
        ]
    Q = cfg.ssm_chunk
    nc = ceil_div(s, Q)
    return [
        GEMM("ssd_in_proj", b * s, h, proj_in),
        # G = C B^T within chunk (per chunk, per group)
        GEMM("ssd_chunk_score", Q, N, Q, batch=b * nc * ng, weight_is_b=False),
        # Y_intra = (G*L) X  (per chunk, per head)
        GEMM("ssd_chunk_over_value", Q, Q, P, batch=b * nc * nh, weight_is_b=False),
        # chunk states: B^T X  (per chunk, per head)
        GEMM("ssd_chunk_state", N, Q, P, batch=b * nc * nh, weight_is_b=False),
        # inter-chunk: C h_state  (per chunk, per head)
        GEMM("ssd_state_read", Q, N, P, batch=b * nc * nh, weight_is_b=False),
        GEMM("ssd_out_proj", b * s, di, h),
    ]


def layer_gemms(cfg: ModelConfig, b: int, s: int, t: int = 1,
                mode: str = "train", layer: int = 0) -> List[GEMM]:
    """All GEMMs of one layer of `cfg` at microbatch b, sequence s, TP t."""
    decode = mode == "decode"
    g: List[GEMM] = []
    if cfg.family in ("ssm", "hybrid"):
        g += _ssd_gemms(cfg, b, s, t, decode)
        if (cfg.family == "hybrid" and cfg.hybrid_attn_every
                and layer % cfg.hybrid_attn_every == cfg.hybrid_attn_every - 1):
            # zamba2 shared attention+MLP block application
            g += _attn_gemms(cfg, b, s, t, decode, prefix="shared_")
            g += _mlp_gemms(cfg, b, s, t, decode, prefix="shared_")
        return g
    if cfg.attn_type == "mla":
        g += _mla_gemms(cfg, b, s, t, decode)
    else:
        g += _attn_gemms(cfg, b, s, t, decode)
    if cfg.is_moe_layer(layer):
        g += _moe_gemms(cfg, b, s, t, decode)
    else:
        g += _mlp_gemms(cfg, b, s, t, decode)
    return g


def model_gemms(cfg: ModelConfig, b: int, s: int, t: int = 1,
                mode: str = "train") -> List[GEMM]:
    """All GEMMs of the full model (layers + logit head + enc-dec extras)."""
    decode = mode == "decode"
    out: List[GEMM] = []
    for layer in range(cfg.num_layers):
        out += layer_gemms(cfg, b, s, t, mode, layer)
    # encoder stack + cross attention (whisper)
    if cfg.is_encoder_decoder and not decode:
        se = cfg.encoder_seq or s
        for _ in range(cfg.num_encoder_layers):
            out += _attn_gemms(cfg, b, se, t, False, prefix="enc_")
            out += _mlp_gemms(cfg, b, se, t, False, prefix="enc_")
        for _ in range(cfg.num_layers):
            out += _cross_attn_gemms(cfg, b, s, se, t, decode)
    elif cfg.is_encoder_decoder and decode:
        se = cfg.encoder_seq or 1500
        for _ in range(cfg.num_layers):
            out += _cross_attn_gemms(cfg, b, 1, se, t, True)
    # logit head (Table II "Linear Output"); vocab is TP-sharded
    m = b * (1 if decode else s)
    out.append(GEMM("logit_layer", m, cfg.d_model, max(cfg.vocab_size // t, 1)))
    return out


def _cross_attn_gemms(cfg: ModelConfig, b: int, sq: int, skv: int, t: int,
                      decode: bool) -> List[GEMM]:
    h = cfg.d_model
    hd = cfg.head_dim
    a = max(cfg.num_heads // t, 1)
    m = b * sq
    return [
        GEMM("xattn_q", m, h, a * hd),
        GEMM("xattn_kv", b * skv, h, 2 * a * hd),
        GEMM("xattn_score", sq, hd, skv, batch=b * a, weight_is_b=False),
        GEMM("xattn_over_value", sq, skv, hd, batch=b * a, weight_is_b=False),
        GEMM("xattn_out", m, a * hd, h),
    ]


def training_flops(cfg: ModelConfig, b: int, s: int) -> float:
    """Paper's 24bsh^2(1 + s/6h) generalized: fwd FLOPs x3 for fwd+bwd."""
    fwd = sum(g.flops for g in model_gemms(cfg, b, s, t=1, mode="train"))
    return 3.0 * fwd


def vanilla_forward_flops(h: int, b: int, s: int) -> float:
    """The paper's closed form for one vanilla layer: 24bsh^2 + 4bs^2h."""
    return 24.0 * b * s * h * h + 4.0 * b * s * s * h
