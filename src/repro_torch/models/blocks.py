"""Transformer block assembly over stacked layer params.

A model is a list of *segments*; each segment is `n` structurally identical
layers whose parameters are stacked on a leading axis (the JAX package's
layout, so params convert one to one).  A Python loop over that axis
replaces `lax.scan`: layer l reads the views `t[l]`.  This slice ports the
`dense` kind (attention + MLP); the other kinds raise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import apply_attention, init_attention
from .layers import norm_apply, norm_init
from .mlp import apply_mlp, init_mlp


# --- plan ---------------------------------------------------------------------------

def stack_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    L = cfg.num_layers
    if cfg.family == "ssm":
        return [("ssm", L)]
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every or L
        assert L % k == 0, "hybrid: L must divide hybrid_attn_every"
        return [("hybrid_super", L // k)]
    if cfg.num_experts:
        if cfg.moe_every == 1:
            fd = cfg.first_dense_layers
            plan: List[Tuple[str, int]] = []
            if fd:
                plan.append(("dense", fd))
            plan.append(("moe", L - fd))
            return plan
        assert cfg.moe_every == 2 and cfg.first_dense_layers == 0
        return [("pair", L // 2)]
    return [("dense", L)]


def _check_kind(kind: str) -> None:
    if kind != "dense":
        raise NotImplementedError(
            f"segment kind {kind!r} is not ported yet: it comes with the "
            f"other-families slice (moe / ssm / hybrid)")


# --- init ---------------------------------------------------------------------------

def init_segment(gen: Optional[torch.Generator], cfg: ModelConfig, kind: str, n: int, *,
                 device=None, dtype=torch.float32):
    """Stacked params of `n` layers (leading axis n on every leaf)."""
    _check_kind(kind)
    kw = dict(lead=(n,), device=device, dtype=dtype)
    return {"norm1": norm_init(cfg.d_model, cfg.norm_type, lead=(n,), device=device),
            "attn": init_attention(gen, cfg, **kw),
            "norm2": norm_init(cfg.d_model, cfg.norm_type, lead=(n,), device=device),
            "mlp": init_mlp(gen, cfg, **kw)}


def tree_index(tree, i: int):
    """The views t[i] of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


# --- caches --------------------------------------------------------------------------

KV_DTYPES = ("auto", "int8")


def kv_cache_dtype(cfg: ModelConfig, dtype):
    """Storage dtype for k/v cache leaves ("auto" = the compute dtype)."""
    if cfg.kv_dtype == "auto":
        return dtype
    if cfg.kv_dtype == "int8":
        raise NotImplementedError(
            "kv_dtype='int8' is not ported yet: it comes with the low-precision slice")
    raise ValueError(
        f"unknown kv_dtype {cfg.kv_dtype!r}; valid: {list(KV_DTYPES)}")


def init_cache_segment(cfg: ModelConfig, kind: str, n: int, batch: int,
                       s_max: int, dtype=torch.bfloat16, device=None):
    """Cache of one segment: k, v (n, batch, s_max, kv, hd), zeros."""
    _check_kind(kind)
    if cfg.attn_type != "gqa":
        raise NotImplementedError("only GQA caches are ported")
    store = kv_cache_dtype(cfg, dtype)
    shape = (n, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=store, device=device),
            "v": torch.zeros(shape, dtype=store, device=device)}


# --- apply ---------------------------------------------------------------------------

def _apply_core(p, x, cfg: ModelConfig, kind: str, *, positions,
                cache=None, cache_index=None):
    """One dense layer.  Returns (x, cache)."""
    attn_out, cache = apply_attention(
        p["attn"], norm_apply(p["norm1"], x, cfg.norm_type), cfg,
        positions=positions, cache=cache, cache_index=cache_index)
    if cfg.parallel_layers:
        # y = x + Attn(N(x)) + MLP(N(x))   (§VI-C1; same first norm)
        mix_in = norm_apply(p["norm1"], x, cfg.norm_type)
    else:
        x = x + attn_out
        mix_in = norm_apply(p["norm2"], x, cfg.norm_type)
    mix_out = apply_mlp(p["mlp"], mix_in, cfg)
    x = x + mix_out + (attn_out if cfg.parallel_layers else 0)
    return x, cache


def apply_stack(segments_params, cfg: ModelConfig, x, *, positions,
                caches=None, cache_index=None):
    """Run all segments layer by layer.  segments_params: list of
    (kind, stacked_params); caches: list aligned with segments (or None),
    updated in place.  Returns (x, caches)."""
    for si, (kind, sp) in enumerate(segments_params):
        _check_kind(kind)
        seg_cache = None if caches is None else caches[si]
        n = sp["norm1"]["scale"].shape[0]
        for layer in range(n):
            c_l = None if seg_cache is None else tree_index(seg_cache, layer)
            x, _ = _apply_core(tree_index(sp, layer), x, cfg, kind,
                               positions=positions, cache=c_l,
                               cache_index=cache_index)
    return x, caches
