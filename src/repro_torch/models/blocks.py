"""Transformer block assembly over stacked layer params.

A model is a list of *segments*; each segment is `n` structurally identical
layers whose parameters are stacked on a leading axis (the JAX package's
layout, so params convert one to one).  A Python loop over that axis
replaces `lax.scan`: layer l reads the views `t[l]`.  Kinds:
  dense        — attn + MLP                        (internlm2, ...)
  moe          — attn + MoE                        (deepseek-v3 layers 3..61)
  pair         — [moe, dense] superblock           (llama4: MoE every 2nd layer)
  ssm          — Mamba2 block only                 (mamba2-780m)
  hybrid_super — `k` Mamba2 layers + one SHARED attention + MLP block
                 (zamba2: the shared weights live outside the segment)
The attention of a dense, moe or pair layer is GQA or MLA (`attn_type`).

`remat="full"` recomputes each layer in the backward
(`torch.utils.checkpoint`, non-reentrant: the layer's params reach it by
closure, as `jax.checkpoint` captures them), for every kind: a dense,
MoE or pair layer, a Mamba2 layer, a hybrid superblock with zamba2's
shared block captured the same way.  Every kernel on those paths is
deterministic, so the recomputed layer gives the same bits and the loss
and gradients equal remat="none"'s.  `"dots"` raises.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..quant import QuantizedTensor
from .attention import apply_attention, init_attention
from .layers import norm_apply, norm_init
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .ssm import apply_ssm, decode_ssm, init_ssm, init_ssm_cache


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


KINDS = ("dense", "moe", "pair", "ssm", "hybrid_super")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown segment kind {kind!r}; valid: {list(KINDS)}")


# --- init ---------------------------------------------------------------------------

def init_segment(gen: Optional[torch.Generator], cfg: ModelConfig, kind: str, n: int, *,
                 device=None, dtype=torch.float32):
    """Stacked params of `n` layers (leading axis n on every leaf; a
    hybrid superblock's Mamba2 layers are stacked again, (n, k, ...))."""
    _check_kind(kind)
    if kind == "hybrid_super":
        lead = (n, cfg.hybrid_attn_every)
        return {"layers": {"norm1": norm_init(cfg.d_model, cfg.norm_type, lead=lead, device=device),
                           "ssm": init_ssm(gen, cfg, lead=lead, device=device, dtype=dtype)}}
    if kind == "pair":
        return {"moe_blk": init_segment(gen, cfg, "moe", n, device=device, dtype=dtype),
                "dense_blk": init_segment(gen, cfg, "dense", n, device=device, dtype=dtype)}
    kw = dict(lead=(n,), device=device, dtype=dtype)
    norm1 = norm_init(cfg.d_model, cfg.norm_type, lead=(n,), device=device)
    if kind == "ssm":
        return {"norm1": norm1, "ssm": init_ssm(gen, cfg, **kw)}
    p = {"norm1": norm1,
         "attn": init_attention(gen, cfg, **kw),
         "norm2": norm_init(cfg.d_model, cfg.norm_type, lead=(n,), device=device)}
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, **kw)
    else:
        p["mlp"] = init_mlp(gen, cfg, **kw)
    return p


def init_shared(gen: Optional[torch.Generator], cfg: ModelConfig, *, device=None,
                dtype=torch.float32):
    """Zamba2's shared attention + MLP block (weights tied across its
    applications); None for other families."""
    if cfg.family != "hybrid":
        return None
    return {"norm": norm_init(cfg.d_model, cfg.norm_type, device=device),
            "attn": init_attention(gen, cfg, device=device, dtype=dtype),
            "norm2": norm_init(cfg.d_model, cfg.norm_type, device=device),
            "mlp": init_mlp(gen, cfg, device=device, dtype=dtype)}


def tree_index(tree, i: int):
    """The views t[i] of every leaf of a nested dict (a `QuantizedTensor`
    is one leaf: its payload and scales are indexed together)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.q[i], tree.scale[i], tree.axis)
    return tree[i]


def tree_unbind(tree, n: int):
    """The n per-layer trees of a stacked tree, as views (`unbind`).  Unlike
    n separate `t[i]`, whose backward each writes a zero-filled gradient of
    the whole stack and adds it up, the backward of one `unbind` stacks the
    n slices' gradients once."""
    if isinstance(tree, dict):
        per_key = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, QuantizedTensor):
        return [QuantizedTensor(q, s, tree.axis)
                for q, s in zip(tree.q.unbind(0), tree.scale.unbind(0))]
    return tree.unbind(0)


# --- caches --------------------------------------------------------------------------

KV_DTYPES = ("auto", "int8")


def kv_cache_dtype(cfg: ModelConfig, dtype):
    """Storage dtype for k/v cache leaves: "auto" is the compute dtype,
    "int8" stores quantized k/v beside f32 scale leaves."""
    if cfg.kv_dtype == "auto":
        return dtype
    if cfg.kv_dtype == "int8":
        if cfg.attn_type == "mla":
            raise ValueError(
                "kv_dtype='int8' is not supported with attn_type='mla' "
                "(the latent cache feeds back through projections, not raw k/v)")
        return torch.int8
    raise ValueError(
        f"unknown kv_dtype {cfg.kv_dtype!r}; valid: {list(KV_DTYPES)}")


def init_cache_segment(cfg: ModelConfig, kind: str, n: int, batch: int,
                       s_max: int, dtype=torch.bfloat16, device=None):
    """Cache of one segment, zeros.  Attention: k, v (n, batch, s_max, kv,
    hd); an int8 cache adds the f32 absmax scales k_scale, v_scale (n,
    batch, s_max, kv), one per (token, kv head); MLA: latent (n, batch,
    s_max, kv_lora_rank + qk_rope_dim).  pair: {moe_blk, dense_blk}, one
    such cache each.  ssm: the state and conv tails of `init_ssm_cache`,
    (n, ...); hybrid_super: those (n, k, ...) beside the shared block's k, v."""
    _check_kind(kind)
    if kind == "pair":
        return {blk: _kv_cache(cfg, n, batch, s_max, dtype, device)
                for blk in ("moe_blk", "dense_blk")}
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device, lead=(n,))
    if kind == "hybrid_super":
        return {"ssm": init_ssm_cache(cfg, batch, dtype, device,
                                      lead=(n, cfg.hybrid_attn_every)),
                "shared_attn": _kv_cache(cfg, n, batch, s_max, dtype, device)}
    return _kv_cache(cfg, n, batch, s_max, dtype, device)


def _kv_cache(cfg: ModelConfig, n: int, batch: int, s_max: int, dtype, device):
    store = kv_cache_dtype(cfg, dtype)
    if cfg.attn_type == "mla":
        return {"latent": torch.zeros((n, batch, s_max, cfg.kv_lora_rank + cfg.qk_rope_dim),
                                      dtype=store, device=device)}
    shape = (n, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    leaves = {"k": torch.zeros(shape, dtype=store, device=device),
              "v": torch.zeros(shape, dtype=store, device=device)}
    if store == torch.int8:
        for name in ("k", "v"):
            leaves[f"{name}_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                                  device=device)
    return leaves


# --- apply ---------------------------------------------------------------------------

def _ssm_layer(p, x, cfg: ModelConfig, cache, decode: bool):
    """One Mamba2 layer's residual branch; its cache (state, conv tails) is
    written in place with the new values, cast to the cache's dtype."""
    xin = norm_apply(p["norm1"], x, cfg.norm_type)
    if decode:
        if cache is None:
            raise ValueError("an SSM decode step needs the layer's cache")
        y, new = decode_ssm(p["ssm"], xin, cfg, cache)
    else:
        y, (state, tails) = apply_ssm(p["ssm"], xin, cfg,
                                      state=None if cache is None else cache["state"])
        new = {"state": state, **tails}
    if cache is not None:
        for name, leaf in cache.items():
            leaf.copy_(new[name])
    return y


def _apply_core(p, x, cfg: ModelConfig, kind: str, *, positions,
                cache=None, cache_index=None, block_tables=None, decode=False,
                shared=None):
    """One layer (a dense, MoE or Mamba2 layer, a [moe, dense] pair, or a
    hybrid superblock).  `decode`: single-token steps through the SSM
    recurrence (attention decodes from its cache either way).  Returns
    (x, cache, aux): aux the MoE load-balance loss (0-d f32) of a moe or
    pair layer, None for the other kinds."""
    if kind == "ssm":
        return x + _ssm_layer(p, x, cfg, cache, decode), cache, None
    if kind == "hybrid_super":
        if block_tables is not None:
            raise ValueError("block-table KV paging does not support ssm/hybrid caches")
        for i in range(cfg.hybrid_attn_every):
            x = x + _ssm_layer(tree_index(p["layers"], i), x, cfg,
                               None if cache is None else tree_index(cache["ssm"], i), decode)
        # the shared attention + MLP block (weights tied across all applications)
        attn_out, _ = apply_attention(
            shared["attn"], norm_apply(shared["norm"], x, cfg.norm_type), cfg,
            positions=positions, cache=None if cache is None else cache["shared_attn"],
            cache_index=cache_index)
        x = x + attn_out
        x = x + apply_mlp(shared["mlp"], norm_apply(shared["norm2"], x, cfg.norm_type), cfg)
        return x, cache, None
    if kind == "pair":
        kw = dict(positions=positions, cache_index=cache_index, block_tables=block_tables,
                  decode=decode)
        x, _, a1 = _apply_core(p["moe_blk"], x, cfg, "moe",
                               cache=None if cache is None else cache["moe_blk"], **kw)
        x, _, _ = _apply_core(p["dense_blk"], x, cfg, "dense",
                              cache=None if cache is None else cache["dense_blk"], **kw)
        return x, cache, a1
    attn_out, cache = apply_attention(
        p["attn"], norm_apply(p["norm1"], x, cfg.norm_type), cfg,
        positions=positions, cache=cache, cache_index=cache_index,
        block_tables=block_tables)
    if cfg.parallel_layers:
        # y = x + Attn(N(x)) + MLP(N(x))   (§VI-C1; same first norm)
        mix_in = norm_apply(p["norm1"], x, cfg.norm_type)
    else:
        x = x + attn_out
        mix_in = norm_apply(p["norm2"], x, cfg.norm_type)
    aux = None
    if kind == "moe":
        mix_out, aux = apply_moe(p["moe"], mix_in, cfg)
    else:
        mix_out = apply_mlp(p["mlp"], mix_in, cfg)
    x = x + mix_out + (attn_out if cfg.parallel_layers else 0)
    return x, cache, aux


REMATS = ("none", "full", "dots")


def _num_layers(tree) -> int:
    """The leading (layer) dim of a stacked params tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return (tree.q if isinstance(tree, QuantizedTensor) else tree).shape[0]


def apply_stack(segments_params, cfg: ModelConfig, x, *, positions,
                caches=None, cache_index=None, decode=False, shared=None,
                remat: str = "none", block_tables=None):
    """Run all segments layer by layer.  segments_params: list of
    (kind, stacked_params); caches: list aligned with segments (or None),
    updated in place; decode: single-token SSM steps; shared: zamba2's shared
    block; block_tables: (b, max_blocks) when the caches are a
    physical block pool (attention.apply_gqa).  remat: "none" keeps every layer's activations for
    the backward, "full" recomputes each layer there (blocks.py:282-283 of
    the JAX package).  Returns (x, caches, aux): aux the MoE layers'
    load-balance losses summed in f32 (a 0-d tensor; 0 without MoE
    layers), as blocks.py:257-293 of the JAX package carries it."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; valid: {list(REMATS)}")
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (keep the GEMM outputs, recompute the rest) is not ported "
            "yet: it comes with the remat-policy slice")
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (kind, sp) in enumerate(segments_params):
        _check_kind(kind)
        seg_cache = None if caches is None else caches[si]
        n = _num_layers(sp)
        for layer, p_l in enumerate(tree_unbind(sp, n)):
            if remat == "full" and seg_cache is None:
                def body(h, p_l=p_l, kind=kind):
                    out, _, a = _apply_core(p_l, h, cfg, kind, positions=positions,
                                            shared=shared)
                    return out, a
                x, aux = checkpoint(body, x, use_reentrant=False)
            else:
                c_l = None if seg_cache is None else tree_index(seg_cache, layer)
                x, _, aux = _apply_core(p_l, x, cfg, kind, positions=positions, cache=c_l,
                                        cache_index=cache_index, block_tables=block_tables,
                                        decode=decode, shared=shared)
            if aux is not None:
                total_aux = total_aux + aux
    return x, caches, total_aux
