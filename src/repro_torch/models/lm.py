"""Decoder-only LM: params, caches and the forward pass.

Parameter layout (the JAX package's pytree, key for key):
  embed        (v, h)            token embedding
  seg{i}       stacked params    one entry per stack_plan segment
  final_norm
  lm_head      (h, v)            untied output head
GEMM weights and the embedding are held in the compute dtype, norm gains
in float32 (see `convert.params_from_jax`).  The encoder-decoder, VLM and
MTP parts come with the other-families slice; sharding constraints have
no counterpart on one card and are dropped.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from .blocks import apply_stack, init_cache_segment, init_segment, stack_plan
from .layers import compute_dtype, dense_init, embed_init, norm_apply, norm_init
from .linear import linear


def _check_decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder or cfg.num_patches or cfg.mtp_depth or cfg.pos_emb == "learned":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder, VLM, MTP and learned positions are not "
            f"ported yet: they come with the other-families slice")


def init_lm(gen: Optional[torch.Generator], cfg: ModelConfig, *, device,
            dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random params with the JAX package's shapes and scales (lm.py
    init_lm), drawn from `gen` on `device` (a CUDA generator draws on the
    card: the weights never pass through the host).  GEMM weights and the
    embedding come out in `dtype` (default: the config's compute dtype),
    norm gains in float32 — the layout `convert.params_from_jax` returns.
    `gen=None` uses the device's default generator (as the meta device
    needs)."""
    _check_decoder_only(cfg)
    dtype = dtype or compute_dtype(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab_size, cfg.d_model, device=device, dtype=dtype)}
    for i, (kind, n) in enumerate(stack_plan(cfg)):
        params[f"seg{i}"] = init_segment(gen, cfg, kind, n, device=device, dtype=dtype)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm_type, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab_size,
                                       device=device, dtype=dtype)
    return params


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16, device=None):
    return [init_cache_segment(cfg, kind, n, batch, s_max, dtype, device)
            for kind, n in stack_plan(cfg)]


def apply_lm(params, tokens, cfg: ModelConfig, *, positions=None, caches=None,
             cache_index=None):
    """tokens: (b, s) integer tensor.  Returns (logits, caches).

    cache_index: an int (prefill write offset) or a (b,) tensor of per-row
    offsets (engine decode).  Caches are updated in place and returned.
    (The JAX function also returns the MoE aux loss, which a dense decoder
    does not have.)
    """
    _check_decoder_only(cfg)
    dt = compute_dtype(cfg.dtype)
    b, s = tokens.shape
    dev = tokens.device
    # cast, then scale in the compute dtype (lm.py:117's order)
    scale = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32).to(dt)
    x = params["embed"][tokens].to(dt) * scale  # a 0-d host tensor: no copy

    if positions is None:
        if torch.is_tensor(cache_index) and cache_index.dim():
            # vector cache_index (serving engine): per-row (b, s) positions
            positions = cache_index[:, None] + torch.arange(s, device=dev)[None]
        else:
            start = 0 if cache_index is None else int(cache_index)
            positions = start + torch.arange(s, device=dev)

    segs = [(kind, params[f"seg{i}"]) for i, (kind, n) in enumerate(stack_plan(cfg))]
    x, caches = apply_stack(segs, cfg, x, positions=positions, caches=caches,
                            cache_index=cache_index)

    x = norm_apply(params["final_norm"], x, cfg.norm_type)
    if cfg.tie_embeddings:
        # the head is embed^T, which the kernels cannot take in place (they
        # read row-major operands): compute (embed . x^T)^T instead, so the
        # (v, h) table is read as it lies and only the activations transpose
        xt = x.reshape(b * s, -1).T.contiguous()
        logits = linear(params["embed"], xt, impl=cfg.linear_impl).T.reshape(b, s, -1)
    else:
        logits = linear(x, params["lm_head"], impl=cfg.linear_impl)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask the padded vocabulary tail, in the logits dtype (lm.py:162-165)
        pad_mask = torch.arange(cfg.padded_vocab_size, device=dev) < cfg.vocab_size
        logits = logits.masked_fill(~pad_mask, -1e30)
    return logits, caches
