"""Decoder-only LM: params, caches and the forward pass.

Parameter layout (the JAX package's pytree, key for key):
  embed        (v, h)            token embedding
  seg{i}       stacked params    one entry per stack_plan segment
  shared       zamba2's shared attention + MLP block (hybrid only)
  final_norm
  lm_head      (h, v)            untied output head
For serving, GEMM weights and the embedding are held in the compute dtype
(`convert.params_from_jax`); for training every leaf is a float32 master
and `linear` casts per call, as JAX does.  Norm gains are float32 either
way, as are the SSM's conv kernels and biases, A_log, D and dt_bias (JAX
keeps them in float32 and casts per use).  The encoder-decoder, VLM and
MTP parts (and MTP's and MoE's extra losses) come with the other-families
slice; sharding constraints have no counterpart on one card and are
dropped.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from .blocks import apply_stack, init_cache_segment, init_segment, init_shared, stack_plan
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
    shared = init_shared(gen, cfg, device=device, dtype=dtype)
    if shared is not None:
        params["shared"] = shared
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm_type, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab_size,
                                       device=device, dtype=dtype)
    return params


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16, device=None):
    return [init_cache_segment(cfg, kind, n, batch, s_max, dtype, device)
            for kind, n in stack_plan(cfg)]


def apply_lm(params, tokens, cfg: ModelConfig, *, positions=None, caches=None,
             cache_index=None, decode=False, remat: str = "none", block_tables=None):
    """tokens: (b, s) integer tensor.  Returns (logits, caches).

    cache_index: an int (prefill write offset) or a (b,) tensor of per-row
    offsets (engine decode).  Caches are updated in place and returned.
    decode: `tokens` is one step after the caches' contents — SSM layers
    take their recurrent step (`decode_ssm`) from the cached state and conv
    tails, not the chunked form.
    block_tables: (b, max_blocks) int32 -- the caches are a physical KV
    block pool (leaves (n, num_blocks, block_size, kv, hd)) and row b's
    logical block j lives at block_tables[b, j]; single-token decode only.
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
                            cache_index=cache_index, decode=decode, shared=params.get("shared"),
                            remat=remat, block_tables=block_tables)

    x = norm_apply(params["final_norm"], x, cfg.norm_type)
    # a tied head is the view embed^T, which the tile GEMM reads in place
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = linear(x, head, impl=cfg.linear_impl)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask the padded vocabulary tail, in the logits dtype (lm.py:162-165)
        pad_mask = torch.arange(cfg.padded_vocab_size, device=dev) < cfg.vocab_size
        logits = logits.masked_fill(~pad_mask, -1e30)
    return logits, caches


# --- loss ----------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross entropy, in float32.  logits: (b, s, v);
    labels: (b, s)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def lm_loss(params, batch, cfg: ModelConfig, remat: str = "none"):
    """batch: dict(tokens, labels[, loss_mask]).  Returns (loss, metrics)
    for the dense decoder, mamba2 (`ssm` segments) and zamba2
    (`hybrid_super` segments with the shared attention + MLP block)
    (lm.py:197-221 of the JAX package); MoE (its aux loss), MTP and VLM /
    encoder inputs raise with the other-families slice."""
    if cfg.num_experts or batch.get("patch_embeds") is not None \
            or batch.get("encoder_frames") is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE aux loss and VLM / encoder inputs are not ported yet: "
            f"they come with the other-families slice")
    logits, _ = apply_lm(params, batch["tokens"], cfg, remat=remat)
    mask = batch.get("loss_mask")
    loss = softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                        None if mask is None else mask[:, 1:])
    return loss, {"lm_loss": loss, "loss": loss}
