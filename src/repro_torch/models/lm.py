"""Decoder-only LM: params, caches and the forward pass.

Parameter layout (the JAX package's pytree, key for key):
  embed        (v, h)            token embedding
  seg{i}       stacked params    one entry per stack_plan segment
  shared       zamba2's shared attention + MLP block (hybrid only)
  final_norm
  lm_head      (h, v)            untied output head
  mtp          deepseek's multi-token-prediction head: proj (2h, h), a
               dense block, norm (mtp_depth > 0)
For serving, GEMM weights and the embedding are held in the compute dtype
(`convert.params_from_jax`); for training every leaf is a float32 master
and `linear` casts per call, as JAX does.  Norm gains are float32 either
way, as are the SSM's conv kernels and biases, A_log, D and dt_bias (JAX
keeps them in float32 and casts per use).  The encoder-decoder and VLM
parts and learned positions come with their own slice; sharding
constraints have no counterpart on one card and are dropped.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from .blocks import (_apply_core, apply_stack, init_cache_segment, init_segment, init_shared,
                     stack_plan)
from .layers import compute_dtype, dense_init, embed_init, norm_apply, norm_init
from .linear import linear


def _check_decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder or cfg.num_patches or cfg.pos_emb == "learned":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder, VLM and learned positions are not "
            f"ported yet: they come with the encoder-decoder and VLM slice")


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
    if cfg.mtp_depth:
        block = init_segment(gen, cfg, "dense", 1, device=device, dtype=dtype)
        params["mtp"] = {
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, device=device, dtype=dtype),
            "block": {k: _unstack(v) for k, v in block.items()},
            "norm": norm_init(cfg.d_model, cfg.norm_type, device=device),
        }
    return params


def _unstack(tree):
    """The one layer of a 1-layer stacked tree (a view, made contiguous)."""
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    return tree[0].contiguous()


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16, device=None):
    return [init_cache_segment(cfg, kind, n, batch, s_max, dtype, device)
            for kind, n in stack_plan(cfg)]


def apply_lm(params, tokens, cfg: ModelConfig, *, positions=None, caches=None,
             cache_index=None, decode=False, remat: str = "none", block_tables=None,
             return_hidden: bool = False):
    """tokens: (b, s) integer tensor.  Returns (logits, caches, aux), and
    with `return_hidden` the pre-norm hidden state last, as JAX's
    (logits, caches, aux[, hidden]); aux is the MoE layers' load-balance
    loss (a 0-d f32 tensor, 0 without MoE layers).

    cache_index: an int (prefill write offset) or a (b,) tensor of per-row
    offsets (engine decode).  Caches are updated in place and returned.
    decode: `tokens` is one step after the caches' contents — SSM layers
    take their recurrent step (`decode_ssm`) from the cached state and conv
    tails, not the chunked form.
    block_tables: (b, max_blocks) int32 -- the caches are a physical KV
    block pool (leaves (n, num_blocks, block_size, kv, hd)) and row b's
    logical block j lives at block_tables[b, j]; single-token decode only.
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
    x, caches, aux = apply_stack(segs, cfg, x, positions=positions, caches=caches,
                                 cache_index=cache_index, decode=decode,
                                 shared=params.get("shared"), remat=remat,
                                 block_tables=block_tables)

    hidden = x
    x = norm_apply(params["final_norm"], x, cfg.norm_type)
    # a tied head is the view embed^T, which the tile GEMM reads in place
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = linear(x, head, impl=cfg.linear_impl)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask the padded vocabulary tail, in the logits dtype (lm.py:162-165)
        pad_mask = torch.arange(cfg.padded_vocab_size, device=dev) < cfg.vocab_size
        logits = logits.masked_fill(~pad_mask, -1e30)
    if return_hidden:
        return logits, caches, aux, hidden
    return logits, caches, aux


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
    (lm.py:185-221 of the JAX package): the next-token loss, plus 0.001 x
    the MoE aux loss ("aux_loss") where the model has experts, plus 0.3 x
    the depth-1 MTP loss ("mtp_loss") where it has an MTP head.  VLM and
    encoder inputs raise with their slice."""
    if batch.get("patch_embeds") is not None or batch.get("encoder_frames") is not None:
        raise NotImplementedError(
            f"{cfg.name}: VLM / encoder inputs are not ported yet: they come with the "
            f"encoder-decoder and VLM slice")
    logits, _, aux, hidden = apply_lm(params, batch["tokens"], cfg, remat=remat,
                                      return_hidden=True)
    mask = batch.get("loss_mask")
    loss = softmax_xent(logits[:, :-1], batch["labels"][:, 1:],
                        None if mask is None else mask[:, 1:])
    metrics = {"lm_loss": loss}
    if cfg.num_experts:
        metrics["aux_loss"] = aux
        loss = loss + 0.001 * aux
    if cfg.mtp_depth and "mtp" in params:
        dt = compute_dtype(cfg.dtype)
        mtp = params["mtp"]
        emb_next = params["embed"][batch["labels"]].to(dt)
        mtp_in = linear(torch.cat([hidden.to(dt), emb_next], dim=-1), mtp["proj"],
                        impl=cfg.linear_impl)
        pos = torch.arange(mtp_in.shape[1], device=mtp_in.device)
        h2, _, _ = _apply_core(mtp["block"], mtp_in, cfg, "dense", positions=pos)
        h2 = norm_apply(mtp["norm"], h2, cfg.norm_type)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        mtp_logits = linear(h2, head, impl=cfg.linear_impl)
        mtp_loss = softmax_xent(mtp_logits[:, :-2], batch["labels"][:, 2:])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    metrics["loss"] = loss
    return loss, metrics
