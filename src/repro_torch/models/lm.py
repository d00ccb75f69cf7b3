"""Full models: params, caches and the forward pass of the decoder-only
LM, the VLM (a patch-embedding stub prepended to the token stream) and the
encoder-decoder (whisper; its conv frontend is a stub: the frames arrive as
embeddings).

Parameter layout (the JAX package's pytree, key for key):
  embed        (v, h)            token embedding
  pos_embed    (max_pos, h)      learned positions (pos_emb == "learned"),
                                 max_pos = max(encoder_seq, 8192)
  seg{i}       stacked params    one entry per stack_plan segment
  shared       zamba2's shared attention + MLP block (hybrid only)
  final_norm
  lm_head      (h, v)            untied output head
  encoder      whisper's encoder: seg0 (dense layers, stacked), final_norm
  xattn        whisper's cross-attention blocks, stacked per decoder
               layer: norm, attn
  mtp          deepseek's multi-token-prediction head: proj (2h, h), a
               dense block, norm (mtp_depth > 0)
For serving, GEMM weights and the embedding are held in the compute dtype
(`convert.params_from_jax`); for training every leaf is a float32 master
and `linear` casts per call, as JAX does.  Norm gains are float32 either
way, as are the SSM's conv kernels and biases, A_log, D and dt_bias (JAX
keeps them in float32 and casts per use); `pos_embed` is held as `embed`
is.

Under a sharding plan (`parallel/sharding.py`) the params are this rank's
blocks: the embedding's vocab rows (each rank looks up the tokens in its
range and one all-reduce over `model` sums the rows), the head's vocab
columns (its input through `copy_to_tp`; the logits are gathered over
`model`, or left sharded for `lm_loss`'s vocab-parallel cross entropy).
JAX's sharding constraints have no counterpart: the plan places the
collectives.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel import comm
from ..parallel import sharding as sh
from .attention import apply_attention, init_attention
from .blocks import (apply_layer, apply_stack, init_cache_segment, init_segment, init_shared,
                     stack_plan, tree_unbind)
from .layers import compute_dtype, dense_init, embed_init, norm_apply, norm_init
from .linear import linear
from .mlp import apply_mlp


def init_lm(gen: Optional[torch.Generator], cfg: ModelConfig, *, device,
            dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random params with the JAX package's shapes and scales (lm.py
    init_lm), drawn from `gen` on `device` (a CUDA generator draws on the
    card: the weights never pass through the host).  GEMM weights and the
    embedding come out in `dtype` (default: the config's compute dtype),
    norm gains in float32 — the layout `convert.params_from_jax` returns.
    `gen=None` uses the device's default generator (as the meta device
    needs)."""
    dtype = dtype or compute_dtype(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab_size, cfg.d_model, device=device, dtype=dtype)}
    if cfg.pos_emb == "learned":
        params["pos_embed"] = embed_init(gen, max(cfg.encoder_seq, 8192), cfg.d_model,
                                         device=device, dtype=dtype)
    for i, (kind, n) in enumerate(stack_plan(cfg)):
        params[f"seg{i}"] = init_segment(gen, cfg, kind, n, device=device, dtype=dtype)
    shared = init_shared(gen, cfg, device=device, dtype=dtype)
    if shared is not None:
        params["shared"] = shared
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm_type, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab_size,
                                       device=device, dtype=dtype)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "seg0": init_segment(gen, cfg, "dense", cfg.num_encoder_layers, device=device,
                                 dtype=dtype),
            "final_norm": norm_init(cfg.d_model, cfg.norm_type, device=device)}
        lead = (cfg.num_layers,)
        params["xattn"] = {
            "norm": norm_init(cfg.d_model, cfg.norm_type, lead=lead, device=device),
            "attn": init_attention(gen, cfg, lead=lead, device=device, dtype=dtype)}
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


def _embed(table, tokens, dt):
    """The embedding rows of `tokens` in dt; under tensor parallelism each
    rank holds a block of vocab rows, looks up the tokens in its range
    (zeros elsewhere), and one all-reduce over `model` sums the blocks:
    exactly one rank contributes each row."""
    if sh.tp_size() == 1:
        return table[tokens].to(dt)
    v_loc = table.shape[0]
    lo = sh.tp_rank() * v_loc
    mine = (tokens >= lo) & (tokens < lo + v_loc)
    rows = table[(tokens - lo).clamp(0, v_loc - 1)].to(dt)
    return sh.reduce_from_tp(rows.masked_fill(~mine[..., None], 0))


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16, device=None):
    return [init_cache_segment(cfg, kind, n, batch, s_max, dtype, device)
            for kind, n in stack_plan(cfg)]


# --- encoder (whisper; the conv frontend is a stub: frames are embeddings) ----------

def apply_encoder(params, frames, cfg: ModelConfig, remat: str = "none"):
    """frames: (b, enc_seq, h) precomputed frame embeddings (the stub).
    Learned positions, pre-norm blocks of non-causal self-attention and
    MLP, the final norm (lm.py:74-96 of the JAX package).  remat="full"
    recomputes each layer in the backward; "dots" keeps everything, as
    JAX's encoder does."""
    dt = compute_dtype(cfg.dtype)
    x = frames.to(dt)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.pos_emb == "learned":
        x = x + sh.fsdp_use(params["pos_embed"], "pos_embed")[positions].to(dt)[None]
    enc = params["encoder"]

    def body(h, p_l):
        p_l = sh.fsdp_use(p_l)
        hn = norm_apply(p_l["norm1"], h, cfg.norm_type)
        a, _ = apply_attention(p_l["attn"], hn, cfg, positions=positions, causal=False)
        h = h + a
        return h + apply_mlp(p_l["mlp"], norm_apply(p_l["norm2"], h, cfg.norm_type), cfg)

    for p_l in tree_unbind(enc["seg0"], cfg.num_encoder_layers):
        if remat == "full":
            x = checkpoint(body, x, p_l, use_reentrant=False)
        else:
            x = body(x, p_l)
    return norm_apply(sh.fsdp_use(enc["final_norm"]), x, cfg.norm_type)


def apply_lm(params, tokens, cfg: ModelConfig, *, positions=None, caches=None,
             cache_index=None, decode=False, remat: str = "none", block_tables=None,
             patch_embeds=None, encoder_frames=None, enc_out=None,
             return_hidden: bool = False, vocab_parallel: bool = False):
    """tokens: (b, s) integer tensor.  Returns (logits, caches, aux), and
    with `return_hidden` the pre-norm hidden state last, as JAX's
    (logits, caches, aux[, hidden]); aux is the MoE layers' load-balance
    loss (a 0-d f32 tensor, 0 without MoE layers).

    patch_embeds: (b, n_patches, h) -- the VLM stub, prepended to the token
    stream (the causal mask spans the patches, as JAX's does).
    encoder_frames: (b, enc_seq, h) -- the whisper stub; the encoder runs on
    them unless `enc_out`, its output, is given (decode steps reuse it).

    cache_index: an int (prefill write offset) or a (b,) tensor of per-row
    offsets (engine decode).  Caches are updated in place and returned.
    decode: `tokens` is one step after the caches' contents — SSM layers
    take their recurrent step (`decode_ssm`) from the cached state and conv
    tails, not the chunked form.
    block_tables: (b, max_blocks) int32 -- the caches are a physical KV
    block pool (leaves (n, num_blocks, block_size, kv, hd)) and row b's
    logical block j lives at block_tables[b, j]; single-token decode only.
    vocab_parallel: under tensor parallelism, return this rank's vocab
    columns of the logits instead of gathering them.
    """
    dt = compute_dtype(cfg.dtype)
    b, s = tokens.shape
    dev = tokens.device
    # cast, then scale in the compute dtype (lm.py:117's order)
    scale = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32).to(dt)
    embed = sh.fsdp_use(params["embed"], "embed")
    x = _embed(embed, tokens, dt) * scale  # a 0-d host tensor: no copy
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(dt), x], dim=1)
        s = x.shape[1]

    if positions is None:
        if torch.is_tensor(cache_index) and cache_index.dim():
            # vector cache_index (serving engine): per-row (b, s) positions
            positions = cache_index[:, None] + torch.arange(s, device=dev)[None]
        else:
            start = 0 if cache_index is None else int(cache_index)
            positions = start + torch.arange(s, device=dev)
    if cfg.pos_emb == "learned":
        pe = sh.fsdp_use(params["pos_embed"], "pos_embed")[positions].to(dt)
        x = x + (pe if positions.dim() > 1 else pe[None])

    if cfg.is_encoder_decoder and enc_out is None:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs encoder_frames or enc_out")
        enc_out = apply_encoder(params, encoder_frames, cfg, remat)

    segs = [(kind, params[f"seg{i}"]) for i, (kind, n) in enumerate(stack_plan(cfg))]
    x, caches, aux = apply_stack(segs, cfg, x, positions=positions, caches=caches,
                                 cache_index=cache_index, decode=decode,
                                 shared=sh.fsdp_use(params.get("shared")), remat=remat,
                                 block_tables=block_tables)

    if cfg.is_encoder_decoder:
        # whisper's cross-attention: the stacked blocks applied after the
        # self-attention stack (lm.py:149-156 of the JAX package, its
        # documented simplification: the same GEMM inventory)
        for p_l in tree_unbind(params["xattn"], cfg.num_layers):
            p_l = sh.fsdp_use(p_l)
            hn = norm_apply(p_l["norm"], x, cfg.norm_type)
            a, _ = apply_attention(p_l["attn"], hn, cfg, positions=positions, causal=False,
                                   kv_input=enc_out)
            x = x + a

    hidden = x
    x = norm_apply(sh.fsdp_use(params["final_norm"]), x, cfg.norm_type)
    # a tied head is the view embed^T, which the tile GEMM reads in place
    head = embed.T if cfg.tie_embeddings else sh.fsdp_use(params["lm_head"], "lm_head")
    logits = linear(sh.copy_to_tp(x), head, impl=cfg.linear_impl)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask the padded vocabulary tail, in the logits dtype (lm.py:162-165)
        v_loc = logits.shape[-1]
        pad_mask = sh.tp_rank() * v_loc + torch.arange(v_loc, device=dev) < cfg.vocab_size
        logits = logits.masked_fill(~pad_mask, -1e30)
    if not vocab_parallel and sh.tp_size() > 1:
        logits = sh.gather_from_tp(logits, -1)
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


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] where each rank of `group` holds a block
    of vocab columns (float32 logits (n, v_loc), labels (n,)): the max, the
    sum of exponentials and the label's logit are reduced over the group;
    the backward is the local block of softmax - onehot, no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        v_loc = logits.shape[-1]
        m = comm.all_reduce(logits.max(dim=-1).values, group, op="max")
        e = torch.exp(logits - m[..., None])
        total = comm.all_reduce(e.sum(dim=-1), group)
        mine = (labels >= lo) & (labels < lo + v_loc)
        idx = (labels - lo).clamp(0, v_loc - 1).long()
        picked = torch.gather(logits, -1, idx[..., None])[..., 0].masked_fill(~mine, 0.0)
        picked = comm.all_reduce(picked, group)
        ctx.save_for_backward(e / total[..., None], idx, mine)
        return torch.log(total) + m - picked

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p.scatter_add(-1, idx[..., None], -mine.to(p.dtype)[..., None])
        return grad * g[..., None], None, None, None


def _token_nll(logits, labels):
    """Per-token cross entropy in float32; vocab-parallel under tensor
    parallelism (`logits` then hold this rank's vocab columns)."""
    logits = logits.float()
    plan = sh.active()
    if plan is None or plan.tp == 1:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    v_loc = logits.shape[-1]
    flat = _VocabParallelNLL.apply(logits.reshape(-1, v_loc), labels.reshape(-1),
                                   plan.tp_rank * v_loc, plan.tp_group)
    return flat.reshape(labels.shape)


def _xent_share(logits, labels, mask=None):
    """This data rank's share of the global batch's mean cross entropy:
    its tokens' summed loss over the count of every rank's tokens, so the
    shares add up to `softmax_xent` of the whole batch."""
    nll = _token_nll(logits, labels)
    if mask is None:
        num, count = nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)
    else:
        mask = mask.float()
        num, count = (nll * mask).sum(), mask.sum()
    count = comm.all_reduce(count, sh.active().dp_group)
    return num / count.clamp_min(1.0)


def lm_loss(params, batch, cfg: ModelConfig, remat: str = "none"):
    """batch: dict(tokens, labels[, loss_mask, patch_embeds,
    encoder_frames]).  Returns (loss, metrics) (lm.py:185-221 of the JAX
    package): the next-token loss over the text positions (a VLM's patch
    positions are sliced off), plus 0.001 x the MoE aux loss ("aux_loss")
    where the model has experts, plus 0.3 x the depth-1 MTP loss
    ("mtp_loss") where it has an MTP head.

    Under a sharding plan `batch` is this data rank's rows and the loss
    returned is the rank's share of the global loss (the shares sum to
    it; the MoE aux loss, the same on every data rank, counts 1/dp a
    rank), whose gradient summed over the data ranks is the global one;
    `metrics` hold the global values."""
    plan = sh.active()
    xent = softmax_xent if plan is None else _xent_share
    patches = batch.get("patch_embeds")
    logits, _, aux, hidden = apply_lm(params, batch["tokens"], cfg, remat=remat,
                                      patch_embeds=patches,
                                      encoder_frames=batch.get("encoder_frames"),
                                      return_hidden=True, vocab_parallel=True)
    mask = batch.get("loss_mask")
    npatch = 0 if patches is None else patches.shape[1]
    if npatch:
        logits = logits[:, npatch:]
        hidden = hidden[:, npatch:]
    loss = xent(logits[:, :-1], batch["labels"][:, 1:], None if mask is None else mask[:, 1:])
    metrics = {"lm_loss": loss}
    if cfg.num_experts:
        if plan is not None:
            aux = aux / plan.dp
        metrics["aux_loss"] = aux
        loss = loss + 0.001 * aux
    if cfg.mtp_depth and "mtp" in params:
        dt = compute_dtype(cfg.dtype)
        mtp = sh.fsdp_use(params["mtp"])
        embed = sh.fsdp_use(params["embed"], "embed")
        emb_next = _embed(embed, batch["labels"], dt)
        mtp_in = linear(torch.cat([hidden.to(dt), emb_next], dim=-1), mtp["proj"],
                        impl=cfg.linear_impl)
        pos = torch.arange(mtp_in.shape[1], device=mtp_in.device)
        h2, _, _ = apply_layer(mtp["block"], mtp_in, cfg, "dense", positions=pos)
        h2 = norm_apply(mtp["norm"], h2, cfg.norm_type)
        head = embed.T if cfg.tie_embeddings else sh.fsdp_use(params["lm_head"], "lm_head")
        mtp_logits = linear(sh.copy_to_tp(h2), head, impl=cfg.linear_impl)
        mtp_loss = xent(mtp_logits[:, :-2], batch["labels"][:, 2:])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    metrics["loss"] = loss
    if plan is not None:
        metrics = {k: comm.all_reduce(v.detach(), plan.dp_group) for k, v in metrics.items()}
    return loss, metrics
