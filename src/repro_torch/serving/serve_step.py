"""Serving: prefill + single-token decode steps over in-place KV caches.

Under a sharding plan (`parallel/sharding.py`, tensor parallelism over
`model`) the steps take this rank's blocks of the params, hold the caches
of this rank's KV heads (JAX's `cache_specs` shard the sequence instead:
the same numbers), and return the whole logits on every rank.  The engines
stay single-rank, as JAX's launcher serves on one device."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import apply_lm, init_caches
from ..models.layers import compute_dtype
from ..parallel import sharding as sh


def _serving_plan(plan):
    """Serving holds params whole over `data`: FSDP blocks would be
    all-gathered a layer at a time at every decode step."""
    if plan is not None and plan.data_sharded:
        raise ValueError(
            f"serve steps under FSDP (data={plan.mesh.shape['data']}, fsdp=True): serving holds "
            "params whole over data, or every decode step would all-gather every layer; build "
            "the mesh with MeshConfig(..., fsdp=False)")
    return plan


def make_prefill_step(cfg: ModelConfig, s_max: int, plan=None):
    """prefill(params, batch) -> (next_token_logits, caches); batch holds
    "tokens" (b, s) and, where the model takes them, "patch_embeds" (a VLM:
    the caches then hold n_patches + s positions, so s_max counts the
    patches) or "encoder_frames" (an encoder-decoder), on the params'
    device.  plan: a sharding plan (params are then this rank's blocks)."""

    @sh.under(_serving_plan(plan))
    def prefill(params, batch):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        caches = init_caches(cfg, b, s_max, compute_dtype(cfg.dtype), tokens.device)
        logits, caches, _ = apply_lm(params, tokens, cfg, caches=caches, cache_index=0,
                                     patch_embeds=batch.get("patch_embeds"),
                                     encoder_frames=batch.get("encoder_frames"))
        return logits[:, -1], caches

    return prefill


def make_decode_step(cfg: ModelConfig, plan=None):
    """decode(params, token, caches, index, enc_out=None) -> (logits, caches).

    token: (b, 1); index: int — the cache write position (and the rotary or
    learned position of the new token).  The caches are written in place.
    SSM layers take their recurrent step (`decode=True`, as the JAX
    package's decode step passes).  enc_out: an encoder-decoder's encoder
    output (`models.apply_encoder`), computed once per request batch; the
    cross-attention projects its K/V from it every step, as JAX's does.
    plan: a sharding plan (params are then this rank's blocks).
    """

    @sh.under(_serving_plan(plan))
    def decode(params, token, caches, index, enc_out=None):
        logits, caches, _ = apply_lm(params, token, cfg, caches=caches, cache_index=index,
                                     decode=True, enc_out=enc_out)
        return logits[:, -1], caches

    return decode


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    num_tokens: int, s_max: int = 0, plan=None) -> torch.Tensor:
    """Reference end-to-end generation loop (examples / tests)."""
    b, s0 = prompt.shape
    s_max = s_max or (s0 + num_tokens)
    prefill = make_prefill_step(cfg, s_max, plan)
    decode = make_decode_step(cfg, plan)
    logits, caches = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [tok]
    idx = s0
    for _ in range(num_tokens - 1):
        logits, caches = decode(params, tok, caches, idx)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
        idx += 1
    return torch.cat(out, dim=1)
