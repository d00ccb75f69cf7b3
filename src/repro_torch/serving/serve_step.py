"""Serving: prefill + single-token decode steps over in-place KV caches."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import apply_lm, init_caches
from ..models.layers import compute_dtype


def make_prefill_step(cfg: ModelConfig, s_max: int):
    """prefill(params, batch) -> (next_token_logits, caches); batch holds
    "tokens" (b, s), on the params' device."""

    def prefill(params, batch):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        caches = init_caches(cfg, b, s_max, compute_dtype(cfg.dtype), tokens.device)
        logits, caches, _ = apply_lm(params, tokens, cfg, caches=caches, cache_index=0)
        return logits[:, -1], caches

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, token, caches, index) -> (logits, caches).

    token: (b, 1); index: int — the cache write position (and the rotary
    position of the new token).  The caches are written in place.  SSM
    layers take their recurrent step (`decode=True`, as the JAX package's
    decode step passes).
    """

    def decode(params, token, caches, index):
        logits, caches, _ = apply_lm(params, token, cfg, caches=caches, cache_index=index,
                                  decode=True)
        return logits[:, -1], caches

    return decode


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    num_tokens: int, s_max: int = 0) -> torch.Tensor:
    """Reference end-to-end generation loop (examples / tests)."""
    b, s0 = prompt.shape
    s_max = s_max or (s0 + num_tokens)
    prefill = make_prefill_step(cfg, s_max)
    decode = make_decode_step(cfg)
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
