"""Blocked online-softmax attention in plain PyTorch: a loop over KV blocks.

The JAX package's `models/blocked_attention.py` (a `lax.scan` in XLA, no
Pallas kernel): FlashAttention-2's streaming softmax over blocks of
`block_kv` keys, so the scores never exist at (sq, skv) at once.  It is
selected by `ModelConfig.attn_impl == "blocked"` for prefill and training
("naive" is the paper's score/AOV decomposition; "flash" the hand-written
kernels).  It differentiates through autograd.

Dtypes follow JAX's: q is scaled by 1/sqrt(hd) in q's dtype, the scores,
the running max m and the running sum l are float32, and the accumulator
stays in q's dtype (P is cast to v's dtype for the P.V product).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def blocked_sdpa(q, k, v, *, causal: bool, q_pos=None, kv_len=None, block_kv: int = 1024):
    """q: (b, sq, a, hd); k, v: (b, skv, kv, hd); GQA a % kv == 0.

    q_pos: (sq,) absolute query positions (causal masking against a
    cache); kv_len: the number of valid keys (an int or a 0-d tensor; the
    keys past it are masked).  Returns (b, sq, a, v_hd), the contract of
    `attention._sdpa`.  A tail of skv % block_kv keys is padded to a whole
    block (and masked)."""
    b, sq, a, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    g = a // nkv
    blk = min(block_kv, skv)
    if skv % blk:
        pad = blk - skv % blk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = k.shape[1] // blk
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(sq, device=dev)
    limit = skv if kv_len is None else kv_len

    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
    qg = q.reshape(b, sq, nkv, g, hd) / scale
    m = torch.full((b, nkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nkv, g, sq, vd), dtype=q.dtype, device=dev)
    for i in range(nblk):
        kc, vc = k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk]
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kc).float()
        pos = i * blk + torch.arange(blk, device=dev)
        valid = (pos < limit)[None, :]
        if causal:
            valid = valid & (pos[None, :] <= q_pos[:, None])
        s = torch.where(valid[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vc.dtype), vc)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, a, vd)
