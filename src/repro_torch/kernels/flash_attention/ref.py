"""Plain PyTorch versions of the flash-attention kernels and of the paged
decode kernel over a slot pool or a block table, float or int8 (the CPU
path, and what the CUDA kernels are held against), and the JAX package's
attention oracle."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pool_f32(pool, scales):
    """A KV pool (or its gathered rows) in f32; an int8 pool dequantized per
    (token, kv head) as the kernels do it: widen, then one f32 product."""
    if scales is None:
        return pool.float()
    return pool.float() * scales.float()[..., None]


def paged_decode_ref(q, k_pool, v_pool, slot_idx, lengths, scale=None, k_scale=None,
                     v_scale=None):
    """q: (b, a, d); k_pool, v_pool: (slots, s_max, nkv, d); slot_idx: (b,)
    row->slot gather; lengths: (b,) live kv entries per row (0 = dead slot,
    returns zeros).  GQA via a % nkv == 0.  k_scale, v_scale: (slots, s_max,
    nkv) f32 for an int8 pool, dequantized in f32.  Returns (b, a, d)."""
    b, a, d = q.shape
    _, s_max, nkv, _ = k_pool.shape
    g = a // nkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    slot_idx = slot_idx.long()
    # (b, nkv, s_max, d)
    k = _pool_f32(k_pool[slot_idx], None if k_scale is None else k_scale[slot_idx]).transpose(1, 2)
    v = _pool_f32(v_pool[slot_idx], None if v_scale is None else v_scale[slot_idx]).transpose(1, 2)
    qh = q.reshape(b, nkv, g, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qh.float(), k) * scale
    live = torch.arange(s_max, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, a, d).to(q.dtype)


def gather_block_kv(pool, block_tables):
    """(num_blocks, bs, ...) pool + (b, max_blocks) tables -> contiguous
    (b, max_blocks * bs, ...) per-row KV (or scales) in logical order."""
    g = pool[block_tables.long()]                 # (b, max_nb, bs, ...)
    b, max_nb, bs = g.shape[:3]
    return g.reshape(b, max_nb * bs, *g.shape[3:])


def paged_decode_blocktable_ref(q, k_blocks, v_blocks, block_tables, lengths, scale=None,
                                k_scale=None, v_scale=None):
    """Plain version of the block-table kernel: gather each row's physical
    blocks (and an int8 pool's (num_blocks, bs, nkv) scales) into the
    logical layout, then slot-decode with an identity map."""
    b = q.shape[0]
    ks = None if k_scale is None else gather_block_kv(k_scale, block_tables)
    vs = None if v_scale is None else gather_block_kv(v_scale, block_tables)
    return paged_decode_ref(q, gather_block_kv(k_blocks, block_tables),
                            gather_block_kv(v_blocks, block_tables),
                            torch.arange(b, dtype=torch.int32, device=q.device), lengths,
                            scale=scale, k_scale=ks, v_scale=vs)


def attention_ref(q, k, v, causal: bool = True, scale=None):
    """The JAX package's attention oracle, folded layout: q (bh, sq, d); k, v
    (bkv, skv, d); GQA via bh % bkv == 0.  Its causal mask is bottom-right
    (tril(k = skv - sq)); it agrees with the kernels' top-left mask when
    sq == skv, as in training."""
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    g = bh // bkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k = torch.repeat_interleave(k, g, dim=0)
    v = torch.repeat_interleave(v, g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril(skv - sq)
        s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def _acc(q):
    """The accumulation dtype: float32, or float64 for float64 inputs (the
    tests' exact references)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores(q, k, causal: bool, scale):
    """f32 scores (b, nkv, g, sq, skv) and the live mask (sq, skv) or None."""
    b, sq, a, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qh = q.to(_acc(q)).reshape(b, sq, nkv, a // nkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.to(_acc(q))) * scale
    if not causal:
        return s, None
    # top-left, as the kernels (kernel.py:42-45): key j is live for query i
    # when j <= i
    mask = (torch.arange(skv, device=q.device)[None, :]
            <= torch.arange(sq, device=q.device)[:, None])
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_ref(q, k, v, causal: bool = True, scale=None):
    """Plain version of the flash forward kernel.  q (b, sq, a, d); k, v (b,
    skv, nkv, d).  Returns (out like q, lse (b, a, sq) f32).  A row with no
    live key gets output 0 and lse 0 (kernel.py:101-112)."""
    b, sq, a, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s, mask = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
        lse = torch.where(mask.any(-1), lse, 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(_acc(q))).reshape(b, sq, a, d)
    return out.to(q.dtype).contiguous(), lse.reshape(b, a, sq).contiguous()


def attention_di(o, do):
    """rowsum(do * o) in f32, (b, a, sq): the softmax-Jacobian diagonal term
    (backward.py:137-138) of the plain version (the CUDA backward takes it
    in a pre-pass kernel)."""
    return (do.to(_acc(o)) * o.to(_acc(o))).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True, scale=None):
    """Plain version of the flash backward kernels: (dq, dk, dv) from the
    forward's o and lse, p recomputed as exp(s * scale - lse), in f32, each
    rounded once to its input's dtype.  dk and dv sum the g query heads of
    each kv head."""
    b, sq, a, d = q.shape
    nkv = k.shape[2]
    g = a // nkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, nkv, g, sq)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    di = attention_di(o, do).reshape(b, nkv, g, sq)
    qh = q.to(_acc(q)).reshape(b, sq, nkv, g, d)
    doh = do.to(_acc(q)).reshape(b, sq, nkv, g, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", doh, v.to(_acc(q)))
    ds = p * (dp - di[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(_acc(q))).reshape(b, sq, a, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qh)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
