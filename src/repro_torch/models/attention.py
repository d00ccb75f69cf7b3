"""GQA attention: the naive score/AOV decomposition and the paged decode
kernel over the serving slot pool.

Caches are updated in place: the JAX package returns new cache arrays
(`dynamic_update_slice`, a one-hot `where`, donated buffers); the port
writes the same values into the caller's tensors with `copy_` (scalar
`cache_index`, prefill) and one `index_put_` per layer (vector
`cache_index`, engine decode), and returns those same tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import paged_decode
from .layers import apply_rotary, dense_init
from .linear import linear

NEG_INF = -1e30


def init_gqa(gen: Optional[torch.Generator], cfg: ModelConfig, *, lead=(), device=None,
             dtype=torch.float32):
    h, hd = cfg.d_model, cfg.head_dim
    a, kv = cfg.num_heads, cfg.num_kv_heads
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {
        "wq": dense_init(gen, h, a * hd, **kw),
        "wk": dense_init(gen, h, kv * hd, **kw),
        "wv": dense_init(gen, h, kv * hd, **kw),
        "wo": dense_init(gen, a * hd, h, scale=1.0 / (2 * cfg.num_layers) ** 0.5, **kw),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", a * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((*lead, n), dtype=dtype, device=device)
    return p


def _sdpa(q, k, v, causal: bool, q_pos=None, kv_len=None):
    """Reference scaled-dot-product attention.

    q: (b, sq, a, hd); k, v: (b, skv, kv, hd).  GQA: a % kv == 0.
    q_pos: (sq,) absolute query positions, or (b, sq) per-row positions;
    kv_len: number of valid cache entries (int, or a (b,) tensor per row).
    """
    b, sq, a, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = a // nkv
    q = q.reshape(b, sq, nkv, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    scores = scores / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    kv_pos = torch.arange(skv, device=q.device)
    mask = None  # (B, sq, skv) with B in {1, b}, broadcast over head dims
    if causal:
        if q_pos is None:
            q_pos = torch.arange(sq, device=q.device)
        if q_pos.dim() == 1:
            mask = (kv_pos[None, :] <= q_pos[:, None])[None]
        else:  # per-row query positions
            mask = kv_pos[None, None, :] <= q_pos[:, :, None]
    if kv_len is not None:
        if torch.is_tensor(kv_len) and kv_len.dim():
            live = (kv_pos[None, :] < kv_len[:, None])[:, None, :]
        else:
            live = (kv_pos < kv_len)[None, None, :]
        mask = live if mask is None else mask & live
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, sq, a, v.shape[-1])


def _unsupported(what: str, slice_name: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with the {slice_name} slice")


def apply_gqa(p, x, cfg: ModelConfig, *, positions, cache=None, cache_index=None,
              block_tables=None):
    """x: (b, s, h).  Returns (out, cache).

    cache: dict(k=(b, s_max, kv, hd), v=...) or None; written in place.
    cache_index: write offset — an int (prefill: positions ci..ci+s), or a
    (b,) tensor of per-row offsets (engine decode: s == 1, each slot at its
    own depth; `positions` is then the matching (b, 1) tensor).
    """
    if block_tables is not None:
        raise _unsupported("the block-table KV pool", "prefix-cache")
    if cache is not None and "k_scale" in cache:
        raise _unsupported("int8 KV caches", "low-precision")
    if cfg.attn_impl not in ("naive", "paged"):
        raise _unsupported(f"attn_impl={cfg.attn_impl!r}", "training")
    b, s, h = x.shape
    a, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    impl = cfg.linear_impl
    q = linear(x, p["wq"], impl=impl)
    k = linear(x, p["wk"], impl=impl)
    v = linear(x, p["wv"], impl=impl)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, a, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.pos_emb == "rotary":
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    kv_len = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if torch.is_tensor(cache_index) and cache_index.dim():
            # per-row write positions (serving-engine slot pool)
            assert s == 1, "vector cache_index requires single-token decode"
            rows = torch.arange(b, device=x.device)
            ck.index_put_((rows, cache_index), k[:, 0].to(ck.dtype))
            cv.index_put_((rows, cache_index), v[:, 0].to(cv.dtype))
        else:
            ci = int(cache_index)
            ck[:, ci:ci + s].copy_(k)
            cv[:, ci:ci + s].copy_(v)
        k, v = ck, cv
        kv_len = cache_index + s
    if cfg.attn_impl == "paged" and cache is not None and s == 1:
        # paged decode kernel over the slot pool (identity slot map here;
        # the kernel's gather-by-slot path is exercised by its tests)
        lengths = torch.as_tensor(kv_len, device=x.device).to(torch.int32).expand(b)
        out = paged_decode(q[:, 0], k.to(q.dtype), v.to(q.dtype),
                           torch.arange(b, dtype=torch.int32, device=x.device),
                           lengths.contiguous())[:, None]
    else:
        out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), causal=True,
                    q_pos=positions, kv_len=kv_len)
    out = linear(out.reshape(b, s, a * hd), p["wo"], impl=impl)
    return out, cache


def init_attention(gen, cfg: ModelConfig, **kw):
    if cfg.attn_type == "mla":
        raise _unsupported("MLA attention", "other-families")
    return init_gqa(gen, cfg, **kw)


def apply_attention(p, x, cfg: ModelConfig, **kw):
    if cfg.attn_type == "mla":
        raise _unsupported("MLA attention", "other-families")
    return apply_gqa(p, x, cfg, **kw)
