"""GQA attention: the naive score/AOV decomposition, the flash-attention
kernels (training: cache-free, differentiable) and the paged decode kernel
over the serving slot pool or block-table pool, float or int8; and
DeepSeek-V3's multi-head latent attention (MLA) with its latent cache.

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
from ..kernels.flash_attention.ops import (flash_attention, paged_decode,
                                           paged_decode_blocktable)
from ..kernels.flash_attention.ref import gather_block_kv
from ..quant import dequantize_kv, quantize_kv
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


def _write_rows(leaf, rows, cols, val):
    """leaf[rows[i], cols[i]] = val[i], in place (one `index_put_`)."""
    leaf.index_put_((rows, cols), val.to(leaf.dtype))


def _write_slice(leaf, ci: int, val):
    """leaf[:, ci:ci + s] = val, in place; raises where ci + s passes the
    cache's depth (the JAX package's `dynamic_update_slice` clamps the start
    there instead, over live KV:
    tests/test_torch_prefix.py::test_suffix_prefill_past_the_pool_depth)."""
    leaf[:, ci:ci + val.shape[1]].copy_(val)


def apply_gqa(p, x, cfg: ModelConfig, *, positions, cache=None, cache_index=None,
              block_tables=None):
    """x: (b, s, h).  Returns (out, cache).

    cache: dict(k=(b, s_max, kv, hd), v=...) or None; written in place.  An
    int8 cache (cfg.kv_dtype="int8") also holds k_scale, v_scale (b, s_max,
    kv) f32: k and v are quantized per (token, kv head) on write and
    dequantized on read (in the paged kernel, or up front on the plain path).
    cache_index: write offset — an int (prefill: positions ci..ci+s), or a
    (b,) tensor of per-row offsets (engine decode: s == 1, each slot at its
    own depth; `positions` is then the matching (b, 1) tensor).
    block_tables: (b, max_blocks) int32 — the cache is a physical block pool
    (k, v: (num_blocks, block_size, kv, hd)) and row b's logical block j is
    block_tables[b, j].  Single-token decode with a (b,) cache_index: the new
    token goes to (table[b, ci // bs], ci % bs).  Each live row's tail block
    is private (the pool's copy-on-write), so rows never collide; dead rows
    all write the pool's garbage block, which is never read.
    """
    if cfg.attn_impl not in ("naive", "paged", "flash"):
        raise _unsupported(f"attn_impl={cfg.attn_impl!r}", "tuning")
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
    quant = cache is not None and "k_scale" in cache
    # what a write stores, per cache leaf
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    scales = (cache["k_scale"], cache["v_scale"]) if quant else (None, None)
    paged = cfg.attn_impl == "paged" and cache is not None and s == 1

    if block_tables is not None:
        if cache is None or s != 1 or not (torch.is_tensor(cache_index)
                                          and cache_index.dim() == 1):
            raise ValueError("block_tables requires single-token decode with a (b,) "
                             "cache_index into a block-pool cache")
        bs = cache["k"].shape[1]   # physical block size (tokens)
        rows = torch.arange(b, device=x.device)
        phys = block_tables[rows, cache_index // bs].long()
        for name, leaf in cache.items():
            _write_rows(leaf, phys, cache_index % bs, new[name][:, 0])
        lengths = (cache_index + 1).to(torch.int32)
        kc, vc = cache["k"], cache["v"]
        if paged:
            out = paged_decode_blocktable(
                q[:, 0], kc if quant else kc.to(q.dtype), vc if quant else vc.to(q.dtype),
                block_tables, lengths, k_scale=scales[0], v_scale=scales[1], tuned=True)[:, None]
        else:
            kg, vg = gather_block_kv(kc, block_tables), gather_block_kv(vc, block_tables)
            if quant:
                kg = dequantize_kv(kg, gather_block_kv(scales[0], block_tables), q.dtype)
                vg = dequantize_kv(vg, gather_block_kv(scales[1], block_tables), q.dtype)
            out = _sdpa(q, kg.to(q.dtype), vg.to(q.dtype), causal=True, q_pos=positions,
                        kv_len=lengths)
        return linear(out.reshape(b, s, a * hd), p["wo"], impl=impl), cache

    kv_len = None
    if cache is not None:
        if torch.is_tensor(cache_index) and cache_index.dim():
            # per-row write positions (serving-engine slot pool)
            assert s == 1, "vector cache_index requires single-token decode"
            rows = torch.arange(b, device=x.device)
            for name, leaf in cache.items():
                _write_rows(leaf, rows, cache_index, new[name][:, 0])
        else:
            for name, leaf in cache.items():
                _write_slice(leaf, int(cache_index), new[name])
        k, v = cache["k"], cache["v"]
        if quant and not paged:   # the paged kernel dequantizes per kv tile
            k = dequantize_kv(k, scales[0], q.dtype)
            v = dequantize_kv(v, scales[1], q.dtype)
        kv_len = cache_index + s
    if cfg.attn_impl == "flash" and cache is None:
        # the flash kernels with their fused backward: the training path.
        # Cache-backed prefill and decode stay on the paths below, as in JAX
        out = flash_attention(q, k.to(q.dtype), v.to(q.dtype), causal=True)
    elif paged:
        # paged decode kernel over the slot pool (identity slot map here;
        # the kernel's gather-by-slot path is exercised by its tests)
        lengths = torch.as_tensor(kv_len, device=x.device).to(torch.int32).expand(b)
        out = paged_decode(q[:, 0], k if quant else k.to(q.dtype), v if quant else v.to(q.dtype),
                           torch.arange(b, dtype=torch.int32, device=x.device),
                           lengths.contiguous(), k_scale=scales[0], v_scale=scales[1],
                           tuned=True)[:, None]
    else:
        out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), causal=True,
                    q_pos=positions, kv_len=kv_len)
    out = linear(out.reshape(b, s, a * hd), p["wo"], impl=impl)
    return out, cache


# --- DeepSeek-V3 Multi-head Latent Attention ------------------------------------------

def init_mla(gen: Optional[torch.Generator], cfg: ModelConfig, *, lead=(), device=None,
             dtype=torch.float32):
    h, a = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "wq_down": dense_init(gen, h, qr, **kw),
        "wq_up": dense_init(gen, qr, a * (nope + rope), **kw),
        "wkv_down": dense_init(gen, h, kvr + rope, **kw),
        "wk_up": dense_init(gen, kvr, a * nope, **kw),
        "wv_up": dense_init(gen, kvr, a * vd, **kw),
        "wo": dense_init(gen, a * vd, h, scale=1.0 / (2 * cfg.num_layers) ** 0.5, **kw),
    }


def apply_mla(p, x, cfg: ModelConfig, *, positions, cache=None, cache_index=None):
    """MLA with a latent-KV cache (attention.py:273-317 of the JAX package).
    x: (b, s, h).  Returns (out, cache).

    cache: dict(latent=(b, s_max, kv_lora_rank + qk_rope_dim)) or None,
    written in place at the int `cache_index` (positions ci..ci+s) with the
    post-rotary latent (c_kv ++ k_rope); k_nope and v are then recomputed
    from the whole cached latent, through `linear`, each call.  Prefill and
    training run the same decompressed (naive) path; the weight-absorbed
    schedule is what `core/` models.  The scores are the plain `_sdpa`
    product, which JAX also computes outside any Pallas kernel.  A per-row
    (tensor) cache_index raises, as JAX's `dynamic_update_slice` does.
    """
    b, s, _ = x.shape
    a = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    impl = cfg.linear_impl
    q = linear(linear(x, p["wq_down"], impl=impl), p["wq_up"], impl=impl)
    q = q.reshape(b, s, a, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rotary(q_rope, positions, cfg.rope_theta)

    latent = linear(x, p["wkv_down"], impl=impl)  # (b, s, kvr + rope)
    c_kv, k_rope_flat = latent[..., :kvr], latent[..., kvr:]
    k_rope = apply_rotary(k_rope_flat[..., None, :], positions, cfg.rope_theta)

    kv_len = None
    if cache is not None:
        if torch.is_tensor(cache_index) and cache_index.dim():
            raise ValueError("MLA's latent cache takes an int cache_index "
                             "(one write offset for every row)")
        ci = int(cache_index)
        stored = cache["latent"]
        _write_slice(stored, ci, torch.cat([c_kv, k_rope[..., 0, :]], dim=-1))
        c_kv = stored[..., :kvr].to(x.dtype)
        k_rope = stored[..., None, kvr:].to(x.dtype)
        kv_len = ci + s

    skv = c_kv.shape[1]
    c_kv = c_kv.contiguous()   # a slice of the latent: the tile GEMM takes whole rows
    k_nope = linear(c_kv, p["wk_up"], impl=impl).reshape(b, skv, a, nope)
    v = linear(c_kv, p["wv_up"], impl=impl).reshape(b, skv, a, vd)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, skv, a, rope)], dim=-1)
    out = _sdpa(q_full, k_full, v, causal=True,
                q_pos=positions[0] if positions.dim() > 1 else positions, kv_len=kv_len)
    out = linear(out.reshape(b, s, a * vd), p["wo"], impl=impl)
    return out, cache


def init_attention(gen, cfg: ModelConfig, **kw):
    return init_mla(gen, cfg, **kw) if cfg.attn_type == "mla" else init_gqa(gen, cfg, **kw)


def apply_attention(p, x, cfg: ModelConfig, **kw):
    if cfg.attn_type == "mla":
        if kw.pop("block_tables", None) is not None:
            raise ValueError("block-table KV paging is not supported for MLA")
        return apply_mla(p, x, cfg, **kw)
    return apply_gqa(p, x, cfg, **kw)
