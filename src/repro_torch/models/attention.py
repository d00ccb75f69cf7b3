"""GQA attention: the naive score/AOV decomposition, the flash-attention
kernels (training and cache-free passes: causal self-attention,
non-causal encoder and cross-attention; differentiable), blocked
online-softmax attention in plain PyTorch (`blocked_attention.py`) and
the paged decode kernel over the serving slot pool or block-table pool,
float or int8; and DeepSeek-V3's multi-head latent attention (MLA) with its
latent cache.

Caches are updated in place: the JAX package returns new cache arrays
(`dynamic_update_slice`, a one-hot `where`, donated buffers); the port
writes the same values into the caller's tensors with `copy_` (scalar
`cache_index`, prefill) and one `index_put_` per layer (vector
`cache_index`, engine decode), and returns those same tensors.

Under tensor parallelism (`parallel/sharding.py`) a GQA layer holds its
rank's whole KV groups: wq / wk / wv (and their biases) column-sharded, so
the rank computes num_heads / model query heads over num_kv_heads / model
KV heads, and its cache holds those KV heads; wo is row-sharded and its
output summed over `model` (`tp_exit`: `reduce_from_tp`, or under sequence
parallelism a reduce-scatter on the sequence; the input enters through
`tp_enter`).  Where `model` is a multiple of num_kv_heads larger than it,
a rank holds num_heads / model query heads and the one KV head they read
(`sharding.kv_replication`: its wk / wv columns, its cache), and the
replicas' wk / wv gradients are summed by the train step.  Where the heads
do not split over `model`, a rank's column slices are mid-head (JAX's):
it gathers the q / k / v columns of the heads its slice touches
(`sharding.gather_heads`), computes those heads whole, caches their KV
heads whole, and keeps its own columns for wo (`sharding.head_span`).
MLA: see `apply_mla`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import (flash_attention, paged_decode,
                                           paged_decode_blocktable)
from ..kernels.flash_attention.ref import gather_block_kv
from ..parallel import sharding as sh
from ..quant import dequantize_kv, quantize_kv
from .blocked_attention import blocked_sdpa
from .layers import apply_rotary, dense_init
from .linear import linear

NEG_INF = -1e30
ATTN_IMPLS = ("naive", "paged", "flash", "blocked")


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


def _write_rows(leaf, rows, cols, val):
    """leaf[rows[i], cols[i]] = val[i], in place (one `index_put_`)."""
    leaf.index_put_((rows, cols), val.to(leaf.dtype))


def _write_slice(leaf, ci: int, val):
    """leaf[:, ci:ci + s] = val, in place; raises where ci + s passes the
    cache's depth (the JAX package's `dynamic_update_slice` clamps the start
    there instead, over live KV:
    tests/test_torch_prefix.py::test_suffix_prefill_past_the_pool_depth)."""
    leaf[:, ci:ci + val.shape[1]].copy_(val)


def apply_gqa(p, x, cfg: ModelConfig, *, positions, causal=True, cache=None, cache_index=None,
              kv_input=None, block_tables=None):
    """x: (b, s, h).  Returns (out, cache).

    causal: mask keys after each query (self-attention); an encoder passes
    False.  kv_input: (b, s_kv, h) -- keys and values are projected from it
    instead of x (cross-attention: no rotary, no mask, no cache write).

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
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; valid: {list(ATTN_IMPLS)}")
    hd, t = cfg.head_dim, sh.tp_size()
    span = sh.local_span(cfg) if t > 1 else None
    a = cfg.num_heads if span is None else span.q[1] - span.q[0]
    nkv = sh.local_kv_heads(cfg)
    impl = cfg.linear_impl
    x = sh.tp_enter(x)
    b, s, h = x.shape
    src = x if kv_input is None else sh.copy_to_tp(kv_input)
    q = linear(x, p["wq"], impl=impl)
    k = linear(src, p["wk"], impl=impl)
    v = linear(src, p["wv"], impl=impl)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if span is not None and span.halo:
        # halo heads: the touched heads made whole from every rank's columns
        q = sh.gather_heads(q, *span.q, hd)
        if sh.kv_replication(cfg, t) == 1:
            k = sh.gather_heads(k, *span.kv, hd)
            v = sh.gather_heads(v, *span.kv, hd)
    q = q.reshape(b, s, a, hd)
    k = k.reshape(b, src.shape[1], nkv, hd)
    v = v.reshape(b, src.shape[1], nkv, hd)
    if cfg.pos_emb == "rotary" and kv_input is None:
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    masked = causal and kv_input is None
    quant = cache is not None and "k_scale" in cache
    # what a write stores, per cache leaf
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    scales = (cache["k_scale"], cache["v_scale"]) if quant else (None, None)
    is_decode = cache is not None and s == 1
    paged = cfg.attn_impl == "paged" and is_decode

    if block_tables is not None:
        if cache is None or s != 1 or kv_input is not None or not (torch.is_tensor(cache_index)
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
            out = _sdpa(q, kg.to(q.dtype), vg.to(q.dtype), causal=causal, q_pos=positions,
                        kv_len=lengths)
        return _out_proj(p, out, span, impl), cache

    kv_len = None
    if cache is not None and kv_input is None:
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
        # the flash kernels with their fused backward: training and every
        # cache-free pass (the encoder; cross-attention, at decode too, at
        # sq = 1).  Cache-backed prefill and decode stay on the paths below,
        # as in JAX (attention.py:232)
        out = flash_attention(q, k.to(q.dtype), v.to(q.dtype), causal=masked)
    elif paged:
        # paged decode kernel over the slot pool (identity slot map here;
        # the kernel's gather-by-slot path is exercised by its tests)
        lengths = torch.as_tensor(kv_len, device=x.device).to(torch.int32).expand(b)
        out = paged_decode(q[:, 0], k if quant else k.to(q.dtype), v if quant else v.to(q.dtype),
                           torch.arange(b, dtype=torch.int32, device=x.device),
                           lengths.contiguous(), k_scale=scales[0], v_scale=scales[1],
                           tuned=True)[:, None]
    elif cfg.attn_impl == "blocked" and not is_decode:
        # prefill (into a cache too: kv_len masks its tail) and training
        out = blocked_sdpa(q, k.to(q.dtype), v.to(q.dtype), causal=masked,
                           q_pos=positions if positions.dim() == 1 else positions[0],
                           kv_len=kv_len, block_kv=cfg.attn_block_kv)
    else:
        out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), causal=masked,
                    q_pos=positions, kv_len=kv_len)
    return _out_proj(p, out, span, impl), cache


def _out_proj(p, out, span, impl):
    """The row-parallel wo on the rank's own columns of the attention
    output (b, s, heads, hd): under halo heads, the columns of its query
    slice among the heads it computed."""
    b, s, _, hd = out.shape
    out = out.reshape(b, s, -1)
    if span is not None and span.halo:
        lo = span.cols[0] - span.q[0] * hd
        out = out[..., lo:lo + span.cols[1] - span.cols[0]].contiguous()
    return sh.tp_exit(linear(out, p["wo"], impl=impl, row=True))


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

    Under tensor parallelism the spec tree column-shards wq_down and
    wkv_down as well: each rank's slice of the (b, s, q_lora) and (b, s,
    kv_lora + rope) latents is all-gathered (`gather_latent`, whose
    backward reduce-scatters the heads' partial gradients) before wq_up /
    wk_up / wv_up, which are column-parallel over heads (a / model a
    rank); wo is row-parallel.  Every rank caches the whole latent, since
    its heads read all of it (JAX's cache_specs shard it on the sequence:
    the same numbers, another layout).
    """
    a = cfg.num_heads // sh.tp_size()
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    impl = cfg.linear_impl
    x = sh.tp_enter(x)
    b, s, _ = x.shape
    q = linear(sh.gather_latent(linear(x, p["wq_down"], impl=impl)), p["wq_up"], impl=impl)
    q = q.reshape(b, s, a, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rotary(q_rope, positions, cfg.rope_theta)

    latent = sh.gather_latent(linear(x, p["wkv_down"], impl=impl))  # (b, s, kvr + rope)
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
    out = sh.tp_exit(linear(out.reshape(b, s, a * vd), p["wo"], impl=impl, row=True))
    return out, cache


def init_attention(gen, cfg: ModelConfig, **kw):
    return init_mla(gen, cfg, **kw) if cfg.attn_type == "mla" else init_gqa(gen, cfg, **kw)


def apply_attention(p, x, cfg: ModelConfig, **kw):
    if cfg.attn_type == "mla":
        # MLA is causal self-attention only: JAX drops both (attention.py:324-327)
        kw.pop("kv_input", None)
        kw.pop("causal", None)
        if kw.pop("block_tables", None) is not None:
            raise ValueError("block-table KV paging is not supported for MLA")
        return apply_mla(p, x, cfg, **kw)
    return apply_gqa(p, x, cfg, **kw)
