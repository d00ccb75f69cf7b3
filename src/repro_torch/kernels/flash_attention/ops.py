"""Public wrappers of the flash-attention kernels (`csrc/flash_attention.cu`)
and the paged decode kernel over a slot pool or a block table, float or
int8 (`csrc/paged_decode.cu`).

Each dispatches on the device: a CPU tensor runs the plain version
(`ref.py`), a CUDA tensor launches the kernel — or raises.

`flash_attention` takes the JAX public layout, q (b, sq, a, d) and k, v (b,
skv, nkv, d), and the kernels read it in place through strides: no
fold/unfold copies and no padding to the block grid (the kernels mask the
ragged edges).  Any head dim from 1 to 256 and any group size a / nkv
works: the kernels pad d to their instantiated width in shared memory only.
It is differentiable, as JAX's `_flash_core` custom VJP: the forward saves
its inputs, the output and the per-row logsumexp, and the backward launches
the one-pass backward kernel (bf16: dq through an f32 scratch buffer that
the wrapper allocates; f32: the dq and dk/dv kernels).  The
autograd.Function is taken only when a gradient is recorded.
`flash_attention_fwd.launches` and `flash_attention_bwd.launches` count
wrapper calls that launched their kernels.

Any pool depth, block size and group size works for `paged_decode` and
`paged_decode_blocktable`: the kernel masks the tail tile and resolves each
token's physical block itself, so there is no block_kv clamp or pool pad as
in the JAX wrapper, no tuning-cache lookup (`tuned=` comes with the tuning
slice) and no interpret toggle — the tensor's device decides.  The launch
geometry (`paged_launch`: the bf16 kernel's tile, split and cluster size,
the f32 body's tile, and the shared memory of either) is a pure function of
the shapes, cached per shape.  Each counts its launches on a float pool
(`.launches`) and on an int8 pool (`.int8_launches`) apart.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _build
from .ref import (flash_attention_bwd_ref, flash_attention_ref, paged_decode_blocktable_ref,
                  paged_decode_ref)

MAX_BLOCK_KV = 64          # kv tokens staged per tile of the f32 paged-decode body
SMEM_BUDGET = 48 * 1024    # bytes of shared memory an f32 paged-decode tile may take
MAX_HEAD_DIM = 256         # the largest head dim the flash and paged-decode kernels take
PAGED_TILES = (32, 64)     # kv tokens a tile of the bf16 paged-decode kernel
PAGED_STAGES = 3           # ring slots of the bf16 paged-decode kernel (csrc STAGES)
TARGET_BLOCKS = 264        # bf16 paged-decode blocks the H100 wants: two an SM of 132
MAX_SPLITS = 8             # blocks of one cluster (the portable cluster size)
GROUP_ROWS = 64            # query heads one bf16 block serves (the wgmma tile's rows)
SMEM_LIMIT = 232_448       # bytes of dynamic shared memory a block can take on the H100


def flash_shape_ok(d: int, a: int, nkv: int) -> bool:
    """Whether the flash kernels take head dim d with a query heads over nkv
    kv heads: any d from 1 to 256, any group size.  Shapes only, no launch."""
    return 1 <= d <= MAX_HEAD_DIM and nkv > 0 and a % nkv == 0


def flash_padded_d(d: int) -> int:
    """The head dim csrc/flash_attention.cuh `padded_d` runs d at: a multiple
    of 16 up to 128, of 32 above (zeros past d, in shared memory only)."""
    return -(-d // 16) * 16 if d <= 128 else -(-d // 32) * 32


def paged_shape_ok(d: int, a: int, nkv: int, kv_itemsize: int) -> bool:
    """Whether the paged-decode kernels take head dim d with a query heads
    over nkv kv heads, a pool of kv_itemsize-byte elements: any group size,
    d up to 256 in whole 16-byte loads per row.  Shapes only, no launch."""
    return (1 <= d <= MAX_HEAD_DIM and nkv > 0 and a % nkv == 0
            and d % (16 // kv_itemsize) == 0)


class PagedLaunch(NamedTuple):
    """A paged-decode launch: tokens a tile, tokens a block (split), blocks
    a (row, kv head) walk (one cluster) and dynamic shared memory bytes."""
    tile: int
    split: int
    splits: int
    smem: int


def _f32_smem(g: int, d: int, bkv: int, kv_itemsize: int) -> int:
    """Shared memory of csrc/paged_decode.cu's f32 body (`f32_smem`)."""
    gw = 8 if g <= 8 else 16
    gs = min(g, gw)
    return (bkv * 8 + 2 * bkv * d * kv_itemsize + gs * d * 4 + gs * bkv * 4 + 2 * bkv * 4
            + 3 * gw * 4)


def _sm90_smem(g: int, d: int, tile: int, kv_itemsize: int) -> int:
    """Shared memory of csrc/paged_decode.cu's bf16 kernel (`Layout::bytes`):
    the Q tile and the ring (int8: the widened tiles and the raw slots with
    their scales), or the parked partial where it is larger, and m, l."""
    dp = -(-d // 64) * 64
    rows = -(-min(g, GROUP_ROWS) // 8) * 8
    tile_b = tile * dp * 2
    ring = (2 * tile_b + PAGED_STAGES * (2 * tile * dp + 8 * tile) if kv_itemsize == 1
            else PAGED_STAGES * 2 * tile_b)
    return 1024 + max(rows * dp * 2 + ring, rows * (dp + 8) * 4) + 2 * GROUP_ROWS * 4


@functools.lru_cache(maxsize=None)
def paged_launch(b: int, nkv: int, g: int, d: int, capacity: int, kv_itemsize: int,
                 q_itemsize: int = 2, tile: int | None = None,
                 splits: int | None = None) -> PagedLaunch:
    """The paged-decode launch for b rows of nkv kv heads, g query heads
    each, head dim d, over a pool of `capacity` tokens a row (s_max, or
    max_blocks x block_size) of kv_itemsize-byte elements.  Shapes only: it
    reads no tensor, so the host never waits on the device for it.

    bf16 q (q_itemsize 2): each of the b x nkv x ceil(g / 64) walks is cut
    into the largest power of two of blocks, at most 8 (one cluster), that
    keeps walks x splits within TARGET_BLOCKS: few walks still put two
    blocks on each SM, and many walks take one block each, since a split
    costs its cluster's barriers and combine.  On the card one split was
    fastest at 512 walks, two at 128, and a cluster of 3 ran 1.34x slower
    than 2 at a long context (tuning/paged_tiles.py).  A block takes
    ceil(capacity / splits) tokens in whole tiles: 64-token tiles where the
    walks are few (each block walks longer), 32 where they are many (fewer
    registers, so more blocks an SM).  `tile` and `splits` override the
    pick (the sweep).  f32 q: one block walks the row, in tiles of the
    largest bkv of 64, 32, 16, 8 whose shared memory fits 48 KB (split =
    capacity)."""
    if q_itemsize == 4:
        bkv = MAX_BLOCK_KV
        while bkv > 8 and _f32_smem(g, d, bkv, kv_itemsize) > SMEM_BUDGET:
            bkv //= 2
        return PagedLaunch(bkv, capacity, 1, _f32_smem(g, d, bkv, kv_itemsize))
    walks = b * nkv * -(-g // GROUP_ROWS)
    if splits is None:
        splits = min(MAX_SPLITS, 1 << (max(1, TARGET_BLOCKS // walks).bit_length() - 1))
    if tile is None:
        tile = PAGED_TILES[1] if walks < TARGET_BLOCKS else PAGED_TILES[0]
    if tile not in PAGED_TILES or not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"paged_launch: tile {tile} (one of {PAGED_TILES}), splits {splits} "
                         f"(1..{MAX_SPLITS})")
    split = -(-capacity // (splits * tile)) * tile
    smem = _sm90_smem(g, d, tile, kv_itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_launch: {smem} bytes of shared memory (g={g}, d={d})")
    return PagedLaunch(tile, split, -(-capacity // split), smem)


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q: (b, sq, a, d); k, v: (b, skv, nkv, d), a % nkv == 0.  Returns (b,
    sq, a, d).  The causal mask is top-left (key j live for query i when
    j <= i), as the Pallas kernel's."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]


class _Flash(torch.autograd.Function):
    """JAX's `_flash_core` (flash_attention/ops.py:86-118)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, *, causal: bool = True, scale=None):
    """(out (b, sq, a, d), lse (b, a, sq) f32)."""
    if _build.dispatch_device("flash_attention", q) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _flash_fwd_cuda(q, k, v, causal, scale)


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, scale=None):
    """(dq, dk, dv) from the forward's inputs, output o and lse, and the
    output cotangent do."""
    if _build.dispatch_device("flash_attention_bwd", q) == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, scale=scale)
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)


flash_attention_bwd.launches = 0


def _flash_shapes(what, q, k, v, *like_q):
    _build.cuda_operands(what, q, k, v, *like_q)
    b, sq, a, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if (k.dim() != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or a % nkv
            or any(t.shape != q.shape for t in like_q)):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
                         f"{''.join(f', {tuple(t.shape)}' for t in like_q)}")
    if any(t.dtype != q.dtype for t in (k, v, *like_q)):
        raise TypeError(f"{what}: dtypes {[str(t.dtype) for t in (q, k, v, *like_q)]}")
    if not flash_shape_ok(d, a, nkv) or not _build.aligned16(q, k, v, *like_q):
        raise ValueError(f"{what}: the kernels take head dims 1..{MAX_HEAD_DIM} and 16-byte "
                         f"aligned tensors (d = {d})")
    return b, sq, skv, a, nkv, d


def _flash_fwd_cuda(q, k, v, causal, scale):
    b, sq, skv, a, nkv, d = _flash_shapes("flash_attention", q, k, v)
    dt = _build.dtype_code(q.dtype)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, a, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0 or a == 0:
        return out, lse
    if skv == 0:
        return out.zero_(), lse.zero_()
    lib = _build.build().lib
    with torch.cuda.device(q.device):
        status = lib.repro_flash_fwd(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                                     _build.ptr(out), _build.ptr(lse), b, sq, skv, a, nkv, d,
                                     int(causal), float(scale), dt, _build.stream_of(q.device))
    _build.check(status, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale):
    # o enters only through di = rowsum(do * o), the kernels' pre-pass: any strides
    o = o.contiguous()
    b, sq, skv, a, nkv, d = _flash_shapes("flash_attention_bwd", q, k, v, do, o)
    if lse.shape != (b, a, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"want ({b}, {a}, {sq}) float32, contiguous")
    dt = _build.dtype_code(q.dtype)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or sq == 0 or skv == 0 or a == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    di = torch.empty((b, a, sq), dtype=torch.float32, device=q.device)   # the pre-pass's
    # bf16: the kernel adds dq into f32 scratch with atomics, then rounds it
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if q.dtype == torch.bfloat16 else None)
    lib = _build.build().lib
    with torch.cuda.device(q.device):
        status = lib.repro_flash_bwd(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                                     _build.ptr(do), _build.ptr(lse), _build.ptr(di),
                                     _build.ptr(dq), _build.ptr(dq_acc), _build.ptr(dk),
                                     _build.ptr(dv), b, sq, skv, a, nkv, d, int(causal),
                                     float(scale), dt, _build.stream_of(q.device))
    _build.check(status, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def paged_decode(q, k_pool, v_pool, slot_idx, lengths, *, k_scale=None, v_scale=None,
                 scale=None):
    """Slot-gathering decode attention over a fixed KV pool.

    q: (b, a, d) — one query token per row; k_pool, v_pool: (slots, s_max,
    nkv, d); slot_idx: (b,) row->slot; lengths: (b,) live kv entries (0 =
    dead slot -> zero output).  k_scale, v_scale: (slots, s_max, nkv) f32
    per-(token, kv head) scales of an int8 pool (both or neither), which the
    kernel applies in f32 (bf16 q: to the scores and to P; f32 q: to each
    element it reads).  Returns (b, a, d).
    """
    if _build.dispatch_device("paged_decode", q) == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, slot_idx, lengths, scale=scale,
                                k_scale=k_scale, v_scale=v_scale)
    return _paged_cuda(paged_decode, q, k_pool, v_pool, k_scale, v_scale,
                       slot_idx.to(torch.int32), lengths, 0, scale)


paged_decode.launches = 0        # float pools
paged_decode.int8_launches = 0   # int8 pools


def paged_decode_blocktable(q, k_blocks, v_blocks, block_tables, lengths, *, k_scale=None,
                            v_scale=None, scale=None):
    """Block-table decode attention over a physical KV block pool.

    q: (b, a, d) — one query token per row; k_blocks, v_blocks: (num_blocks,
    block_size, nkv, d); block_tables: (b, max_blocks) row -> physical block
    ids (entries past a row's live blocks are never read); lengths: (b,)
    live kv entries (0 = dead row -> zero output).  k_scale, v_scale:
    (num_blocks, block_size, nkv) f32 scales of an int8 block pool.  Any
    block size works: the kernel resolves each token's block itself, so a kv
    tile may span blocks.  Returns (b, a, d).
    """
    if _build.dispatch_device("paged_decode_blocktable", q) == "cpu":
        return paged_decode_blocktable_ref(q, k_blocks, v_blocks, block_tables, lengths,
                                           scale=scale, k_scale=k_scale, v_scale=v_scale)
    tables = block_tables.to(torch.int32).contiguous()
    if tables.dim() != 2 or tables.shape[0] != q.shape[0] or tables.shape[1] < 1:
        raise ValueError(f"paged_decode_blocktable: block_tables {tuple(tables.shape)} for "
                         f"{q.shape[0]} rows")
    return _paged_cuda(paged_decode_blocktable, q, k_blocks, v_blocks, k_scale, v_scale,
                       tables, lengths, tables.shape[1], scale)


paged_decode_blocktable.launches = 0        # float pools
paged_decode_blocktable.int8_launches = 0   # int8 pools


def _paged_cuda(fn, q, k_pool, v_pool, k_scale, v_scale, index, lengths, max_blocks, scale,
                geometry=None):
    """Launch csrc/paged_decode.cu over a slot pool (max_blocks = 0, index =
    slot_idx) or a block table (index = tables (b, max_blocks)); a launch
    adds one to the wrapper `fn`'s count for its pool type.  `geometry`
    (tile, splits) overrides `paged_launch`'s pick for the bf16 kernel (the
    sweep in tuning/paged_tiles.py)."""
    what = fn.__name__
    lengths = lengths.to(torch.int32)
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{what}: pass both k_scale and v_scale, or neither")
    scales = (k_scale, v_scale) if quant else ()
    _build.cuda_operands(what, q, k_pool, v_pool, *scales, index, lengths)
    b, a, d = q.shape
    n, depth, nkv, dk = k_pool.shape
    if (v_pool.shape != k_pool.shape or dk != d or a % nkv or lengths.shape != (b,)
            or (max_blocks == 0 and index.shape != (b,))
            or any(t.shape != (n, depth, nkv) for t in scales)):
        raise ValueError(f"{what}: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)}, index {tuple(index.shape)}, lengths "
                         f"{tuple(lengths.shape)}, scales {[tuple(t.shape) for t in scales]}")
    want_kv = torch.int8 if quant else q.dtype
    if k_pool.dtype != want_kv or v_pool.dtype != want_kv or any(
            t.dtype != torch.float32 for t in scales):
        raise TypeError(f"{what}: q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}, scales "
                        f"{[str(t.dtype) for t in scales]} (pools take q's dtype, or int8 "
                        f"with float32 scales)")
    dt = _build.dtype_code(q.dtype)
    kv_dt = _build.DT_INT8 if quant else dt
    g = a // nkv
    if (not paged_shape_ok(d, a, nkv, k_pool.element_size())
            or not _build.aligned16(q, k_pool, v_pool)):
        raise ValueError(f"{what}: the kernel takes 16-byte aligned rows of <= "
                         f"{MAX_HEAD_DIM} elements (g={g}, d={d})")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.build().lib
    geo = paged_launch(b, nkv, g, d, max_blocks * depth if max_blocks else depth,
                       k_pool.element_size(), q.element_size(), *(geometry or ()))
    with torch.cuda.device(q.device):
        status = lib.repro_paged_decode(
            _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(k_scale),
            _build.ptr(v_scale), _build.ptr(index), _build.ptr(lengths), _build.ptr(out), b, a,
            nkv, d, depth, max_blocks, geo.tile, geo.split, geo.splits, geo.smem, float(scale),
            dt, kv_dt, _build.stream_of(q.device))
    _build.check(status, what)
    if quant:
        fn.int8_launches += 1
    else:
        fn.launches += 1
    return out
