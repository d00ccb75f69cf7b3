"""Public wrapper of the SSD intra-chunk kernel (`csrc/ssd_chunk.cu`).

`ssd_chunk(x_dt, B, C, seg)` returns `(Y_diag, S)` in the JAX package's
layout — (..., nc, Q, P) and (..., nc, N, P) — and dispatches on the
device: a CPU tensor runs the plain version (`ref.ssd_chunk_ref`), a CUDA
tensor launches the kernel — or raises.  `ssd_chunk.launches` counts calls
that launched it.

The leading dims are one to three: (bh,) as in the JAX wrapper, or the
model's (b, groups, heads per group).  The kernel reads every operand in
place through its strides (the last dim contiguous), so the model passes
views: B and C `expand`ed over the heads of a group (the JAX model
materialises that repeat), x_dt a permuted view of its (b, s, heads, P)
layout.  Y comes back in x_dt's stride order (a permuted view of the same
layout, which the model folds back without a copy), S contiguous.

The bf16 launch (`launch_shape`, a pure function of the shapes and B's and
C's strides) shares one C B^T among a slab of HEADS heads where B and C
have stride 0 over the heads, and computes it per head otherwise; both
give the same bits.  f32 (a check dtype) runs the FMA kernel.

Under autograd (a gradient recorded and an operand that requires it)
`ssd_chunk` runs `_SSDChunk`: its forward is the same kernel (or, on the
CPU, the plain version) and saves only the four operands; its backward is
`ssd_chunk_bwd`, which launches `csrc/ssd_chunk_bwd.cu` on a CUDA tensor
and runs `ref.ssd_chunk_bwd_ref` on a CPU tensor.  The JAX kernel has no
backward (JAX trains the model's einsums), so that kernel has no Pallas
counterpart.  In bf16 one call runs two kernels in stream order (the key
walk, then the query walk; `bwd_launch_shape` picks their slab, grid and
shared memory as `launch_shape` does the forward's, and both layouts give
the same bits); f32 runs the FMA kernel.  A build or launch failure
raises: nothing falls back to the plain version on the card.
`ssd_chunk_bwd.launches` counts its calls that launched.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .. import _build
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

MAX_N, MAX_P = 256, 128  # the largest state and head dims csrc/ssd_chunk.cu's shared memory holds
ROWS = 64                # query rows, key rows per step, state rows: one warpgroup's
WARPGROUPS = 2           # a block: two warpgroups
S_ROWS = ROWS * WARPGROUPS  # state rows of an S block
SHARED_TILES = 4         # score tiles a block keeps in shared memory: C B^T shared for Q <= 256
HEADS = 12               # heads per block (a slab) where C B^T is shared (tuning/ssd_tiles.py)
BWD_HEADS = 12           # ... of the backward kernels (tuning/ssd_bwd_tiles.py)
STAGES = 2               # ring slots of a warpgroup's copies: the next step's in flight
SCORE_BYTES = ROWS * ROWS * 4
SEG_BYTES = ROWS * 4
SEG_AREA = 2048          # a backward region's seg vectors and sums
MAX_SMEM = 232448        # dynamic shared memory a block may take on the H100 (227 KB)
MAX_BLOCKS = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class SsdLaunch:
    """One bf16 launch of csrc/ssd_chunk.cu (or of each of the two kernels
    of csrc/ssd_chunk_bwd.cu): `heads` heads a block, C B^T computed once
    per block and `shared` by its heads (else each of the block's
    warpgroups takes its own heads and scores), `grid` blocks, `smem` bytes
    of dynamic shared memory (the backward: the larger kernel's) and P
    padded to `width` (the forward's instantiation, the backward's staged
    columns)."""
    heads: int
    shared: bool
    grid: int
    smem: int
    width: int


def _tile_bytes(cols: int) -> int:
    """A 64-row bf16 tile of `cols` columns in whole 64-column atoms."""
    return ROWS * 2 * (-(-cols // 64) * 64)


def _smem(N: int, width: int, nqt: int, shared: bool, heads: int) -> int:
    """csrc/ssd_chunk.cu `ssd_smem`: the larger role and 1024 bytes of slack."""
    tc, tx, tb = _tile_bytes(-(-N // 16) * 16), _tile_bytes(width), _tile_bytes(S_ROWS)
    if shared:
        xs = STAGES * WARPGROUPS * (tx + SEG_BYTES)
        y, s = nqt * SCORE_BYTES + max(3 * tc, xs), nqt * tb + xs
    else:
        y = heads * (tc + STAGES * (tc + tx + SEG_BYTES))
        s = STAGES * WARPGROUPS * (tb + tx + SEG_BYTES)
    return max(y, s) + 1024


@functools.lru_cache(maxsize=256)
def launch_shape(lead, nc: int, b_strides, c_strides, Q: int, N: int, P: int,
                 heads: int | None = None) -> SsdLaunch:
    """The bf16 kernel's launch for leading dims `lead` (three: (l0, l1,
    l2), heads last), nc chunks and B's and C's element strides (three
    leading dims, the chunk, the row).  Where B and C have stride 0 over the
    heads (the model's expanded views) and a chunk has at most SHARED_TILES
    query tiles, a block computes C B^T once and its two warpgroups walk
    `heads` heads (HEADS by default, fewer in the last slab); otherwise each
    warpgroup takes one head (two a block, one where two do not fit in
    shared memory).  The grid is (S units of S_ROWS state rows + ceil(Q /
    64) query tiles) x nc x l0 l1 x slabs."""
    l0, l1, l2 = lead
    width = next(w for w in (16, 32, 64, 128) if P <= w)
    nqt, nnt = -(-Q // ROWS), -(-N // S_ROWS)
    shared = l2 > 1 and b_strides[2] == 0 and c_strides[2] == 0 and nqt <= SHARED_TILES
    if shared:
        h = min(l2, heads or HEADS)
    else:
        h = min(l2, WARPGROUPS if _smem(N, width, nqt, False, WARPGROUPS) <= MAX_SMEM else 1)
    return SsdLaunch(heads=h, shared=shared, grid=(nnt + nqt) * nc * l0 * l1 * -(-l2 // h),
                     smem=_smem(N, width, nqt, shared, h), width=width)


def _bwd_widths(P: int, N: int):
    """The backward's staged widths (csrc/ssd_chunk_bwd.cu `BwdGeom`): x and
    dY in px columns (dX in 64-column slices), B and C in nb columns and dS
    in nb rows (dB and dC in dnw-column slices), and the slices a tile
    takes."""
    px = -(-P // 64) * 64
    dnw = 64 if N <= 64 else 128
    nb = -(-N // dnw) * dnw
    return px, nb, max(px // 64, nb // dnw)


def bwd_smem(Q: int, P: int, N: int, shared: bool, nwg: int):
    """Dynamic shared memory of the backward's key walk and query walk
    (csrc/ssd_chunk_bwd.cu `BwdGeom`) with `nwg` warpgroups walking heads:
    a region a warpgroup (two head buffers, two ring slots, SEG_AREA); with
    shared scores the chunk's score tiles before them (and the key walk's
    B_k); 1024 bytes of slack."""
    px, nb, _ = _bwd_widths(P, N)
    nqt = -(-Q // ROWS)
    tx, tb, ds = _tile_bytes(px), _tile_bytes(nb), nb * px * 2
    head = tx + (0 if shared else tb)
    keys = nwg * (2 * head + STAGES * max(tb + tx, ds) + SEG_AREA)
    queries = nwg * (2 * head + STAGES * (tb + tx) + SEG_AREA)
    if shared:
        keys += nqt * SCORE_BYTES + tb
        queries = nqt * SCORE_BYTES + max(3 * tb, queries)
    return keys + 1024, queries + 1024


@functools.lru_cache(maxsize=64)
def bwd_smem_f32(N: int, P: int) -> int:
    """Dynamic shared memory of the f32 backward (csrc/ssd_chunk_bwd.cu
    `BwdLayout` at 4-byte operands, which the entry re-checks): the C, B, X
    and dY tiles (rows of an odd number of words), the two 64 x 65 f32
    score tiles (or dS and B dS), the f32 accumulators and the vectors,
    each rounded up to 128 bytes."""
    def al(n):
        return -(-n // 128) * 128
    np_, pp = -(-N // 16) * 16, -(-P // 16) * 16
    tn, tp = al(ROWS * (np_ + 1) * 4), al(ROWS * (pp + 1) * 4)
    tile, an, ap = al(ROWS * (ROWS + 1) * 4), al(ROWS * (np_ + 1) * 4), al(ROWS * (pp + 1) * 4)
    return 2 * (tn + tp) + max(2 * tile, tp + ap) + max(an, ap + an) + al(ROWS * 10 * 4)


@functools.lru_cache(maxsize=256)
def bwd_launch_shape(lead, nc: int, b_strides, c_strides, Q: int, N: int, P: int,
                     heads: int | None = None) -> SsdLaunch:
    """The bf16 backward's launch (both kernels) for leading dims `lead`
    (three, heads last), nc chunks and B's and C's element strides.  Where
    B and C have stride 0 over the heads, a chunk has at most SHARED_TILES
    tiles and the shared scores fit, a block forms its tile's scores once
    and its two warpgroups walk `heads` heads (BWD_HEADS by default, fewer
    in the last slab); otherwise each warpgroup takes one head (two a
    block, one where two do not fit).  The grid, per kernel: ceil(Q / 64)
    tiles x slices x nc x l0 l1 x slabs."""
    l0, l1, l2 = lead
    px, _, nslice = _bwd_widths(P, N)
    nqt = -(-Q // ROWS)

    def fits(shared, nwg):
        return max(bwd_smem(Q, P, N, shared, nwg)) <= MAX_SMEM

    shared = (l2 > 1 and b_strides[2] == 0 and c_strides[2] == 0 and nqt <= SHARED_TILES
              and fits(True, WARPGROUPS))
    if shared:
        h = min(l2, heads or BWD_HEADS)
    else:
        h = min(l2, WARPGROUPS if fits(False, WARPGROUPS) else 1)
    return SsdLaunch(heads=h, shared=shared, grid=nqt * nslice * nc * l0 * l1 * -(-l2 // h),
                     smem=max(bwd_smem(Q, P, N, shared, min(h, WARPGROUPS))), width=px)


def copy_width(t: torch.Tensor, strides, d: int) -> int:
    """16 where every row of `t` lies in whole 16-byte copies (its base, its
    element strides and its row of d elements), else 2: the kernel then
    loads the operand element by element."""
    e = 16 // t.element_size()
    whole = t.data_ptr() % 16 == 0 and d % e == 0 and all(v % e == 0 for v in strides)
    return 16 if whole else 2


def ssd_chunk(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor, seg: torch.Tensor):
    """x_dt: (..., nc, Q, P); B, C: (..., nc, Q, N) in x_dt's dtype; seg:
    (..., nc, Q) f32, the within-chunk cumulative sum of dt * A.  Returns
    (Y_diag (..., nc, Q, P), S (..., nc, N, P)) in x_dt's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_dt, B, C, seg)):
        return _SSDChunk.apply(x_dt, B, C, seg)
    return _ssd_chunk_fwd(x_dt, B, C, seg)


ssd_chunk.launches = 0


def _ssd_chunk_fwd(x_dt, B, C, seg):
    """The forward's dispatch: the plain version on a CPU tensor, the
    kernel on a CUDA tensor."""
    if _build.dispatch_device("ssd_chunk", x_dt) == "cpu":
        return ssd_chunk_ref(x_dt, B, C, seg)
    return _ssd_chunk_cuda(x_dt, B, C, seg)


class _SSDChunk(torch.autograd.Function):
    """`ssd_chunk` with its gradient: the forward kernel (the plain version
    on the CPU), then `ssd_chunk_bwd` from the saved operands.  What JAX
    takes by autodiff of `repro/models/ssm.py:136-145`."""

    @staticmethod
    def forward(ctx, x_dt, B, C, seg):
        ctx.save_for_backward(x_dt, B, C, seg)
        return _ssd_chunk_fwd(x_dt, B, C, seg)

    @staticmethod
    def backward(ctx, dY, dS):
        # an output the loss does not reach arrives as zeros (autograd
        # materializes the cotangents of a Function's outputs)
        return ssd_chunk_bwd(*ctx.saved_tensors, dY, dS)


def ssd_chunk_bwd(x_dt, B, C, seg, dY, dS):
    """The gradient of `ssd_chunk` from its operands and the cotangents dY
    (..., nc, Q, P) of Y_diag and dS (..., nc, N, P) of S.  Returns (dX, dB,
    dC, dseg): dX, dB, dC in the operands' dtype and shapes (dB, dC per head
    where B and C are expanded over the heads), dseg f32."""
    if _build.dispatch_device("ssd_chunk_bwd", x_dt) == "cpu":
        return ssd_chunk_bwd_ref(x_dt, B, C, seg, dY, dS)
    return _ssd_chunk_bwd_cuda(x_dt, B, C, seg, dY, dS)


ssd_chunk_bwd.launches = 0


def _ssd_chunk_cuda(x, B, C, seg, heads=None):
    """The kernel's launch; `heads` forces the slab size (tuning/ssd_tiles.py)."""
    dev = x.device
    for t in (B, C, seg):
        if t.device != dev:
            raise ValueError(f"ssd_chunk: operands on {dev} and {t.device}")
    if B.dtype != x.dtype or C.dtype != x.dtype or seg.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: x_dt, B, C in one dtype and seg float32 (got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}, {seg.dtype})")
    lead = tuple(x.shape[:-3])
    nc, Q, P = x.shape[-3:]
    N = B.shape[-1]
    if (not 1 <= len(lead) <= 3 or tuple(B.shape) != (*lead, nc, Q, N)
            or C.shape != B.shape or tuple(seg.shape) != (*lead, nc, Q)):
        raise ValueError(f"ssd_chunk: shapes x_dt {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, seg {tuple(seg.shape)}")
    if N > MAX_N or P > MAX_P:
        raise ValueError(f"ssd_chunk: the kernel takes N <= {MAX_N} and P <= {MAX_P} "
                         f"(got N {N}, P {P})")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("ssd_chunk: the last dim of x_dt, B and C must be contiguous")
    dt = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)     # x's stride order (a dense view keeps its layout)
    s = torch.empty((*lead, nc, N, P), dtype=x.dtype, device=dev)
    if min(*lead, nc, Q, P, N) == 0:
        return y.zero_(), s.zero_()      # empty sums
    lead3 = (1,) * (3 - len(lead)) + lead

    def strides(t):
        # three leading dims (size-1 ones in front), the chunk, the row
        k = len(lead)
        return (0,) * (3 - k) + tuple(t.stride()[:k + 2])

    sx, sb, sc = strides(x), strides(B), strides(C)
    vals = sx + sb + sc + strides(seg) + strides(y) + strides(s)
    vec = slab = shared = widths = smem = 0
    if x.dtype == torch.float32:
        if lead3[0] * lead3[1] * lead3[2] > 65535 or nc > 65535:
            raise ValueError(f"ssd_chunk: {lead} sequence-heads and {nc} chunks exceed the grid")
        vec = int(_build.aligned16(x, B, C) and all(v % 4 == 0 for v in sx + sb + sc))
    else:
        shape = launch_shape(lead3, nc, sb, sc, Q, N, P, heads)
        if shape.grid > MAX_BLOCKS:
            raise ValueError(f"ssd_chunk: {lead} sequence-heads and {nc} chunks exceed the grid")
        slab, shared, smem = shape.heads, int(shape.shared), shape.smem
        widths = copy_width(x, sx, P) | copy_width(B, sb, N) << 8 | copy_width(C, sc, N) << 16
    arr = (ctypes.c_longlong * len(vals))(*vals)
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_ssd_chunk(_build.ptr(x), _build.ptr(B), _build.ptr(C), _build.ptr(seg),
                                     _build.ptr(y), _build.ptr(s), arr, *lead3, nc, Q, P, N, dt,
                                     vec, slab, shared, widths, smem, _build.stream_of(dev))
    _build.check(status, "ssd_chunk")
    ssd_chunk.launches += 1
    return y, s


def _ssd_chunk_bwd_cuda(x, B, C, seg, dY, dS, heads=None):
    """The backward kernels' launch; `heads` forces the bf16 slab size
    (tuning/ssd_bwd_tiles.py)."""
    dev = x.device
    for t in (B, C, seg, dY, dS):
        if t.device != dev:
            raise ValueError(f"ssd_chunk_bwd: operands on {dev} and {t.device}")
    if any(t.dtype != x.dtype for t in (B, C, dY, dS)) or seg.dtype != torch.float32:
        raise TypeError(f"ssd_chunk_bwd: x_dt, B, C, dY, dS in one dtype and seg float32 (got "
                        f"{[str(t.dtype) for t in (x, B, C, dY, dS, seg)]})")
    lead = tuple(x.shape[:-3])
    nc, Q, P = x.shape[-3:]
    N = B.shape[-1]
    if (not 1 <= len(lead) <= 3 or tuple(B.shape) != (*lead, nc, Q, N)
            or C.shape != B.shape or tuple(seg.shape) != (*lead, nc, Q)
            or dY.shape != x.shape or tuple(dS.shape) != (*lead, nc, N, P)):
        raise ValueError(f"ssd_chunk_bwd: shapes x_dt {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, seg {tuple(seg.shape)}, dY {tuple(dY.shape)}, "
                         f"dS {tuple(dS.shape)}")
    if N > MAX_N or P > MAX_P:
        raise ValueError(f"ssd_chunk_bwd: the kernel takes N <= {MAX_N} and P <= {MAX_P} "
                         f"(got N {N}, P {P})")
    # a cotangent may arrive expanded (the gradient of a sum: stride 0 in
    # every dim); the kernel reads rows whose last dim is contiguous
    dY, dS = (t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous() for t in (dY, dS))
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("ssd_chunk_bwd: the last dim of x_dt, B and C must be contiguous")
    dt = _build.dtype_code(x.dtype)
    lead3 = (1,) * (3 - len(lead)) + lead

    def strides(t):
        k = len(lead)
        return (0,) * (3 - k) + tuple(t.stride()[:k + 2])

    slab = shared = widths = 0
    esum = None
    if x.dtype == torch.float32:
        smem = bwd_smem_f32(N, P)
        blocks = lead3[0] * lead3[1] * lead3[2] * nc
    else:
        shape = bwd_launch_shape(lead3, nc, strides(B), strides(C), Q, N, P, heads)
        smem, blocks = shape.smem, shape.grid
        slab, shared = shape.heads, int(shape.shared)
        widths = sum(bit for bit, (t, d) in zip((1, 2, 4, 8, 16),
                                               ((x, P), (B, N), (C, N), (dY, P), (dS, P)))
                     if copy_width(t, strides(t), d) == 16)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_chunk_bwd: N {N} and P {P} take {smem} bytes of shared memory "
                         f"a block in {x.dtype}, more than the card's {MAX_SMEM}")
    if blocks > MAX_BLOCKS:
        raise ValueError(f"ssd_chunk_bwd: {lead} sequence-heads and {nc} chunks exceed the grid")
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    db = torch.empty(B.shape, dtype=x.dtype, device=dev)
    dc = torch.empty(C.shape, dtype=x.dtype, device=dev)
    dseg = torch.empty(seg.shape, dtype=torch.float32, device=dev)
    if min(*lead, nc, Q, P, N) == 0:
        return dx.zero_(), db.zero_(), dc.zero_(), dseg.zero_()   # empty sums
    if x.dtype != torch.float32:   # each key tile's sum of e (csrc/ssd_chunk_bwd.cu)
        esum = torch.empty(math.prod(lead3) * nc * -(-Q // ROWS), dtype=torch.float32, device=dev)
    vals = sum((strides(t) for t in (x, B, C, seg, dY, dS, dx, db, dc, dseg)), ())
    arr = (ctypes.c_longlong * len(vals))(*vals)
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_ssd_chunk_bwd(*map(_build.ptr, (x, B, C, seg, dY, dS, dx, db, dc, dseg)),
                                         arr, *lead3, nc, Q, P, N, dt, slab, shared, widths, smem,
                                         None if esum is None else _build.ptr(esum),
                                         _build.stream_of(dev))
    _build.check(status, "ssd_chunk_bwd")
    ssd_chunk_bwd.launches += 1
    return dx, db, dc, dseg
