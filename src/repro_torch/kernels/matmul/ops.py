"""Public wrapper of the tile GEMM kernel (`csrc/matmul.cu`).

`matmul` flattens leading dims into one m axis (as the JAX wrapper does) and
dispatches on the operand's device: a CPU tensor runs the plain version
(`ref.matmul_ref`), a CUDA tensor launches the kernel — or raises.  Unlike
the JAX wrapper it pads nothing: the kernel masks the ragged edge.

Each 2-D operand may be row-major or the transpose of a row-major tensor
(`w.T`, `x.T`): the kernel reads either in place, so the dgrad
`matmul(g, w.T)` and the wgrad `matmul(x.T, g)` copy nothing.  An optional
second pair (`a1`, `b1`) is summed into the same f32 accumulator:
C = A @ B + A1 @ B1 in one launch.

`pick_tile` and `split_k` are the host-side launch shape: the rule.  bf16 runs on
`csrc/gemm_sm90.cuh`: a 64 x 128 tile of one warpgroup for at most 64 rows
(decode and prefill: every weight element read once), else a 128 x 128
tile of two warpgroups; f32 on `csrc/gemm_tile.cuh`'s 64 x 64 FMA tiles.
`split_k` splits the k range across the grid when the output alone has too
few tiles to fill the card; the f32 partials are then summed by a second,
small kernel.  With `tuned=True` (as `linear_impl` "tuned" and "fused"
pass it) a tuning-cache entry for (m, k, n, dtype, hardware) replaces the
rule's tile and split (`geometry`, a pure function of those; a miss keeps
the rule); an entry whose tile the library does not instantiate raises at
the launch.  `matmul.tuned_hits` / `tuned_misses` count the tuned lookups
of launches.  `matmul.launches` counts calls that launched the GEMM
kernel, the reduce riding with them; `matmul.by_layout` splits that count
by operand layout: "nn" (forward), "nt" (B transposed: dgrad) and "tn" (A
transposed: wgrad).

`matmul_expert` is the MoE layer's batched product, X[e] @ W[e] for every
expert e of a stack in ONE launch of the same mainloop (the grid's z axis
is the expert; no split of k), forward only; `matmul_expert.launches`
counts it apart from `matmul.launches`.
"""
from __future__ import annotations

import torch

from ...core.hardware import get_hardware
from ...tuning.cache import TunedConfig, dtype_name, lookup
from ...tuning.candidates import split_depth
from .. import _build
from .ref import matmul_expert_ref, matmul_ref

BLOCK_K = 64             # csrc/gemm_sm90.cuh GEMM_BK: the bf16 k step, one 128-byte swizzle atom
DECODE_TILE = (64, 128)  # (rows, columns) at most 64 rows: one warpgroup, 2 blocks an SM
TRAIN_TILE = (128, 128)  # more rows: two warpgroups, 1 block an SM
TILES = (DECODE_TILE, TRAIN_TILE)  # the bf16 tiles csrc/matmul.cu instantiates
F32_TILE = (64, 64)      # csrc/gemm_tile.cuh BM, BN (the f32 FMA path)
F32_BLOCK_K = 32         # csrc/gemm_tile.cuh BK
MIN_SPLIT_STEPS = 4      # k steps per split, at least
WAVES = 2                # blocks per SM a 64-row tile's split aims for
LAYOUTS = ("nn", "nt", "tn")  # the (A, B) layouts csrc/matmul.cu instantiates


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_tile(m: int) -> tuple[int, int]:
    """The bf16 output tile (rows, columns) for an (m, n) product: 64 x 128
    for at most 64 rows, else 128 x 128.  (A 128 x 256 tile ran 2-48%
    slower than 128 x 128 at 10 of the 12 training GEMMs, and at most 2.4%
    faster at the other two, on the H100: PERF.md.)"""
    return DECODE_TILE if m <= DECODE_TILE[0] else TRAIN_TILE


def split_k(m: int, n: int, k: int, num_sms: int, block_k: int = BLOCK_K,
            tile: tuple[int, int] | None = None, *, waves: int = WAVES,
            min_steps: int = MIN_SPLIT_STEPS, most: int | None = None) -> int:
    """k range per grid z-slice (a multiple of the kernel's k step
    `block_k`) for output tiles `tile` (default: `pick_tile`'s); k itself =
    no split.  A grid of at least one tile per SM is not split.  Below
    that, 64-row tiles (two blocks an SM) split until the grid holds
    `waves` blocks per SM; 128-row tiles (one block an SM) into as many
    whole copies of the grid as one wave holds, so a grid that nearly fills
    the card is not split into a second, partial wave.  Each split is at
    least `min_steps` k steps deep, and there are at most `most` splits."""
    bm, bn = tile if tile is not None else pick_tile(m)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    max_splits = max(1, min(k // (min_steps * block_k), most or k))
    if tiles >= num_sms:
        splits = 1
    elif bm <= 64:
        splits = min(max_splits, _cdiv(waves * num_sms, tiles))
    else:
        splits = min(max_splits, max(1, num_sms // tiles))
    return _cdiv(_cdiv(k, splits), block_k) * block_k


def launch_shape(m: int, n: int, k: int, dtype, num_sms: int) -> tuple[int, int, int]:
    """(tile rows, tile columns, k per split) of one launch of csrc/matmul.cu."""
    if dtype == torch.float32:
        tile, block_k = F32_TILE, F32_BLOCK_K
    else:
        tile, block_k = pick_tile(m), BLOCK_K
    return (*tile, split_k(m, n, k, num_sms, block_k, tile))


def geometry(m: int, k: int, n: int, dtype, *, tuned: bool = False,
             hw_name: str | None = None, num_sms: int = 132, op: str = "matmul",
             key_dtype: str | None = None) -> tuple[tuple[int, int, int], TunedConfig | None]:
    """((tile rows, tile columns, k per split), the cache entry used or
    None) of one launch of csrc/matmul.cu for an (m, k, n) product in
    `dtype`: with `tuned`, the default tuning cache's entry for
    (op, (m, k, n), key_dtype or dtype's name, hw_name or the H100) when
    there is one (blocks block_m, block_n, split_k: the number of splits),
    else `launch_shape`'s rule on `num_sms` SMs."""
    if tuned:
        cfg = lookup(op, (m, k, n), key_dtype or dtype_name(dtype),
                     hw_name or get_hardware().name)
        if cfg is not None:
            bk = F32_BLOCK_K if dtype == torch.float32 else BLOCK_K
            b = cfg.blocks
            return (b["block_m"], b["block_n"], split_depth(k, b["split_k"], bk)), cfg
    return launch_shape(m, n, k, dtype, num_sms), None


def transposed(what: str, t: torch.Tensor) -> bool:
    """False for a row-major (contiguous) 2-D operand, True for the
    transpose of one; raise for any other strides."""
    if t.is_contiguous():
        return False
    if t.dim() == 2 and t.stride(0) == 1 and t.stride(1) == t.shape[0]:
        return True
    raise ValueError(f"{what}: the kernel takes row-major operands or transposed views of one "
                     f"(got strides {t.stride()} for shape {tuple(t.shape)})")


def matmul(a: torch.Tensor, b: torch.Tensor, a1: torch.Tensor | None = None,
           b1: torch.Tensor | None = None, *, tuned: bool = False,
           hw_name: str | None = None) -> torch.Tensor:
    """C = A @ B (+ A1 @ B1), f32 accumulation, output in A's dtype.
    A: (..., k); B: (k, n); A1, B1 (optional): the shapes of A and B.
    Leading dims of A flatten to one m axis, which keys the tuning cache as
    (m, k, n), the shape `autotune_matmul` writes."""
    return keyed_matmul(a, b, a1, b1, tuned=tuned, hw_name=hw_name)


def keyed_matmul(a, b, a1=None, b1=None, *, tuned: bool = False, hw_name: str | None = None,
                 op: str = "matmul", key_dtype: str | None = None) -> torch.Tensor:
    """`matmul` under another tuning-cache op and dtype key (the emulated
    fp8 GEMM's "fp8_matmul" entries)."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    a12 = None if a1 is None else a1.reshape(-1, k)
    if _build.dispatch_device("matmul", a2) == "cpu":
        out = matmul_ref(a2, b, a1=a12, b1=b1)
    else:
        out = _matmul_cuda(a2, b, a12, b1, tuned, hw_name, op, key_dtype)
    return out.reshape(*lead, b.shape[-1])


matmul.launches = 0
matmul.by_layout = dict.fromkeys(LAYOUTS, 0)
matmul.tuned_hits = 0
matmul.tuned_misses = 0


def reset_launches() -> None:
    matmul.launches = 0
    matmul.by_layout = dict.fromkeys(LAYOUTS, 0)
    matmul.tuned_hits = matmul.tuned_misses = 0


def _matmul_cuda(a, b, a1, b1, tuned=False, hw_name=None, op="matmul", key_dtype=None,
                 forced=None) -> torch.Tensor:
    """Launch csrc/matmul.cu; `forced` (tile rows, tile columns, k per
    split) launches that geometry, bypassing rule and cache (the checks of
    a tuned entry against its own geometry)."""
    pair = (a, b) if a1 is None else (a, b, a1, b1)
    dev = a.device
    for t in pair:
        if t.device != dev:
            raise ValueError(f"matmul: operands on {dev} and {t.device}")
        if t.dtype != a.dtype:
            raise TypeError(f"matmul: dtypes {a.dtype} and {t.dtype}")
    if (a1 is None) != (b1 is None):
        raise ValueError("matmul: a1 and b1 come together")
    if b.dim() != 2 or a.shape[1] != b.shape[0] or (
            a1 is not None and (a1.shape != a.shape or b1.shape != b.shape)):
        raise ValueError(f"matmul: shapes {[tuple(t.shape) for t in pair]}")
    ta, tb = transposed("matmul", a), transposed("matmul", b)
    if a1 is not None and (transposed("matmul", a1), transposed("matmul", b1)) != (ta, tb):
        raise ValueError("matmul: the two pairs need the same layouts")
    layout = ("t" if ta else "n") + ("t" if tb else "n")
    if layout not in LAYOUTS or (a1 is not None and layout != "nt"):
        raise ValueError(f"matmul: layout {layout!r}{' with a second pair' if a1 is not None else ''}"
                         f" is not instantiated (csrc/matmul.cu)")
    dt = _build.dtype_code(a.dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if forced is not None:
        (tm, tn, ks), cfg = forced, None
    else:
        (tm, tn, ks), cfg = geometry(m, k, n, a.dtype, tuned=tuned, hw_name=hw_name,
                                     num_sms=_build.num_sms(dev), op=op, key_dtype=key_dtype)
        if tuned:
            if cfg is None:
                matmul.tuned_misses += 1
            else:
                matmul.tuned_hits += 1
    splits = _cdiv(k, ks)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    chunk = 16 // a.element_size()
    # every operand's row length (its leading dimension) a multiple of 16 bytes
    lda, ldb = (m if ta else k), (k if tb else n)
    vec = int(lda % chunk == 0 and ldb % chunk == 0 and _build.aligned16(*pair))
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_matmul(_build.ptr(a), _build.ptr(b), _build.ptr(a1), _build.ptr(b1),
                                  _build.ptr(out), _build.ptr(work), m, n, k, ks, dt, int(ta),
                                  int(tb), vec, tm, tn, _build.stream_of(dev))
    _build.check(status, "matmul")
    matmul.launches += 1
    matmul.by_layout[layout] += 1
    return out


# --- the expert-batched launch (the MoE layer's expert GEMMs) -----------------------

MOE_TRAINING = ("the batched expert launch is forward-only on the card: its dgrad and wgrad "
                "come with the MoE-training slice")


def matmul_expert(x: torch.Tensor, w: torch.Tensor, *, tuned: bool = False,
                  hw_name: str | None = None) -> torch.Tensor:
    """Per-expert C[e] = X[e] @ W[e], f32 accumulation, output in X's dtype.
    x: (E, m, k); w: (E, k, n) -> (E, m, n).  A CUDA tensor launches
    csrc/matmul.cu `repro_matmul_expert` once for all E experts (the grid's
    z axis is the expert), each at `geometry(m, k, n)`'s tile and unsplit,
    so a tuning-cache entry for the per-expert (m, k, n) applies, as JAX's
    per-expert `tuned=True` key does; forward only (raises under autograd).
    A CPU tensor runs the plain version, a per-expert einsum, differentiable
    as any torch op.  `matmul_expert.launches` counts launches."""
    if _build.dispatch_device("matmul_expert", x) == "cpu":
        return matmul_expert_ref(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(f"matmul_expert: {MOE_TRAINING}")
    return _matmul_expert_cuda(x, w, tuned, hw_name)


matmul_expert.launches = 0


def _matmul_expert_cuda(x, w, tuned=False, hw_name=None) -> torch.Tensor:
    """Launch csrc/matmul.cu `repro_matmul_expert`."""
    _build.cuda_operands("matmul_expert", x, w)
    if w.dtype != x.dtype:
        raise TypeError(f"matmul_expert: dtypes {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"matmul_expert: x {tuple(x.shape)} against w {tuple(w.shape)}")
    e, m, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    (tm, tn, _), _ = geometry(m, k, n, x.dtype, tuned=tuned, hw_name=hw_name,
                              num_sms=_build.num_sms(x.device))
    chunk = 16 // x.element_size()
    vec = int(k % chunk == 0 and n % chunk == 0 and _build.aligned16(x, w))
    lib = _build.build().lib
    with torch.cuda.device(x.device):
        status = lib.repro_matmul_expert(_build.ptr(x), _build.ptr(w), _build.ptr(out), e, m, n,
                                         k, _build.dtype_code(x.dtype), vec, tm, tn,
                                         _build.stream_of(x.device))
    _build.check(status, "matmul_expert")
    matmul_expert.launches += 1
    return out


def alignment_report(m: int, k: int, n: int, dtype=torch.bfloat16,
                     hw_name: str | None = None) -> dict:
    """Tile-alignment report for an (m, k, n) GEMM (the JAX wrapper's, with
    `dtype` a torch dtype); `hw_name` defaults to `get_hardware()`'s chip,
    the H100.  Its padded shape and per-tile bytes are the JAX kernel's
    128-element blocks, kept for parity; the utilizations come from the
    hardware's own tiles (`core.quantization.tile_utilization`)."""
    from ...core.gemm_model import GEMM, recommend_precision
    from ...core.quantization import round_up, tile_utilization
    hw = get_hardware(hw_name) if hw_name else get_hardware()
    dtype_bytes = dtype.itemsize
    util = tile_utilization(m, n, k, hw, dtype_bytes)
    gemm = GEMM("alignment_report", m, k, n, dtype_bytes=dtype_bytes)
    rec_dtype, rec_speedup = recommend_precision(gemm, hw, dtypes=(dtype_name(dtype), "int8"))
    return {
        "hw_name": hw.name,
        "dtype": dtype_name(dtype),
        "mxu_utilization": util,
        "padded_shape": (round_up(m, 128), round_up(k, 128), round_up(n, 128)),
        "aligned": util > 0.999,
        "vmem_per_tile_bytes": (128 * 128 * dtype_bytes * 2 + 128 * 128 * 4),
        # dtype-aware pricing: int8 weights win exactly where the GEMM is
        # bandwidth-bound (see core.gemm_model.recommend_precision)
        "int8_utilization": tile_utilization(m, n, k, hw, 1),
        "recommended_dtype": rec_dtype,
        "recommended_speedup": rec_speedup,
    }
