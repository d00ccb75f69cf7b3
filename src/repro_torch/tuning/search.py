"""Measured launch-geometry search for the port's CUDA kernels (the JAX
package's `tuning/search.py`, in the port's knobs).

For each problem shape the search sweeps the kernel's candidate lattice
(`tuning.candidates`: only geometries the library instantiates), times
every candidate on the card with `tuning.measure.wall_us`, and records the
winner in a `TuningCache` — the measured counterpart of the analytic model
in `core.gemm_model`.  The wrappers then take the entry with `tuned=True`,
and `core.gemm_model.MeasuredProfile` uses the same entries to calibrate
the advisor's predictions.

The op names, shape tuples and dtype keys are the JAX package's, so one
cache file holds both packages' entries and `MeasuredProfile.from_cache`
reads either; `blocks` holds the port's knobs (`tuning/cache.py`).
`baseline_us` is the time of the wrapper's own rule at the shape (the
measured default, as JAX's 128-blocks are there), the first candidate of
every lattice.

Operands come from an explicit `torch.Generator` seeded 0 on the card (as
JAX's come from `PRNGKey(0)`), with the weights (or pools) copied until a
rotation through them exceeds the 50 MB L2, as the serving path finds them
cold.  Each candidate launches the wrapper's kernel entry with its geometry
forced, so the timing is the kernel's alone (the int8 paths' eager
activation quantization runs once, before the sweep).  The search times
the card only (JAX's `interpret` has no counterpart): an autotune raises
without a CUDA device, and `_measure` raises on operands that lie on the
CPU, where the wrappers would run their plain versions.
"""
from __future__ import annotations

import dataclasses
import itertools
import statistics
from typing import List, Optional, Tuple

import torch

from .. import obs
from ..core.hardware import Hardware, get_hardware
from .cache import TunedConfig, TuningCache, dtype_name, get_default_cache, mixed_dtype
from .candidates import (fallback_block_size, fp8_matmul_candidates, fused_mlp_candidates,
                         int8_fused_mlp_candidates, int8_matmul_candidates, matmul_candidates,
                         paged_blocktable_candidates, paged_decode_candidates, split_depth,
                         sublane_granule)
from .measure import wall_us

L2_BYTES = 50 * 2 ** 20
MAX_COPIES = 16
# where the operands are made: the card (the CPU tests set "cpu" to run the
# loop with `_measure` replaced, which on the card alone times anything)
DEVICE = "cuda"


@dataclasses.dataclass(frozen=True)
class Trial:
    blocks: Tuple[int, ...]
    time_us: float
    time_us_std: float = 0.0


def _measure(op: str, fn, *args, iters: int, warmup: int) -> Tuple[float, float]:
    """Time one candidate: (mean_us, std_us).  The mean is one pair of
    events around `iters` back-to-back calls (per-call events would add
    their own gaps to kernels of ~10 us); the std comes from a second loop
    with per-iteration samples, which also feed the histogram
    `tuning.<op>.us` when observability is on.  Raises unless an operand
    lies on the card."""
    if not any(torch.is_tensor(a) and a.is_cuda for a in args):
        raise RuntimeError(f"autotune {op}: the search times the kernels on a CUDA device; "
                           f"its operands lie on the CPU, where the wrappers run their plain "
                           f"versions")
    mean = wall_us(fn, *args, iters=iters, warmup=warmup)
    _, samples = wall_us(fn, *args, iters=iters, warmup=0, return_samples=True)
    std = statistics.pstdev(samples) if len(samples) > 1 else 0.0
    if obs.enabled():
        obs.histogram(f"tuning.{op}.us").observe_many(samples)
    return mean, std


def _setup(hw, cache):
    """(hw, cache, device, generator, SMs) for one search."""
    dev = torch.device(DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune: no CUDA device (the search times the kernels on the card)")
    hw = hw or get_hardware()
    cache = cache if cache is not None else get_default_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        from ..kernels import _build
        sms = _build.num_sms(dev)
    else:
        sms = hw.num_cores
    return hw, cache, dev, gen, sms


def _copies(nbytes: int) -> int:
    """Operand sets a rotation needs to exceed L2."""
    return max(1, min(MAX_COPIES, -(-L2_BYTES // max(nbytes, 1))))


def _randn(gen, dev, shape, dtype, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _sweep(op: str, what: str, cands, run, first, iters: int, warmup: int,
           verbose: bool) -> List[Trial]:
    """Time run(candidate) (a function of `first`, the operand on the card)
    for every candidate, in order."""
    trials = []
    for c in cands:
        t, std = _measure(op, run(c), first, iters=iters, warmup=warmup)
        trials.append(Trial(tuple(c), t, std))
        if verbose:
            print(f"  {op} {what} {c}: {t:.2f} us", flush=True)
    return trials


def _best(op, shape, dtype, hw, names, trials, cache) -> TunedConfig:
    """The winner as a cache entry (trials[0] is the rule's pick)."""
    best = min(trials, key=lambda t: t.time_us)
    cfg = TunedConfig(op=op, shape=tuple(shape), dtype=dtype, hw_name=hw.name,
                      blocks=dict(zip(names, best.blocks)), time_us=best.time_us,
                      baseline_us=trials[0].time_us, candidates_tried=len(trials),
                      time_us_std=best.time_us_std)
    cache.put(cfg)
    return cfg


def _rotate(items):
    """A zero-argument function returning the next of `items`, cyclically."""
    return itertools.cycle(items).__next__


def autotune_matmul(m: int, k: int, n: int, *, dtype=torch.bfloat16,
                    hw: Optional[Hardware] = None, cache: Optional[TuningCache] = None,
                    iters: int = 20, warmup: int = 3,
                    max_candidates: Optional[int] = None,
                    verbose: bool = False) -> TunedConfig:
    """Sweep (block_m, block_n, split_k) of the tile GEMM for an (m, k, n)
    product; persist and return the measured winner (op "matmul").
    `cache=None` uses the default cache."""
    from ..kernels.matmul.ops import BLOCK_K, F32_BLOCK_K, _matmul_cuda

    hw, cache, dev, gen, sms = _setup(hw, cache)
    cands = matmul_candidates(m, k, n, dtype.itemsize, sms)[:max_candidates]
    bk = F32_BLOCK_K if dtype == torch.float32 else BLOCK_K
    a = _randn(gen, dev, (m, k), dtype)
    ws = [_randn(gen, dev, (k, n), dtype, k ** -0.5)
          for _ in range(_copies(k * n * dtype.itemsize))]

    def run(c):
        geo, w = (c[0], c[1], split_depth(k, c[2], bk)), _rotate(ws)
        return lambda a: _matmul_cuda(a, w(), None, None, forced=geo)
    trials = _sweep("matmul", f"{m}x{k}x{n}", cands, run, a, iters, warmup, verbose)
    return _best("matmul", (m, k, n), dtype_name(dtype), hw, ("block_m", "block_n", "split_k"),
                 trials, cache)


def autotune_fused_mlp(m: int, h: int, f: int, *, mlp_type: str = "swiglu",
                       dtype=torch.bfloat16, hw: Optional[Hardware] = None,
                       cache: Optional[TuningCache] = None, iters: int = 20,
                       warmup: int = 3, max_candidates: Optional[int] = None,
                       verbose: bool = False) -> TunedConfig:
    """Sweep (block_m, block_f) of the fused MLP hidden for x (m, h) against
    (h, f) weights; persist the winner under op "fused_mlp_<mlp_type>",
    shape (m, h, f): the key `fused_mlp_hidden(tuned=True)` (and
    linear_impl="fused", which flattens (b, s, h) to m = b*s) looks up."""
    from ..kernels.fused_mlp.ops import _fused_cuda, fused_mlp_op_name
    from ..kernels.fused_mlp.ref import is_gated

    hw, cache, dev, gen, _ = _setup(hw, cache)
    gated = is_gated(mlp_type)
    cands = fused_mlp_candidates(m, h, f, dtype.itemsize)[:max_candidates]
    x = _randn(gen, dev, (m, h), dtype)
    nw = 2 if gated else 1
    ws = [(_randn(gen, dev, (h, f), dtype, h ** -0.5) if gated else None,
           _randn(gen, dev, (h, f), dtype, h ** -0.5))
          for _ in range(_copies(nw * h * f * dtype.itemsize))]

    def run(c):
        w = _rotate(ws)
        return lambda x: _fused_cuda(x, *w(), mlp_type, forced=tuple(c))
    op = fused_mlp_op_name(mlp_type)
    trials = _sweep(op, f"{m}x{h}x{f}", cands, run, x, iters, warmup, verbose)
    return _best(op, (m, h, f), dtype_name(dtype), hw, ("block_m", "block_f"), trials, cache)


def _int8_weights(gen, dev, k, n, dtype, count):
    from ..quant import quantize_weight
    return [quantize_weight(_randn(gen, dev, (k, n), dtype, k ** -0.5)) for _ in range(count)]


def autotune_int8_matmul(m: int, k: int, n: int, *, dtype=torch.bfloat16,
                         hw: Optional[Hardware] = None, cache: Optional[TuningCache] = None,
                         iters: int = 20, warmup: int = 3,
                         max_candidates: Optional[int] = None,
                         verbose: bool = False) -> TunedConfig:
    """Sweep (block_m, block_n, split_k) of the int8 GEMM for an (m, k, n)
    product with `dtype` activations; persist the winner under op
    "int8_matmul" with the mixed dtype key (e.g. "bfloat16xint8") — the key
    `int8_matmul(tuned=True)` looks up."""
    from ..kernels.quantized.ops import BLOCK_K, _int8_matmul_cuda
    from ..quant import quantize_int8

    hw, cache, dev, gen, sms = _setup(hw, cache)
    cands = int8_matmul_candidates(m, k, n, sms)[:max_candidates]
    a_q, a_s = quantize_int8(_randn(gen, dev, (m, k), dtype))
    ws = _int8_weights(gen, dev, k, n, dtype, _copies(k * n))

    def run(c):
        geo, w = (c[0], c[1], split_depth(k, c[2], BLOCK_K)), _rotate(ws)

        def f(a_q):
            wq = w()
            return _int8_matmul_cuda(a_q, a_s, wq.q, wq.scale.reshape(1, -1), dtype,
                                     forced=geo)
        return f
    trials = _sweep("int8_matmul", f"{m}x{k}x{n}", cands, run, a_q, iters, warmup, verbose)
    return _best("int8_matmul", (m, k, n), mixed_dtype(dtype_name(dtype), "int8"), hw,
                 ("block_m", "block_n", "split_k"), trials, cache)


def autotune_fp8_matmul(m: int, k: int, n: int, *, fp8_dtype: str = "float8_e4m3fn",
                        dtype=torch.bfloat16, hw: Optional[Hardware] = None,
                        cache: Optional[TuningCache] = None, iters: int = 20,
                        warmup: int = 3, max_candidates: Optional[int] = None,
                        verbose: bool = False) -> TunedConfig:
    """Sweep the tile GEMM's knobs for the emulated-fp8 (m, k, n) GEMM
    (operands rounded through fp8 once); persist the winner under op
    "fp8_matmul" with the mixed dtype key (e.g. "bfloat16xfloat8_e4m3fn")."""
    from ..kernels.matmul.ops import BLOCK_K, F32_BLOCK_K, _matmul_cuda
    from ..quant import fp8_round_trip

    hw, cache, dev, gen, sms = _setup(hw, cache)
    cands = fp8_matmul_candidates(m, k, n, dtype.itemsize, sms)[:max_candidates]
    bk = F32_BLOCK_K if dtype == torch.float32 else BLOCK_K
    a = fp8_round_trip(_randn(gen, dev, (m, k), dtype), fp8_dtype)
    ws = [fp8_round_trip(_randn(gen, dev, (k, n), dtype, k ** -0.5), fp8_dtype)
          for _ in range(_copies(k * n * dtype.itemsize))]

    def run(c):
        geo, w = (c[0], c[1], split_depth(k, c[2], bk)), _rotate(ws)
        return lambda a: _matmul_cuda(a, w(), None, None, forced=geo)
    trials = _sweep("fp8_matmul", f"{m}x{k}x{n}", cands, run, a, iters, warmup, verbose)
    return _best("fp8_matmul", (m, k, n), mixed_dtype(dtype_name(dtype), fp8_dtype), hw,
                 ("block_m", "block_n", "split_k"), trials, cache)


def autotune_int8_fused_mlp(m: int, h: int, f: int, *, mlp_type: str = "swiglu",
                            dtype=torch.bfloat16, hw: Optional[Hardware] = None,
                            cache: Optional[TuningCache] = None,
                            iters: int = 20, warmup: int = 3,
                            max_candidates: Optional[int] = None,
                            verbose: bool = False) -> TunedConfig:
    """Sweep (block_m, block_f) of the int8-weight fused MLP hidden; persist
    the winner under op "int8_fused_mlp_<mlp_type>" with the mixed dtype
    key."""
    from ..kernels.fused_mlp.ref import is_gated
    from ..kernels.quantized.ops import _int8_fused_cuda, int8_fused_mlp_op_name
    from ..quant import quantize_int8

    hw, cache, dev, gen, _ = _setup(hw, cache)
    gated = is_gated(mlp_type)
    cands = int8_fused_mlp_candidates(m, h, f)[:max_candidates]
    x_q, x_s = quantize_int8(_randn(gen, dev, (m, h), dtype))
    nw = 2 if gated else 1
    ws = [_int8_weights(gen, dev, h, f, dtype, nw) for _ in range(_copies(nw * h * f))]

    def run(c):
        w = _rotate(ws)

        def fn(x_q):
            ps = w()
            wg, wu = (ps[0], ps[1]) if gated else (None, ps[0])
            return _int8_fused_cuda(x_q, x_s, None if wg is None else wg.q,
                                    None if wg is None else wg.scale.reshape(1, -1), wu.q,
                                    wu.scale.reshape(1, -1), mlp_type, dtype, forced=tuple(c))
        return fn
    op = int8_fused_mlp_op_name(mlp_type)
    trials = _sweep(op, f"{m}x{h}x{f}", cands, run, x_q, iters, warmup, verbose)
    return _best(op, (m, h, f), mixed_dtype(dtype_name(dtype), "int8"), hw,
                 ("block_m", "block_f"), trials, cache)


def autotune_paged_decode(batch: int, slots: int, s_max: int, kv_heads: int, heads: int,
                          head_dim: int, *, dtype=torch.bfloat16, hw: Optional[Hardware] = None,
                          cache: Optional[TuningCache] = None, iters: int = 20,
                          warmup: int = 3, max_candidates: Optional[int] = None,
                          verbose: bool = False) -> TunedConfig:
    """Sweep (tile, splits) of the bf16 paged decode kernel over a (slots,
    s_max, kv_heads, head_dim) pool with `batch` rows, every row s_max
    tokens deep (as JAX's search); persist the winner under op
    "paged_decode", shape (batch, slots, s_max, kv_heads, heads, head_dim)."""
    from ..kernels.flash_attention.ops import _paged_cuda, paged_decode

    hw, cache, dev, gen, _ = _setup(hw, cache)
    g = heads // kv_heads
    cands = paged_decode_candidates(batch, kv_heads, g, head_dim, s_max,
                                    dtype.itemsize)[:max_candidates]
    q = _randn(gen, dev, (batch, heads, head_dim), dtype)
    shape = (slots, s_max, kv_heads, head_dim)
    pools = [(_randn(gen, dev, shape, dtype), _randn(gen, dev, shape, dtype))
             for _ in range(_copies(2 * slots * s_max * kv_heads * head_dim * dtype.itemsize))]
    slot_idx = torch.arange(batch, dtype=torch.int32, device=dev) % slots
    lengths = torch.full((batch,), s_max, dtype=torch.int32, device=dev)

    def run(c):
        p = _rotate(pools)
        return lambda q: _paged_cuda(paged_decode, q, *p(), None, None, slot_idx, lengths, 0,
                                     None, tuple(c))
    what = f"b{batch} pool{slots}x{s_max} kv{kv_heads} a{heads} d{head_dim}"
    trials = _sweep("paged_decode", what, cands, run, q, iters, warmup, verbose)
    return _best("paged_decode", (batch, slots, s_max, kv_heads, heads, head_dim),
                 dtype_name(dtype), hw, ("tile", "splits"), trials, cache)


def autotune_paged_decode_blocktable(batch: int, num_rows: int, s_max: int, kv_heads: int,
                                     heads: int, head_dim: int, *, dtype=torch.bfloat16,
                                     hw: Optional[Hardware] = None,
                                     cache: Optional[TuningCache] = None,
                                     iters: int = 20, warmup: int = 3,
                                     max_candidates: Optional[int] = None,
                                     verbose: bool = False) -> TunedConfig:
    """Jointly sweep (block_size, tile, splits) for the block-table decode
    kernel over a pool sized for `num_rows` sequences of up to `s_max`
    tokens, each block size with its own pool (num_rows x s_max/block_size
    blocks), every row s_max tokens deep.

    Two kinds of entry, as JAX's search writes them:
      * op "paged_decode_blocktable_pool", shape (batch, num_rows, s_max,
        kv_heads, heads, head_dim), blocks {block_size, tile, splits}: the
        entry the engine's `_pick_block_size` consults; its baseline is the
        engine's own fallback block size at the kernel's rule;
      * op "paged_decode_blocktable", shape (batch, num_blocks, block_size,
        kv_heads, heads, head_dim), blocks {tile, splits}: the best at each
        block size tried, its baseline the rule at that size.
    Returns the pool-level winner."""
    from ..kernels.flash_attention.ops import _paged_cuda, paged_decode_blocktable

    hw, cache, dev, gen, _ = _setup(hw, cache)
    g = heads // kv_heads
    cands = paged_blocktable_candidates(batch, kv_heads, g, head_dim, s_max,
                                        dtype.itemsize)[:max_candidates]
    q = _randn(gen, dev, (batch, heads, head_dim), dtype)
    lengths = torch.full((batch,), s_max, dtype=torch.int32, device=dev)
    dt = dtype_name(dtype)
    trials: List[Trial] = []
    for bs in dict.fromkeys(c[0] for c in cands):
        max_blocks = s_max // bs
        nb = num_rows * max_blocks
        shape = (nb, bs, kv_heads, head_dim)
        pools = [(_randn(gen, dev, shape, dtype), _randn(gen, dev, shape, dtype))
                 for _ in range(_copies(2 * nb * bs * kv_heads * head_dim * dtype.itemsize))]
        tables = ((torch.arange(batch, dtype=torch.int32, device=dev)[:, None] * max_blocks
                   + torch.arange(max_blocks, dtype=torch.int32, device=dev)[None, :]) % nb)

        def run(c, pools=pools, tables=tables):
            p = _rotate(pools)
            return lambda q: _paged_cuda(paged_decode_blocktable, q, *p(), None, None, tables,
                                         lengths, tables.shape[1], None, tuple(c[1:]))
        what = f"b{batch} rows{num_rows} s{s_max} kv{kv_heads} a{heads} d{head_dim} bs{bs}"
        at = _sweep("paged_decode_blocktable", what, [c for c in cands if c[0] == bs], run, q,
                    iters, warmup, verbose)
        # the per-pool-shape entry: the kernel-level tuned lookup
        best = min(at, key=lambda t: t.time_us)
        cache.put(TunedConfig(
            op="paged_decode_blocktable", shape=(batch, nb, bs, kv_heads, heads, head_dim),
            dtype=dt, hw_name=hw.name, blocks={"tile": best.blocks[1], "splits": best.blocks[2]},
            time_us=best.time_us, baseline_us=at[0].time_us, candidates_tried=len(at),
            time_us_std=best.time_us_std))
        trials += at
    # the pool entry's baseline: the engine's fallback block size, at the rule
    fallback = fallback_block_size(s_max, sublane_granule(hw, dtype.itemsize))
    baseline = next((t for t in trials if t.blocks[0] == fallback), None)
    best = min(trials, key=lambda t: t.time_us)
    cfg = TunedConfig(
        op="paged_decode_blocktable_pool",
        shape=(batch, num_rows, s_max, kv_heads, heads, head_dim), dtype=dt, hw_name=hw.name,
        blocks=dict(zip(("block_size", "tile", "splits"), best.blocks)), time_us=best.time_us,
        baseline_us=baseline.time_us if baseline else 0.0, candidates_tried=len(trials),
        time_us_std=best.time_us_std)
    cache.put(cfg)
    return cfg
