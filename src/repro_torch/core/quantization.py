"""Tile- and wave-quantization math (paper §III-B, §VI-B), hardware-parametric
(a copy of the JAX package's `core/quantization.py`).

GPU mode reproduces the paper's rules verbatim:
  * tensor-core alignment: dims multiple of `tile_2byte` elements,
  * tile quantization: output matrix divided into mxu-tile blocks, partial
    blocks execute at full-block cost,
  * wave quantization: blocks scheduled to `num_cores` SMs in waves; a tail
    wave runs at full-wave latency with partial useful work.

TPU mode keeps the first two (MXU pass padding) and replaces the third:
grid steps on a v5e TensorCore are *sequential*, so the "wave" is a single
grid step and the tail effect is the partial final block plus shard-level
divisibility (see `shard_quantization`).

Naming note: this module is about *tile/wave* quantization — utilization
loss from shapes that do not divide the hardware's native tiles.  *Numeric*
quantization (compressing values to int8/fp8) lives in `repro_torch.quant`; the
two share a name in the literature but nothing else.
"""
from __future__ import annotations


from .hardware import Hardware


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return ceil_div(x, multiple) * multiple


def pow2_factor(n: int, cap: int = 1024) -> int:
    """Largest power of two dividing n (capped).  The paper's Figs. 7-9 color
    curves by this quantity."""
    if n <= 0:
        return 1
    f = n & (-n)
    return min(f, cap)


def tile_utilization(m: int, n: int, k: int, hw: Hardware, dtype_bytes: int = 2) -> float:
    """Fraction of matmul-unit work that is useful after padding every
    dimension up to the native tile.  1.0 = perfectly aligned.

    This is the paper's tensor-core + tile-quantization effect folded into a
    single multiplicative utilization term.
    """
    sub, lane = hw.tile_2byte
    # scale sublane granularity with dtype (f32: 8, bf16: 16, int8: 32 on TPU)
    sub = max(1, sub * 2 // max(dtype_bytes, 1)) if hw.name.startswith("tpu") else sub
    tm, tn = hw.mxu
    # dims are padded to the register tile, and the output is blocked into
    # mxu tiles; both pads waste multiply-accumulate cycles.
    m_pad = round_up(round_up(m, sub), 1)
    n_pad = round_up(round_up(n, lane), 1)
    k_pad = round_up(k, lane)
    m_blk = round_up(m_pad, tm)
    n_blk = round_up(n_pad, tn)
    useful = m * n * k
    padded = m_blk * n_blk * k_pad
    return useful / max(padded, 1)


def num_output_tiles(m: int, n: int, hw: Hardware) -> int:
    tm, tn = hw.mxu
    return ceil_div(m, tm) * ceil_div(n, tn)


def wave_efficiency(m: int, n: int, hw: Hardware, batch: int = 1) -> float:
    """Paper §VI-B wave quantization: `batch * tiles` thread blocks scheduled
    over `num_cores` SMs.  Tail wave runs at full-wave latency.

    Returns useful_waves / actual_waves in (0, 1].  For hardware with
    sequential grids (TPU), returns 1.0 — the tail cost is already inside
    `tile_utilization` (partial final block) and `shard_quantization`.
    """
    if not hw.concurrent_tiles:
        return 1.0
    blocks = num_output_tiles(m, n, hw) * batch
    waves = ceil_div(blocks, hw.num_cores)
    return blocks / (waves * hw.num_cores)


def wave_free(m: int, n: int, hw: Hardware) -> bool:
    """Paper's no-wave-quantization constraint:
    ceil(X/t1)*ceil(Y/t2) ≡ 0 (mod #SMs)  (either tile orientation)."""
    t1, t2 = hw.mxu
    a = ceil_div(m, t1) * ceil_div(n, t2)
    b = ceil_div(m, t2) * ceil_div(n, t1)
    return a % hw.num_cores == 0 or b % hw.num_cores == 0


def shard_quantization(dim: int, shards: int) -> float:
    """TPU-scale analogue of wave quantization: utilization loss from a
    dimension that does not divide evenly across a mesh axis.  XLA SPMD pads
    every shard to ceil(dim/shards); utilization = dim / (shards * shard)."""
    if shards <= 1:
        return 1.0
    per = ceil_div(dim, shards)
    return dim / (per * shards)
