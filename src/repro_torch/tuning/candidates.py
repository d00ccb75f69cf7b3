"""Candidate lattices: the serving engine's bucket lattice and, per tuned
kernel, the launch geometries worth timing, in the port's own knobs.

The tile granules and the power-of-two bucket lattice are copied from the
JAX package's `tuning/candidates.py`.  The per-kernel lattices are not: the
JAX package sweeps Pallas block shapes under a TPU VMEM model, and on
Hopper the accumulator lives in registers and the operands stage through
shared memory, so those VMEM models do not carry over.  Here a candidate is
a geometry the CUDA library instantiates, and nothing else (a C entry
refuses any other with a status, and the wrapper raises):

  matmul / fp8_matmul   (block_m, block_n, split_k): `kernels/matmul/ops.py`
                        TILES (F32_TILE in f32) x 1, 2, 4, 8 splits of k,
                        each at least MIN_SPLIT_STEPS k steps deep;
  fused MLP             (block_m, block_f): its two bf16 tiles (f32: one);
  int8 GEMM             (block_m, block_n, split_k): the tiles
                        csrc/int8_matmul.cu instantiates (64 x 128,
                        128 x 256) x 1, 2, 4, 8 splits (one cluster), each
                        at least SPLIT_MIN_STEPS 128-column steps deep;
  int8 fused MLP        (block_m, block_f): FUSED_TILE, FUSED_WIDE_TILE;
  paged decode          (tile, splits): PAGED_TILES x 1-8 splits whose
                        shared memory fits SMEM_LIMIT (bf16 queries: the f32
                        body has no knob);
  block-table pool      (block_size, tile, splits): block sizes from
                        `bucket_steps` at MIN_BLOCK granularity that divide
                        s_max (the pool needs whole blocks a row, the kernel
                        takes any size).

`split_k` is the number of k splits; a lattice holds each distinct launch
once (two split counts that give the same k per split are one candidate).
Flash attention has no lattice yet: its kernels compile one geometry per
head-dim width, so there is nothing to choose.
"""
from __future__ import annotations

from typing import List, Tuple

from ..core.hardware import Hardware
from ..core.quantization import round_up

# Don't let the lattice explode: per-dimension caps keep the sweep tractable
# while covering every block size the kernels plausibly benefit from.
MAX_BLOCK = 1024
# split counts the GEMM lattices try (the int8 GEMM's splits form one
# cluster of at most 8 blocks)
SPLITS = (1, 2, 4, 8)
# the smallest physical KV block the block-table lattice tries (the engine's
# own fallback takes no block under 16 tokens)
MIN_BLOCK = 16


def sublane_granule(hw: Hardware, dtype_bytes: int = 2) -> int:
    """Native second-to-minor tile granularity at `dtype_bytes`.

    TPU packs (32 / dtype_bytes) x 128 register tiles (f32: 8, bf16: 16,
    int8: 32); GPUs use `tile_2byte[0]` at every dtype (64 on the H100).
    """
    sub, _ = hw.tile_2byte
    if hw.name.startswith("tpu"):
        return max(1, sub * 2 // max(dtype_bytes, 1))
    return sub


def lane_granule(hw: Hardware) -> int:
    """Minor-most tile granularity (always the full lane width)."""
    return hw.tile_2byte[1]


def _steps(dim: int, granule: int, cap: int = MAX_BLOCK) -> List[int]:
    """Power-of-two multiples of `granule`, capped by the (padded) problem
    dim and `cap` — blocks larger than the problem only add padding."""
    hi = min(cap, round_up(max(dim, 1), granule))
    out = []
    b = granule
    while b <= hi:
        out.append(b)
        b *= 2
    if not out:
        out = [granule]
    return out


def bucket_steps(dim: int, granule: int, cap: int = MAX_BLOCK) -> List[int]:
    """Public lattice for the serving engine's bucket policy: power-of-two
    multiples of the hardware tile granule, up to (the padding of) `dim`."""
    return _steps(dim, granule, cap)


def fallback_block_size(s_max: int, granule: int) -> int:
    """The engine's physical KV block size where the tuning cache has no
    pool entry: the smallest divisor of s_max on the bucket lattice that is
    >= 16 — fine-grained enough to share prefixes, still a whole number of
    register tiles."""
    divisors = [b for b in bucket_steps(s_max, granule) if s_max % b == 0]
    for b in divisors:
        if b >= 16:
            return b
    return divisors[-1] if divisors else s_max


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_depth(k: int, splits: int, block_k: int) -> int:
    """k per split of `splits` splits in whole steps of `block_k`: what the
    wrappers pass their C entries (k itself when there is one split)."""
    if splits < 1:
        raise ValueError(f"split_k {splits}: at least one split")
    return _cdiv(_cdiv(k, splits), block_k) * block_k


def _gemm_lattice(k: int, tiles, block_k: int, min_steps: int, rule, splits=SPLITS):
    """(block_m, block_n, split_k) for every tile x split count whose splits
    are each `min_steps` steps deep, one per distinct launch, the rule's
    pick (block_m, block_n, k per split) first."""
    tm, tn, ks = rule
    out = {(tm, tn, ks): (tm, tn, _cdiv(k, ks))}
    for bm, bn in tiles:
        for s in splits:
            if s == 1 or k >= s * min_steps * block_k:
                out.setdefault((bm, bn, split_depth(k, s, block_k)), (bm, bn, s))
    return [(bm, bn, _cdiv(k, ks)) for bm, bn, ks in out]


def matmul_candidates(m: int, k: int, n: int, dtype_bytes: int = 2,
                      num_sms: int = 132) -> List[Tuple[int, int, int]]:
    """(block_m, block_n, split_k) of the tile GEMM (csrc/matmul.cu) for an
    (m, k, n) product; the rule's pick (`launch_shape`) first."""
    import torch

    from ..kernels.matmul import ops
    f32 = dtype_bytes == 4
    rule = ops.launch_shape(m, n, k, torch.float32 if f32 else torch.bfloat16, num_sms)
    return _gemm_lattice(k, (ops.F32_TILE,) if f32 else ops.TILES,
                         ops.F32_BLOCK_K if f32 else ops.BLOCK_K, ops.MIN_SPLIT_STEPS, rule)


def fp8_matmul_candidates(m: int, k: int, n: int, dtype_bytes: int = 2,
                          num_sms: int = 132) -> List[Tuple[int, int, int]]:
    """The emulated fp8 GEMM runs the tile GEMM in the activation dtype:
    the same lattice."""
    return matmul_candidates(m, k, n, dtype_bytes, num_sms)


def fused_mlp_candidates(m: int, h: int, f: int, dtype_bytes: int = 2
                         ) -> List[Tuple[int, int]]:
    """(block_m, block_f) of the fused MLP hidden (csrc/fused_mlp.cu), the
    rule's pick (`pick_tile`) first."""
    import torch

    from ..kernels.fused_mlp import ops
    if dtype_bytes == 4:
        return [ops.F32_TILE]
    rule = ops.pick_tile(m, torch.bfloat16)
    return [rule] + [t for t in (ops.DECODE_TILE, ops.TRAIN_TILE) if t != rule]


def int8_matmul_candidates(m: int, k: int, n: int, num_sms: int = 132
                           ) -> List[Tuple[int, int, int]]:
    """(block_m, block_n, split_k) of the int8 GEMM (csrc/int8_matmul.cu),
    the rule's pick (`launch_shape`) first."""
    from ..kernels.quantized import ops
    return _gemm_lattice(k, (ops.DECODE_TILE, ops.WIDE_TILE), ops.BLOCK_K,
                         ops.SPLIT_MIN_STEPS, ops.launch_shape(m, n, k, num_sms))


def int8_fused_mlp_candidates(m: int, h: int, f: int) -> List[Tuple[int, int]]:
    """(block_m, block_f) of the int8 fused MLP (csrc/int8_fused_mlp.cu),
    the rule's pick (`fused_tile`) first."""
    from ..kernels.quantized import ops
    rule = ops.fused_tile(m)
    return [rule] + [t for t in (ops.FUSED_TILE, ops.FUSED_WIDE_TILE) if t != rule]


def paged_decode_candidates(b: int, nkv: int, g: int, d: int, capacity: int,
                            kv_itemsize: int = 2) -> List[Tuple[int, int]]:
    """(tile, splits) of the bf16 paged-decode kernel (csrc/paged_decode.cu)
    over b rows of nkv kv heads, g query heads each, `capacity` tokens a
    row: PAGED_TILES x 1..MAX_SPLITS within SMEM_LIMIT, one per distinct
    launch, the rule's pick (`paged_launch`) first."""
    from ..kernels.flash_attention import ops
    rule = ops.paged_launch(b, nkv, g, d, capacity, kv_itemsize)
    out = {rule: (rule.tile, rule.splits)}
    for tile in ops.PAGED_TILES:
        for s in range(1, ops.MAX_SPLITS + 1):
            try:
                geo = ops.paged_launch(b, nkv, g, d, capacity, kv_itemsize, 2, tile, s)
            except ValueError:       # shared memory past SMEM_LIMIT
                continue
            out.setdefault(geo, (tile, s))
    return list(out.values())


def paged_blocktable_candidates(b: int, nkv: int, g: int, d: int, s_max: int,
                                kv_itemsize: int = 2) -> List[Tuple[int, int, int]]:
    """(block_size, tile, splits) for the block-table pool: every block
    size of the lattice that divides s_max (largest first) with the paged
    lattice at that pool's capacity (max_blocks x block_size = s_max)."""
    sizes = [bs for bs in bucket_steps(s_max, MIN_BLOCK, cap=min(MAX_BLOCK, s_max))
             if s_max % bs == 0]
    return [(bs, tile, s) for bs in sorted(sizes, reverse=True)
            for tile, s in paged_decode_candidates(b, nkv, g, d, s_max, kv_itemsize)]
