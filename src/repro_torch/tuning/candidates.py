"""Tile-aligned lattices shared by the serving engine's bucket policy.

Copied from the JAX package's `tuning/candidates.py`: the hardware tile
granules and the power-of-two bucket lattice.  The per-kernel candidate
lattices and their on-chip memory models follow with the tuning slice
(Hopper keeps the accumulator in registers and stages operands in shared
memory, so the TPU's VMEM models do not carry over).
"""
from __future__ import annotations

from typing import List

from ..core.hardware import Hardware
from ..core.quantization import round_up

# Don't let the lattice explode: per-dimension caps keep the sweep tractable
# while covering every block size the kernels plausibly benefit from.
MAX_BLOCK = 1024


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
