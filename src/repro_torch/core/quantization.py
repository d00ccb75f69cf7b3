"""Tile-quantization arithmetic the serving slice needs (copied from the
JAX package's `core/quantization.py`; the rest of that module — tile and
wave utilization — follows with the tuning slice)."""
from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return ceil_div(x, multiple) * multiple
