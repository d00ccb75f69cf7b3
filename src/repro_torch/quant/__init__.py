"""Numeric int8 quantization of the KV cache (the JAX package's
`quant/__init__.py`, its KV part; weight quantization comes with the
low-precision GEMM slice).

Symmetric absmax scaling, as the JAX package: ``scale = max|x| / 127``,
``q = round(x / scale)`` clipped to [-127, 127] (-128 unused, so the range
is symmetric).  The division runs in float32 and rounds half to even, as
``jnp.round`` does (so does ``torch.round``).  Scales are float32 and live
beside the int8 payload: one per (token, kv head) for KV-cache entries.
"""
from __future__ import annotations

from typing import Tuple

import torch

INT8_MAX = 127.0
# smallest scale divided by; an all-zero slice quantizes to zeros
EPS = 1e-8


def quantize_int8(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 with `axis` kept at size 1), q * scale ~= x."""
    x = x.float()
    absmax = x.abs().amax(dim=axis, keepdim=True)
    scale = absmax.clamp_min(EPS) / INT8_MAX
    q = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_int8`: widen and re-scale in float32, then cast."""
    return (q.float() * scale.float()).to(dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a KV tensor (..., kv_heads, head_dim) per (token, kv head):
    (int8 values, f32 scales with head_dim dropped), the layout of the int8
    pools' "k"/"v" and "k_scale"/"v_scale" leaves."""
    q, scale = quantize_int8(x, axis=-1)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `quantize_kv`: the scales broadcast back over head_dim."""
    return dequantize_int8(q, scale[..., None], dtype)


def kv_bytes_per_token(num_kv_heads: int, head_dim: int, kv_dtype: str = "auto",
                       compute_bytes: int = 2) -> int:
    """KV bytes per token per layer (K and V): int8 stores 1 byte per
    element plus one f32 scale per (token, head) for each of K and V;
    "auto" stores the compute dtype."""
    elems = 2 * num_kv_heads * head_dim
    if kv_dtype == "int8":
        return elems + 2 * num_kv_heads * 4
    return elems * compute_bytes
