"""Numeric quantization: int8 and emulated-fp8 value compression (the JAX
package's `quant/__init__.py`, one to one).

Symmetric absmax scaling, as the JAX package: ``scale = max|x| / 127``,
``q = round(x / scale)`` clipped to [-127, 127] (-128 unused, so the range
is symmetric).  The scale is computed in the form the JAX package runs:
under `jit` (the engine step, the int8 GEMM wrappers) XLA rewrites
``absmax / 127.0`` as ``absmax * float32(1/127)``, one ulp away from the
division on some inputs, so the port multiplies by that constant.  The
payload's ``x / scale`` stays a float32 division (XLA keeps it) and rounds
half to even, as ``jnp.round`` does (so does ``torch.round``).

Scales are float32 and live beside the int8 payload: weights carry one per
output channel, activations one per row, KV-cache entries one per (token,
kv head).  fp8 is emulated: values round through ``float8_e4m3fn`` /
``float8_e5m2`` storage and widen back, so the product that follows runs
on the bf16 / f32 path.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

INT8_MAX = 127.0
# emulated fp8 storage formats (both 1 byte; e4m3 = more mantissa, e5m2 =
# more range)
FP8_DTYPES = ("float8_e4m3fn", "float8_e5m2")
# smallest scale divided by; an all-zero slice quantizes to zeros
EPS = 1e-8
# XLA's constant for `absmax / 127.0` (the reciprocal, rounded to f32)
_INV_INT8_MAX = 1.0 / INT8_MAX
# e4m3fn has no infinity: JAX (ml_dtypes) gives NaN for every |x| past the
# halfway point between 448 (its largest value) and 480, where torch's cast
# saturates at 448
_E4M3_NAN_ABOVE = 464.0


class QuantizedTensor(NamedTuple):
    """An int8 (or fp8) payload plus the float32 scales that de-quantize it.

    ``axis`` is the axis reduced when the scales were computed (the scales
    hold it at size 1)."""

    q: torch.Tensor       # int8 values
    scale: torch.Tensor   # float32, broadcastable against q
    axis: int             # axis reduced when computing absmax


def quantize_int8(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 with `axis` kept at size 1), q * scale ~= x."""
    x = x.float()
    absmax = x.abs().amax(dim=axis, keepdim=True)
    scale = absmax.clamp_min(EPS) * torch.tensor(_INV_INT8_MAX, dtype=torch.float32)
    q = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_int8`: widen and re-scale in float32, then cast."""
    return (q.float() * scale.float()).to(dtype)


def _to_fp8(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x` cast to fp8 storage with JAX's overflow: NaN past e4m3's range."""
    if name not in FP8_DTYPES:
        raise ValueError(f"unknown fp8 dtype {name!r}; valid: {list(FP8_DTYPES)}")
    out = x.to(getattr(torch, name))
    if name == "float8_e4m3fn":
        out = torch.where(x.abs() > _E4M3_NAN_ABOVE,
                          torch.tensor(float("nan"), dtype=out.dtype, device=x.device), out)
    return out


def k_major(q: torch.Tensor) -> torch.Tensor:
    """A (..., k, n) payload held K-major: the `.mT` view of a contiguous
    (..., n, k) tensor, as the int8 GEMM kernels read their weights (s8
    `wgmma` takes K-major operands only).  The same shape and values; a
    tensor already so held is not copied."""
    return q.mT.contiguous().mT


def quantize_weight(w: torch.Tensor, dtype: str = "int8") -> QuantizedTensor:
    """Quantize a (..., k, n) weight per output channel (reduce over k): an
    int8 payload held K-major (`k_major`) with (..., 1, n) scales, or an fp8
    payload with an all-ones scale (the rounding itself is the
    compression)."""
    if dtype == "int8":
        q, scale = quantize_int8(w, axis=-2)
        return QuantizedTensor(q=k_major(q), scale=scale, axis=-2)
    if dtype in FP8_DTYPES:
        return QuantizedTensor(q=_to_fp8(w, dtype),
                               scale=torch.ones((1,) * w.dim(), dtype=torch.float32,
                                                device=w.device), axis=-2)
    raise ValueError(f"unknown quant dtype {dtype!r}; valid: ['int8', *{list(FP8_DTYPES)}]")


def fp8_round_trip(x: torch.Tensor, fp8_dtype: str = "float8_e4m3fn") -> torch.Tensor:
    """Round `x` through fp8 storage and widen back to its own dtype."""
    return _to_fp8(x, fp8_dtype).to(x.dtype)


# -- KV-cache quantization -------------------------------------------------------------

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
