"""Plain PyTorch versions of the low-precision GEMM kernels (the CPU path,
and what the CUDA kernels are held against).

Each takes the SAME quantized operands as its kernel (quantization happens
once, in ops.py, outside both), so a comparison isolates the kernel's
arithmetic.  The integer product is exact: the int8 operands widen to
float64, where every partial sum is an integer below k * 127^2 < 2^53, then
the exact sum rounds to float32 (to nearest, as the kernel's i32 -> f32
conversion) and takes the de-scale `* a_scale * b_scale` in that order, as
the JAX kernel's epilogue.  (The JAX package's own oracle sums in float32,
which is not exact past 2^24; the port is held to its kernel.)
"""
from __future__ import annotations

import torch

from ...quant import fp8_round_trip
from ..fused_mlp.ref import ACTS, is_gated


def int8_product(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact a_q @ b_q of int8 operands, rounded once to float32."""
    return (a_q.double() @ b_q.double()).float()


def int8_matmul_ref(a_q, a_scale, b_q, b_scale, out_dtype=torch.float32):
    """a_q (m, k) int8, a_scale (m, 1) f32; b_q (k, n) int8, b_scale (1, n)
    f32.  Returns (m, n) in `out_dtype`."""
    return (int8_product(a_q, b_q) * a_scale * b_scale).to(out_dtype)


def int8_matmul_expert_ref(a_q, a_scale, b_q, b_scale, out_dtype=torch.float32):
    """The batched int8 GEMM's plain version, one expert at a time: a_q (E,
    m, k) int8, a_scale (E, m, 1); b_q (E, k, n) int8, b_scale (E, 1, n).
    Returns (E, m, n) in `out_dtype`."""
    return torch.stack([int8_matmul_ref(a_q[z], a_scale[z], b_q[z], b_scale[z], out_dtype)
                        for z in range(a_q.shape[0])])


def int8_fused_mlp_ref(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, *,
                       mlp_type: str = "swiglu", out_dtype=torch.float32):
    """The int8-weight fused-MLP hidden: de-scaled gate / up products and the
    activation combine in f32.  x_q (m, h) int8, x_scale (m, 1); w*_q (h, f)
    int8, w*_scale (1, f); wg_* None for the ungated types."""
    act = ACTS[mlp_type]
    up = int8_product(x_q, wu_q) * x_scale * wu_scale
    if is_gated(mlp_type):
        gate = int8_product(x_q, wg_q) * x_scale * wg_scale
        return (act(gate) * up).to(out_dtype)
    return act(up).to(out_dtype)


def fp8_matmul_ref(a, b, fp8_dtype: str = "float8_e4m3fn", out_dtype=None):
    """Emulated-fp8 GEMM: both operands rounded through fp8 storage, then
    contracted in f32."""
    out_dtype = out_dtype or a.dtype
    a8 = fp8_round_trip(a.float(), fp8_dtype)
    b8 = fp8_round_trip(b.float(), fp8_dtype)
    return (a8 @ b8).to(out_dtype)
