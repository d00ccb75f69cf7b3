"""Unified linear-execution layer: every model GEMM routes through here.

`linear` flattens (b, s, h) activations to 2-D and selects the execution
path from `ModelConfig.linear_impl`:

  "jnp"    — `torch.matmul` (the JAX package leaves this GEMM to XLA)
  "pallas" — the hand-written CUDA tile GEMM (kernels/matmul)
  "tuned"  — the same kernel: block shapes are fixed until the tuning slice
  "fused"  — the tile GEMM everywhere, plus the fused SwiGLU/MLP kernel
             (kernels/fused_mlp) for the MLP gate/up pair
  "quantized" — raises: the int8 path comes with the low-precision slice

The kernel paths are differentiable: `_Linear` mirrors JAX's
`_pallas_linear` custom VJP, its dgrad (g @ w^T) and wgrad (x^T @ g) both
launching the tile GEMM on transposed views.  It is taken only when a
gradient is recorded: serving (under `no_grad`) calls the kernel wrapper
directly and pays no `autograd.Function` on its ~170 calls per decode step.

Weights are cast to the activation dtype per call, as JAX does: a no-op on
the serving path (params arrive in the compute dtype), and on the training
path (float32 masters) the cast's own backward returns the float32
gradient.
"""
from __future__ import annotations

import torch

from ..kernels.fused_mlp.ops import fused_mlp_hidden
from ..kernels.matmul.ops import matmul

LINEAR_IMPLS = ("jnp", "pallas", "tuned", "fused", "quantized")


def _check_impl(impl: str) -> None:
    if impl not in LINEAR_IMPLS:
        raise ValueError(
            f"unknown linear_impl {impl!r}; valid: {list(LINEAR_IMPLS)}")
    if impl == "quantized":
        raise NotImplementedError(
            "linear_impl='quantized' (int8 kernels) is not ported yet: it comes "
            "with the low-precision slice")


class _Linear(torch.autograd.Function):
    """JAX's `_pallas_linear` (models/linear.py:75-97): x2 (m, k) @ w (k, n)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return matmul(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.contiguous()
        dx = matmul(g, w.T) if ctx.needs_input_grad[0] else None
        dw = matmul(x2.T, g) if ctx.needs_input_grad[1] else None
        return dx, dw


def linear(x, w, *, impl: str = "jnp"):
    """y = x @ w with dispatched execution.  x: (..., k); w: (k, n)."""
    _check_impl(impl)
    w = w.to(x.dtype)
    if impl == "jnp":
        return x @ w
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        lead, k = x.shape[:-1], x.shape[-1]
        return _Linear.apply(x.reshape(-1, k), w).reshape(*lead, w.shape[-1])
    return matmul(x, w)


def fused_mlp(x, p, cfg):
    """Full MLP block through the fused hidden kernel + the tile-GEMM down
    projection.  p: {w_gate (swiglu), w_up, w_down}; x: (..., h)."""
    dt = x.dtype
    w_gate = p["w_gate"].to(dt) if cfg.mlp_type == "swiglu" else None
    hidden = fused_mlp_hidden(x, w_gate, p["w_up"].to(dt), mlp_type=cfg.mlp_type)
    return linear(hidden, p["w_down"], impl="tuned")
