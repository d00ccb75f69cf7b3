"""Unified linear-execution layer: every model GEMM routes through here.

`linear` flattens (b, s, h) activations to 2-D and selects the execution
path from `ModelConfig.linear_impl`:

  "jnp"    — `torch.matmul` (the JAX package leaves this GEMM to XLA)
  "pallas" — the hand-written CUDA tile GEMM (kernels/matmul)
  "tuned"  — the same kernel: block shapes are fixed until the tuning slice
  "fused"  — the tile GEMM everywhere, plus the fused SwiGLU/MLP kernel
             (kernels/fused_mlp) for the MLP gate/up pair
  "quantized" — raises: the int8 path comes with the low-precision slice

Forward only: the dgrad/wgrad backward comes with the training slice.
Params arrive already in the compute dtype (cast once at load), so the
per-call cast below is a no-op on the serving path.
"""
from __future__ import annotations

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


def linear(x, w, *, impl: str = "jnp"):
    """y = x @ w with dispatched execution.  x: (..., k); w: (k, n)."""
    _check_impl(impl)
    w = w.to(x.dtype)
    if impl == "jnp":
        return x @ w
    return matmul(x, w)


def fused_mlp(x, p, cfg):
    """Full MLP block through the fused hidden kernel + the tile-GEMM down
    projection.  p: {w_gate (swiglu), w_up, w_down}; x: (..., h)."""
    dt = x.dtype
    w_gate = p["w_gate"].to(dt) if cfg.mlp_type == "swiglu" else None
    hidden = fused_mlp_hidden(x, w_gate, p["w_up"].to(dt), mlp_type=cfg.mlp_type)
    return linear(hidden, p["w_down"], impl="tuned")
