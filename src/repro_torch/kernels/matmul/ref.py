"""Plain PyTorch version of the tile GEMM kernel (the CPU path, and what the
CUDA kernel is held against)."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None, *, a1=None,
               b1=None) -> torch.Tensor:
    """A @ B (+ A1 @ B1) in f32, rounded once to `out_dtype` (default A's)."""
    out_dtype = out_dtype or a.dtype
    acc = a.float() @ b.float()
    if a1 is not None:
        acc = acc + a1.float() @ b1.float()
    return acc.to(out_dtype)


def matmul_expert_ref(x: torch.Tensor, w: torch.Tensor, x1: torch.Tensor | None = None,
                      w1: torch.Tensor | None = None) -> torch.Tensor:
    """Per-expert X[e] @ W[e] (+ X1[e] @ W1[e]) in f32, rounded once to X's
    dtype.  x: (E, m, k); w: (E, k, n) -> (E, m, n); any strides (the
    kernel's `.mT` views among them)."""
    acc = torch.einsum("emk,ekn->emn", x.float(), w.float())
    if x1 is not None:
        acc = acc + torch.einsum("emk,ekn->emn", x1.float(), w1.float())
    return acc.to(x.dtype)
