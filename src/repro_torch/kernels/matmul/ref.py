"""Plain PyTorch version of the tile GEMM kernel (the CPU path, and what the
CUDA kernel is held against)."""
import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None, *, a1=None,
               b1=None) -> torch.Tensor:
    """A @ B (+ A1 @ B1) in f32, rounded once to `out_dtype` (default A's)."""
    out_dtype = out_dtype or a.dtype
    acc = a.float() @ b.float()
    if a1 is not None:
        acc = acc + a1.float() @ b1.float()
    return acc.to(out_dtype)
