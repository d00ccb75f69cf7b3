"""Plain PyTorch version of the tile GEMM kernel (the CPU path, and what the
CUDA kernel is held against)."""
import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)
