"""Public wrapper of the tile GEMM kernel (`csrc/matmul.cu`).

`matmul` flattens leading dims into one m axis (as the JAX wrapper does) and
dispatches on the operand's device: a CPU tensor runs the plain version
(`ref.matmul_ref`), a CUDA tensor launches the kernel — or raises.  Unlike
the JAX wrapper it pads nothing: the kernel masks the ragged edge.

`split_k` is the host-side launch shape: it splits the k range across the
grid when the output alone has too few 64x64 tiles to fill the card; the
f32 partials are then summed by a second, small kernel.  `matmul.launches`
counts calls that launched the GEMM kernel, the reduce riding with them.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import matmul_ref

BLOCK_M = BLOCK_N = 64   # csrc/gemm_tile.cuh BM, BN
BLOCK_K = 32             # csrc/gemm_tile.cuh BK
MIN_SPLIT_STEPS = 4      # k steps per split, at least
WAVES = 2                # blocks per SM the split aims for


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(m: int, n: int, k: int, num_sms: int) -> int:
    """k range per grid z-slice (a multiple of BLOCK_K); k itself = no split."""
    tiles = _cdiv(m, BLOCK_M) * _cdiv(n, BLOCK_N)
    max_splits = max(1, k // (MIN_SPLIT_STEPS * BLOCK_K))
    splits = 1 if tiles >= num_sms else min(max_splits, _cdiv(WAVES * num_sms, tiles))
    return _cdiv(_cdiv(k, splits), BLOCK_K) * BLOCK_K


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, f32 accumulation, output in A's dtype.  A: (..., k); B: (k, n)."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    if _build.dispatch_device("matmul", a2) == "cpu":
        out = matmul_ref(a2, b)
    else:
        out = _matmul_cuda(a2, b)
    return out.reshape(*lead, b.shape[-1])


matmul.launches = 0


def _matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _build.cuda_operands("matmul", a, b)
    if b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: dtypes {a.dtype} and {b.dtype}")
    dt = _build.dtype_code(a.dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    ks = split_k(m, n, k, _build.num_sms(a.device))
    splits = _cdiv(k, ks)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    chunk = 16 // a.element_size()
    vec = int(k % chunk == 0 and n % chunk == 0 and _build.aligned16(a, b))
    lib = _build.build().lib
    with torch.cuda.device(a.device):
        status = lib.repro_matmul(_build.ptr(a), _build.ptr(b), _build.ptr(out),
                                  _build.ptr(work), m, n, k, ks, dt, vec,
                                  _build.stream_of(a.device))
    _build.check(status, "matmul")
    matmul.launches += 1
    return out
