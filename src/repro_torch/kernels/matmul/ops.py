"""Public wrapper of the tile GEMM kernel (`csrc/matmul.cu`).

`matmul` flattens leading dims into one m axis (as the JAX wrapper does) and
dispatches on the operand's device: a CPU tensor runs the plain version
(`ref.matmul_ref`), a CUDA tensor launches the kernel — or raises.  Unlike
the JAX wrapper it pads nothing: the kernel masks the ragged edge.

Each 2-D operand may be row-major or the transpose of a row-major tensor
(`w.T`, `x.T`): the kernel reads either in place, so the dgrad
`matmul(g, w.T)` and the wgrad `matmul(x.T, g)` copy nothing.  An optional
second pair (`a1`, `b1`) is summed into the same f32 accumulator:
C = A @ B + A1 @ B1 in one launch.

`split_k` is the host-side launch shape: it splits the k range across the
grid when the output alone has too few 64x64 tiles to fill the card; the
f32 partials are then summed by a second, small kernel.  `matmul.launches`
counts calls that launched the GEMM kernel, the reduce riding with them;
`matmul.by_layout` splits that count by operand layout: "nn" (forward),
"nt" (B transposed: dgrad) and "tn" (A transposed: wgrad).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import matmul_ref

BLOCK_M = BLOCK_N = 64   # csrc/gemm_tile.cuh BM, BN
BLOCK_K = 32             # csrc/gemm_tile.cuh BK
MIN_SPLIT_STEPS = 4      # k steps per split, at least
WAVES = 2                # blocks per SM the split aims for
LAYOUTS = ("nn", "nt", "tn")  # the (A, B) layouts csrc/matmul.cu instantiates


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(m: int, n: int, k: int, num_sms: int, block_k: int = BLOCK_K) -> int:
    """k range per grid z-slice (a multiple of the kernel's k step
    `block_k`); k itself = no split."""
    tiles = _cdiv(m, BLOCK_M) * _cdiv(n, BLOCK_N)
    max_splits = max(1, k // (MIN_SPLIT_STEPS * block_k))
    splits = 1 if tiles >= num_sms else min(max_splits, _cdiv(WAVES * num_sms, tiles))
    return _cdiv(_cdiv(k, splits), block_k) * block_k


def transposed(what: str, t: torch.Tensor) -> bool:
    """False for a row-major (contiguous) 2-D operand, True for the
    transpose of one; raise for any other strides."""
    if t.is_contiguous():
        return False
    if t.dim() == 2 and t.stride(0) == 1 and t.stride(1) == t.shape[0]:
        return True
    raise ValueError(f"{what}: the kernel takes row-major operands or transposed views of one "
                     f"(got strides {t.stride()} for shape {tuple(t.shape)})")


def matmul(a: torch.Tensor, b: torch.Tensor, a1: torch.Tensor | None = None,
           b1: torch.Tensor | None = None) -> torch.Tensor:
    """C = A @ B (+ A1 @ B1), f32 accumulation, output in A's dtype.
    A: (..., k); B: (k, n); A1, B1 (optional): the shapes of A and B."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    a12 = None if a1 is None else a1.reshape(-1, k)
    if _build.dispatch_device("matmul", a2) == "cpu":
        out = matmul_ref(a2, b, a1=a12, b1=b1)
    else:
        out = _matmul_cuda(a2, b, a12, b1)
    return out.reshape(*lead, b.shape[-1])


matmul.launches = 0
matmul.by_layout = dict.fromkeys(LAYOUTS, 0)


def reset_launches() -> None:
    matmul.launches = 0
    matmul.by_layout = dict.fromkeys(LAYOUTS, 0)


def _matmul_cuda(a, b, a1, b1) -> torch.Tensor:
    pair = (a, b) if a1 is None else (a, b, a1, b1)
    dev = a.device
    for t in pair:
        if t.device != dev:
            raise ValueError(f"matmul: operands on {dev} and {t.device}")
        if t.dtype != a.dtype:
            raise TypeError(f"matmul: dtypes {a.dtype} and {t.dtype}")
    if (a1 is None) != (b1 is None):
        raise ValueError("matmul: a1 and b1 come together")
    if b.dim() != 2 or a.shape[1] != b.shape[0] or (
            a1 is not None and (a1.shape != a.shape or b1.shape != b.shape)):
        raise ValueError(f"matmul: shapes {[tuple(t.shape) for t in pair]}")
    ta, tb = transposed("matmul", a), transposed("matmul", b)
    if a1 is not None and (transposed("matmul", a1), transposed("matmul", b1)) != (ta, tb):
        raise ValueError("matmul: the two pairs need the same layouts")
    layout = ("t" if ta else "n") + ("t" if tb else "n")
    if layout not in LAYOUTS or (a1 is not None and layout != "nt"):
        raise ValueError(f"matmul: layout {layout!r}{' with a second pair' if a1 is not None else ''}"
                         f" is not instantiated (csrc/matmul.cu)")
    dt = _build.dtype_code(a.dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    ks = split_k(m, n, k, _build.num_sms(dev))
    splits = _cdiv(k, ks)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    chunk = 16 // a.element_size()
    # every operand's row length (its leading dimension) a multiple of 16 bytes
    lda, ldb = (m if ta else k), (k if tb else n)
    vec = int(lda % chunk == 0 and ldb % chunk == 0 and _build.aligned16(*pair))
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_matmul(_build.ptr(a), _build.ptr(b), _build.ptr(a1), _build.ptr(b1),
                                  _build.ptr(out), _build.ptr(work), m, n, k, ks, dt, int(ta),
                                  int(tb), vec, _build.stream_of(dev))
    _build.check(status, "matmul")
    matmul.launches += 1
    matmul.by_layout[layout] += 1
    return out
