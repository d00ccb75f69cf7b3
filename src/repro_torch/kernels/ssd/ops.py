"""Public wrapper of the SSD intra-chunk kernel (`csrc/ssd_chunk.cu`).

`ssd_chunk(x_dt, B, C, seg)` returns `(Y_diag, S)` in the JAX package's
layout — (..., nc, Q, P) and (..., nc, N, P) — and dispatches on the
device: a CPU tensor runs the plain version (`ref.ssd_chunk_ref`), a CUDA
tensor launches the kernel — or raises.  `ssd_chunk.launches` counts calls
that launched it.

The leading dims are one to three: (bh,) as in the JAX wrapper, or the
model's (b, groups, heads per group).  The kernel reads every operand in
place through its strides (the last dim contiguous), so the model passes
views: B and C `expand`ed over the heads of a group (the JAX model
materialises that repeat), x_dt a permuted view of its (b, s, heads, P)
layout.  Y comes back in x_dt's stride order (a permuted view of the same
layout, which the model folds back without a copy), S contiguous.

The JAX kernel has no backward, and neither does this one: on a CUDA
tensor that records a gradient `ssd_chunk` raises (SSM training is a later
slice); on the CPU the plain version differentiates as any PyTorch code.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_chunk_ref

MAX_N, MAX_P = 256, 128  # the largest state and head dims csrc/ssd_chunk.cu's shared memory holds


def ssd_chunk(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor, seg: torch.Tensor):
    """x_dt: (..., nc, Q, P); B, C: (..., nc, Q, N) in x_dt's dtype; seg:
    (..., nc, Q) f32, the within-chunk cumulative sum of dt * A.  Returns
    (Y_diag (..., nc, Q, P), S (..., nc, N, P)) in x_dt's dtype."""
    if _build.dispatch_device("ssd_chunk", x_dt) == "cpu":
        return ssd_chunk_ref(x_dt, B, C, seg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_dt, B, C, seg)):
        raise NotImplementedError(
            "ssd_chunk: the CUDA kernel has no backward (nor has the JAX kernel): "
            "gradients through it come with the SSM-training slice")
    return _ssd_chunk_cuda(x_dt, B, C, seg)


ssd_chunk.launches = 0


def _ssd_chunk_cuda(x, B, C, seg):
    dev = x.device
    for t in (B, C, seg):
        if t.device != dev:
            raise ValueError(f"ssd_chunk: operands on {dev} and {t.device}")
    if B.dtype != x.dtype or C.dtype != x.dtype or seg.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: x_dt, B, C in one dtype and seg float32 (got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}, {seg.dtype})")
    lead = tuple(x.shape[:-3])
    nc, Q, P = x.shape[-3:]
    N = B.shape[-1]
    if (not 1 <= len(lead) <= 3 or tuple(B.shape) != (*lead, nc, Q, N)
            or C.shape != B.shape or tuple(seg.shape) != (*lead, nc, Q)):
        raise ValueError(f"ssd_chunk: shapes x_dt {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, seg {tuple(seg.shape)}")
    if N > MAX_N or P > MAX_P:
        raise ValueError(f"ssd_chunk: the kernel takes N <= {MAX_N} and P <= {MAX_P} "
                         f"(got N {N}, P {P})")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("ssd_chunk: the last dim of x_dt, B and C must be contiguous")
    dt = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)     # x's stride order (a dense view keeps its layout)
    s = torch.empty((*lead, nc, N, P), dtype=x.dtype, device=dev)
    if min(*lead, nc, Q, P, N) == 0:
        return y.zero_(), s.zero_()      # empty sums
    lead3 = (1,) * (3 - len(lead)) + lead
    if lead3[0] * lead3[1] * lead3[2] > 65535 or nc > 65535:
        raise ValueError(f"ssd_chunk: {lead} sequence-heads and {nc} chunks exceed the grid")

    def strides(t):
        # three leading dims (size-1 ones in front), the chunk, the row
        k = len(lead)
        return (0,) * (3 - k) + tuple(t.stride()[:k + 2])

    loads = strides(x) + strides(B) + strides(C)
    vals = loads + strides(seg) + strides(y) + strides(s)
    chunk = 16 // x.element_size()
    vec = int(_build.aligned16(x, B, C) and all(v % chunk == 0 for v in loads))
    arr = (ctypes.c_longlong * len(vals))(*vals)
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_ssd_chunk(_build.ptr(x), _build.ptr(B), _build.ptr(C), _build.ptr(seg),
                                     _build.ptr(y), _build.ptr(s), arr, *lead3, nc, Q, P, N, dt,
                                     vec, _build.stream_of(dev))
    _build.check(status, "ssd_chunk")
    ssd_chunk.launches += 1
    return y, s
