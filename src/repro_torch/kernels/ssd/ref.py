"""Plain PyTorch version of the SSD intra-chunk kernel (the CPU path, and
what `csrc/ssd_chunk.cu` is held against): the JAX package's oracle
(`kernels/ssd/ref.py`) line for line.  f32 inside, the outputs rounded to
x_dt's dtype, the causal mask inside the exponent (masked entries get
exp(-1e30) = 0, never exp of a positive difference).

Leading dims are free: (bh,) as in the JAX oracle, or (b, nh), or (b, g,
heads per group) views whose B / C are `expand`ed over the heads of a group.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ssd_chunk_ref(x_dt, B, C, seg):
    """x_dt: (..., nc, Q, P); B, C: (..., nc, Q, N); seg: (..., nc, Q) f32.
    Returns (Y_diag (..., nc, Q, P), S (..., nc, N, P)) in x_dt's dtype."""
    Q = x_dt.shape[-2]
    diff = seg[..., :, None] - seg[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=seg.device))
    L = torch.exp(torch.where(mask, diff, NEG_INF))
    CB = torch.einsum("...qn,...kn->...qk", C.float(), B.float())
    y = torch.einsum("...qk,...kp->...qp", CB * L, x_dt.float())
    decay = torch.exp(seg[..., -1:] - seg)
    S = torch.einsum("...qn,...qp->...np", B.float(), (x_dt * decay[..., None]).float())
    return y.to(x_dt.dtype), S.to(x_dt.dtype)
