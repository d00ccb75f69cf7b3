"""Plain PyTorch versions of the SSD intra-chunk kernel and of its backward
(the CPU path, and what `csrc/ssd_chunk.cu` and `csrc/ssd_chunk_bwd.cu` are
held against).  The forward is the JAX package's oracle
(`kernels/ssd/ref.py`) line for line; the backward writes out the gradient
that JAX takes by autodiff of the model's einsums.  f32 inside, the
outputs rounded to x_dt's dtype, the causal mask inside the exponent
(masked entries get exp(-1e30) = 0, never exp of a positive difference).

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


def ssd_chunk_bwd_ref(x_dt, B, C, seg, dY, dS):
    """The gradient of `ssd_chunk_ref` written out (what `csrc/ssd_chunk_bwd.cu`
    is held against).  dY: (..., nc, Q, P) and dS: (..., nc, N, P), the
    cotangents of Y_diag and S.  Per (head, chunk), with A = (C B^T) o L,
    L_ij = exp(seg_i - seg_j) for i >= j and d_k = exp(seg_{Q-1} - seg_k):
      dX = A^T dY + d o (B dS)
      dA = mask o (dY X^T),  dC = (dA o L) B,  dB = (dA o L)^T C + (d o X) dS^T
      G = dA o A:   dseg_i += sum_j G_ij,  dseg_j -= sum_i G_ij
      e_k = d_k sum_p X_kp (B dS)_kp:  dseg_{Q-1} += sum_k e_k,  dseg_k -= e_k
    f32 inside (f64 for f64 operands); dX, dB, dC in the operands' dtypes
    (dB, dC per head: a B or C expanded over the heads gets its gradient
    in the view's shape), dseg in seg's."""
    f = torch.float64 if x_dt.dtype == torch.float64 else torch.float32
    Q = x_dt.shape[-2]
    x, Bf, Cf, dy, ds = (t.to(f) for t in (x_dt, B, C, dY, dS))
    sg = seg.to(f)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=seg.device))
    L = torch.exp(torch.where(mask, sg[..., :, None] - sg[..., None, :], NEG_INF))
    CB = torch.einsum("...qn,...kn->...qk", Cf, Bf)
    A = CB * L
    decay = torch.exp(sg[..., -1:] - sg)
    dAL = torch.where(mask, torch.einsum("...qp,...kp->...qk", dy, x), 0.0) * L
    BdS = torch.einsum("...kn,...np->...kp", Bf, ds)
    dX = torch.einsum("...qk,...qp->...kp", A, dy) + decay[..., None] * BdS
    dC = torch.einsum("...qk,...kn->...qn", dAL, Bf)
    dB = torch.einsum("...qk,...qn->...kn", dAL, Cf) \
        + torch.einsum("...kp,...np->...kn", x * decay[..., None], ds)
    G = dAL * CB
    e = decay * (x * BdS).sum(-1)
    last = torch.zeros_like(e)
    last[..., -1] = e.sum(-1)
    dseg = G.sum(-1) - G.sum(-2) - e + last
    return dX.to(x_dt.dtype), dB.to(B.dtype), dC.to(C.dtype), dseg.to(seg.dtype)
