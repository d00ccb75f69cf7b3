"""How far a CUDA kernel's output may lie from its plain version's.

A kernel and its plain version (`*/ref.py`) compute in f32 from the same
inputs, sum in another order, and round the f32 result to the output dtype.
Each element is held to its own bound:

    |got - want| <= 1.02 * (2 * half_ulp(dtype) * |want| + E)

The first term is the two final roundings, one on each side (half an ulp
relative: 2^-8 for bf16, 2^-24 for f32).  E bounds how far the two f32
results may lie apart: an f32 sum of n terms lies within n * u * sum|terms|
of the exact sum (u = 2^-24) on each side, and the tensor cores'
truncating accumulation may double the kernel's share, so a sum costs
3 * n * u * sum|terms|; the epilogue (activation, softmax) carries that
through by its slope.  The 2% covers second-order terms.

Each `*_tol` function takes the kernel's inputs and the plain version's
output and returns the per-element bound; `check` holds a result to it.
"""
from __future__ import annotations

import torch

from .fused_mlp.ref import ACTS, is_gated

U = 2.0 ** -24
HALF_ULP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11, torch.float32: U}
# Largest slope of the activation: silu 1.0998 (at z = 2.40), tanh-gelu
# 1.1290 (at z = 1.42); relu2's slope 2|z| is taken per element.
MAX_SLOPE = {"swiglu": 1.0999, "gelu": 1.129}


def _bound(want: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return 1.02 * (2.0 * HALF_ULP[want.dtype] * want.float().abs() + e)


def _sum_err(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bound on |kernel - plain| of the f32 product x @ w (k-term sums)."""
    return 3.0 * x.shape[-1] * U * (x.float().abs() @ w.float().abs())


def matmul_tol(a: torch.Tensor, b: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return _bound(want, _sum_err(a, b))


def fused_mlp_hidden_tol(x, w_gate, w_up, mlp_type: str, want: torch.Tensor) -> torch.Tensor:
    u = x.float() @ w_up.float()
    eu = _sum_err(x, w_up)
    act = ACTS[mlp_type]
    if is_gated(mlp_type):
        g = x.float() @ w_gate.float()
        eg = _sum_err(x, w_gate)
        # |silu(g')u' - silu(g)u| <= slope*eg*(|u| + eu) + (|silu(g)| + slope*eg)*eu
        s = MAX_SLOPE[mlp_type]
        e = s * eg * (u.abs() + 2.0 * eu) + act(g).abs() * eu
    elif mlp_type == "relu2":
        e = 2.0 * (u.abs() + eu) * eu
    else:
        e = MAX_SLOPE[mlp_type] * eu
    # the epilogue's own f32 roundings (exp or tanh, a divide, products)
    return _bound(want, e + 16.0 * U * want.float().abs())


def paged_decode_tol(q, k_pool, v_pool, slot_idx, lengths, want: torch.Tensor,
                     scale=None) -> torch.Tensor:
    """Scores: d-term sums, so each may be off by delta = 3 d u sum|q k| *
    scale; that moves every softmax weight by a factor within e^(+-2 delta).
    The softmax, its online rescaling and the weighted sum add at most
    (2 len + 64) u relative on each side.  Both act on the weighted sum of
    |v|, so E = (2 delta + (4 len + 128) u) * sum_j w_j |v_j|.  A dead row
    (length 0) must be exactly zero."""
    b, a, d = q.shape
    _, s_max, nkv, _ = k_pool.shape
    g = a // nkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = slot_idx.long()
    k = k_pool[idx].transpose(1, 2).float()  # (b, nkv, s_max, d)
    v = v_pool[idx].transpose(1, 2).float()
    qh = q.reshape(b, nkv, g, d).float()
    live = torch.arange(s_max, device=q.device)[None, :] < lengths[:, None]   # (b, s_max)
    live4 = live[:, None, None, :]
    s = torch.where(live4, torch.einsum("bhgd,bhsd->bhgs", qh, k) * scale, -1e30)
    s_abs = torch.einsum("bhgd,bhsd->bhgs", qh.abs(), k.abs()) * scale
    delta = 3.0 * d * U * torch.where(live4, s_abs, 0.0).amax(-1, keepdim=True)
    w_abs_v = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(s, dim=-1), v.abs())
    n = lengths.clamp(0, s_max).float()[:, None, None, None]
    e = (2.0 * delta + (4.0 * n + 128.0) * U) * w_abs_v
    e = torch.where((lengths > 0)[:, None, None, None], e, 0.0)
    return _bound(want, e.reshape(b, a, d))


def check(got: torch.Tensor, want: torch.Tensor, tol: torch.Tensor):
    """(ok, max |got - want|, max |got - want| / tol).  ok: every element
    finite and within its bound."""
    diff = (got.float() - want.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / tol)
    ok = bool(torch.isfinite(got).all().item()) and bool((diff <= tol).all().item())
    return ok, diff.max().item(), ratio.max().item()
