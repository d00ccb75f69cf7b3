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

Where a kernel rounds an intermediate to the input dtype before a further
product (flash attention's P and dS, the fused-MLP backward's dg and du,
the SSD kernel's C B^T o L and decay o X, the SSD backward's A and dA o
L: bf16 inputs to the tensor cores), the plain version keeps it in f32, and the bound adds that
rounding, half an ulp relative per element, carried through the product.

Each `*_tol` function takes the kernel's inputs and the plain version's
output and returns the per-element bound; `check` holds a result to it.
"""
from __future__ import annotations

import torch

from .flash_attention.ref import _pool_f32, _scores, attention_di, gather_block_kv
from .fused_mlp.ref import ACTS, DACTS, is_gated
from .quantized.ref import int8_product
from .ssd.ref import NEG_INF as SSD_NEG_INF

U = 2.0 ** -24
HALF_ULP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11, torch.float32: U}
# Largest slope of the activation: silu 1.0998 (at z = 2.40), tanh-gelu
# 1.1290 (at z = 1.42); relu2's slope 2|z| is taken per element.
MAX_SLOPE = {"swiglu": 1.0999, "gelu": 1.129}
# Largest |second derivative|: silu 0.5 (at z = 0), tanh-gelu 0.798 (at
# z = 0), relu2 2 (z > 0).
MAX_CURVE = {"swiglu": 0.501, "gelu": 0.8, "relu2": 2.0}


def _rounds(dtype) -> float:
    """Relative rounding of an intermediate the kernel stores in `dtype`
    before a tensor-core product (none in f32)."""
    return 0.0 if dtype == torch.float32 else HALF_ULP[dtype]


def _bound(want: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return 1.02 * (2.0 * HALF_ULP[want.dtype] * want.float().abs() + e)


def _sum_err(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bound on |kernel - plain| of the f32 product x @ w (k-term sums)."""
    return 3.0 * x.shape[-1] * U * (x.float().abs() @ w.float().abs())


def matmul_tol(a: torch.Tensor, b: torch.Tensor, want: torch.Tensor, a1=None,
               b1=None) -> torch.Tensor:
    """A @ B (+ A1 @ B1): with a second pair, one sum of 2k terms."""
    if a1 is None:
        return _bound(want, _sum_err(a, b))
    k2 = 2 * a.shape[-1]
    return _bound(want, 3.0 * k2 * U * (a.float().abs() @ b.float().abs()
                                        + a1.float().abs() @ b1.float().abs()))


def _mlp_epilogue_bound(mlp_type: str, g, eg, u, eu, want: torch.Tensor) -> torch.Tensor:
    """The fused MLP's output bound when its pre-activations g (gated only)
    and u may be off by eg and eu: carried through the activation's slope,
    plus the epilogue's own f32 roundings (exp or tanh, a divide, products)."""
    if is_gated(mlp_type):
        # |silu(g')u' - silu(g)u| <= slope*eg*(|u| + eu) + (|silu(g)| + slope*eg)*eu
        e = MAX_SLOPE[mlp_type] * eg * (u.abs() + 2.0 * eu) + ACTS[mlp_type](g).abs() * eu
    elif mlp_type == "relu2":
        e = 2.0 * (u.abs() + eu) * eu
    else:
        e = MAX_SLOPE[mlp_type] * eu
    return _bound(want, e + 16.0 * U * want.float().abs())


def fused_mlp_hidden_tol(x, w_gate, w_up, mlp_type: str, want: torch.Tensor) -> torch.Tensor:
    gated = is_gated(mlp_type)
    g = x.float() @ w_gate.float() if gated else None
    eg = _sum_err(x, w_gate) if gated else None
    return _mlp_epilogue_bound(mlp_type, g, eg, x.float() @ w_up.float(), _sum_err(x, w_up),
                               want)


def int8_matmul_tol(want: torch.Tensor) -> torch.Tensor:
    """Zero: the kernel's int32 sums are exact, as the plain version's
    float64 ones; both round the sum to f32 to nearest, take the same two
    f32 products and round once to the output type."""
    return torch.zeros_like(want, dtype=torch.float32)


def int8_fused_mlp_tol(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, mlp_type: str,
                       want: torch.Tensor) -> torch.Tensor:
    """The epilogue only: gate and up are exact sums, each de-scaled by the
    same f32 roundings on both sides (held here at 3 u relative, a rounding
    apiece), carried through the activation; there is no k-term sum error."""
    up = int8_product(x_q, wu_q) * x_scale * wu_scale
    gate = int8_product(x_q, wg_q) * x_scale * wg_scale if is_gated(mlp_type) else None
    return _mlp_epilogue_bound(mlp_type, gate, None if gate is None else 3.0 * U * gate.abs(),
                               up, 3.0 * U * up.abs(), want)


def paged_decode_tol(q, k_pool, v_pool, slot_idx, lengths, want: torch.Tensor,
                     scale=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Scores: d-term sums, so each may be off by delta = 3 d u sum|q k| *
    scale; that moves every softmax weight by a factor within e^(+-2 delta).
    The softmax, its online rescaling and the weighted sum add at most
    (2 len + 64) u relative on each side.  Both act on the weighted sum of
    |v|, so E = (2 delta + (4 len + 128) u) * sum_j w_j |v_j|.  An int8 pool
    (k_scale, v_scale) is held to the same bound on its dequantized K/V,
    plus the dequantizing product's own rounding (u relative per element of
    K and of V) on each side.  The bf16 kernel (csrc/paged_decode.cu
    `paged_decode_sm90`) also takes each weight as 2^(s scale log2(e) - m)
    by exp2f, charged to delta as the flash forward's (2 |s scale|_max + 4)
    u; rounds P (an int8 pool: P times the V scale) to bf16 before P.V,
    half an ulp relative on the weighted sum; and combines the partials of
    its splits, each rescaled once by exp2f(m_z - M) (the difference's
    rounding, |s scale|_max u, and exp2f's, products and a sum of at most 8
    terms, 32 u), relative on the weighted sum too.  A dead row (length 0)
    must be exactly zero."""
    b, a, d = q.shape
    _, s_max, nkv, _ = k_pool.shape
    g = a // nkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = slot_idx.long()
    r = 0.0 if k_scale is None else 2.0 * U
    k = _pool_f32(k_pool[idx], None if k_scale is None else k_scale[idx]).transpose(1, 2)
    v = _pool_f32(v_pool[idx], None if v_scale is None else v_scale[idx]).transpose(1, 2)
    qh = q.reshape(b, nkv, g, d).float()
    live = torch.arange(s_max, device=q.device)[None, :] < lengths[:, None]   # (b, s_max)
    live4 = live[:, None, None, :]
    s = torch.where(live4, torch.einsum("bhgd,bhsd->bhgs", qh, k) * scale, -1e30)
    s_abs = torch.einsum("bhgd,bhsd->bhgs", qh.abs(), k.abs()) * scale
    delta = (3.0 * d * U + r) * torch.where(live4, s_abs, 0.0).amax(-1, keepdim=True)
    w_abs_v = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(s, dim=-1), v.abs())
    n = lengths.clamp(0, s_max).float()[:, None, None, None]
    rel = (4.0 * n + 128.0) * U + r
    if q.dtype != torch.float32:
        s_max_abs = torch.where(live4, s.abs(), 0.0).amax(-1, keepdim=True)
        delta = delta + (2.0 * s_max_abs + 4.0) * U
        rel = rel + _rounds(q.dtype) + (s_max_abs + 32.0) * U
    e = (2.0 * delta + rel) * w_abs_v
    e = torch.where((lengths > 0)[:, None, None, None], e, 0.0)
    return _bound(want, e.reshape(b, a, d))


def paged_decode_blocktable_tol(q, k_blocks, v_blocks, block_tables, lengths,
                                want: torch.Tensor, scale=None, k_scale=None,
                                v_scale=None) -> torch.Tensor:
    """The slot pool's bound on each row's blocks gathered into logical
    order: the kernel reads the same elements through the table."""
    b = q.shape[0]
    ks = None if k_scale is None else gather_block_kv(k_scale, block_tables)
    vs = None if v_scale is None else gather_block_kv(v_scale, block_tables)
    return paged_decode_tol(q, gather_block_kv(k_blocks, block_tables),
                            gather_block_kv(v_blocks, block_tables),
                            torch.arange(b, device=q.device), lengths, want, scale=scale,
                            k_scale=ks, v_scale=vs)


def fused_mlp_bwd_tol(x, w_gate, w_up, dh, mlp_type: str, want):
    """Bounds on (dx, dwg, dwu) of the fused-MLP backward; `want` is the
    plain version's (dx, dwg, dwu).  g and u carry their sum errors eg, eu
    into dg = dh u act'(g) and du = dh act(g) (plain: du = dh act'(u))
    through the slopes; the kernel then rounds dg and du to the input dtype
    and the dx / dW products sum 2f (dx) or m (dW) terms.  With a leading
    expert axis on every operand, each expert's bounds (the batched
    backward)."""
    xf, dhf, wu = x.float(), dh.float().abs(), w_up.float()
    r = _rounds(x.dtype)
    u = xf @ wu
    eu = _sum_err(x, w_up)
    curve = MAX_CURVE[mlp_type]
    if is_gated(mlp_type):
        wg = w_gate.float()
        g = xf @ wg
        eg = _sum_err(x, w_gate)
        dg = dhf * u.abs() * DACTS[mlp_type](g).abs()
        du = dhf * ACTS[mlp_type](g).abs()
        e_dg = dhf * (eu * DACTS[mlp_type](g).abs() + (u.abs() + eu) * curve * eg) \
            + (r + 16.0 * U) * dg
        e_du = dhf * MAX_SLOPE[mlp_type] * eg + (r + 16.0 * U) * du
    else:
        du = dhf * DACTS[mlp_type](u).abs()
        e_du = dhf * curve * eu + (r + 16.0 * U) * du
    f = w_up.shape[-1]
    e_dx = e_du @ wu.abs().mT + 3.0 * 2 * f * U * (du @ wu.abs().mT)
    e_dwu = xf.abs().mT @ e_du + 3.0 * x.shape[-2] * U * (xf.abs().mT @ du)
    dx, dwg, dwu = want
    if not is_gated(mlp_type):
        return _bound(dx, e_dx), None, _bound(dwu, e_dwu)
    e_dx = e_dx + e_dg @ wg.abs().mT + 3.0 * 2 * f * U * (dg @ wg.abs().mT)
    e_dwg = xf.abs().mT @ e_dg + 3.0 * x.shape[-2] * U * (xf.abs().mT @ dg)
    return _bound(dx, e_dx), _bound(dwg, e_dwg), _bound(dwu, e_dwu)


def _flash_parts(q, k, causal, scale):
    """Scores (b, nkv, g, sq, skv), live mask, per-row score error delta
    (d-term sums: 3 d u sum|q k| scale, the row's largest) and the number
    of live keys per row."""
    b, sq, a, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s, mask = _scores(q, k, causal, scale)
    qa = q.float().abs().reshape(b, sq, nkv, a // nkv, d)
    s_abs = torch.einsum("bqkgd,bskd->bkgqs", qa, k.float().abs()) * scale
    if mask is not None:
        s_abs = torch.where(mask, s_abs, 0.0)
        n = mask.sum(-1).float()[:, None]                  # (sq, 1)
    else:
        n = torch.full((sq, 1), float(skv), device=q.device)
    delta = 3.0 * d * U * s_abs.amax(-1, keepdim=True)
    return s, mask, delta, n, scale


def flash_attention_tol(q, k, v, want, causal: bool = True, scale=None):
    """Bounds on (out, lse) of the flash forward; `want` is the plain
    version's (out, lse).  A score error delta moves every softmax weight by
    a factor within e^(+-2 delta); the softmax and its online rescaling add
    (4 n + 128) u relative; the kernel rounds P to the input dtype before
    P.V.  All act on sum_j w_j |v_j|.  lse = m + log(l) is off by delta and
    (2 n + 64) u relative.  The bf16 kernel takes each weight as 2^(s scale
    log2(e) - m) by exp2f (2 ulp): the prescale's and the FFMA's roundings
    move a weight by at most 2 u |s scale|_max relative each and exp2f by
    4 u, charged to delta as (2 |s scale|_max + 4) u (the f32 kernel takes
    expf)."""
    out, lse = want
    b, sq, a, d = q.shape
    s, mask, delta, n, _ = _flash_parts(q, k, causal, scale)
    if q.dtype != torch.float32:
        live = s if mask is None else torch.where(mask, s, 0.0)
        delta = delta + (2.0 * live.abs().amax(-1, keepdim=True) + 4.0) * U
    w = torch.softmax(s, dim=-1)
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    w_abs_v = torch.einsum("bkgqs,bskd->bqkgd", w, v.float().abs()).reshape(b, sq, a, d)
    rel = (2.0 * delta + (4.0 * n + 128.0) * U).squeeze(-1)  # (b, nkv, g, sq)
    rel = rel.permute(0, 3, 1, 2).reshape(b, sq, a, 1) + _rounds(q.dtype)
    e_lse = delta.squeeze(-1).reshape(b, a, sq) \
        + ((2.0 * n + 64.0) * U).reshape(1, 1, sq) * (1.0 + lse.abs())
    return _bound(out, rel * w_abs_v), 1.02 * e_lse


def flash_attention_bwd_tol(q, k, v, o, lse, do, want, causal: bool = True, scale=None):
    """Bounds on (dq, dk, dv) of the flash backward; `want` is the plain
    version's.  p = exp(s scale - lse) is off by a factor within
    e^(+-2 delta); dP = do.v^T by 3 d u sum|do v|; dS = p (dP - di) scale
    carries both, and the kernel rounds P (for dv) and dS (for dq, dk) to
    the input dtype.  di = rowsum(do o) sums d terms in the kernels'
    pre-pass, in another order than the plain version's: 3 d u sum|do o|
    more on dP - di.  The final products sum skv (dq) or g sq (dk, dv)
    terms."""
    b, sq, a, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = a // nkv
    s, mask, delta, _, scale = _flash_parts(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, nkv, g, sq)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    r = _rounds(q.dtype)
    doh = do.float().reshape(b, sq, nkv, g, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", doh, v.float())
    e_dp = 3.0 * d * U * torch.einsum("bqkgd,bskd->bkgqs", doh.abs(), v.float().abs())
    di = attention_di(o, do).reshape(b, nkv, g, sq)[..., None]
    e_di = 3.0 * d * U * attention_di(o.abs(), do.abs()).reshape(b, nkv, g, sq)[..., None]
    ds = (p * (dp - di) * scale).abs()
    e_ds = p * (2.2 * delta * (dp - di).abs() + e_dp + e_di) * scale + (r + 8.0 * U) * ds
    e_p = p * (2.2 * delta + r + 8.0 * U)
    qa = q.float().abs().reshape(b, sq, nkv, g, d)
    ka = k.float().abs()
    e_dq = (torch.einsum("bkgqs,bskd->bqkgd", e_ds, ka)
            + 3.0 * skv * U * torch.einsum("bkgqs,bskd->bqkgd", ds, ka)).reshape(b, sq, a, d)
    e_dk = (torch.einsum("bkgqs,bqkgd->bskd", e_ds, qa)
            + 3.0 * g * sq * U * torch.einsum("bkgqs,bqkgd->bskd", ds, qa))
    doa = doh.abs()
    e_dv = (torch.einsum("bkgqs,bqkgd->bskd", e_p, doa)
            + 3.0 * g * sq * U * torch.einsum("bkgqs,bqkgd->bskd", p, doa))
    dq, dk, dv = want
    return _bound(dq, e_dq), _bound(dk, e_dk), _bound(dv, e_dv)


def blocked_sdpa_tol(q, k, v, want, causal: bool, q_pos=None, kv_len=None,
                     block_kv: int = 1024):
    """Bound on blocked attention (`models/blocked_attention.py`, plain
    PyTorch) against the naive score/AOV path (`models/attention._sdpa`)
    on the same inputs, `want` the naive path's output.  Both run in the
    input dtype with f32 softmax statistics.  A score moves by the
    roundings of q / sqrt(d) and of sqrt(d) itself (blocked), of the score
    product's output (both sides): 4 half-ulps of sum|q k| scale, plus the
    d-term f32 sums; a score error delta moves each weight by a factor
    within e^(+-2 delta).  Each side rounds the weights to the input dtype
    before P.V (a half-ulp each) and the softmax sums n terms ((4 n + 128)
    u).  The blocked accumulator stays in the input dtype: per block it
    rounds the block's P.V, alpha, acc * alpha and the sum (4 half-ulps of
    at most sum_j w_j |v_j|), and the final 1 / l once more; the P.V
    products sum skv terms in f32 on each side.  All act on sum_j w_j
    |v_j|; the naive product's own rounding is `_bound`'s."""
    b, sq, a, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = a // nkv
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qh = q.float().reshape(b, sq, nkv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) * scale
    s_abs = torch.einsum("bqkgd,bskd->bkgqs", qh.abs(), k.float().abs()) * scale
    pos = torch.arange(skv, device=dev)
    live = (pos < (skv if kv_len is None else kv_len))[None, :].expand(sq, skv)
    if causal:
        qp = torch.arange(sq, device=dev) if q_pos is None else q_pos
        live = live & (pos[None, :] <= qp[:, None])
    s = torch.where(live, s, float("-inf"))
    s_abs = torch.where(live, s_abs, 0.0)
    n = live.sum(-1).float()[:, None]                       # (sq, 1)
    h = _rounds(q.dtype)
    delta = (4.0 * h + 6.0 * d * U) * s_abs.amax(-1, keepdim=True)
    w = torch.nan_to_num(torch.softmax(s, dim=-1))
    w_abs_v = torch.einsum("bkgqs,bskd->bqkgd", w, v.float().abs()).reshape(b, sq, a, d)
    nblk = -(-skv // min(block_kv, skv))
    rel = (torch.expm1(2.0 * delta) + (4.0 * n + 128.0) * U).squeeze(-1)   # (b, nkv, g, sq)
    # + the P.V products' skv-term sums on both sides
    rel = rel.permute(0, 3, 1, 2).reshape(b, sq, a, 1) + (2.0 + 4.0 * nblk + 1.0) * h \
        + 6.0 * skv * U
    return _bound(want, rel * w_abs_v)


def ssd_chunk_tol(x_dt, B, C, seg, want):
    """Bounds on (Y_diag, S) of the SSD chunk kernel; `want` is the plain
    version's.  CB = C B^T sums N terms (off by e_cb = 3 N u sum|C B|), the
    plain version's decay L = exp(seg_i - seg_j) may be off by 4 u relative
    (an exp of a few ulps), and CB o L rounds once more on each side; in
    bf16 the kernel rounds CB o L to bf16 before the product with X (half
    an ulp relative) and takes L as 2^(seg_i log2(e) - seg_j log2(e)): the
    prescale and the FFMA put (|seg_i| + 2 |seg_i - seg_j|) u log2(e) on the
    exponent, so (|seg_i| + 2 |seg_i - seg_j| + 4) u relative on L with
    exp2's 2 ulps (f32 keeps expf: 4 u).  Y sums Q terms of (CB o L) X:
    E_Y = sum_k (e_cb L + (r + (3 Q + 10) u + e_L) |CB| L) |x|.  S sums Q
    terms of B (decay o X), decay o X rounded to bf16 in bf16: E_S = (r + (3
    Q + 10) u) sum_q |B| decay |x|."""
    y, s = want
    Q, N = x_dt.shape[-2], B.shape[-1]
    r = _rounds(x_dt.dtype)
    xa, Bf, Cf = x_dt.float().abs(), B.float(), C.float()
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=seg.device))
    diff = seg[..., :, None] - seg[..., None, :]
    L = torch.exp(torch.where(mask, diff, SSD_NEG_INF))
    cb = torch.einsum("...qn,...kn->...qk", Cf, Bf).abs()
    e_cb = 3.0 * N * U * torch.einsum("...qn,...kn->...qk", Cf.abs(), Bf.abs())
    rel = r + (3.0 * Q + 10.0) * U
    if x_dt.dtype == torch.bfloat16:   # the kernel's exp2 with a log2(e) prescale
        rel = rel + (seg.abs()[..., :, None] + 2.0 * diff.abs()) * U
    e_y = torch.einsum("...qk,...kp->...qp", (e_cb + rel * cb) * L, xa)
    decay = torch.exp(seg[..., -1:] - seg)
    e_s = (r + (3.0 * Q + 10.0) * U) * torch.einsum("...qn,...qp->...np", Bf.abs(),
                                                      xa * decay[..., None])
    return _bound(y, e_y), _bound(s, e_s)


def ssd_chunk_bwd_tol(x_dt, B, C, seg, dY, dS, want):
    """Bounds on (dX, dB, dC, dseg) of the SSD backward kernels
    (csrc/ssd_chunk_bwd.cu); `want` is the plain version's
    (`ssd_chunk_bwd_ref`).  Both compute in f32 from the same operands, sum
    in another order and round the outputs.  Per (head, chunk), with A = CB
    o L, dAL = mask o (dY X^T) o L:
      CB = C B^T sums N terms: e_cb = 3 N u |C||B|^T; dY X^T sums P terms:
      e_da = 3 P u |dY||X|^T; B dS sums N terms: e_bds = 3 N u |B||dS|;
      L and the decay d are exps, 4 u on either side, and each product
      rounds once more on either side: 10 u relative on A, dAL and d o .;
      in bf16 the kernel takes L as 2^(seg_i log2(e) - seg_j log2(e)), whose
      prescale and FFMA put (|seg_i| + 2 |seg_i - seg_j|) u more on L (as
      `ssd_chunk_tol`), and rounds A (for dX) and dAL (for dC and dB) to
      bf16 before the tensor cores (half an ulp relative, r); d o (X dS^T)
      and d o (B dS) stay f32;
      dX sums Q query terms and the state term (n = Q + 1), dC Q key terms,
      dB Q query terms and P state terms (n = Q + P), each 3 n u over the
      sum of |terms| on top of the terms' own errors;
      dseg: G = dAL o CB, formed from the f32 tiles, carries e_dal |CB| +
      |dAL| e_cb + u |G|; its row and column sums (Q terms each) and e_k =
      d_k sum_p X (B dS) (P terms) are charged over the sums of |G| and |e|
      (not |dseg|, which cancels), and the last row over every row's e."""
    dX, dB, dC, dseg = want
    Q, N, P = x_dt.shape[-2], B.shape[-1], x_dt.shape[-1]
    r = _rounds(x_dt.dtype)
    xa, Ba, Ca, dya, dsa = (t.float().abs() for t in (x_dt, B, C, dY, dS))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=seg.device))
    diff = seg[..., :, None] - seg[..., None, :]
    L = torch.exp(torch.where(mask, diff, SSD_NEG_INF))
    cb = torch.einsum("...qn,...kn->...qk", C.float(), B.float()).abs()
    e_cb = 3.0 * N * U * torch.einsum("...qn,...kn->...qk", Ca, Ba)
    da = torch.where(mask, torch.einsum("...qp,...kp->...qk", dY.float(), x_dt.float()), 0.0).abs()
    e_da = 3.0 * P * U * torch.einsum("...qp,...kp->...qk", dya, xa)
    rel_l = 10.0 * U
    if x_dt.dtype == torch.bfloat16:   # the kernels' exp2 with a log2(e) prescale
        rel_l = rel_l + (seg.abs()[..., :, None] + 2.0 * diff.abs()) * U
    a, dal = cb * L, da * L
    e_a, e_dal = (e_cb + rel_l * cb) * L, (e_da + rel_l * da) * L
    decay = torch.exp(seg[..., -1:] - seg)
    bds = torch.einsum("...kn,...np->...kp", Ba, dsa)
    e_bds = 3.0 * N * U * bds
    n_x, n_b = Q + 1, Q + P
    e_dx = torch.einsum("...qk,...qp->...kp", e_a + (3.0 * n_x * U + r) * a, dya) \
        + decay[..., None] * (e_bds + (3.0 * n_x + 10.0) * U * bds)
    e_dc = torch.einsum("...qk,...kn->...qn", e_dal + (3.0 * Q * U + r) * dal, Ba)
    e_db = torch.einsum("...qk,...qn->...kn", e_dal + (3.0 * n_b * U + r) * dal, Ca) \
        + (3.0 * n_b + 10.0) * U * torch.einsum("...kp,...np->...kn", xa * decay[..., None], dsa)
    g = dal * cb
    e_g = e_dal * cb + dal * e_cb + (1.0 + 3.0 * Q) * U * g
    e_abs = decay * (xa * bds).sum(-1)
    e_e = decay * (xa * (e_bds + (3.0 * P + 10.0) * U * bds)).sum(-1)
    e_seg = e_g.sum(-1) + e_g.sum(-2) + e_e + 6.0 * U * (g.sum(-1) + g.sum(-2) + e_abs)
    last = torch.zeros_like(e_seg)
    last[..., -1] = (e_e + 3.0 * (Q + 1) * U * e_abs).sum(-1)
    return (_bound(dX, e_dx), _bound(dB, e_db), _bound(dC, e_dc),
            _bound(dseg, e_seg + last))


def check(got: torch.Tensor, want: torch.Tensor, tol: torch.Tensor):
    """(ok, max |got - want|, max |got - want| / tol).  ok: every element
    finite and within its bound."""
    diff = (got.float() - want.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / tol)
    ok = bool(torch.isfinite(got).all().item()) and bool((diff <= tol).all().item())
    return ok, diff.max().item(), ratio.max().item()
