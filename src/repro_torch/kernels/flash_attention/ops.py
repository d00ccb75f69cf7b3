"""Public wrappers of the flash-attention kernels (`csrc/flash_attention.cu`)
and the slot-pool paged decode kernel (`csrc/paged_decode.cu`).

Each dispatches on the device: a CPU tensor runs the plain version
(`ref.py`), a CUDA tensor launches the kernel — or raises.

`flash_attention` takes the JAX public layout, q (b, sq, a, d) and k, v (b,
skv, nkv, d), and the kernels read it in place through strides: no
fold/unfold copies and no padding to the block grid (the kernels mask the
ragged edges).  It is differentiable, as JAX's `_flash_core` custom VJP:
the forward saves its inputs, the output and the per-row logsumexp, and the
backward launches the dq and dk/dv kernels.  The autograd.Function is taken
only when a gradient is recorded.  `flash_attention_fwd.launches` and
`flash_attention_bwd.launches` count wrapper calls that launched their
kernels (the backward's dq and dk/dv kernels ride together).

Any pool depth works for `paged_decode`: the kernel masks the tail tile, so
there is no block_kv clamp or pool pad as in the JAX wrapper, and no
interpret toggle — the tensor's device decides.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import attention_di, flash_attention_bwd_ref, flash_attention_ref, paged_decode_ref

MAX_BLOCK_KV = 64          # kv tokens staged per tile
SMEM_BUDGET = 48 * 1024    # bytes of shared memory a paged-decode tile may take
FLASH_HEAD_DIMS = (16, 32, 64, 128)  # head dims csrc/flash_attention.cu instantiates


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q: (b, sq, a, d); k, v: (b, skv, nkv, d), a % nkv == 0.  Returns (b,
    sq, a, d).  The causal mask is top-left (key j live for query i when
    j <= i), as the Pallas kernel's."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]


class _Flash(torch.autograd.Function):
    """JAX's `_flash_core` (flash_attention/ops.py:86-118)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, *, causal: bool = True, scale=None):
    """(out (b, sq, a, d), lse (b, a, sq) f32)."""
    if _build.dispatch_device("flash_attention", q) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _flash_fwd_cuda(q, k, v, causal, scale)


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, scale=None):
    """(dq, dk, dv) from the forward's inputs, output o and lse, and the
    output cotangent do."""
    if _build.dispatch_device("flash_attention_bwd", q) == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, scale=scale)
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)


flash_attention_bwd.launches = 0


def _flash_shapes(what, q, k, v, *like_q):
    _build.cuda_operands(what, q, k, v, *like_q)
    b, sq, a, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if (k.dim() != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or a % nkv
            or any(t.shape != q.shape for t in like_q)):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
                         f"{''.join(f', {tuple(t.shape)}' for t in like_q)}")
    if any(t.dtype != q.dtype for t in (k, v, *like_q)):
        raise TypeError(f"{what}: dtypes {[str(t.dtype) for t in (q, k, v, *like_q)]}")
    if d not in FLASH_HEAD_DIMS or not _build.aligned16(q, k, v, *like_q):
        raise ValueError(f"{what}: the kernels take head dims {FLASH_HEAD_DIMS} and 16-byte "
                         f"aligned tensors (d = {d})")
    return b, sq, skv, a, nkv, d


def _flash_fwd_cuda(q, k, v, causal, scale):
    b, sq, skv, a, nkv, d = _flash_shapes("flash_attention", q, k, v)
    dt = _build.dtype_code(q.dtype)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, a, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0 or a == 0:
        return out, lse
    if skv == 0:
        return out.zero_(), lse.zero_()
    lib = _build.build().lib
    with torch.cuda.device(q.device):
        status = lib.repro_flash_fwd(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                                     _build.ptr(out), _build.ptr(lse), b, sq, skv, a, nkv, d,
                                     int(causal), float(scale), dt, _build.stream_of(q.device))
    _build.check(status, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale):
    # o enters only through di = rowsum(do * o), taken here: any strides
    b, sq, skv, a, nkv, d = _flash_shapes("flash_attention_bwd", q, k, v, do)
    if o.shape != q.shape or o.device != q.device:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} on {o.device} for q "
                         f"{tuple(q.shape)} on {q.device}")
    if lse.shape != (b, a, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"want ({b}, {a}, {sq}) float32, contiguous")
    dt = _build.dtype_code(q.dtype)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or sq == 0 or skv == 0 or a == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    di = attention_di(o, do)
    lib = _build.build().lib
    with torch.cuda.device(q.device):
        status = lib.repro_flash_bwd(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
                                     _build.ptr(lse), _build.ptr(di), _build.ptr(dq),
                                     _build.ptr(dk), _build.ptr(dv), b, sq, skv, a, nkv, d,
                                     int(causal), float(scale), dt, _build.stream_of(q.device))
    _build.check(status, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def paged_decode(q, k_pool, v_pool, slot_idx, lengths, *, scale=None):
    """Slot-gathering decode attention over a fixed KV pool.

    q: (b, a, d) — one query token per row; k_pool, v_pool: (slots, s_max,
    nkv, d); slot_idx: (b,) row->slot; lengths: (b,) live kv entries (0 =
    dead slot -> zero output).  Returns (b, a, d).
    """
    if _build.dispatch_device("paged_decode", q) == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, slot_idx, lengths, scale=scale)
    return _paged_cuda(q, k_pool, v_pool, slot_idx, lengths, scale)


paged_decode.launches = 0


def _paged_cuda(q, k_pool, v_pool, slot_idx, lengths, scale):
    slot_idx = slot_idx.to(torch.int32)
    lengths = lengths.to(torch.int32)
    _build.cuda_operands("paged_decode", q, k_pool, v_pool, slot_idx, lengths)
    b, a, d = q.shape
    slots, s_max, nkv, dk = k_pool.shape
    if (v_pool.shape != k_pool.shape or dk != d or a % nkv
            or slot_idx.shape != (b,) or lengths.shape != (b,)):
        raise ValueError(f"paged_decode: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)}, slot_idx {tuple(slot_idx.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(f"paged_decode: dtypes {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    dt = _build.dtype_code(q.dtype)
    g = a // nkv
    if g > 8 or d > 256 or d % (16 // q.element_size()) or not _build.aligned16(q, k_pool, v_pool):
        raise ValueError(f"paged_decode: the kernel takes <= 8 query heads per kv head and "
                         f"16-byte aligned rows of <= 256 elements (g={g}, d={d})")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.build().lib
    bkv = MAX_BLOCK_KV
    while bkv > 8 and lib.repro_paged_decode_smem(g, d, bkv, dt) > SMEM_BUDGET:
        bkv //= 2
    with torch.cuda.device(q.device):
        status = lib.repro_paged_decode(
            _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(slot_idx),
            _build.ptr(lengths), _build.ptr(out), b, a, nkv, d, s_max, bkv, float(scale), dt,
            _build.stream_of(q.device))
    _build.check(status, "paged_decode")
    paged_decode.launches += 1
    return out
