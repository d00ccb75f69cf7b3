"""Public wrapper of the slot-pool paged decode kernel (`csrc/paged_decode.cu`).

`paged_decode` dispatches on the device: a CPU tensor runs the plain version
(`ref.paged_decode_ref`), a CUDA tensor launches the kernel — or raises.
Any pool depth works: the kernel masks the tail tile, so there is no
block_kv clamp or pool pad as in the JAX wrapper, and no interpret toggle —
the tensor's device decides.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import paged_decode_ref

MAX_BLOCK_KV = 64          # kv tokens staged per tile
SMEM_BUDGET = 48 * 1024    # bytes of shared memory a tile may take


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
