"""Plain PyTorch version of the slot-pool paged decode kernel (the CPU path,
and what the CUDA kernel is held against)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_decode_ref(q, k_pool, v_pool, slot_idx, lengths, scale=None):
    """q: (b, a, d); k_pool, v_pool: (slots, s_max, nkv, d); slot_idx: (b,)
    row->slot gather; lengths: (b,) live kv entries per row (0 = dead slot,
    returns zeros).  GQA via a % nkv == 0.  Returns (b, a, d)."""
    b, a, d = q.shape
    _, s_max, nkv, _ = k_pool.shape
    g = a // nkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    slot_idx = slot_idx.long()
    k = k_pool[slot_idx].transpose(1, 2)  # (b, nkv, s_max, d)
    v = v_pool[slot_idx].transpose(1, 2)
    qh = q.reshape(b, nkv, g, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qh.float(), k.float()) * scale
    live = torch.arange(s_max, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, a, d).to(q.dtype)
