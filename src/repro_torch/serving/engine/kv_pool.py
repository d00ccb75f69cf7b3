"""KV-cache slot pool for the serving engine.

`SlotPool` — slot = one contiguous KV region.  One cache (per segment: k, v
of shape (layers, num_slots, seq_max, kv, hd)) with batch dim = `num_slots`
and depth = `seq_max`, both snapped to the bucket lattice
(`buckets.BucketPolicy`).  Requests borrow a slot for their lifetime; a
prefilled single-request cache is copied into the pool at the slot index
(`copy_`, in place — the JAX package donates the pool to the same end), and
a freed slot is simply marked length-0: the stale bytes are masked by
per-slot lengths downstream and overwritten by the next occupant's prefill.

The block-table pool with prefix caching (`BlockPool`, `PagedPool`) comes
with the prefix-cache slice.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from ...configs.base import ModelConfig
from ...models import init_caches


class SlotPool:
    """Host-side slot bookkeeping + the device cache."""

    def __init__(self, cfg: ModelConfig, num_slots: int, seq_max: int,
                 dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.seq_max = seq_max
        self.caches = init_caches(cfg, num_slots, seq_max, dtype, device)
        self.lengths = [0] * num_slots   # live kv entries per slot
        self._free: List[int] = list(range(num_slots - 1, -1, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return self.num_slots - len(self._free)

    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def can_admit(self, prompt_len: int) -> bool:
        """A free slot always fits a validated prompt: slots are full
        seq_max-deep regions, so depth was checked at validation time."""
        return bool(self._free)

    def release(self, slot: int) -> None:
        self.lengths[slot] = 0
        self._free.append(slot)

    def write(self, slot: int, new_caches: Any, length: int) -> None:
        """Install a prefilled batch-1 cache into `slot` (batch is axis 1:
        the layer axis leads)."""
        for pool_seg, new_seg in zip(self.caches, new_caches):
            for name, leaf in pool_seg.items():
                leaf[:, slot].copy_(new_seg[name][:, 0])
        self.lengths[slot] = length

    def advance(self, slot: int) -> None:
        """One decode token was written at position `lengths[slot]`."""
        self.lengths[slot] += 1
