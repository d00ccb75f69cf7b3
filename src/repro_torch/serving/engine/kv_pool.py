"""KV-cache slot pool for the serving engine.

`SlotPool` — slot = one contiguous KV region.  One cache (per segment: k, v
of shape (layers, num_slots, seq_max, kv, hd)) with batch dim = `num_slots`
and depth = `seq_max`, both snapped to the bucket lattice
(`buckets.BucketPolicy`).  Requests borrow a slot for their lifetime; a
prefilled single-request cache is copied into the pool at the slot index
(`copy_`, in place — the JAX package donates the pool to the same end), and
a freed slot is simply marked length-0: the stale bytes are masked by
per-slot lengths downstream and overwritten by the next occupant's prefill.

`BlockPool` + `PagedPool` — vLLM-style block-table indirection, as the JAX
package's (`kv_pool.py:129-609`).  The KV space is a fixed pool of physical
blocks of `block_size` tokens; a request's logical KV positions [j*bs,
(j+1)*bs) live in physical block `table[j]`; full prompt blocks are
content-addressed (chained SHA-256 over the token prefix) and shared across
requests with refcounts, copy-on-write on divergence, and LRU eviction of
unreferenced cached blocks under pressure.  `BlockPool` is the host state
machine, copied one to one; `PagedPool` wraps it with the device cache and
three plain tensor functions in place of the JAX package's jitted programs:
gather (`index_select`), scatter (`index_copy_`) and the COW block copy.
With observability on, `BlockPool` counts `kv.blocks_allocated`,
`kv.evictions`, `kv.prefix_hit_blocks` and `kv.cow_copies`, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import obs
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
            for leaf, new in zip(seg_leaves(pool_seg), seg_leaves(new_seg)):
                leaf[:, slot].copy_(new[:, 0])
        self.lengths[slot] = length

    def advance(self, slot: int) -> None:
        """One decode token was written at position `lengths[slot]`."""
        self.lengths[slot] += 1


# --- block-table pool ----------------------------------------------------------------


class PoolExhausted(RuntimeError):
    """No free physical block and nothing evictable."""


@dataclasses.dataclass
class BlockSeq:
    """One sequence's view of the block pool: a table of physical block ids
    covering logical positions [0, length)."""
    sid: int
    table: List[int]
    length: int
    num_cached: int = 0    # leading tokens whose KV came from the prefix cache


@dataclasses.dataclass(frozen=True)
class CowCopy:
    """Device-side obligation emitted by the host state machine: block `src`
    was copy-on-write forked into `dst`; the caller must copy the KV bytes
    before the next write lands in `dst`."""
    src: int
    dst: int


class BlockPool:
    """Pure-host state machine for a fixed pool of physical KV blocks.

    Every block is in exactly one of three states:
      * free        — on `_free`, refcount 0, not content-addressed;
      * cached-free — refcount 0 but still holding a registered prefix
                      block (on the `_cached` LRU; evictable);
      * referenced  — refcount >= 1 (held by that many sequence tables).

    Full prompt blocks are registered under a chained content hash
    (sha256(parent_digest || chunk_bytes)), so an identical prefix reaching
    a block boundary maps to the same key regardless of what follows —
    the dedupe never has to compare KV bytes, only token ids.  Keys are
    purged when their block is evicted, so a map hit always points at a
    live, content-valid block.

    The class owns no device memory: `PagedPool` mirrors every transition
    onto the cache tensors (and honors the returned `CowCopy` obligations).
    The tests drive it through the same op sequences as the JAX package's.
    """

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 1 and block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.ref = [0] * num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._cached: "OrderedDict[int, bytes]" = OrderedDict()  # block -> key (LRU)
        self._hash: Dict[bytes, int] = {}        # chain key -> block
        self._block_key: Dict[int, bytes] = {}   # registered block -> chain key
        self.seqs: Dict[int, BlockSeq] = {}
        self._next_sid = 0
        self.evictions = 0

    # -- stats ---------------------------------------------------------------

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    @property
    def num_cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def num_referenced_blocks(self) -> int:
        return sum(1 for r in self.ref if r > 0)

    # -- content addressing ---------------------------------------------------

    @staticmethod
    def _chain_key(parent: Optional[bytes], chunk: Sequence[int]) -> bytes:
        h = hashlib.sha256(parent or b"root")
        h.update(np.asarray(chunk, np.int64).tobytes())
        return h.digest()

    # -- block alloc/free -----------------------------------------------------

    def _alloc_block(self) -> int:
        if self._free:
            if obs.enabled():
                obs.counter("kv.blocks_allocated").inc()
            return self._free.pop()
        if self._cached:  # evict the least-recently-used cached-free block
            blk, key = self._cached.popitem(last=False)
            del self._hash[key]
            del self._block_key[blk]
            self.evictions += 1
            if obs.enabled():
                obs.counter("kv.blocks_allocated").inc()
                obs.counter("kv.evictions").inc()
            return blk
        raise PoolExhausted(
            f"all {self.num_blocks} blocks referenced; nothing evictable")

    def _unref(self, blk: int) -> None:
        assert self.ref[blk] > 0, blk
        self.ref[blk] -= 1
        if self.ref[blk] == 0:
            key = self._block_key.get(blk)
            if key is not None:
                self._cached[blk] = key      # stays warm for future hits
                self._cached.move_to_end(blk)
            else:
                self._free.append(blk)

    def _take_cached(self, blk: int) -> None:
        """A cached-free block got a prefix hit: back to referenced."""
        self._cached.pop(blk, None)
        self.ref[blk] += 1

    # -- sequence lifecycle ---------------------------------------------------

    def alloc_sequence(self, tokens: Sequence[int], *,
                       prefix_cache: bool = True
                       ) -> Tuple[BlockSeq, List[CowCopy]]:
        """Build a block table covering `tokens` (a prompt).

        Walks the prefix cache chunk by chunk: every leading full block whose
        chain key is registered is shared (ref++) instead of allocated.  If
        the *whole* prompt is covered, the last matched block is immediately
        copy-on-write forked so the final prompt token can be recomputed into
        private storage (its logits are needed, and a shared block must never
        be written).  Fresh blocks cover the remainder.  Raises PoolExhausted
        (with every transition rolled back) if blocks run out.
        """
        tokens = [int(t) for t in tokens]
        n = len(tokens)
        assert n >= 1, "empty prompt"
        bs = self.block_size
        table: List[int] = []
        cows: List[CowCopy] = []
        matched = 0
        parent: Optional[bytes] = None
        if prefix_cache:
            while (matched + 1) * bs <= n:
                key = self._chain_key(parent, tokens[matched * bs:(matched + 1) * bs])
                blk = self._hash.get(key)
                if blk is None:
                    break
                if self.ref[blk] == 0:
                    self._take_cached(blk)
                else:
                    self.ref[blk] += 1
                table.append(blk)
                parent = key
                matched += 1
        num_cached = matched * bs
        if obs.enabled() and matched:
            obs.counter("kv.prefix_hit_blocks").inc(matched)

        def rollback():
            for blk in table:
                self._unref(blk)

        if num_cached == n:
            # full hit: recompute the last token into a private fork of the
            # tail block (COW — the shared original is never mutated)
            src = table[-1]
            try:
                dst = self._alloc_block()
            except PoolExhausted:
                rollback()
                raise
            self._unref(src)
            self.ref[dst] = 1
            table[-1] = dst
            cows.append(CowCopy(src=src, dst=dst))
            if obs.enabled():
                obs.counter("kv.cow_copies").inc()
            num_cached = n - 1
        else:
            # fresh private blocks for the uncached remainder of the prompt
            need = -(-n // bs) - len(table)   # ceil(n / bs) - shared
            for _ in range(need):
                try:
                    blk = self._alloc_block()
                except PoolExhausted:
                    rollback()
                    raise
                self.ref[blk] = 1
                table.append(blk)

        seq = BlockSeq(sid=self._next_sid, table=table, length=n,
                       num_cached=num_cached)
        self._next_sid += 1
        self.seqs[seq.sid] = seq
        return seq, cows

    def commit(self, seq: BlockSeq, tokens: Sequence[int]) -> None:
        """Register `seq`'s full blocks over `tokens` in the prefix cache
        (call after their KV content is final, i.e. post-prefill).  Keys that
        already map to a live block are left alone — first writer wins."""
        tokens = [int(t) for t in tokens]
        bs = self.block_size
        parent: Optional[bytes] = None
        for j in range(len(tokens) // bs):
            key = self._chain_key(parent, tokens[j * bs:(j + 1) * bs])
            blk = seq.table[j]
            if key not in self._hash and blk not in self._block_key:
                self._hash[key] = blk
                self._block_key[blk] = key
            parent = key

    def prepare_append(self, seq: BlockSeq) -> Optional[CowCopy]:
        """Make position `seq.length` writable: allocate a fresh tail block
        at a block boundary, or copy-on-write fork a shared tail.  Returns
        the copy obligation (None when the tail was already private)."""
        bs = self.block_size
        j = seq.length // bs
        if j == len(seq.table):           # boundary: open a new private block
            blk = self._alloc_block()
            self.ref[blk] = 1
            seq.table.append(blk)
            return None
        tgt = seq.table[j]
        if self.ref[tgt] > 1:             # shared tail: COW before writing
            dst = self._alloc_block()
            self._unref(tgt)
            self.ref[dst] = 1
            seq.table[j] = dst
            if obs.enabled():
                obs.counter("kv.cow_copies").inc()
            return CowCopy(src=tgt, dst=dst)
        if tgt in self._block_key:
            # private but registered: writing would corrupt the cache entry
            # for every future hit, so un-register it first
            del self._hash[self._block_key.pop(tgt)]
        return None

    def advance(self, seq: BlockSeq) -> None:
        """Commit one appended token (after prepare_append + the write)."""
        seq.length += 1
        assert seq.length <= len(seq.table) * self.block_size

    def fork(self, seq: BlockSeq) -> BlockSeq:
        """New sequence sharing every block (ref++); divergence later goes
        through prepare_append's COW path."""
        for blk in seq.table:
            if self.ref[blk] == 0:
                self._take_cached(blk)
            else:
                self.ref[blk] += 1
        child = BlockSeq(sid=self._next_sid, table=list(seq.table),
                         length=seq.length, num_cached=seq.num_cached)
        self._next_sid += 1
        self.seqs[child.sid] = child
        return child

    def release(self, seq: BlockSeq) -> None:
        """Drop the sequence; registered blocks stay warm (cached-free)."""
        for blk in seq.table:
            self._unref(blk)
        self.seqs.pop(seq.sid, None)

    def reserve(self, n: int) -> BlockSeq:
        """Grab up to `n` blocks as an opaque held sequence (chaos / test
        hook: simulates external memory pressure).  Takes free blocks first,
        then evicts cached-free ones; stops early — never raises — when the
        pool is fully referenced.  Release with `release(seq)`."""
        table: List[int] = []
        for _ in range(n):
            try:
                blk = self._alloc_block()
            except PoolExhausted:
                break
            self.ref[blk] = 1
            table.append(blk)
        seq = BlockSeq(sid=self._next_sid, table=table,
                       length=len(table) * self.block_size)
        self._next_sid += 1
        self.seqs[seq.sid] = seq
        return seq

    # -- invariants (test hook) ----------------------------------------------

    def check(self) -> None:
        """Assert the pool invariants the property suite locks down."""
        counts = [0] * self.num_blocks
        for seq in self.seqs.values():
            assert len(seq.table) == len(set(seq.table)), \
                f"seq {seq.sid}: duplicate physical block in table"
            assert seq.length <= len(seq.table) * self.block_size
            for blk in seq.table:
                counts[blk] += 1
        assert counts == self.ref, (counts, self.ref)
        assert all(r >= 0 for r in self.ref)
        free = set(self._free)
        cached = set(self._cached)
        referenced = {b for b, r in enumerate(self.ref) if r > 0}
        assert not (free & referenced), "block both free and referenced"
        assert not (cached & referenced), "block both cached-free and referenced"
        assert not (free & cached), "block both free and cached-free"
        assert len(free) + len(cached) + len(referenced) == self.num_blocks
        for key, blk in self._hash.items():
            assert self._block_key.get(blk) == key
        assert len(self._hash) == len(self._block_key)
        for blk in self._block_key:
            assert self.ref[blk] > 0 or blk in cached


# --- device wrapper -------------------------------------------------------------------


def seg_leaves(seg) -> List[torch.Tensor]:
    """One segment's cache leaves in a fixed order, nested dicts walked: a
    `pair` segment's cache is {moe_blk: {k, v}, dense_blk: {k, v}} (JAX's
    `_seg_map` tree-maps the same leaves, kv_pool.py:436-442)."""
    if isinstance(seg, dict):
        return [leaf for v in seg.values() for leaf in seg_leaves(v)]
    return [seg]


def _seg_map(fn, seg):
    """`fn` over one segment's cache leaves, keeping its nesting."""
    if isinstance(seg, dict):
        return {k: _seg_map(fn, v) for k, v in seg.items()}
    return fn(seg)


def gather_blocks(caches, table: torch.Tensor, max_blocks: int, block_size: int):
    """Contiguous (1, max_blocks * bs) cache view of one row: its table's
    blocks, in logical order (a copy, `index_select`)."""
    return [_seg_map(lambda leaf: leaf.index_select(1, table).reshape(
                leaf.shape[0], 1, max_blocks * block_size, *leaf.shape[3:]), seg)
            for seg in caches]


def scatter_blocks(caches, contig, wtable: torch.Tensor, max_blocks: int,
                   block_size: int) -> None:
    """Write the contiguous view's blocks into the pool at `wtable`, in
    place (`index_copy_`).  Entries the caller wants untouched point at the
    garbage block, which several may share: what lands there is never
    read."""
    for pool_seg, contig_seg in zip(caches, contig):
        for leaf, view in zip(seg_leaves(pool_seg), seg_leaves(contig_seg)):
            blocks = view.reshape(leaf.shape[0], max_blocks, block_size, *leaf.shape[3:])
            leaf.index_copy_(1, wtable, blocks.to(leaf.dtype))


def copy_block(caches, src: int, dst: int) -> None:
    """Block dst := block src in every leaf (a copy-on-write fork), in place."""
    for seg in caches:
        for leaf in seg_leaves(seg):
            leaf[:, dst].copy_(leaf[:, src])


class PagedPool:
    """Device-facing paged KV pool: BlockPool host bookkeeping + the block
    cache tensors + a fixed lattice of decode rows.

    The decode batch stays a bucketed constant (`num_rows`, the row count of
    every decode GEMM), but each row's KV lives in `seq_max // block_size`
    physical blocks named by a block table instead of one contiguous slot.
    Capacity is `num_rows * seq_max / block_size` blocks — the SlotPool
    byte budget — plus one reserved garbage block (device index
    `num_blocks`) that dead rows point at and nothing ever reads, so prefix
    sharing strictly adds headroom for the cached-free pool.
    """

    def __init__(self, cfg: ModelConfig, num_rows: int, seq_max: int,
                 dtype=torch.bfloat16, device=None, *, block_size: int,
                 num_blocks: Optional[int] = None):
        assert seq_max % block_size == 0, (seq_max, block_size)
        self.cfg = cfg
        self.num_rows = num_rows
        self.seq_max = seq_max
        self.block_size = block_size
        self.max_blocks = seq_max // block_size
        nb = num_blocks or num_rows * self.max_blocks
        self.blocks = BlockPool(nb, block_size)
        self.garbage = nb                      # reserved device block id
        self.device = device
        self.caches = init_caches(cfg, nb + 1, block_size, dtype, device)
        self.row_seq: List[Optional[BlockSeq]] = [None] * num_rows
        self._free_rows: List[int] = list(range(num_rows - 1, -1, -1))

    # -- SlotPool-compatible row interface (Scheduler speaks this) ------------

    @property
    def num_free(self) -> int:
        return len(self._free_rows)

    @property
    def num_active(self) -> int:
        return self.num_rows - len(self._free_rows)

    @property
    def lengths(self) -> List[int]:
        return [0 if s is None else s.length for s in self.row_seq]

    def alloc(self) -> Optional[int]:
        return self._free_rows.pop() if self._free_rows else None

    def can_admit(self, prompt_len: int) -> bool:
        """Conservative admissibility: a free row AND enough allocatable
        (free + evictable cached) blocks to cover the whole prompt cold.
        Prefix hits only reduce the real need, so True here means
        `alloc_sequence` succeeds barring a concurrent COW burst (the
        engine's bounded admission retry covers that residue)."""
        if not self._free_rows:
            return False
        need = -(-max(prompt_len, 1) // self.block_size)
        bp = self.blocks
        return bp.num_free_blocks + bp.num_cached_blocks >= need

    def release(self, row: int) -> None:
        seq = self.row_seq[row]
        if seq is not None:
            self.blocks.release(seq)
            self.row_seq[row] = None
        self._free_rows.append(row)

    def advance(self, row: int) -> None:
        self.blocks.advance(self.row_seq[row])

    # -- block-table machinery ------------------------------------------------

    def _apply_cows(self, cows: List[CowCopy]) -> None:
        for cow in cows:
            copy_block(self.caches, cow.src, cow.dst)

    def alloc_sequence(self, row: int, tokens: Sequence[int]) -> BlockSeq:
        """Bind a prompt to `row`: block table + prefix-cache hits, with any
        COW obligation applied on device.  seq.num_cached tokens of KV are
        already live; the engine prefills only the suffix."""
        seq, cows = self.blocks.alloc_sequence(tokens)
        self._apply_cows(cows)
        self.row_seq[row] = seq
        return seq

    def prepare_append(self, row: int) -> None:
        """Make the next decode write position of `row` physically writable
        (tail-block allocation / COW), mirroring copies on device."""
        cow = self.blocks.prepare_append(self.row_seq[row])
        if cow is not None:
            self._apply_cows([cow])

    def commit(self, row: int, tokens: Sequence[int]) -> None:
        self.blocks.commit(self.row_seq[row], tokens)

    def _padded_table(self, seq: Optional[BlockSeq]) -> List[int]:
        tab = [] if seq is None else seq.table
        return tab + [self.garbage] * (self.max_blocks - len(tab))

    def tables(self) -> np.ndarray:
        """(num_rows, max_blocks) int32 device block ids; dead rows and
        unallocated tail entries point at the garbage block."""
        return np.asarray([self._padded_table(s) for s in self.row_seq], np.int32)

    def _ids(self, table: List[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(table, np.int64), device=self.device)

    def gather(self, row: int):
        """Contiguous (1, seq_max) cache view of `row` (a copy)."""
        return gather_blocks(self.caches, self._ids(self._padded_table(self.row_seq[row])),
                             self.max_blocks, self.block_size)

    def scatter(self, row: int, contig_caches, start_block: int) -> None:
        """Write blocks [start_block:] of the contiguous view back into the
        row's physical blocks.  Earlier entries are shared prefix blocks and
        must never be touched: their write-table slots alias the garbage
        block instead."""
        seq = self.row_seq[row]
        wtable = self._padded_table(seq)
        for j in range(min(start_block, len(seq.table))):
            wtable[j] = self.garbage
        scatter_blocks(self.caches, contig_caches, self._ids(wtable), self.max_blocks,
                       self.block_size)
