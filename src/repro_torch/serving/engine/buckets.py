"""Tile-aligned bucket policy: the co-design advisor applied to serving.

The paper's thesis — shapes snapped to the hardware tile lattice run faster —
applied to the *dynamic* dimensions a serving engine controls:

  * the decode batch (pool slot count) is the row dim of every decode GEMM
    (b tokens x (h, ...) weights), so it is snapped to the sublane granule
    (64 rows on the H100, whatever the dtype);
  * prompt lengths are padded up to a small lattice of aligned buckets, so
    prefill only ever runs a bounded set of (1, bucket) shapes;
  * the KV pool depth (skv of every decode attention) is lane-aligned.

The lattice is shared with the tuning slice (`tuning.candidates.bucket_steps`).
Growing the decode bucket with the advisor's cost model (`grow_batch=True`,
`choose_batch_bucket`) needs `core/advisor` and comes with that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ...configs.base import ModelConfig
from ...core.hardware import Hardware, get_hardware
from ...core.quantization import round_up
from ...models.layers import compute_dtype
from ...tuning.candidates import bucket_steps, lane_granule, sublane_granule


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The engine's shape contract: every program's dynamic dims come from
    this (bounded, tile-aligned) set."""

    num_slots: int                  # decode batch bucket == KV pool slots
    prompt_buckets: Tuple[int, ...]  # ascending prompt-length buckets
    seq_max: int                    # KV pool depth (max prompt + max gen)

    def prompt_bucket(self, prompt_len: int) -> int:
        """Smallest bucket that fits `prompt_len` (prompts are right-padded
        up to it; the pad tail is masked out by per-slot lengths)."""
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt_len {prompt_len} exceeds the largest bucket "
            f"{self.prompt_buckets[-1]}")

    @property
    def num_programs(self) -> int:
        """Upper bound on distinct step shapes: one decode + one prefill per
        prompt bucket."""
        return 1 + len(self.prompt_buckets)


def _dtype_bytes(cfg: ModelConfig) -> int:
    return compute_dtype(cfg.dtype).itemsize


def make_policy(cfg: ModelConfig, hw: Optional[Hardware] = None, *,
                max_batch: int = 8, max_prompt: int = 64,
                max_seq: int = 0, grow_batch: bool = False) -> BucketPolicy:
    """Build the engine's bucket policy for `cfg` on `hw` (default: the
    H100).  max_seq is the deepest KV any request may reach (prompt +
    generation); defaults to 2 * max_prompt."""
    if grow_batch:
        raise NotImplementedError(
            "grow_batch=True asks core/advisor's cost model, which is not ported "
            "yet: it comes with the tuning slice")
    hw = hw or get_hardware()
    db = _dtype_bytes(cfg)
    sub = sublane_granule(hw, db)
    lane = lane_granule(hw)
    max_seq = max_seq or 2 * max_prompt
    top = round_up(max_prompt, sub)
    steps = [b for b in bucket_steps(max_prompt, sub) if b <= top]
    if not steps or steps[-1] < top:
        steps.append(top)  # lattice must cover the largest allowed prompt
    # the pool must fit the padded top bucket plus the generation headroom
    # the caller asked for (a prompt of exactly `top` tokens is admissible)
    gen_headroom = max(max_seq - max_prompt, 1)
    seq_max = round_up(max(max_seq, top + gen_headroom), lane)
    num_slots = round_up(max(max_batch, 1), sub)
    return BucketPolicy(num_slots=num_slots, prompt_buckets=tuple(steps),
                        seq_max=seq_max)
