"""Admission queue + slot scheduler for the continuous-batching engine.

Two policies share the machinery:

  * "continuous" — the engine's normal mode: any free slot is refilled the
    moment a request has arrived, so prefill and decode interleave and a
    finished sequence's slot goes straight back to work;
  * "static" — the baseline the benchmarks compare against: a new batch is
    admitted only once the pool has fully drained, i.e. classic static
    batching where early finishers leave dead slots until the whole batch
    completes (exactly the `launch/serve.py` greedy-loop behavior, expressed
    through the same engine so the comparison isolates the scheduling
    policy).

Admission control (`ShedPolicy`) rides on top of both: before a ready
request is admitted, the scheduler can *shed* it — drop it with a
finish_reason instead of letting the engine melt down under overload:

  * per-request contracts: `Request.max_queue_wait_s` (shed once queueing
    exceeds it) and `Request.deadline_s` (time out once even an immediate
    admission could no longer deliver the first token in time, using the
    advisor-calibrated decode-step time as the TTFT predictor);
  * policy-level bounds: `max_queue_depth` (newest ready requests beyond
    the bound are shed — FIFO seniority is preserved) and `ttft_slo_s`
    (shed when predicted TTFT = queue wait so far + one calibrated step
    would already violate the SLO).

Admission itself scans a bounded FIFO *lookahead window* (default 4): a
head request the pool cannot currently fit (e.g. a block-pool-filling long
prompt) no longer head-of-line-blocks admissible requests right behind it.
Within the window the earliest admissible request wins, so FIFO order is
preserved among requests that fit.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

from .kv_pool import SlotPool
from .request import Request


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Admission-control knobs.  The default policy sheds nothing (all
    thresholds None) but still applies the lookahead window.

    step_s is the calibrated pool decode-step time
    (`Engine.calibrate_step_s`) used as the one-step TTFT predictor; 0.0
    (uncalibrated) degrades every prediction to "queue wait so far".
    """
    max_queue_depth: Optional[int] = None   # ready requests beyond: shed
    ttft_slo_s: Optional[float] = None      # predicted TTFT beyond: shed
    step_s: float = 0.0                     # calibrated decode-step seconds
    lookahead: int = 4                      # FIFO admission window


@dataclasses.dataclass(frozen=True)
class Shed:
    """A request dropped by admission control, with the finish_reason the
    engine should stamp on its Completion."""
    req: Request
    reason: str                             # "shed" | "timeout"
    detail: str


class RequestQueue:
    """Arrival-ordered queue; `pop_ready` respects the engine clock."""

    def __init__(self, requests=()):
        self._q: List[Request] = sorted(
            requests, key=lambda r: (r.arrival_s, r.rid))

    def push(self, req: Request) -> None:
        # keep the arrival-order invariant pop_ready/next_arrival_s rely on
        bisect.insort(self._q, req, key=lambda r: (r.arrival_s, r.rid))

    def __len__(self) -> int:
        return len(self._q)

    def next_arrival_s(self) -> Optional[float]:
        return self._q[0].arrival_s if self._q else None

    def ready_count(self, now_s: float) -> int:
        """Requests whose arrival time has passed (the live queue depth —
        future replay arrivals don't count as waiting)."""
        return bisect.bisect_right(self._q, now_s, key=lambda r: r.arrival_s)

    def peek(self, i: int) -> Request:
        return self._q[i]

    def pop_index(self, i: int) -> Request:
        return self._q.pop(i)

    def pop_ready(self, now_s: float) -> Optional[Request]:
        if self._q and self._q[0].arrival_s <= now_s:
            return self._q.pop(0)
        return None

    def pop_newest_ready(self, now_s: float) -> Optional[Request]:
        """Drop the most recently arrived ready request (depth shedding
        keeps FIFO seniority: the newest arrival is the one to go)."""
        n = self.ready_count(now_s)
        return self._q.pop(n - 1) if n else None


class Scheduler:
    """Decides which queued requests enter which slots at each engine tick,
    and which get shed by admission control."""

    def __init__(self, queue: RequestQueue, pool: SlotPool,
                 policy: str = "continuous",
                 shed: Optional[ShedPolicy] = None):
        assert policy in ("continuous", "static"), policy
        self.queue = queue
        self.pool = pool
        self.policy = policy
        self.shed = shed or ShedPolicy()

    # -- admission-control verdicts -------------------------------------------

    def _verdict(self, req: Request, now_s: float
                 ) -> Optional[Tuple[str, str]]:
        """(finish_reason, detail) to drop `req` right now, or None to keep
        it.  Predicted TTFT = time already queued + one calibrated decode
        step (the earliest a first token could land if admitted this tick).
        """
        waited = now_s - req.arrival_s
        predicted_ttft = waited + self.shed.step_s
        if req.deadline_s is not None and predicted_ttft > req.deadline_s:
            return ("timeout",
                    f"deadline {req.deadline_s:.3f}s unreachable: predicted "
                    f"TTFT {predicted_ttft:.3f}s")
        if (req.max_queue_wait_s is not None
                and waited > req.max_queue_wait_s):
            return ("shed",
                    f"queued {waited:.3f}s > max_queue_wait_s "
                    f"{req.max_queue_wait_s:.3f}s")
        if (self.shed.ttft_slo_s is not None
                and predicted_ttft > self.shed.ttft_slo_s):
            return ("shed",
                    f"predicted TTFT {predicted_ttft:.3f}s > SLO "
                    f"{self.shed.ttft_slo_s:.3f}s")
        return None

    # -- the per-tick decision ------------------------------------------------

    def admissions(self, now_s: float
                   ) -> Tuple[List[Tuple[Request, int]], List[Shed]]:
        """((request, slot) pairs to prefill right now, requests shed)."""
        if self.policy == "static" and self.pool.num_active:
            return [], []
        sheds: List[Shed] = []
        # 1. expire: drop ready requests whose contract is already blown —
        #    before admission, so a doomed head never eats a slot
        i = 0
        while i < self.queue.ready_count(now_s):
            verdict = self._verdict(self.queue.peek(i), now_s)
            if verdict is None:
                i += 1
            else:
                sheds.append(Shed(self.queue.pop_index(i), *verdict))
        # 2. admit: earliest admissible request within the lookahead window
        #    (FIFO among those that fit; a too-big head doesn't block)
        out: List[Tuple[Request, int]] = []
        while self.pool.num_free:
            window = min(max(self.shed.lookahead, 1),
                         self.queue.ready_count(now_s))
            picked = None
            for j in range(window):
                if self.pool.can_admit(self.queue.peek(j).prompt_len):
                    picked = self.queue.pop_index(j)
                    break
            if picked is None:
                break
            out.append((picked, self.pool.alloc()))
        # 3. depth-shed: whatever is still ready beyond the bound goes,
        #    newest first (admission already took its share, so this only
        #    drops requests that would wait at least another tick)
        if self.shed.max_queue_depth is not None:
            while self.queue.ready_count(now_s) > self.shed.max_queue_depth:
                req = self.queue.pop_newest_ready(now_s)
                sheds.append(Shed(
                    req, "shed",
                    f"queue depth > {self.shed.max_queue_depth}"))
        return out, sheds

    @property
    def drained(self) -> bool:
        return not len(self.queue) and not self.pool.num_active
