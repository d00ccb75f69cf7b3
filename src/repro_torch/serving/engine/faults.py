"""Deterministic fault injection for the serving engine (chaos harness).

A `FaultPlan` is a *seeded, replayable* schedule of failures:

  request-level corruptions (applied to the workload before submission):
    oversized_prompt    prompt longer than the pool depth -> must be rejected
    garbage_prompt      negative token ids -> must be rejected
    deadline_pressure   deadline_s = 0 -> must time out, never hold a slot

  step-indexed events (applied at decode-step boundaries via `on_step`):
    steal_blocks        BlockPool.reserve(n): simulate external memory
                        pressure by holding n physical KV blocks for
                        `hold_steps` steps (evicts warm cache, then starves
                        tail-growth -> exercises admission retry and
                        youngest-first preemption)
    cow_storm           fork every live row's block sequence (refcounts
                        jump, so each row's next append copy-on-writes) and
                        hold the forks -> block demand spikes mid-decode

The two step-level faults are *semantically transparent*: they squeeze
memory but never corrupt live KV, so every surviving request must still
produce exactly the tokens a fault-free run produces — the preemption
rollback is exact, COW preserves content, eviction only loses warmth.  Only
the request-level corruptions change outcomes, and those rids are recorded
in `affected_rids`.

`chaos_soak` runs a workload twice — fault-free baseline, then under the
plan with `BlockPool.check()` asserted after every step — and verifies:
zero exceptions escape, zero invariant violations, and for every request
NOT in `affected_rids` the chaos tokens equal the baseline tokens (prefix
thereof when the request legitimately ended early: timeout or retry budget
exhausted).  Same seed -> same plan -> same failures: a chaos run is a
regression test, not a dice roll.

A copy of the JAX package's `serving/engine/faults.py` (pure numpy): the
same seed gives the same plan, event for event, in both packages.  The
plan's block-level faults need the block-table pool (`prefix_cache=True`);
on the slot pool they expire without firing, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .request import Completion, EngineStats, Request

FAULT_KINDS = ("oversized_prompt", "garbage_prompt", "deadline_pressure",
               "steal_blocks", "cow_storm")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One step-indexed injection: at decode step `step`, do `kind`."""
    step: int
    kind: str               # "steal_blocks" | "cow_storm"
    blocks: int = 0         # steal_blocks: how many to grab


@dataclasses.dataclass
class FaultPlan:
    """A replayable fault schedule; build by hand or with `generate`."""
    seed: int = 0
    request_faults: Dict[int, str] = dataclasses.field(default_factory=dict)
    events: List[FaultEvent] = dataclasses.field(default_factory=list)
    hold_steps: int = 8     # how long stolen blocks / forks stay held

    def __post_init__(self):
        for kind in self.request_faults.values():
            assert kind in ("oversized_prompt", "garbage_prompt",
                            "deadline_pressure"), kind
        for ev in self.events:
            assert ev.kind in ("steal_blocks", "cow_storm"), ev.kind
        self._holds: List[Tuple[int, object]] = []   # (expire_step, BlockSeq)
        self._fired: Set[int] = set()

    @property
    def affected_rids(self) -> Set[int]:
        """Requests whose *outcome* the plan changes.  Step-level faults are
        excluded by design: they must not change any output."""
        return set(self.request_faults)

    @property
    def kinds_used(self) -> Set[str]:
        return (set(self.request_faults.values())
                | {ev.kind for ev in self.events})

    @classmethod
    def generate(cls, seed: int, rids: Sequence[int], *,
                 num_steps: int = 48, oversized: int = 2, garbage: int = 2,
                 deadline: int = 2, steals: int = 2, storms: int = 2,
                 steal_blocks: int = 8, hold_steps: int = 8) -> "FaultPlan":
        """Seeded plan over a workload: pick victim rids and step indices
        with an isolated PRNG, so the same (seed, rids) always yields the
        same plan."""
        rng = np.random.default_rng(seed)
        victims = rng.choice(np.asarray(sorted(rids)),
                             size=min(oversized + garbage + deadline,
                                      len(rids)),
                             replace=False).tolist()
        faults: Dict[int, str] = {}
        for kind, count in (("oversized_prompt", oversized),
                            ("garbage_prompt", garbage),
                            ("deadline_pressure", deadline)):
            for _ in range(count):
                if not victims:
                    break
                faults[int(victims.pop())] = kind
        events = []
        steps = sorted(rng.choice(np.arange(1, max(num_steps, 2)),
                                  size=min(steals + storms, num_steps - 1),
                                  replace=False).tolist())
        for i, step in enumerate(steps):
            if i < steals:
                events.append(FaultEvent(step=int(step), kind="steal_blocks",
                                         blocks=steal_blocks))
            else:
                events.append(FaultEvent(step=int(step), kind="cow_storm"))
        return cls(seed=seed, request_faults=faults, events=events,
                   hold_steps=hold_steps)

    # -- workload corruption ---------------------------------------------------

    def apply_to_requests(self, requests: Sequence[Request],
                          seq_max: int) -> List[Request]:
        """Return the workload with the planned request-level corruptions
        applied (untouched requests pass through by reference)."""
        out: List[Request] = []
        for req in requests:
            kind = self.request_faults.get(req.rid)
            if kind == "oversized_prompt":
                req = dataclasses.replace(
                    req, tokens=np.ones(2 * seq_max, np.int32))
            elif kind == "garbage_prompt":
                req = dataclasses.replace(
                    req, tokens=np.full(req.prompt_len or 1, -7, np.int32))
            elif kind == "deadline_pressure":
                req = dataclasses.replace(req, deadline_s=0.0)
            out.append(req)
        return out

    # -- engine hooks ----------------------------------------------------------

    def reset(self) -> None:
        """Called by Engine.run on entry; forget fired events and holds from
        a previous run so the same plan object replays identically."""
        self._holds = []
        self._fired = set()

    def on_step(self, engine, step: int) -> None:
        """Engine hook, called at the top of every decode step (before
        prepare_append): first expire due holds, then fire due events."""
        self._release_expired(engine, step)
        if not engine.prefix_cache:
            return              # block-level faults need the paged pool
        for i, ev in enumerate(self.events):
            if ev.step != step or i in self._fired:
                continue
            self._fired.add(i)
            if ev.kind == "steal_blocks":
                held = engine.pool.blocks.reserve(ev.blocks)
                self._holds.append((step + self.hold_steps, held))
            elif ev.kind == "cow_storm":
                # fork every live row: refcounts jump, the rows' next
                # appends all COW, and the forks pin blocks until released
                for seq in engine.pool.row_seq:
                    if seq is not None:
                        child = engine.pool.blocks.fork(seq)
                        self._holds.append((step + self.hold_steps, child))

    def _release_expired(self, engine, step: int) -> None:
        live = []
        for expire, seq in self._holds:
            if expire <= step:
                engine.pool.blocks.release(seq)
            else:
                live.append((expire, seq))
        self._holds = live

    def drain_holds(self, engine) -> bool:
        """Release every held sequence now (end of run, or the engine's
        deadlock breaker asking for capacity back).  True if anything was
        actually freed."""
        released = bool(self._holds)
        for _, seq in self._holds:
            engine.pool.blocks.release(seq)
        self._holds = []
        return released


# -- the soak driver -----------------------------------------------------------


@dataclasses.dataclass
class SoakResult:
    """Outcome of `chaos_soak`: empty `violations` == pass."""
    violations: List[str]
    baseline_stats: EngineStats
    chaos_stats: EngineStats
    chaos_completions: List[Completion]
    affected_rids: Set[int]

    @property
    def ok(self) -> bool:
        return not self.violations


def chaos_soak(engine, requests: Sequence[Request], plan: FaultPlan, *,
               shed=None) -> SoakResult:
    """Run `requests` fault-free, then under `plan` with block-pool
    invariants asserted after every step, and diff the outcomes.

    Checks (collected into `violations`, not raised, so a failing soak
    reports everything at once):
      * every submitted rid gets exactly one Completion in both runs;
      * every request NOT in plan.affected_rids is token-identical to its
        baseline when it finished ok, and a strict prefix of baseline when
        it legitimately ended early (timeout / preempted-retry-exhausted);
      * corrupted requests actually failed the way the plan intended
        (oversized/garbage -> rejected; deadline_pressure -> timeout).

    `BlockPool.check()` violations and any engine exception propagate —
    those are crashes, the exact thing the harness exists to rule out."""
    baseline, base_stats = engine.run(list(requests))
    chaos_reqs = plan.apply_to_requests(requests, engine.policy.seq_max)
    completions, stats = engine.run(chaos_reqs, shed=shed, faults=plan,
                                    check_invariants=True)
    base_by_rid = {c.rid: c for c in baseline}
    violations: List[str] = []
    want_rids = {r.rid for r in requests}
    got_rids = [c.rid for c in completions]
    if sorted(got_rids) != sorted(want_rids):
        violations.append(
            f"completion set mismatch: missing={want_rids - set(got_rids)} "
            f"extra={set(got_rids) - want_rids} dupes="
            f"{[r for r in set(got_rids) if got_rids.count(r) > 1]}")
    for c in completions:
        kind = plan.request_faults.get(c.rid)
        if kind in ("oversized_prompt", "garbage_prompt"):
            if c.finish_reason != "rejected":
                violations.append(
                    f"rid {c.rid}: {kind} finished {c.finish_reason!r}, "
                    f"expected rejected")
            continue
        if kind == "deadline_pressure":
            if c.finish_reason != "timeout":
                violations.append(
                    f"rid {c.rid}: deadline_pressure finished "
                    f"{c.finish_reason!r}, expected timeout")
            continue
        b = base_by_rid.get(c.rid)
        if b is None:
            continue            # already counted in the set mismatch
        if c.ok:
            if c.tokens != b.tokens:
                violations.append(
                    f"rid {c.rid}: tokens diverged under faults "
                    f"(chaos {c.tokens[:8]}... vs baseline "
                    f"{b.tokens[:8]}..., reason={c.finish_reason})")
        elif c.finish_reason in ("timeout", "preempted-retry-exhausted"):
            if c.tokens != b.tokens[:len(c.tokens)]:
                violations.append(
                    f"rid {c.rid}: partial tokens are not a baseline "
                    f"prefix (reason={c.finish_reason})")
        elif shed is None:
            # with no admission control, an uncorrupted request must not
            # be shed or rejected by fault side-effects alone
            violations.append(
                f"rid {c.rid}: unexpectedly finished {c.finish_reason!r} "
                f"({c.detail})")
    return SoakResult(violations=violations, baseline_stats=base_stats,
                      chaos_stats=stats, chaos_completions=completions,
                      affected_rids=plan.affected_rids)
