"""Request / completion dataclasses and latency accounting for the engine.

A `Request` is what a client submits: prompt tokens, a generation budget,
sampling parameters, optional latency contracts (`deadline_s`,
`max_queue_wait_s`), and (for offline replay) an arrival time on the
engine's clock.  The engine hands back a `Completion` carrying the generated
tokens, a `finish_reason` naming how the request ended, and the per-request
latency trace the serving benchmarks aggregate: TTFT (arrival -> first
generated token) and the inter-token gaps.

Failure semantics: `Engine.run` never raises for a per-request problem.
Every submitted request gets exactly one `Completion`; the finish_reason
says what happened:

  stop                      eos_id generated (normal)
  length                    max_new_tokens generated (normal)
  rejected                  failed validation (oversized / garbage prompt,
                            prompt that can never fit the pool)
  shed                      dropped by admission control (queue depth,
                            predicted-TTFT SLO, max_queue_wait_s, or pool
                            exhaustion at admission after bounded retries)
  timeout                   deadline_s expired (tokens generated so far are
                            returned — a timeout after the first token is a
                            partial result, not an empty one)
  preempted-retry-exhausted preempted for KV backpressure more times than
                            the engine's retry budget; partial tokens
                            returned

`OK_REASONS` (stop, length) are the only reasons counted into TTFT /
inter-token percentiles; rejected and shed completions carry no tokens and
no first-token time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

FINISH_REASONS = ("stop", "length", "rejected", "shed", "timeout",
                  "preempted-retry-exhausted")
OK_REASONS = ("stop", "length")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy argmax; > 0 -> softmax sampling with a
    per-request PRNG stream (seeded by `seed`, folded with the step index,
    so outputs are reproducible regardless of slot placement)."""
    temperature: float = 0.0
    seed: int = 0


GREEDY = SamplingParams()


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    sampling: SamplingParams = GREEDY
    arrival_s: float = 0.0        # seconds on the engine clock (0 = at start)
    eos_id: Optional[int] = None
    # latency contracts (None = unbounded).  Both are relative to arrival_s:
    # deadline_s bounds total completion time (the engine returns whatever
    # tokens exist when it expires, finish_reason="timeout");
    # max_queue_wait_s bounds time spent queued before admission (exceeding
    # it sheds the request, finish_reason="shed").
    deadline_s: Optional[float] = None
    max_queue_wait_s: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.tokens))


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: List[int]             # generated tokens (first token included)
    arrival_s: float
    # engine-clock time of the first token; None when the request never
    # produced one (rejected / shed / timed out while queued)
    first_token_s: Optional[float]
    done_s: float

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    itl_s: List[float] = dataclasses.field(default_factory=list)
    # prompt tokens whose KV came from the prefix cache (block-table engine;
    # 0 on the slot pool / a cold prompt) — these skipped prefill entirely
    cached_tokens: int = 0
    finish_reason: str = "length"
    detail: str = ""              # human-readable cause for non-ok reasons
    preemptions: int = 0          # KV-backpressure preemptions survived

    @property
    def ok(self) -> bool:
        return self.finish_reason in OK_REASONS


def _pct(xs: Sequence[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p)) if len(xs) else 0.0


def _pct_or_none(xs: Sequence[float], p: float) -> Optional[float]:
    """Percentile of a class split that may legitimately be empty (e.g. no
    cache-hit requests in the run): None, not a fake 0.0 that would read as
    'instant TTFT' in reports and comparisons."""
    return _pct(xs, p) if len(xs) else None


@dataclasses.dataclass
class EngineStats:
    """Aggregate + percentile view over a batch of completions."""
    wall_s: float
    total_generated: int
    num_requests: int
    decode_steps: int
    prefills: int
    tok_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    itl_p50_s: float
    itl_p99_s: float
    # prefix-cache accounting (block-table engine; all zero on the slot pool)
    cache_hit_requests: int = 0   # requests with >= 1 cached prompt token
    cached_tokens: int = 0        # prompt tokens served from the cache
    prompt_tokens: int = 0
    cache_hit_rate: float = 0.0   # cached_tokens / prompt_tokens
    # TTFT split: cache-hit vs cold requests.  None when the class is empty
    # (no hits / no colds) — a 0.0 here would masquerade as a real latency
    ttft_hit_p50_s: Optional[float] = None
    ttft_cold_p50_s: Optional[float] = None
    # failure-class accounting (see module docstring): every request lands in
    # exactly one finish_reason bucket; goodput = ok / admitted, where
    # admitted excludes rejected and shed requests (they never held a slot)
    finish_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    num_ok: int = 0
    num_rejected: int = 0
    num_shed: int = 0
    num_timeout: int = 0
    num_preempt_exhausted: int = 0
    preemptions: int = 0          # preemption events (not completions)
    resumes: int = 0              # preempted requests successfully resumed
    goodput: float = 1.0          # ok / admitted (1.0 when nothing admitted)

    @classmethod
    def collect(cls, completions: Sequence[Completion], wall_s: float,
                decode_steps: int = 0, prefills: int = 0,
                preemptions: int = 0, resumes: int = 0) -> "EngineStats":
        gen = sum(len(c.tokens) for c in completions)
        # latency percentiles are over requests that actually produced
        # tokens; rejected/shed completions have no first-token time
        ttfts = [c.ttft_s for c in completions if c.ttft_s is not None]
        itls = [d for c in completions for d in c.itl_s]
        cached = sum(c.cached_tokens for c in completions)
        prompt = sum(c.prompt_len for c in completions)
        hit_ttfts = [c.ttft_s for c in completions
                     if c.cached_tokens > 0 and c.ttft_s is not None]
        cold_ttfts = [c.ttft_s for c in completions
                      if c.cached_tokens == 0 and c.ttft_s is not None]
        reasons: Dict[str, int] = {}
        for c in completions:
            reasons[c.finish_reason] = reasons.get(c.finish_reason, 0) + 1
        num_ok = sum(1 for c in completions if c.ok)
        num_rejected = reasons.get("rejected", 0)
        num_shed = reasons.get("shed", 0)
        admitted = len(completions) - num_rejected - num_shed
        return cls(
            wall_s=wall_s, total_generated=gen,
            num_requests=len(completions), decode_steps=decode_steps,
            prefills=prefills,
            tok_s=gen / wall_s if wall_s > 0 else 0.0,
            ttft_p50_s=_pct(ttfts, 50), ttft_p99_s=_pct(ttfts, 99),
            itl_p50_s=_pct(itls, 50), itl_p99_s=_pct(itls, 99),
            cache_hit_requests=len(hit_ttfts), cached_tokens=cached,
            prompt_tokens=prompt,
            cache_hit_rate=cached / prompt if prompt else 0.0,
            ttft_hit_p50_s=_pct_or_none(hit_ttfts, 50),
            ttft_cold_p50_s=_pct_or_none(cold_ttfts, 50),
            finish_reasons=dict(sorted(reasons.items())),
            num_ok=num_ok, num_rejected=num_rejected, num_shed=num_shed,
            num_timeout=reasons.get("timeout", 0),
            num_preempt_exhausted=reasons.get("preempted-retry-exhausted", 0),
            preemptions=preemptions, resumes=resumes,
            goodput=num_ok / admitted if admitted > 0 else 1.0)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)
