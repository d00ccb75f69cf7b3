"""Synthetic serving workloads: arrival patterns x prompt-length mixes.

Shared by `launch/serve.py --engine` and `benchmarks/serve_engine.py` so the
CLI and the benchmark replay identical request streams.  Deterministic in
the seed; arrival times are expressed in units of `step_s` (a caller-side
estimate of one decode-step wall time) so the same abstract pattern stresses
the scheduler identically across machines.

Patterns:
  * burst    — everything arrives at t=0 (queueing only)
  * uniform  — constant inter-arrival gap (steady trickle)
  * bursty   — clustered arrivals: groups land together, gaps between groups
  * longtail — uniform arrivals, but prompt lengths drawn Zipf-ish so a few
               long prompts ride among many short ones (bucket stress)
"""
from __future__ import annotations

from typing import List

import numpy as np

from .request import Request, SamplingParams

PATTERNS = ("burst", "uniform", "bursty", "longtail")


def synthetic_requests(num: int, *, pattern: str = "uniform",
                       min_prompt: int = 4, max_prompt: int = 48,
                       min_new: int = 4, max_new: int = 24,
                       vocab: int = 256, step_s: float = 0.0,
                       arrival_gap_steps: float = 1.0,
                       burst_size: int = 4,
                       temperature: float = 0.0,
                       prefix_share: float = 0.0,
                       shared_prefix_len: int = 0,
                       seed: int = 0) -> List[Request]:
    """Build `num` requests following `pattern` (see module docstring).

    prefix_share: fraction of requests that open with a common system-prompt
    prefix of `shared_prefix_len` tokens (default: half of max_prompt) —
    the realistic serving mix the prefix-cache benchmarks replay.  Sharing
    requests draw their *tail* from the usual length distribution, so
    total prompt lengths still exercise the bucket lattice; the remaining
    (1 - prefix_share) of requests are fully cold.
    """
    if pattern not in PATTERNS:
        raise ValueError(f"pattern {pattern!r}; have {PATTERNS}")
    assert 0.0 <= prefix_share <= 1.0, prefix_share
    rng = np.random.RandomState(seed)
    shared_len = 0
    shared: np.ndarray = np.zeros(0, np.int32)
    if prefix_share > 0.0:
        shared_len = shared_prefix_len or max(max_prompt // 2, 1)
        assert shared_len < max_prompt, (shared_len, max_prompt)
        shared = rng.randint(0, vocab, size=shared_len).astype(np.int32)
    reqs: List[Request] = []
    for i in range(num):
        if pattern == "longtail":
            # Zipf-flavored: mostly near min_prompt, occasional long ones
            u = rng.rand()
            plen = min_prompt + int((max_prompt - min_prompt) * u ** 3)
        else:
            plen = int(rng.randint(min_prompt, max_prompt + 1))
        gen = int(rng.randint(min_new, max_new + 1))
        if pattern == "burst":
            arrival = 0.0
        elif pattern == "bursty":
            arrival = (i // burst_size) * arrival_gap_steps * burst_size * step_s
        else:  # uniform, longtail
            arrival = i * arrival_gap_steps * step_s
        shares = prefix_share > 0.0 and rng.rand() < prefix_share
        if shares:
            tail = max(plen - shared_len, 1)
            tokens = np.concatenate(
                [shared, rng.randint(0, vocab, size=tail).astype(np.int32)])
        else:
            tokens = rng.randint(0, vocab, size=plen).astype(np.int32)
        reqs.append(Request(
            rid=i, tokens=tokens, max_new_tokens=gen,
            sampling=SamplingParams(temperature=temperature, seed=1000 + i),
            arrival_s=float(arrival)))
    return reqs
