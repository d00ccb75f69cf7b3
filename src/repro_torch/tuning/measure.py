"""Timing for autotuning and the tile sweeps: the one timing primitive of the
port's tuning (`tuning/search.py`, `int8_tiles.py`, `paged_tiles.py`,
`ssd_tiles.py`, `ssd_bwd_tiles.py`).

`wall_us` is the JAX package's `tuning/measure.py` API: the mean time of
`fn(*args)` in microseconds, after `warmup` calls, optionally with the
per-iteration samples.  When an argument lives on the card it times with
CUDA events on the current stream, the host queued ahead of the card by a
sleep kernel, so the events read device time, not the host's issue time;
on the CPU it times with `perf_counter` (the JAX package's `jit` argument
has no counterpart: PyTorch runs eagerly).

`time_ms` is the sweeps' timer: the mean device ms of one call, warm,
cycling through `calls` (operand sets rotated past the 50 MB L2, as the
serving path finds its weights cold), the card asleep while the host queues
them; with `host=True` also the host's mean us a call.
"""
from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple, Union

import torch

SLEEP_CYCLES = 50_000_000   # ~25 ms of device sleep: longer than queueing a timed loop


def _on_card(args) -> bool:
    return any(torch.is_tensor(a) and a.is_cuda for a in args)


def wall_us(fn: Callable, *args, iters: int = 5, warmup: int = 2,
            return_samples: bool = False) -> Union[float, Tuple[float, List[float]]]:
    """Mean wall time of `fn(*args)` in microseconds, after `warmup` calls.

    Default path: one pair of marks around the whole loop (back-to-back
    launches, the steady-state number).  With return_samples=True each
    iteration has its own marks and (mean, samples_us) is returned: a
    variance estimate for a little more overhead per iteration."""
    for _ in range(max(warmup, 0)):
        fn(*args)
    iters = max(iters, 1)
    if not _on_card(args):
        if return_samples:
            samples = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn(*args)
                samples.append((time.perf_counter() - t0) * 1e6)
            return sum(samples) / len(samples), samples
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(iters + 1 if return_samples else 2)]
    torch.cuda._sleep(SLEEP_CYCLES)
    marks[0].record()
    for i in range(iters):
        fn(*args)
        if return_samples:
            marks[i + 1].record()
    marks[-1].record()
    torch.cuda.synchronize()
    if return_samples:
        samples = [a.elapsed_time(b) * 1e3 for a, b in zip(marks, marks[1:])]
        return sum(samples) / len(samples), samples
    return marks[0].elapsed_time(marks[1]) / iters * 1e3


def time_ms(calls: Sequence[Callable[[], object]], iters: int, *,
            host: bool = False) -> Union[float, Tuple[float, float]]:
    """Mean device ms of one call, warm, cycling through `calls`; the card
    sleeps while the host queues them.  host=True: (ms, the host's mean us
    a call)."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    h0 = time.perf_counter()
    for i in range(iters):
        calls[i % len(calls)]()
    host_us = (time.perf_counter() - h0) / iters * 1e6
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / iters
    return (ms, host_us) if host else ms
