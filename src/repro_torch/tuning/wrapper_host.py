"""Host time per kernel-wrapper call, and the wall time of a decode step,
on the card.

Serving is host-bound (a decode step's wall is the host's time to issue
its ~170 wrapper calls), so what a wrapper costs on the host moves ITL.
This times, with the op counter off (as serving runs), each decode-path
wrapper at the serve cell's shapes: the tile GEMM (16 x 2048 @ 2048 x
2048), the fused SwiGLU hidden (16 x 2048 against 2048 x 8192 twice) and
the slot paged decode (16 rows over 16 heads / 8 KV heads of 128, 256 live
tokens a row), bf16; ROUNDS rounds of CALLS calls each, host wall clock
around the round over its calls (the device is faster than the host at
these shapes, so the launch queue never blocks).  Then internlm2-1.8b at
full width and depth (24 layers, bf16, `linear_impl="fused"`) through
`serve_step`: a prefill of 16 x 64 tokens, then DECODE_STEPS greedy decode
steps, each timed with the device synchronized after it.  It prints a
median and every round's value, per microsecond (wrappers) and
millisecond (steps); and, in a tree with the op counter, what a wrapper's
counter block costs with no counter on (`op_analysis.kernel`, NULL_CALLS
entries and exits), the host work the counter adds to every wrapper call.

    python -m repro_torch.tuning.wrapper_host      # needs the card and nvcc

Run as a file against another checkout's package,

    PYTHONPATH=<other checkout>/src python src/repro_torch/tuning/wrapper_host.py

it times that checkout's wrappers and step, so two trees can be compared
in turns on one card (parent, change, change, parent).  Host times move
with the machine's load, so compare only within one call.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import torch

import repro_torch
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention.ops import paged_decode
from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.models import init_lm
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step

ROUNDS, CALLS, WARM = 7, 500, 50
NULL_CALLS = 1_000_000
ROWS, D, F, HEADS, KV_HEADS, HEAD_DIM, LIVE = 16, 2048, 8192, 16, 8, 128, 256
PROMPT, DECODE_STEPS = 64, 32


def _rounds(call) -> list:
    """Host microseconds per call, one value a round."""
    for _ in range(WARM):
        call()
    torch.cuda.synchronize()
    out = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        out.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return out


def wrappers(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)
    x, w = randn(ROWS, D), randn(D, D, scale=D ** -0.5)
    wg, wu = randn(D, F, scale=D ** -0.5), randn(D, F, scale=D ** -0.5)
    q = randn(ROWS, HEADS, HEAD_DIM)
    kp, vp = randn(ROWS, LIVE, KV_HEADS, HEAD_DIM), randn(ROWS, LIVE, KV_HEADS, HEAD_DIM)
    slot = torch.arange(ROWS, dtype=torch.int32, device=dev)
    lengths = torch.full((ROWS,), LIVE, dtype=torch.int32, device=dev)
    calls = {"matmul": lambda: matmul(x, w),
             "fused_mlp_hidden": lambda: fused_mlp_hidden(x, wg, wu, mlp_type="swiglu"),
             "paged_decode": lambda: paged_decode(q, kp, vp, slot, lengths)}
    return {name: _rounds(call) for name, call in calls.items()}


def null_block_us():
    """Host microseconds a wrapper's `op_analysis.kernel` block takes with
    no counter on (the cost lambda built, never called); None in a tree
    without the op counter."""
    try:
        from repro_torch.core import op_analysis
    except ImportError:
        return None
    t0 = time.perf_counter()
    for _ in range(NULL_CALLS):
        with op_analysis.kernel("matmul", lambda: (0.0, 0.0)):
            pass
    return (time.perf_counter() - t0) / NULL_CALLS * 1e6


def decode_steps(dev) -> list:
    """Wall milliseconds of each greedy decode step."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), linear_impl="fused")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (ROWS, PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    prefill = make_prefill_step(cfg, PROMPT + DECODE_STEPS + 1)
    decode = make_decode_step(cfg)
    out = []
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": prompts.to(torch.int32)})
        for i in range(DECODE_STEPS):
            tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(params, tok, caches, PROMPT + i)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return out[2:]     # the first steps warm the caches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_host: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    print(f"wrapper host times ({repro_torch.__file__}); card {card}:")
    for name, us in wrappers(dev).items():
        print("  " + json.dumps({"wrapper": name, "median_host_us": statistics.median(us),
                                 "rounds_host_us": us}), flush=True)
    print("  " + json.dumps({"null_counter_block_us": null_block_us()}), flush=True)
    ms = decode_steps(dev)
    print("  " + json.dumps({"decode_step": "internlm2-1.8b 24 layers, 16 rows, fused",
                             "median_ms": statistics.median(ms), "steps_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
