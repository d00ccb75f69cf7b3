"""Serving entry points of the port: static batch (baseline) and the
continuous-batching engine (`repro_torch.serving.engine`).

Static batch:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --batch 4 --prompt-len 32 --gen 16

Continuous-batching engine (`--paged`: decode attention through the paged
decode kernel; `--prefix-cache`: the block-table KV pool with prefix
sharing; `--kv-dtype int8`: an int8 KV pool with f32 scales;
`--grow-batch`: the advisor may double the slot bucket):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --engine --paged --requests 12 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --engine --prefix-cache --kv-dtype int8 --device cpu

The MoE family: deepseek-v3 (MLA, 256 experts top-8, MTP) through the
static loop (the engines refuse MLA, as JAX's do), llama4-maverick (GQA,
128 experts top-1, MoE every 2nd layer) through either:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-maverick-400b-a17b --smoke --engine --paged --device cpu

On the card each runs at the depth its config gives (the full configs
hold 61 and 48 layers, beyond one card).

Runs on the CUDA card; `--device cpu` runs the plain PyTorch versions on
the host instead (there is no silent fallback).  Weights are random, drawn
from `--seed` on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.registry import get_config, get_smoke_config
from ..data.pipeline import synthetic_tokens
from ..models import init_lm
from ..serving.engine.engine import resolve_device
from ..serving.serve_step import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def run_static(cfg, params, args, device: torch.device) -> None:
    """Static-batch greedy loop: slots idle once a sequence finishes — the
    baseline the engine improves on."""
    s_max = args.prompt_len + args.gen
    prompts = torch.as_tensor(synthetic_tokens(args.seed, 0, args.batch,
                                               args.prompt_len, cfg.vocab_size), device=device)
    prefill = make_prefill_step(cfg, s_max)
    decode = make_decode_step(cfg)

    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts})
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    idx = args.prompt_len
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, caches = decode(params, tok, caches, idx)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
        idx += 1
    toks = torch.cat(out, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t0

    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill*1e3:.1f} ms")
    print(f"decode:  {args.gen - 1} steps x batch {args.batch} in "
          f"{t_decode*1e3:.1f} ms "
          f"({(args.gen-1)*args.batch/max(t_decode,1e-9):,.0f} tok/s)")
    print("sample:", np.asarray(toks[0, :16]))


def parse_shed_policy(spec: str, step_s: float):
    """`--shed-policy depth=16,slo=0.25,lookahead=4` -> ShedPolicy.
    `step_s` is the calibrated decode-step time (the TTFT predictor)."""
    from ..serving.engine import ShedPolicy

    kw = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        key, _, val = part.partition("=")
        if key == "depth":
            kw["max_queue_depth"] = int(val)
        elif key == "slo":
            kw["ttft_slo_s"] = float(val)
        elif key == "lookahead":
            kw["lookahead"] = int(val)
        else:
            raise SystemExit(f"--shed-policy: unknown key {key!r} "
                             f"(valid: depth, slo, lookahead)")
    return ShedPolicy(step_s=step_s, **kw)


def run_engine(cfg, params, args, device: torch.device) -> None:
    """Continuous-batching engine over a synthetic request stream."""
    from ..serving.engine import Engine, synthetic_requests

    eng = Engine(params, cfg, max_batch=args.batch,
                 max_prompt=args.prompt_len, max_new=args.gen,
                 use_paged_kernel=args.paged, grow_batch=args.grow_batch,
                 prefix_cache=args.prefix_cache,
                 kv_dtype=args.kv_dtype, device=device)
    pol = eng.policy
    print(f"bucket policy: {pol.num_slots} slots x {pol.seq_max} kv depth, "
          f"prompt buckets {list(pol.prompt_buckets)} "
          f"(<= {pol.num_programs} step shapes)")

    # warmup + one decode-step timing, so arrival patterns are expressed in
    # machine-relative units
    step_s = eng.calibrate_step_s()

    reqs = synthetic_requests(
        args.requests, pattern=args.arrival, min_prompt=4,
        max_prompt=args.prompt_len, min_new=max(args.gen // 4, 1),
        max_new=args.gen, vocab=cfg.vocab_size, step_s=step_s,
        temperature=args.temperature, seed=args.seed)
    if args.deadline_s is not None:
        reqs = [dataclasses.replace(r, deadline_s=args.deadline_s) for r in reqs]
    shed = (parse_shed_policy(args.shed_policy, step_s)
            if args.shed_policy else None)
    done, stats = eng.run(reqs, shed=shed)

    print(f"served {stats.num_requests} requests "
          f"({stats.total_generated} tokens) in {stats.wall_s*1e3:.0f} ms "
          f"| {stats.prefills} prefills, {stats.decode_steps} decode steps")
    print(f"aggregate: {stats.tok_s:,.1f} tok/s")
    print(f"TTFT:       p50 {stats.ttft_p50_s*1e3:8.1f} ms   "
          f"p99 {stats.ttft_p99_s*1e3:8.1f} ms")
    print(f"inter-token p50 {stats.itl_p50_s*1e3:8.1f} ms   "
          f"p99 {stats.itl_p99_s*1e3:8.1f} ms")
    if stats.num_ok != stats.num_requests:
        parts = "  ".join(f"{k}={v}" for k, v in stats.finish_reasons.items())
        print(f"outcomes:   {parts}  | goodput {stats.goodput:.3f} "
              f"(preemptions {stats.preemptions}, resumes {stats.resumes})")
    first_ok = next((c for c in done if c.ok), None)
    if first_ok is not None:
        print("sample:", first_ok.tokens[:16])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine instead of the static "
                         "batch loop")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    # engine-only knobs
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--arrival", default="uniform",
                    choices=("burst", "uniform", "bursty", "longtail"))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--paged", action="store_true",
                    help="decode attention via the paged decode kernel")
    ap.add_argument("--kv-dtype", default="auto", choices=["auto", "int8"],
                    help="KV-cache storage dtype: int8 halves pool bytes "
                         "(vs bf16) with per-(token, head) f32 scales")
    ap.add_argument("--grow-batch", action="store_true",
                    help="let the advisor grow the slot bucket when the "
                         "calibrated model predicts enough amortization")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="block-table KV pool with content-addressed prefix "
                         "sharing")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request completion deadline in seconds; "
                         "expiry returns the partial result as "
                         "finish_reason=timeout")
    ap.add_argument("--shed-policy", default=None, metavar="SPEC",
                    help="admission control, e.g. 'depth=16,slo=0.25"
                         "[,lookahead=4]': shed beyond a ready-queue depth "
                         "and/or a predicted-TTFT SLO")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_lm(gen, cfg, device=device)
    if args.engine:
        run_engine(cfg, params, args, device)
    else:
        run_static(cfg, params, args, device)


if __name__ == "__main__":
    main()
