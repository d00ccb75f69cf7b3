"""Training entry point of the port (the JAX package's `launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 4 --global-batch 4 --seq-len 1024 --attn-impl flash \
        --linear-impl fused --remat none

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 4 --global-batch 4 --seq-len 1024 --linear-impl fused

Trains the dense decoder (internlm2, ...), mamba2 and zamba2 (the SSD
chunk kernel forward and its backward kernel; zamba2's shared attention
through flash with `--attn-impl flash`).  Runs on the CUDA card; `--device
cpu` runs the plain PyTorch versions on the host instead (there is no
silent fallback).  Params are float32 masters drawn from `--seed` on the
device; the batches are the deterministic synthetic stream of
`data/pipeline.py`.  Checkpointing (`--checkpoint-every`,
`--resume`), data/model parallelism (`--data`, `--model` > 1) and the
advisor's launch report come with later slices: passing those flags raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs.base import MeshConfig, ShapeConfig, TrainConfig
from ..configs.registry import get_config, get_smoke_config
from ..data.pipeline import make_batch
from ..models import init_lm
from ..optim.adamw import init_opt
from ..serving.engine.engine import resolve_device
from ..train.train_step import make_train_step, num_microbatches


def build(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.linear_impl:
        cfg = dataclasses.replace(cfg, linear_impl=args.linear_impl)
    mesh_cfg = MeshConfig(data=args.data, model=args.model)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    tc = TrainConfig(total_steps=args.steps, warmup_steps=max(args.steps // 20, 1),
                     learning_rate=args.lr, optimizer=args.optimizer, remat=args.remat,
                     seed=args.seed)
    return cfg, mesh_cfg, shape, tc


def _refuse_unported(args) -> None:
    if args.checkpoint_every is not None or args.resume:
        raise NotImplementedError(
            "--checkpoint-every / --resume are not ported yet: they come with the "
            "checkpoint slice")
    if args.data != 1 or args.model != 1:
        raise NotImplementedError(
            "--data / --model > 1 are not ported yet: they come with the parallelism slice")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adamw8bit"])
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--attn-impl", default=None, choices=[None, "naive", "flash"])
    ap.add_argument("--linear-impl", default=None,
                    choices=[None, "jnp", "pallas", "tuned", "fused"],
                    help="dispatch for every dense projection GEMM (models/linear.py); "
                         "fused = the fused SwiGLU/MLP kernel + the tile GEMM")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="rows per microbatch; 0 = no accumulation")
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    device = resolve_device(args.device)
    cfg, mesh_cfg, shape, tc = build(args)
    n_micro = 1
    if args.microbatch:
        tc = dataclasses.replace(tc, microbatch_per_device=args.microbatch)
        n_micro = num_microbatches(shape, mesh_cfg, tc)

    gen = torch.Generator(device=device).manual_seed(tc.seed)
    params = init_lm(gen, cfg, device=device, dtype=torch.float32)
    opt = init_opt(params, tc)
    step_fn = make_train_step(cfg, tc, n_micro=n_micro)

    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(tc.total_steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in make_batch(cfg, shape, step, tc.seed).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        tokens_done += shape.global_batch * shape.seq_len
        if step % args.log_every == 0 or step == tc.total_steps - 1:
            loss = float(metrics["loss"])   # waits for the step
            dt = time.perf_counter() - t0
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"tok/s {tokens_done / max(dt, 1e-6):,.0f}", flush=True)
    print("done")


if __name__ == "__main__":
    main()
