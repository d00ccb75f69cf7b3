"""Training entry point of the port (the JAX package's `launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 4 --global-batch 4 --seq-len 1024 --attn-impl flash \
        --linear-impl fused --remat none

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 4 --global-batch 4 --seq-len 1024 --linear-impl fused

Trains the dense decoder (internlm2, ...), mamba2 and zamba2 (the SSD
chunk kernel forward and its backward kernel; zamba2's shared attention
through flash with `--attn-impl flash`), the MoE family, whisper-small
(its batches carry the encoder-frame stub) and internvl2-76b (the
patch-embedding stub); `--attn-impl blocked` runs the blocked
online-softmax attention in plain PyTorch.  Runs on the CUDA card; `--device
cpu` runs the plain PyTorch versions on the host instead (there is no
silent fallback).  Params are float32 masters drawn from `--seed` on the
device; the batches are the deterministic synthetic stream of
`data/pipeline.py`.  At launch it prints the advisor's shape-rule findings
for the config on the H100 (`core/advisor.check_alignment`), as JAX's
launcher does for its chip.

`--data D --model T` trains on a D x T mesh (`parallel/sharding.py`): FSDP
and data parallelism over `data`, tensor and expert parallelism over
`model`, the same step as one device takes.  Started without `torchrun`,
it spawns its own D x T ranks on this host (`launch/mesh.spawn`); under
`torchrun` it joins the world it finds.  NCCL where each rank has a card
of its own, gloo where the ranks share one (the one H100: its
communication goes through host memory) or run on the host; the launcher
prints which.  Every rank draws the whole params from `--seed` on the host
(so the model must fit in host memory once per rank) and moves only its
block to the device; the model gathers each data-sharded leaf where it uses
it, a layer at a time.  Rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --data 2 --model 2 --device cpu --steps 2

Fault tolerance, as the JAX launcher's:
  * a checkpoint every `--checkpoint-every` updates (an async host write,
    `checkpoint/ckpt.py`, the JAX package's on-disk layout) and a final
    one, into `--checkpoint-dir`;
  * `--resume` restores the latest checkpoint and continues from it — the
    batches are a pure function of (seed, step), so the resumed run sees
    exactly the batches the uninterrupted one would have.
A checkpoint is labelled by the number of updates applied (`step_k` holds
k updates and `OptState.step == k`), so a run resumed from `step_k` starts
at batch k and follows the uninterrupted run's trajectory.  (The JAX
launcher labels a mid-run checkpoint one short, `step_s` after s + 1
updates, and its resume applies batch s twice; the final checkpoint is
labelled right in both.)

With `REPRO_OBS=1` each step runs in a `train_step` span (the device
synchronized inside it) and counts `train.steps` / `train.tokens`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch
import torch.distributed as dist

from .. import obs
from ..checkpoint.ckpt import Checkpointer
from ..configs.base import MeshConfig, ShapeConfig, TrainConfig
from ..configs.registry import get_config, get_smoke_config
from ..core import advisor
from ..data.pipeline import make_batch
from ..models import init_lm
from ..optim.adamw import init_opt
from ..parallel import sharding as sh
from ..serving.engine.engine import resolve_device
from . import mesh as mesh_lib
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
                     checkpoint_every=args.checkpoint_every,
                     checkpoint_dir=args.checkpoint_dir, seed=args.seed)
    return cfg, mesh_cfg, shape, tc


def _parser():
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
    ap.add_argument("--attn-impl", default=None, choices=[None, "naive", "blocked", "flash"])
    ap.add_argument("--linear-impl", default=None,
                    choices=[None, "jnp", "pallas", "tuned", "fused"],
                    help="dispatch for every dense projection GEMM (models/linear.py); "
                         "fused = the fused SwiGLU/MLP kernel + the tile GEMM")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="rows per microbatch on each data rank; 0 = no accumulation")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--checkpoint-dir", default=TrainConfig.checkpoint_dir,
                    help="default: repro_ckpt under $TMPDIR (/tmp where it is unset)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, mesh_cfg, shape, _ = build(args)
    if mesh_cfg.num_devices == 1:
        return train(args, device)
    # refuse what the plan does not cover before any rank starts; query
    # heads that do not split over `model` run as halo heads (a warning)
    sh.check_supported(cfg, mesh_cfg)
    errs, warns = sh.divisibility(cfg, mesh_cfg, shape.global_batch)
    for w in warns:
        print(f"[warn] {w}: halo heads (each rank computes the heads its columns touch)")
    if errs:
        raise ValueError(f"{cfg.name} on mesh {mesh_cfg.data} x {mesh_cfg.model}: "
                         + "; ".join(errs))
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:   # under torchrun
        rank, world, dev = mesh_lib.init_from_env(device)
        try:
            return train(args, dev, rank)
        finally:
            dist.destroy_process_group()
    argv = sys.argv[1:] if argv is None else list(argv)
    backend = mesh_lib.spawn(_rank_main, mesh_cfg.num_devices, (argv,), device=device)
    print(f"done: {mesh_cfg.num_devices} ranks over {backend}")


def _rank_main(rank: int, world: int, device, argv) -> None:
    train(_parser().parse_args(argv), device, rank)


def train(args, device, rank: int = 0):
    cfg, mesh_cfg, shape, tc = build(args)
    say = print if rank == 0 else (lambda *a, **k: None)
    plan = None
    if mesh_cfg.num_devices > 1:
        mesh = mesh_lib.make_mesh(mesh_cfg, kv_rep=sh.kv_replication(cfg, mesh_cfg.model))
        plan = sh.Plan(cfg, mesh)
        say(f"mesh: data={mesh_cfg.data} x model={mesh_cfg.model}, backend {mesh.backend}, "
            f"rank 0 on {device}")

    # shape-rule report (the paper's contribution, surfaced at launch), at
    # the shard widths the mesh gives
    findings = advisor.check_alignment(cfg, tp=mesh_cfg.model,
                                       global_batch=shape.global_batch)
    for f in findings:
        if f.severity != "ok":
            say(f"[advisor:{f.severity}] {f.rule}: {f.message}")

    n_micro = 1
    if args.microbatch:
        tc = dataclasses.replace(tc, microbatch_per_device=args.microbatch)
        n_micro = num_microbatches(shape, mesh_cfg, tc)

    if plan is None:
        params = init_lm(torch.Generator(device=device).manual_seed(tc.seed), cfg, device=device,
                         dtype=torch.float32)
    else:
        # drawn whole on the host and sharded there: the device holds only
        # this rank's blocks
        whole = init_lm(torch.Generator().manual_seed(tc.seed), cfg, device="cpu",
                        dtype=torch.float32)
        params = plan.shard(whole, device=device)
        del whole
    opt = init_opt(params, tc)
    start_step = 0
    ck = Checkpointer(tc.checkpoint_dir, keep=3)
    if args.resume and ck.latest_step() is not None:
        params, opt, start_step = ck.restore(params, opt, plan=plan)
        say(f"resumed from step {start_step}")
    step_fn = make_train_step(cfg, tc, n_micro=n_micro, plan=plan)

    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(start_step, tc.total_steps):
        with obs.span("train_step", cat="train", step=step) if obs.enabled() else obs.NULL_SPAN:
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in make_batch(cfg, shape, step, tc.seed).items()}
            params, opt, metrics = step_fn(params, opt, batch)
            if obs.enabled() and device.type == "cuda":
                torch.cuda.synchronize(device)
        if obs.enabled():
            obs.counter("train.steps").inc()
            obs.counter("train.tokens").inc(shape.global_batch * shape.seq_len)
        tokens_done += shape.global_batch * shape.seq_len
        if step % args.log_every == 0 or step == tc.total_steps - 1:
            loss = float(metrics["loss"])   # waits for the step
            dt = time.perf_counter() - t0
            say(f"step {step:5d}  loss {loss:.4f}  "
                f"grad_norm {float(metrics['grad_norm']):.3f}  "
                f"tok/s {tokens_done / max(dt, 1e-6):,.0f}", flush=True)
        applied = step + 1    # updates in params and opt now (== opt.step)
        if tc.checkpoint_every and applied % tc.checkpoint_every == 0 \
                and applied < tc.total_steps:
            ck.save(applied, params, opt, meta={"arch": cfg.name}, blocking=False, plan=plan)
    ck.save(tc.total_steps, params, opt, meta={"arch": cfg.name}, plan=plan)
    ck.wait()
    say("done")


if __name__ == "__main__":
    main()
