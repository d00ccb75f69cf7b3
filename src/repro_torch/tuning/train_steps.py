"""Warm training-step times of the port's train cells on the card.

Two cells, as chip_smoke's train and ssm train phases build them: the
train cell (internlm2-1.8b at full width and depth, 24 layers, f32 masters,
bf16 compute, `linear_impl="fused"`, `attn_impl="flash"`) and the SSM
train cell (mamba2-780m at full width and depth, 48 layers, fused linear);
AdamW, 4 x 1024 tokens of the synthetic stream, remat "none".  Each cell
runs WARMUP steps, then STEPS timed ones (host wall clock around each step,
the device synchronized after it); the script prints each step's time, the
median, and the peak device memory.

    python -m repro_torch.tuning.train_steps        # needs the card and nvcc

Run as a file against another checkout's package,

    PYTHONPATH=<other checkout>/src python src/repro_torch/tuning/train_steps.py

it times that checkout's train step at the same cells, so two trees can be
compared in turns on one card (parent, change, change, parent).  Both
steps are host-sensitive (the SSM step idles ~60% of its wall), so compare
only within one call.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import torch

import repro_torch
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import init_lm
from repro_torch.optim.adamw import init_opt
from repro_torch.train.train_step import make_train_step

CELLS = {"train": ("internlm2-1.8b", {"linear_impl": "fused", "attn_impl": "flash"}),
         "ssm train": ("mamba2-780m", {"linear_impl": "fused"})}
BATCH, SEQ = 4, 1024
WARMUP, STEPS = 2, 6


def time_cell(arch: str, overrides: dict) -> dict:
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), **overrides)
    tc = TrainConfig(total_steps=WARMUP + STEPS, warmup_steps=WARMUP + STEPS,
                     learning_rate=3e-4, remat="none")
    shape = ShapeConfig("train_steps", SEQ, BATCH, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
                     dtype=torch.float32)
    opt = init_opt(params, tc)
    step_fn = make_train_step(cfg, tc)
    times = []
    for s in range(WARMUP + STEPS):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in make_batch(cfg, shape, s, tc.seed).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, opt
    warm = [t * 1e3 for t in times[WARMUP:]]
    return {"arch": arch, "layers": cfg.num_layers, "step_ms": [round(t, 2) for t in warm],
            "median_ms": round(statistics.median(warm), 2), "peak_gib": round(peak, 3)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("train_steps: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"train step times ({repro_torch.__file__}); card {card}:")
    for cell, (arch, overrides) in CELLS.items():
        row = time_cell(arch, overrides)
        print(f"  {cell}: " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
