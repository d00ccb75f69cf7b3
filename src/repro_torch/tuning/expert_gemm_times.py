"""Device time of the expert-batched launches on the card.

Times, for the package it is run with, the MoE layer's batched GEMM
(`matmul_expert`: w_down's forward (nn), its dgrad (nt) and the wgrad
x^T du (tn) on `.mT` views, the fused backward's dgrad pair) and the
batched fused-MLP backward (its recompute alone, then the whole backward:
the recompute, the nt pair and two tn launches), bf16, at chip_smoke.py's
MoE shapes: MOE_EXPERT_SHAPES (deepseek-v3's decode and prefill
capacities, llama4-maverick's decode, and llama4's w_down at model=2, 8 of
16 experts x 320 rows) for the forward, MOE_BWD_SHAPES (the trained cuts'
capacities and deepseek-v3's decode) for the rest.  Each is one launch for
all experts (CUDA events, warm, one operand copy: every stack exceeds L2),
printed beside torch.bmm on the same views where one call computes it, its
bound (the larger of its FLOPs at 989 TFLOP/s and its bytes, each operand
read once and each output written once, at 3.35 TB/s) and its TFLOP/s.

    python -m repro_torch.tuning.expert_gemm_times    # needs the card and nvcc

Run as a file against another checkout's package,

    PYTHONPATH=<other checkout>/src python src/repro_torch/tuning/expert_gemm_times.py

it times that checkout's kernels at the same shapes (it uses only wrappers
that the port has had since the batched backward), so two trees can be
compared in turns on one card (parent, change, change, parent):
`chip_smoke.py --parent DIR` does that.  The last line is a JSON object of
every time, keyed "<shape> <launch>".
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels.fused_mlp import ops as fused_ops
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.tuning.measure import time_ms

# (experts, capacity rows, h, f): chip_smoke.py's MOE_EXPERT_SHAPES, and the
# per-shard llama4 w_down of its parallel kernels phase
FORWARD_SHAPES = {"deepseek-v3 decode": (256, 8, 7168, 2048),
                  "deepseek-v3 prefill": (256, 160, 7168, 2048),
                  "llama4-maverick": (128, 8, 5120, 8192),
                  "llama4-maverick model=2": (8, 320, 8192, 5120)}
# ... its MOE_BWD_SHAPES
BACKWARD_SHAPES = {"deepseek-v3 train": (16, 2560, 7168, 2048),
                   "llama4-maverick train": (8, 640, 5120, 8192),
                   "deepseek-v3 decode": (256, 8, 7168, 2048)}
ITERS = 10
PEAK_FLOPS, HBM_BYTES_S = 989e12, 3.35e12


def _bound_ms(flops: float, nbytes: float) -> tuple:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_S) * 1e3, \
        "operations" if flops / PEAK_FLOPS > nbytes / HBM_BYTES_S else "bytes"


def main() -> None:
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi}); package {mm_ops.__file__}")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(bf)

    times = {}

    def row(key, fn, flops, nbytes, library=None):
        ms = time_ms([fn], ITERS)
        times[key] = ms
        bnd, by = _bound_ms(flops, nbytes)
        lib = ""
        if library is not None:
            lms = time_ms([library], ITERS)
            times[key + " torch.bmm"] = lms
            lib = f"  torch.bmm {lms:.4f} ({ms / lms:.2f}x)"
        print(f"{key:<44} {ms:9.4f} ms  {flops / ms / 1e9:7.1f} TFLOP/s  bound {bnd:.4f} "
              f"by {by}{lib}", flush=True)

    for label, (e, cap, h, f) in FORWARD_SHAPES.items():
        xd, wd = randn(e, cap, f), randn(e, f, h, scale=f ** -0.5)
        row(f"{label} forward (nn)", lambda: mm_ops.matmul_expert(xd, wd),
            2.0 * e * cap * f * h, 2.0 * e * (cap * f + f * h + cap * h),
            lambda: torch.bmm(xd, wd))
        del xd, wd
        torch.cuda.empty_cache()
    for label, (e, cap, h, f) in BACKWARD_SHAPES.items():
        gy, wd = randn(e, cap, h), randn(e, f, h, scale=f ** -0.5)
        mnk = 2.0 * e * cap * f * h
        io = 2.0 * e * (cap * f + f * h + cap * h)
        row(f"{label} dgrad (nt)", lambda: mm_ops.matmul_expert(gy, wd.mT), mnk, io,
            lambda: torch.bmm(gy, wd.mT))
        del gy, wd
        torch.cuda.empty_cache()
        x, dh = randn(e, cap, h), randn(e, cap, f)
        wg, wu = randn(e, h, f, scale=h ** -0.5), randn(e, h, f, scale=h ** -0.5)
        row(f"{label} recompute", lambda: fused_ops._recompute_expert_cuda(
            x, wg, wu, dh, "swiglu"), 2 * mnk, 2.0 * e * (cap * h + 2 * h * f + 3 * cap * f))
        dg, du = fused_ops._recompute_expert_cuda(x, wg, wu, dh, "swiglu")
        row(f"{label} wgrad (tn)", lambda: mm_ops.matmul_expert(x.mT, du), mnk, io,
            lambda: torch.bmm(x.mT, du))
        row(f"{label} dgrad pair (nt pair)",
            lambda: mm_ops.matmul_expert(dg, wg.mT, du, wu.mT), 2 * mnk,
            2.0 * e * (2 * cap * f + 2 * f * h + cap * h))
        del dg, du
        torch.cuda.empty_cache()
        row(f"{label} whole backward", lambda: fused_ops.fused_mlp_bwd_expert(
            x, wg, wu, dh, mlp_type="swiglu"), 6 * mnk,
            2.0 * e * (2 * cap * h + 4 * h * f + cap * f))
        del x, dh, wg, wu
        torch.cuda.empty_cache()
    print(json.dumps({k: round(v, 4) for k, v in times.items()}))


if __name__ == "__main__":
    main()
