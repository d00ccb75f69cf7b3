"""Slab sweep of the SSD chunk kernel on the card.

`kernels/ssd/ops.py` `launch_shape` gives each block of the bf16 kernel a
slab of heads that share one C B^T (B and C expanded over the heads).  A
larger slab computes the scores fewer times but leaves fewer blocks for the
132 SMs.  This sweep runs every slab size at mamba2-780m's and zamba2-2.7b's
prefill shapes (4 x 1024 tokens, B and C expanded over the heads as the
model passes them), holds each result bit-identical to the library's own
launch, and prints each one's time (CUDA events, operands rotated past L2),
the pick, and the pick's time over the fastest; then the flat (bh, ...)
layout, where every head computes its own scores.  It changes no pick.  The
slab is a runtime argument of the library's entry, so the sweep builds
nothing of its own.

    python -m repro_torch.tuning.ssd_tiles     # needs the card and nvcc
"""
from __future__ import annotations

import subprocess

import torch

from ..configs.registry import get_config
from ..kernels.ssd import ops
from .int8_tiles import _time_ms

ARCHS = ("mamba2-780m", "zamba2-2.7b")
BATCH, SEQ = 4, 1024
SLABS = (1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 48)
L2_BYTES = 128 * 2 ** 20


def operands(gen, nh: int, P: int, N: int, Q: int):
    """x_dt, B, C, seg of one layer's prefill as `apply_ssm` passes them:
    leading dims (b, 1 group, nh heads), x_dt a permuted view of (b, s, nh,
    P), B and C (b, s, N) expanded over the heads, seg decreasing by steps
    in [0, 0.02) (a trained model's decay)."""
    dev = torch.device("cuda")
    nc = SEQ // Q
    x = (torch.randn((BATCH, nc, Q, 1, nh, P), generator=gen, device=dev) * 0.5).bfloat16()
    B, C = ((torch.randn((BATCH, nc, Q, 1, 1, N), generator=gen, device=dev) * 0.5).bfloat16()
            for _ in range(2))
    seg = -(torch.rand((BATCH, nc, Q, 1, nh), generator=gen, device=dev) * 0.02).cumsum(2)

    def heads(t):
        return t.permute(0, 3, 4, 1, 2, *range(5, t.dim()))
    return (heads(x), heads(B.expand(BATCH, nc, Q, 1, nh, N)),
            heads(C.expand(BATCH, nc, Q, 1, nh, N)), heads(seg))


def sweep(arch: str) -> str:
    """One shape's line: each slab's ms, the pick, pick / fastest."""
    cfg = get_config(arch)
    nh, P, N, Q = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    gen = torch.Generator(device="cuda").manual_seed(0)
    nbytes = 2 * BATCH * SEQ * (nh * P + 2 * N)
    sets = [operands(gen, nh, P, N, Q) for _ in range(-(-L2_BYTES // nbytes))]
    want = ops._ssd_chunk_cuda(*sets[0])
    x = sets[0][0]
    picked = ops.launch_shape(tuple(x.shape[:3]), x.shape[3], sets[0][1].stride()[:5],
                              sets[0][2].stride()[:5], Q, N, P)
    times = {}
    for h in sorted({*SLABS, picked.heads}):
        if h > nh:
            continue
        got = ops._ssd_chunk_cuda(*sets[0], heads=h)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{arch}: a slab of {h} heads differs from the library's launch")
        times[h] = _time_ms([lambda o=o, h=h: ops._ssd_chunk_cuda(*o, heads=h) for o in sets], 50)
    flat = [[t.reshape(-1, *t.shape[3:]) for t in o] for o in sets[:2]]
    got = ops._ssd_chunk_cuda(*flat[0])
    if not all(torch.equal(g.reshape(w.shape), w) for g, w in zip(got, want)):
        raise SystemExit(f"{arch}: the flat layout's per-head scores differ from the shared ones")
    flat_ms = _time_ms([lambda o=o: ops._ssd_chunk_cuda(*o) for o in flat], 50)
    best = min(times, key=times.get)
    cells = ", ".join(f"{h} {t:.4f}" for h, t in times.items())
    return (f"  {arch} ({nh} heads, P {P}, N {N}, Q {Q}), heads a block: {cells}; picked "
            f"{picked.heads} {times[picked.heads]:.4f} = {times[picked.heads] / times[best]:.2f}x "
            f"the fastest ({best}); flat layout, scores per head: {flat_ms:.4f}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_tiles: needs a CUDA device")
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"ssd slab sweep (bf16, ms a call, {BATCH} x {SEQ} tokens); card {name}:")
    for arch in ARCHS:
        print(sweep(arch), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
