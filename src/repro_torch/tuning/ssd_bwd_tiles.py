"""Slab sweep of the bf16 SSD backward kernels on the card.

`kernels/ssd/ops.py` `bwd_launch_shape` gives each block of the bf16
backward (`csrc/ssd_chunk_bwd.cu`: `ssd_bwd_keys`, then `ssd_bwd_queries`)
a slab of heads that share one set of score tiles (B and C expanded over
the heads).  A larger slab forms the scores fewer times but leaves fewer
blocks for the 132 SMs.  This sweep runs every slab size at mamba2-780m's
and zamba2-2.7b's training shapes (4 x 1024 tokens, B and C expanded over
the heads as the model passes them), holds each result bit-identical to the
library's own launch, and prints each one's time (CUDA events, operands
rotated past L2), the pick, and the pick's time over the fastest; then the
flat (bh, ...) layout, where every head forms its own scores.  It changes
no pick.  The slab is a runtime argument of the library's entry, so the
sweep builds nothing of its own.

    python -m repro_torch.tuning.ssd_bwd_tiles     # needs the card and nvcc

`--times` prints only the times of the public wrappers at both training
shapes: the bf16 backward, the f32 backward (mamba2-780m's shape) and the
forward on the same operands.  Run as a file against another checkout's
package,

    PYTHONPATH=<other checkout>/src python src/repro_torch/tuning/ssd_bwd_tiles.py --times

it times that checkout's kernels at the same shapes, so two trees can be
compared in turns on one card (parent, change, change, parent).
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd import ops
from repro_torch.tuning.measure import time_ms

ARCHS = ("mamba2-780m", "zamba2-2.7b")
BATCH, SEQ = 4, 1024
SLABS = (1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 48)
L2_BYTES = 128 * 2 ** 20
ITERS = 20


def operands(gen, nh: int, P: int, N: int, Q: int, dtype=torch.bfloat16):
    """x_dt, B, C, seg, dY, dS of one layer's backward as `_SSDChunk` gets
    them: leading dims (b, 1 group, nh heads), x_dt a permuted view of (b,
    s, nh, P), B and C (b, s, N) expanded over the heads, seg decreasing by
    steps in [0, 0.02) (a trained model's decay), dY like x_dt, dS (b, 1,
    nh, nc, N, P)."""
    dev = torch.device("cuda")
    nc = SEQ // Q
    x = (torch.randn((BATCH, nc, Q, 1, nh, P), generator=gen, device=dev) * 0.5).to(dtype)
    B, C = ((torch.randn((BATCH, nc, Q, 1, 1, N), generator=gen, device=dev) * 0.5).to(dtype)
            for _ in range(2))
    seg = -(torch.rand((BATCH, nc, Q, 1, nh), generator=gen, device=dev) * 0.02).cumsum(2)

    def heads(t):
        return t.permute(0, 3, 4, 1, 2, *range(5, t.dim()))
    x = heads(x)
    dY = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
    dS = torch.randn((BATCH, 1, nh, nc, N, P), generator=gen, device=dev).to(dtype)
    return (x, heads(B.expand(BATCH, nc, Q, 1, nh, N)), heads(C.expand(BATCH, nc, Q, 1, nh, N)),
            heads(seg), dY, dS)


def _shape(arch: str):
    cfg = get_config(arch)
    return cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk


def _sets(gen, nh, P, N, Q, dtype=torch.bfloat16):
    nbytes = (2 if dtype == torch.bfloat16 else 4) * BATCH * SEQ * (2 * nh * P + 2 * N)
    return [operands(gen, nh, P, N, Q, dtype) for _ in range(-(-L2_BYTES // nbytes))]


def sweep(arch: str) -> str:
    """One shape's line: each slab's ms, the pick, pick / fastest."""
    nh, P, N, Q = _shape(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sets = _sets(gen, nh, P, N, Q)
    want = ops._ssd_chunk_bwd_cuda(*sets[0])
    x, B, C = sets[0][:3]
    picked = ops.bwd_launch_shape(tuple(x.shape[:3]), x.shape[3], B.stride()[:5], C.stride()[:5],
                                  Q, N, P)
    times = {}
    for h in sorted({*SLABS, picked.heads}):
        if h > nh:
            continue
        got = ops._ssd_chunk_bwd_cuda(*sets[0], heads=h)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{arch}: a slab of {h} heads differs from the library's launch")
        times[h] = time_ms([lambda o=o, h=h: ops._ssd_chunk_bwd_cuda(*o, heads=h) for o in sets],
                           ITERS)
    flat = [[t.reshape(-1, *t.shape[3:]) for t in o] for o in sets[:2]]
    got = ops._ssd_chunk_bwd_cuda(*flat[0])
    if not all(torch.equal(g.reshape(w.shape), w) for g, w in zip(got, want)):
        raise SystemExit(f"{arch}: the flat layout's per-head scores differ from the shared ones")
    flat_ms = time_ms([lambda o=o: ops._ssd_chunk_bwd_cuda(*o) for o in flat], ITERS)
    best = min(times, key=times.get)
    cells = ", ".join(f"{h} {t:.4f}" for h, t in times.items())
    return (f"  {arch} ({nh} heads, P {P}, N {N}, Q {Q}), heads a block: {cells}; picked "
            f"{picked.heads} {times[picked.heads]:.4f} = {times[picked.heads] / times[best]:.2f}x "
            f"the fastest ({best}); flat layout, scores per head: {flat_ms:.4f}")


def library_times() -> None:
    """The public wrappers' times at both training shapes (any checkout)."""
    from repro_torch.kernels.ssd.ops import ssd_chunk, ssd_chunk_bwd
    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch in ARCHS:
        nh, P, N, Q = _shape(arch)
        sets = _sets(gen, nh, P, N, Q)
        bwd = time_ms([lambda o=o: ssd_chunk_bwd(*o) for o in sets], ITERS)
        fwd = time_ms([lambda o=o: ssd_chunk(*o[:4]) for o in sets], ITERS)
        line = f"  {arch}: bf16 backward {bwd:.4f} ms, forward {fwd:.4f} ms"
        del sets
        if arch == ARCHS[0]:
            sets = _sets(gen, nh, P, N, Q, torch.float32)
            f32 = time_ms([lambda o=o: ssd_chunk_bwd(*o) for o in sets], ITERS // 2)
            line += f", f32 backward {f32:.4f} ms"
            del sets
        print(line, flush=True)
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_tiles: needs a CUDA device")
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if "--times" in sys.argv[1:]:
        print(f"ssd backward times ({ops.__file__}; {BATCH} x {SEQ} tokens); card {name}:")
        t0 = time.perf_counter()
        library_times()
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        return
    print(f"ssd backward slab sweep (bf16, ms a call, {BATCH} x {SEQ} tokens); card {name}:")
    for arch in ARCHS:
        print(sweep(arch), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
