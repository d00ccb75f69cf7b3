"""Tile and split sweep of the int8 kernels on the card.

`kernels/quantized/ops.py` picks one tile and split of k per launch of the
int8 GEMM and one tile for the int8 fused MLP.  This sweep builds the
candidates beside them (`int8_tiles.cu`, one `nvcc` into `build/tuning/`),
runs each at the int8-weight serve path's shapes with bf16 out, holds each
result bit-identical to the library's launch, and prints one line per
shape: every candidate's time (CUDA events, weights rotated past L2), the
pick, and the pick's time over the fastest.  It changes no pick.

    python -m repro_torch.tuning.int8_tiles     # needs the card and nvcc
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels.quantized.ops import fused_tile, int8_fused_mlp_q, int8_matmul_q, launch_shape
from ..quant import quantize_int8, quantize_weight

SOURCE = Path(__file__).resolve().with_name("int8_tiles.cu")
# (k, n) of internlm2-1.8b's int8 projections, as chip_smoke times them
GEMM_SHAPES = {"q/o": (2048, 2048), "k/v": (2048, 1024), "w_down": (8192, 2048),
               "lm_head": (2048, 92544)}
GEMM_ROWS = (64, 128, 256, 4096)
FUSED_SHAPE = (2048, 8192)          # x (m, h) against the gate and up (h, f)
FUSED_ROWS = (16, 64, 128, 256, 4096)
GEMM_TILES = ((64, 128), (64, 256), (128, 128), (128, 256))
FUSED_TILES = ((64, 32), (64, 64), (128, 32), (128, 64))
SPLITS = (1, 2, 4, 8)               # at most 8: one cluster
ACT_NONE, ACT_SWIGLU = 0, 1
L2_BYTES = 50 * 2 ** 20
SLEEP_CYCLES = 50_000_000


def _library() -> ctypes.CDLL:
    """Build (once per source) and load the candidates' library."""
    digest = hashlib.sha256(_build._digest().encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR.parent / "tuning" / f"int8_tiles-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                      "-o", str(tmp), str(SOURCE)]])
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_int8_tile.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.repro_int8_tile.restype = i
    return lib


def _time_ms(calls, iters: int) -> float:
    """Mean device ms of one call, warm, cycling through `calls`; the card
    sleeps while the host queues them."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for i in range(iters):
        calls[i % len(calls)]()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _candidates(m: int, n: int, k: int, tiles, sms: int, split: bool, picked):
    """(tm, tn, k per split) to try, the pick's first: 64-row tiles only
    at most 64 rows; a split of k only where one unsplit wave leaves SMs
    idle, each split at least two 128-column steps deep."""
    tm, tn, splits = picked
    out = {(tm, tn, _cdiv(_cdiv(k, splits), 128) * 128): None}
    for tm, tn in tiles:
        if m <= 64 < tm:
            continue
        grid = _cdiv(m, tm) * _cdiv(n, tn)
        for s in SPLITS if split else (1,):
            if s == 1 or (grid < sms and k >= 2 * 128 * s):
                out[(tm, tn, _cdiv(_cdiv(k, s), 128) * 128)] = None
    return list(out)


def sweep(lib, what: str, m: int, k: int, n: int, gated: bool, picked) -> str:
    """One shape's line: each candidate's ms, the pick, pick / fastest."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    a_q, a_s = quantize_int8(torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16))

    def weight():
        w = quantize_weight(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        return w.q, w.scale

    nw = 2 if gated else 1
    ws = [[weight() for _ in range(nw)] for _ in range(_cdiv(L2_BYTES, nw * k * n))]
    flat = [x for pair in ws[0] for x in pair]
    want = (int8_fused_mlp_q(a_q, a_s, *flat, out_dtype=torch.bfloat16) if gated
            else int8_matmul_q(a_q, a_s, *flat, torch.bfloat16))
    out = torch.empty_like(want)
    sms = _build.num_sms(dev)
    times = {}
    ptr = _build.ptr
    for tm, tn, ks in _candidates(m, n, k, FUSED_TILES if gated else GEMM_TILES, sms,
                                  not gated, picked):
        def call(w, tm=tm, tn=tn, ks=ks):   # K-major weights: (n, k) storage
            (b0, s0), (b1, s1) = (w[0], w[-1]) if gated else (w[0], (None, None))
            status = lib.repro_int8_tile(
                ptr(a_q), ptr(b0), ptr(b1), ptr(a_s), ptr(s0), ptr(s1), ptr(out), m, n, k, ks,
                ACT_SWIGLU if gated else ACT_NONE, int(k % 16 == 0), tm, tn,
                _build.stream_of(dev))
            _build.check(status, f"int8 tile {tm}x{tn}")
        call(ws[0])
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit(f"{what} {m}x{k}x{n}: tile {tm}x{tn}, {_cdiv(k, ks)} splits "
                             f"differs from the library's launch")
        times[(tm, tn, _cdiv(k, ks))] = _time_ms([lambda w=w: call(w) for w in ws],
                                                20 if m * k * n > 2 ** 34 else 50)
    best = min(times, key=times.get)
    name = "{}x{}/{}".format
    cells = ", ".join(f"{name(*c)} {t:.4f}" for c, t in times.items())
    return (f"  {what} {m}x{k}x{n}: {cells}; picked {name(*picked)} {times[picked]:.4f} = "
            f"{times[picked] / times[best]:.2f}x the fastest ({name(*best)})")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int8_tiles: needs a CUDA device")
    lib = _library()
    sms = _build.num_sms(torch.device("cuda"))
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"int8 tile sweep (bf16 out, ms a call, tile/splits); card {name}:")
    for m in GEMM_ROWS:
        for what, (k, n) in GEMM_SHAPES.items():
            tm, tn, ks = launch_shape(m, n, k, sms)
            print(sweep(lib, what, m, k, n, False, (tm, tn, _cdiv(k, ks))), flush=True)
        torch.cuda.empty_cache()
    h, f = FUSED_SHAPE
    for m in FUSED_ROWS:
        print(sweep(lib, "int8_fused_mlp swiglu", m, h, f, True, (*fused_tile(m), 1)), flush=True)


if __name__ == "__main__":
    main()
