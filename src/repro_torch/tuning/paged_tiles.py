"""Tile and split sweep of the bf16 paged-decode kernel on the card.

`kernels/flash_attention/ops.py` `paged_launch` gives the bf16 kernel
(`csrc/paged_decode.cu` `paged_decode_sm90`) a tile of kv tokens and a
number of splits: the blocks one (row, kv head) walk is cut into, one
cluster of at most 8.  More splits put more blocks on the card and shorten
each block's chain of loads; fewer copy and combine less.  This sweep runs
every (tile, splits) at the paged shapes of
chip_smoke (the serve pool, g = 12 and g = 2 over one pool, the prefix
shapes' int8 slot pool and bf16 / int8 block tables, and a long context),
holds each result to the plain version within the kernel's bound
(`kernels/tolerance.py`), and prints each one's time (CUDA events, pools
rotated past L2), the pick, and the pick's time over the fastest.  It
changes no pick.  Tile and splits are runtime arguments of the library's
entry, so it builds nothing of its own.

    python -m repro_torch.tuning.paged_tiles     # needs the card and nvcc

`--times` prints only the time of the library's own launch at each shape,
beside the f32 branch (`paged_decode_kernel`, the token-identity dtype),
the host's us per paged call and three other serve kernels, through the
public wrappers alone.  Run as a file against another checkout's package,

    PYTHONPATH=<other checkout>/src python src/repro_torch/tuning/paged_tiles.py --times

it times that checkout's kernels at the same shapes, so two trees can be
compared in turns on one card (parent, change, change, parent).
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (paged_decode_blocktable_ref,
                                                     paged_decode_ref)

SPLITS = (1, 2, 3, 4, 8)
L2_BYTES = 50 * 2 ** 20
SLEEP_CYCLES = 50_000_000
ITERS = 50
# internlm2-1.8b's attention (16 query / 8 kv heads of 128), and command-r-plus-104b's
# group (96 / 8)
NKV, D = 8, 128


def _time_ms(calls, iters: int = ITERS):
    """(mean device ms, mean host us) of one call, warm, cycling through
    `calls`; the card sleeps while the host queues them."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    h0 = time.perf_counter()
    for i in range(iters):
        calls[i % len(calls)]()
    host = (time.perf_counter() - h0) / iters * 1e6
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host


def _lengths(gen, b: int, lo: int, hi: int, dead_every: int):
    lengths = torch.randint(lo, hi + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    lengths[::dead_every] = 0
    return lengths


def _pools(gen, n: int, depth: int, quant: bool, dtype=torch.bfloat16):
    """Copies of a (K, V[, k_scale, v_scale]) pool of n x depth tokens,
    enough to rotate past L2."""
    from repro_torch.quant import quantize_kv
    elem = 1 if quant else torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * n * depth * NKV * (D * elem + (4 if quant else 0))

    def make():
        k, v = (torch.randn((n, depth, NKV, D), generator=gen, device="cuda") for _ in range(2))
        if quant:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            return kq, vq, ks, vs
        return k.to(dtype), v.to(dtype)
    return [make() for _ in range(max(1, -(-L2_BYTES // nbytes)))], nbytes


def shapes(gen):
    """(label, wrapper, q, pool copies, index, lengths, max_blocks) at each
    paged shape."""
    out = []
    bf = torch.bfloat16

    def q_of(b, a, dtype=bf):
        return torch.randn((b, a, D), generator=gen, device="cuda").to(dtype)

    # the serve shape: 64 slots x 128, 16 / 8 heads, every 5th slot dead
    b, s_max = 64, 128
    lengths = _lengths(gen, b, 1, s_max, 5)
    slot = torch.randperm(b, generator=gen, device="cuda").to(torch.int32)
    pools, _ = _pools(gen, b, s_max, False)
    out.append(("serve slot bf16", ops.paged_decode, q_of(b, 16), pools, slot, lengths, 0))
    # g = 12 and g = 2 over one 16 x 256 pool
    b, s_max = 16, 256
    lengths = _lengths(gen, b, 1, s_max, 16)
    lengths[3] = 0
    slot = torch.randperm(b, generator=gen, device="cuda").to(torch.int32)
    pools, _ = _pools(gen, b, s_max, False)
    out.append(("g=12 slot bf16", ops.paged_decode, q_of(b, 96), pools, slot, lengths, 0))
    out.append(("g=2 slot bf16", ops.paged_decode, q_of(b, 16), pools, slot, lengths, 0))
    # the prefix shapes: 64 rows x 192, 72-160 live tokens, every 7th dead;
    # block tables of 64-token blocks, each row its own permuted blocks
    b, s_max, bs = 64, 192, 64
    lengths = _lengths(gen, b, 72, 160, 7)
    slot = torch.randperm(b, generator=gen, device="cuda").to(torch.int32)
    pools, _ = _pools(gen, b, s_max, True)
    out.append(("prefix slot int8", ops.paged_decode, q_of(b, 16), pools, slot, lengths, 0))
    per = s_max // bs
    tables = torch.randperm(b * per, generator=gen, device="cuda").to(torch.int32)
    tables = tables.reshape(b, per)
    for quant in (False, True):
        pools, _ = _pools(gen, b * per, bs, quant)
        out.append((f"prefix table {'int8' if quant else 'bf16'}", ops.paged_decode_blocktable,
                    q_of(b, 16), pools, tables, lengths, per))
    # a long context: 16 rows x 4096 live tokens of a bf16 slot pool
    b, s_max = 16, 4096
    lengths = torch.full((b,), s_max, dtype=torch.int32, device="cuda")
    slot = torch.randperm(b, generator=gen, device="cuda").to(torch.int32)
    pools, _ = _pools(gen, b, s_max, False)
    out.append(("long context bf16", ops.paged_decode, q_of(b, 16), pools, slot, lengths, 0))
    return out


def _call(fn, q, p, index, lengths, **kw):
    sc = {} if len(p) == 2 else dict(k_scale=p[2], v_scale=p[3])
    if kw:
        mb = index.shape[1] if index.dim() == 2 else 0
        return ops._paged_cuda(fn, q, p[0], p[1], sc.get("k_scale"), sc.get("v_scale"), index,
                               lengths, mb, None, **kw)
    return fn(q, p[0], p[1], index, lengths, **sc)


def _check(fn, q, p, index, lengths, got, what: str) -> None:
    sc = {} if len(p) == 2 else dict(k_scale=p[2], v_scale=p[3])
    if fn is ops.paged_decode:
        want = paged_decode_ref(q, p[0], p[1], index, lengths, **sc)
        tol = tolerance.paged_decode_tol(q, p[0], p[1], index, lengths, want, **sc)
    else:
        want = paged_decode_blocktable_ref(q, p[0], p[1], index, lengths, **sc)
        tol = tolerance.paged_decode_blocktable_tol(q, p[0], p[1], index, lengths, want, **sc)
    ok, err, ratio = tolerance.check(got, want, tol)
    if not ok:
        raise SystemExit(f"{what}: err {err:.3e}, {ratio:.3f} of the bound")


def sweep(gen) -> None:
    for label, fn, q, pools, index, lengths, mb in shapes(gen):
        b, a, _ = q.shape
        capacity = mb * pools[0][0].shape[1] if mb else pools[0][0].shape[1]
        pick = ops.paged_launch(b, NKV, a // NKV, D, capacity, pools[0][0].element_size())
        times = {}
        for tile in ops.PAGED_TILES:
            for splits in SPLITS:
                geo = ops.paged_launch(b, NKV, a // NKV, D, capacity,
                                       pools[0][0].element_size(), 2, tile, splits)
                key = geo.tile, geo.splits
                if key in times:
                    continue
                got = _call(fn, q, pools[0], index, lengths, geometry=key)
                _check(fn, q, pools[0], index, lengths, got, f"{label} tile {tile} x{splits}")
                times[key] = _time_ms(
                    [lambda p=p: _call(fn, q, p, index, lengths, geometry=key) for p in pools])[0]
        best = min(times, key=times.get)
        cells = ", ".join(f"{t} x{n} {ms:.4f}" for (t, n), ms in times.items())
        print(f"  {label} ({int(lengths.sum())} live tokens, capacity {capacity}, "
              f"{b * NKV} walks), tile x splits ms: {cells}; picked {pick.tile} x{pick.splits} "
              f"{times[pick.tile, pick.splits]:.4f} = "
              f"{times[pick.tile, pick.splits] / times[best]:.2f}x the fastest "
              f"({best[0]} x{best[1]})", flush=True)
        del pools
        torch.cuda.empty_cache()


def library_times(gen) -> None:
    """The library's own launch at each paged shape, the f32 branch, and
    three other serve kernels (which this sweep's kernel must not move)."""
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
    from repro_torch.kernels.matmul.ops import matmul
    for label, fn, q, pools, index, lengths, mb in shapes(gen):
        got = _call(fn, q, pools[0], index, lengths)
        _check(fn, q, pools[0], index, lengths, got, label)
        ms, host = _time_ms([lambda p=p: _call(fn, q, p, index, lengths) for p in pools])
        print(f"  {label}: {ms:.4f} ms, host {host:.1f} us a call", flush=True)
        del pools
        torch.cuda.empty_cache()
    # the f32 branch at the serve shape (f32 q over an f32 pool)
    b, s_max = 64, 128
    lengths = _lengths(gen, b, 1, s_max, 5)
    slot = torch.randperm(b, generator=gen, device="cuda").to(torch.int32)
    pools, _ = _pools(gen, b, s_max, False, torch.float32)
    q = torch.randn((b, 16, D), generator=gen, device="cuda")
    got = _call(ops.paged_decode, q, pools[0], slot, lengths)
    _check(ops.paged_decode, q, pools[0], slot, lengths, got, "serve slot f32")
    ms, host = _time_ms([lambda p=p: _call(ops.paged_decode, q, p, slot, lengths) for p in pools])
    print(f"  serve slot f32: {ms:.4f} ms, host {host:.1f} us a call", flush=True)
    del pools
    bf = torch.bfloat16
    x = torch.randn((64, 2048), generator=gen, device="cuda").to(bf)
    ws = [torch.randn((2048, 2048), generator=gen, device="cuda").to(bf) for _ in range(8)]
    print(f"  matmul 64x2048x2048: {_time_ms([lambda w=w: matmul(x, w) for w in ws])[0]:.4f} ms")
    wg = [(torch.randn((2048, 8192), generator=gen, device="cuda").to(bf),
           torch.randn((2048, 8192), generator=gen, device="cuda").to(bf)) for _ in range(2)]
    print(f"  fused_mlp_hidden 64x2048x8192: "
          f"{_time_ms([lambda w=w: fused_mlp_hidden(x, *w) for w in wg])[0]:.4f} ms")
    qf = torch.randn((4, 1024, 16, D), generator=gen, device="cuda").to(bf)
    kf = torch.randn((4, 1024, 8, D), generator=gen, device="cuda").to(bf)
    print(f"  flash_attention 4x1024 16/8x128: "
          f"{_time_ms([lambda: ops.flash_attention(qf, kf, kf)])[0]:.4f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("paged_tiles: needs a CUDA device")
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    times = "--times" in sys.argv[1:]
    print(f"paged decode {'library launches' if times else 'tile/split sweep'} (ms a call; "
          f"{ops.__file__}); card {name}:")
    gen = torch.Generator(device="cuda").manual_seed(0)
    (library_times if times else sweep)(gen)


if __name__ == "__main__":
    main()
