#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: the card's name and count, and nvidia-smi's name/power limit;
  2. build: one nvcc call over src/repro_torch/kernels/csrc (time and the
     ptxas register / spill report);
  3. kernels: each hand-written kernel at the serving slice's full-width
     shapes (internlm2-1.8b, 64-row GEMMs, a 64-slot bf16 pool) against its
     plain PyTorch version on the same inputs, every element within its own
     bound (src/repro_torch/kernels/tolerance.py), and
     timed by CUDA events beside its bound and, where one PyTorch call
     computes the same function, that call;
  4. serve: the port's continuous-batching Engine serving internlm2-1.8b at
     full width (24 layers, random weights from a seed) with
     linear_impl="fused" and the paged decode kernel; every kernel's launch
     count over that run must be > 0 and match the path's shape, and one
     prefill through the plain path on the same weights bounds the logits'
     relative error.
The last line of standard output is the result object; the kernels object
and the card's name and power limit as nvidia-smi prints them come just
before it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

# Whole-model check (prefill logits, kernel path vs plain path, bf16): the
# two paths round every GEMM output to bf16 after summing in another order
# (up to 2^-8 relative per element), through 24 layers and ~170 GEMMs; the
# residual stream carries those roundings forward.  Bound on
# ||logits_kernel - logits_plain|| / ||logits_plain||:
LOGITS_REL_BOUND = 0.05

# internlm2-1.8b projections at the slice's 64-row GEMMs: (k, n), and how
# many of each one decode step launches
MATMUL_SHAPES = {"q/o": ((2048, 2048), 48), "k/v": ((2048, 1024), 48),
                 "w_down": ((8192, 2048), 24), "lm_head": ((2048, 92544), 1)}
ROWS = 64
L2_BYTES = 128 << 20   # rotate operand copies past the 50 MB L2
ITERS = 50                 # timed calls per measurement
SLEEP_CYCLES = 50_000_000  # ~25 ms of device sleep: longer than queueing ITERS calls


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def setup():
    """Import the port from the checkout; refuse to run without a card."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels need a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_phase(torch) -> None:
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"nvidia-smi: {nvidia_smi()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")


def build_phase() -> None:
    from repro_torch.kernels import _build
    lib = _build.build()
    print(f"build: {lib.path.name} in {lib.build_s:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")


# --- timing ---------------------------------------------------------------------------

def time_ms(torch, calls):
    """(mean device ms, mean host us) of one call, warm, cycling through
    `calls` (closures over different operand copies, so weights come from
    device memory as on the real path, not from L2).  The card sleeps while
    the host queues the calls, so the CUDA events time back-to-back device
    work, not the host's launch rate, and the host clock around the loop
    times only what one call costs the host to issue."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    h0 = time.perf_counter()
    for i in range(ITERS):
        calls[i % len(calls)]()
    host_us = (time.perf_counter() - h0) / ITERS * 1e6
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / ITERS, host_us


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def compare(torch, got, want, tol, what: str) -> float:
    """Every element of the kernel's output within its own bound `tol`:
    1.02 (2^-7 |plain| + the f32 sum error the summation length allows),
    as kernels/tolerance.py derives it."""
    from repro_torch.kernels.tolerance import check
    torch.cuda.synchronize()
    ok, err, ratio = check(got, want, tol)
    ref = want.float().abs().max().item()
    print(f"  {what}: max abs err {err:.3e} (max |plain| {ref:.3e}, rel "
          f"{err / max(ref, 1e-30):.2e}), worst err / bound {ratio:.3f} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{what}: kernel disagrees with its plain version")
    return err


def copies(torch, make, nbytes: int):
    return [make() for _ in range(max(1, -(-L2_BYTES // nbytes)))]


# --- kernel phase -----------------------------------------------------------------------

def kernel_phase(torch) -> dict:
    """Each kernel vs its plain version at the main path's shapes; returns the
    rows of the kernels line (without launch counts)."""
    from repro_torch.kernels.flash_attention.ops import paged_decode
    from repro_torch.kernels.flash_attention.ref import paged_decode_ref
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.tolerance import (fused_mlp_hidden_tol, matmul_tol,
                                               paged_decode_tol)

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    rows = {}
    print("kernels (bf16, CUDA events, weights rotated past L2):")

    # matmul: one call at each of the path's projection shapes
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    for name, ((k, n), per_step) in MATMUL_SHAPES.items():
        a = randn(ROWS, k)
        bs = copies(torch, lambda: randn(k, n, scale=k ** -0.5), k * n * 2)
        want = matmul_ref(a, bs[0])
        err = compare(torch, matmul(a, bs[0]), want, matmul_tol(a, bs[0], want),
                      f"matmul {ROWS}x{k}x{n} ({name})")
        ms, host = time_ms(torch, [lambda b=b: matmul(a, b) for b in bs])
        plain, _ = time_ms(torch, [lambda b=b: matmul_ref(a, b) for b in bs])
        lib, lib_host = time_ms(torch, [lambda b=b: torch.matmul(a, b) for b in bs])
        bnd, by = bound(2.0 * ROWS * k * n, 2.0 * (ROWS * k + k * n + ROWS * n))
        print(f"    {ms:.4f} ms (plain {plain:.4f}, torch.matmul {lib:.4f}, bound {bnd:.4f} "
              f"by {by}); {per_step} launches per decode step; host {host:.1f} us per call "
              f"(torch.matmul {lib_host:.1f})")
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bound_ms"] += bnd
        tot["err"] = max(tot["err"], err)
        del bs
    rows["matmul"] = dict(
        name="matmul", route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/kernel.py:35", max_abs_err=tot["err"],
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by="bytes",
        library_ms=tot["library_ms"])
    print(f"  matmul, one call at each shape: {tot['ms']:.4f} ms "
          f"(bound {tot['bound_ms']:.4f}, torch.matmul {tot['library_ms']:.4f})")

    # fused SwiGLU hidden: x (64, 2048) against the (2048, 8192) gate/up pair
    h, f = 2048, 8192
    x = randn(ROWS, h)
    ws = copies(torch, lambda: (randn(h, f, scale=h ** -0.5), randn(h, f, scale=h ** -0.5)),
                2 * h * f * 2)
    want = fused_mlp_hidden_ref(x, *ws[0])
    err = compare(torch, fused_mlp_hidden(x, *ws[0]), want,
                  fused_mlp_hidden_tol(x, *ws[0], "swiglu", want),
                  f"fused_mlp_hidden swiglu {ROWS}x{h}x{f}")
    ms, host = time_ms(torch, [lambda w=w: fused_mlp_hidden(x, *w) for w in ws])
    plain, _ = time_ms(torch, [lambda w=w: fused_mlp_hidden_ref(x, *w) for w in ws])
    bnd, by = bound(2.0 * 2 * ROWS * h * f, 2.0 * (ROWS * h + 2 * h * f + ROWS * f))
    print(f"    {ms:.4f} ms (plain {plain:.4f}, bound {bnd:.4f} by {by}); "
          f"24 launches per decode step; host {host:.1f} us per call")
    rows["fused_mlp_hidden"] = dict(
        name="fused_mlp_hidden", route="cuda", source="src/repro_torch/kernels/csrc/fused_mlp.cu",
        replaces="src/repro/kernels/fused_mlp/kernel.py:64", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    del ws

    # paged decode: 64 rows, 16 query heads over 8 kv heads, d 128, a
    # (64, 128, 8, 128) bf16 pool per layer; lengths as the engine's pool
    # holds them mid-run (some dead slots)
    b, a, nkv, d, s_max = 64, 16, 8, 128, 128
    q = randn(b, a, d)
    pools = copies(torch, lambda: (randn(b, s_max, nkv, d), randn(b, s_max, nkv, d)),
                   2 * b * s_max * nkv * d * 2)
    slot_idx = torch.randperm(b, generator=gen, device=dev).to(torch.int32)
    lengths = torch.randint(1, s_max + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[::5] = 0
    want = paged_decode_ref(q, *pools[0], slot_idx, lengths)
    err = compare(torch, paged_decode(q, *pools[0], slot_idx, lengths), want,
                  paged_decode_tol(q, *pools[0], slot_idx, lengths, want),
                  f"paged_decode b={b} a={a} nkv={nkv} d={d} s_max={s_max}")
    ms, host = time_ms(torch, [lambda p=p: paged_decode(q, *p, slot_idx, lengths)
                               for p in pools])
    plain, _ = time_ms(torch, [lambda p=p: paged_decode_ref(q, *p, slot_idx, lengths)
                               for p in pools])
    live = int(lengths.sum().item())
    bnd, by = bound(4.0 * a * d * live,
                    2.0 * (2 * b * a * d + 2 * live * nkv * d) + 8.0 * b)
    print(f"    {ms:.4f} ms (plain {plain:.4f}, bound {bnd:.4f} by {by}; {live} live tokens); "
          f"24 launches per decode step; host {host:.1f} us per call")
    rows["paged_decode"] = dict(
        name="paged_decode", route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/flash_attention/paged.py:97", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    del pools
    return rows


# --- serve phase ------------------------------------------------------------------------

def serve_phase(torch) -> dict:
    """The port's Engine on internlm2-1.8b at full width; returns launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.kernels.flash_attention.ops import paged_decode
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.models import init_lm
    from repro_torch.serving.engine import Engine, synthetic_requests
    from repro_torch.serving.serve_step import make_prefill_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), linear_impl="fused")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(params))
    print(f"serve: {cfg.name} L={cfg.num_layers} d={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}; {nparams / 1e9:.3f} B "
          f"params in {cfg.dtype} (init {time.perf_counter() - t0:.1f} s)")

    eng = Engine(params, cfg, max_batch=8, max_prompt=64, max_new=32,
                 use_paged_kernel=True, hw=H100_SXM, device=dev)
    pol = eng.policy
    print(f"  policy: {pol.num_slots} slots x {pol.seq_max} kv depth, prompt buckets "
          f"{list(pol.prompt_buckets)}")
    step_s = eng.calibrate_step_s()
    print(f"  calibrated decode step: {step_s * 1e3:.2f} ms")
    reqs = synthetic_requests(16, pattern="burst", min_prompt=16, max_prompt=64, min_new=8,
                              max_new=32, vocab=cfg.vocab_size, seed=0)

    for fn in (matmul, fused_mlp_hidden, paged_decode):
        fn.launches = 0
    done, stats = eng.run(reqs)
    torch.cuda.synchronize()
    counts = {"matmul": matmul.launches, "fused_mlp_hidden": fused_mlp_hidden.launches,
              "paged_decode": paged_decode.launches}

    for r, c in zip(reqs, done):
        if c.rid != r.rid or c.finish_reason != "length" or len(c.tokens) != r.max_new_tokens:
            fail(f"request {r.rid}: {c.finish_reason} with {len(c.tokens)} of "
                 f"{r.max_new_tokens} tokens ({c.detail})")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"request {r.rid}: token outside the vocabulary")
    print(f"  served {stats.num_requests} requests, {stats.total_generated} tokens in "
          f"{stats.wall_s:.3f} s ({stats.prefills} prefills, {stats.decode_steps} decode steps)")
    print(f"  tok/s {stats.tok_s:.1f} | TTFT p50 {stats.ttft_p50_s * 1e3:.2f} ms "
          f"p99 {stats.ttft_p99_s * 1e3:.2f} ms | ITL p50 {stats.itl_p50_s * 1e3:.2f} ms "
          f"p99 {stats.itl_p99_s * 1e3:.2f} ms")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  kernel launches over the run: {json.dumps(counts)}")

    per_layer = cfg.num_layers
    passes = stats.prefills + stats.decode_steps
    want = {"matmul": passes * (5 * per_layer + 1), "fused_mlp_hidden": passes * per_layer,
            "paged_decode": stats.decode_steps * per_layer}
    for name, n in counts.items():
        if n <= 0:
            fail(f"the serve run launched no {name} kernel")
        if n != want[name]:
            fail(f"{name}: {n} launches, the path implies {want[name]}")

    profile_phase(torch, eng, reqs, stats.wall_s)

    # model-level check: one batched full-width prefill, kernel path vs plain
    prompts = torch.as_tensor(synthetic_tokens(0, 0, 4, 64, cfg.vocab_size), device=dev)
    plain_cfg = dataclasses.replace(cfg, linear_impl="jnp")
    lk, _ = make_prefill_step(cfg, 64)(params, {"tokens": prompts})
    lp, _ = make_prefill_step(plain_cfg, 64)(params, {"tokens": prompts})
    lk, lp = lk[:, :cfg.vocab_size].float(), lp[:, :cfg.vocab_size].float()
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("prefill logits not finite")
    rel = ((lk - lp).norm() / lp.norm()).item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"  prefill logits, kernel path vs plain path: rel err {rel:.3e} "
          f"(bound {LOGITS_REL_BOUND}), greedy first-token agreement {agree:.2f}")
    if rel > LOGITS_REL_BOUND:
        fail(f"prefill logits differ from the plain path by {rel:.3e}")
    return counts


def profile_phase(torch, eng, reqs, unprofiled_wall: float) -> None:
    """Where a serve run's time goes: the same requests again under
    torch.profiler.  Device-busy time is the summed device time of the
    kernels and copies (the device-side events only: a CPU operator's
    device time is that of the kernels it launched, which are listed
    too); its share is given against the profiled wall (which the
    profiler's own host cost lengthens) and the unprofiled run's wall.
    Then the top kernels, the split-K reduce of the matmul among them,
    and the host's operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"  profiled rerun: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}% of it; {100 * busy / unprofiled_wall:.1f}% of the "
          f"unprofiled run's {unprofiled_wall:.3f} s), {stats.decode_steps} decode steps")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    shown = events[:10] + [e for e in events[10:] if "splitk_reduce" in e.key]
    for e in shown:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    # the host side: operators by their own host time (launch and dispatch
    # cost, inflated by the profiler's per-op overhead)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"  host time by operator (summed self time "
          f"{sum(e.self_cpu_time_total for e in host) / 1e6:.3f} s):")
    for e in host[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    torch = setup()
    device_phase(torch)
    build_phase()
    rows = kernel_phase(torch)
    counts = serve_phase(torch)
    for name, row in rows.items():
        row["launches"] = counts[name]
    print(json.dumps({"kernels": [rows[n] for n in ("matmul", "fused_mlp_hidden",
                                                     "paged_decode")]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
