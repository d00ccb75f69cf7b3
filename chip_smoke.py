#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: the card's name and count, and nvidia-smi's name/power limit;
  2. build: one nvcc per source under src/repro_torch/kernels/csrc, all at
     once, and a link (time and the ptxas register / spill report);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the same inputs, every element within its own bound
     (src/repro_torch/kernels/tolerance.py), timed by CUDA events beside its
     bound and, where one PyTorch call computes the same function, that
     call: the serving slice's kernels at its shapes (internlm2-1.8b, 64-row
     GEMMs, a 64-slot bf16 pool), then the training slice's at its shapes
     (4 x 1024 tokens: flash attention forward and backward, the fused
     SwiGLU forward and backward, every projection's forward, dgrad and
     wgrad);
  4. serve: the port's continuous-batching Engine serving internlm2-1.8b at
     full width (24 layers, random weights from a seed) with
     linear_impl="fused" and the paged decode kernel; every kernel's launch
     count over that run must be > 0 and match the path's shape, and one
     prefill through the plain path on the same weights bounds the logits'
     relative error;
  5. train: internlm2-1.8b at full width and depth, float32 masters, bf16
     compute, linear_impl="fused", attn_impl="flash", AdamW, 4 x 1024
     tokens: the step-0 loss and every gradient leaf (per layer slice) of
     the kernel path against the plain path (jnp, naive) on the same params
     and batch, with three planted kernel faults that must break the
     gradient bound; then 4 steps of make_train_step (loss, step time,
     tokens/s, share of the card's bf16 peak, peak memory), each kernel's
     launch count against the path's formula, and one profiled step.
The last line of standard output is the result object; the kernels object
and the card's name and power limit as nvidia-smi prints them come just
before it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
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
TRAIN_ITERS = 20           # ... at the training shapes (each call 0.1-10 ms)
SLEEP_CYCLES = 50_000_000  # ~25 ms of device sleep: longer than queueing ITERS calls

# The training slice: internlm2-1.8b, global batch 4 x seq 1024 (one
# microbatch), 4 steps.  Its GEMMs at 4096 token rows: (k, n) of each
# projection through `linear`, and its launches per step.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 4
TOKENS = TRAIN_BATCH * TRAIN_SEQ
TRAIN_GEMMS = {"q/o": ((2048, 2048), 48), "k/v": ((2048, 1024), 48),
               "w_down": ((8192, 2048), 24), "lm_head": ((2048, 92544), 1)}
# Step-0 check, kernel path vs plain path (jnp, naive) on the same params
# and batch, both bf16 compute: each path rounds every GEMM output, the
# attention weights (P / dS in the kernels, softmax weights in the plain
# path) and the MLP cotangents to bf16 after summing in another order.
# Bounds, set from the card's readings (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md): |loss_k - loss_p| / |loss_p| reads 1.4e-5; and
# ||g_k - g_p|| / ||g_p|| for every leaf and every layer slice of a stacked
# leaf reads 2.40e-2 at worst, against 3.62e-2 at worst for the subtlest
# planted fault (`planted_faults`: the MLP cotangent truncated to 4
# mantissa bits), 0.121 and 0.354 for the others.
TRAIN_LOSS_REL_BOUND = 5e-5
TRAIN_GRAD_REL_BOUND = 0.03


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

def time_ms(torch, calls, iters=ITERS):
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
    for i in range(iters):
        calls[i % len(calls)]()
    host_us = (time.perf_counter() - h0) / iters * 1e6
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_us


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


# --- kernel phase, training shapes -------------------------------------------------------

def _train_gemm_rows(torch, randn, rows) -> None:
    """The forward x @ w, dgrad g @ w^T and wgrad x^T @ g of every
    projection of `linear` at 4096 token rows (the gradients on transposed
    views), against matmul_ref and torch.matmul on the same operands."""
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.tolerance import matmul_tol

    for grad in ("forward", "dgrad", "wgrad"):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
               "step_ms": 0.0}
        for name, ((k, n), per_step) in TRAIN_GEMMS.items():
            if grad == "forward":   # (4096, k) x (k, n)
                x = randn(TOKENS, k)
                ops = copies(torch, lambda: (x, randn(k, n, scale=k ** -0.5)), k * n * 2)
                shape = f"{TOKENS}x{k}x{n}"
            elif grad == "dgrad":   # (4096, n) x (n, k): w stored (k, n), read as w^T
                g = randn(TOKENS, n)
                ops = copies(torch, lambda: (g, randn(k, n, scale=k ** -0.5).T), k * n * 2)
                shape = f"{TOKENS}x{n}x{k}"
            else:                   # (k, 4096) x (4096, n): x stored (4096, k), read as x^T
                g = randn(TOKENS, n)
                ops = copies(torch, lambda: (randn(TOKENS, k).T, g), TOKENS * k * 2)
                shape = f"{k}x{TOKENS}x{n}"
            a, b = ops[0]
            want = matmul_ref(a, b)
            err = compare(torch, matmul(a, b), want, matmul_tol(a, b, want),
                          f"matmul {grad} {shape} ({name})")
            del want
            ms, _ = time_ms(torch, [lambda o=o: matmul(*o) for o in ops], TRAIN_ITERS)
            plain, _ = time_ms(torch, [lambda o=o: matmul_ref(*o) for o in ops], TRAIN_ITERS)
            lib, _ = time_ms(torch, [lambda o=o: torch.matmul(*o) for o in ops], TRAIN_ITERS)
            bnd, by = bound(2.0 * TOKENS * k * n, 2.0 * (TOKENS * k + k * n + TOKENS * n))
            print(f"    {ms:.4f} ms (plain {plain:.4f}, torch.matmul {lib:.4f}, bound {bnd:.4f} "
                  f"by {by}; {2.0 * TOKENS * k * n / ms / 1e9:.1f} TFLOP/s); "
                  f"{per_step} launches per step")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("bound_ms", bnd), ("step_ms", ms * per_step)):
                tot[key] += val
            tot["err"] = max(tot["err"], err)
            del ops
        row = "matmul_train" if grad == "forward" else f"matmul_{grad}"
        rows[row] = dict(
            name=row, route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
            replaces="src/repro/kernels/matmul/kernel.py:35", max_abs_err=tot["err"],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="operations", library_ms=tot["library_ms"])
        print(f"  matmul {grad}, one call at each shape: {tot['ms']:.4f} ms (bound "
              f"{tot['bound_ms']:.4f}, torch.matmul {tot['library_ms']:.4f}); "
              f"{tot['step_ms']:.2f} ms per step of linear's {grad} GEMMs")


def _sdpa_ms(torch, q, k, v, do):
    """torch's scaled_dot_product_attention on the same tensors (as (b, h,
    s, d) views), causal, GQA (`enable_gqa`): (forward ms, forward +
    backward ms).  Timed here as a yardstick only; the port never calls it."""
    F = torch.nn.functional
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True).backward(dot)

    return time_ms(torch, [fwd], TRAIN_ITERS)[0], time_ms(torch, [fwd_bwd], TRAIN_ITERS)[0]


def train_kernel_phase(torch) -> dict:
    """The training slice's kernels at its full-width shapes (bf16)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)
    from repro_torch.kernels.fused_mlp.backward import fused_mlp_bwd_ref
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd, fused_mlp_hidden
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
    from repro_torch.kernels.tolerance import (flash_attention_bwd_tol, flash_attention_tol,
                                               fused_mlp_bwd_tol, fused_mlp_hidden_tol)

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    rows = {}
    print(f"kernels at the training shapes ({TOKENS} tokens, bf16, CUDA events):")

    # flash attention: q (4, 1024, 16, 128), k / v (4, 1024, 8, 128), causal
    b, s, a, nkv, d = TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128
    qkv = copies(torch, lambda: (randn(b, s, a, d), randn(b, s, nkv, d), randn(b, s, nkv, d),
                                 randn(b, s, a, d)), 3 * b * s * a * d * 2)
    q, k, v, do = qkv[0]
    want = flash_attention_ref(q, k, v)
    out, lse = flash_attention_fwd(q, k, v)
    t_out, t_lse = flash_attention_tol(q, k, v, want)
    err = compare(torch, out, want[0], t_out, f"flash_attention out b={b} s={s} a={a} "
                                              f"nkv={nkv} d={d} causal")
    compare(torch, lse, want[1], t_lse, "flash_attention lse")
    del t_out, t_lse
    o, lse_p = want
    gwant = flash_attention_bwd_ref(q, k, v, o, lse_p, do)
    got = flash_attention_bwd(q, k, v, o, lse_p, do)
    tols = flash_attention_bwd_tol(q, k, v, o, lse_p, do, gwant)
    errb = max(compare(torch, g_, w_, t_, f"flash_attention_bwd {n_}")
               for n_, g_, w_, t_ in zip(("dq", "dk", "dv"), got, gwant, tols))
    del gwant, got, tols, want
    fwd_in = [(q_, k_, v_) for q_, k_, v_, _ in qkv]
    bwd_in = []
    for q_, k_, v_, do_ in qkv:
        o_, l_ = flash_attention_fwd(q_, k_, v_)
        bwd_in.append((q_, k_, v_, o_, l_, do_))
    ms, _ = time_ms(torch, [lambda t=t: flash_attention_fwd(*t) for t in fwd_in], TRAIN_ITERS)
    plain, _ = time_ms(torch, [lambda t=t: flash_attention_ref(*t) for t in fwd_in], TRAIN_ITERS)
    ms_b, _ = time_ms(torch, [lambda t=t: flash_attention_bwd(*t) for t in bwd_in], TRAIN_ITERS)
    plain_b, _ = time_ms(torch, [lambda t=t: flash_attention_bwd_ref(*t) for t in bwd_in],
                         TRAIN_ITERS)
    sdpa_f, sdpa_fb = _sdpa_ms(torch, q, k, v, do)
    sdpa_b = sdpa_fb - sdpa_f
    pairs = b * a * s * (s + 1) // 2        # live (query, key) pairs, causal
    io = 2.0 * (2 * b * s * a * d + 2 * b * s * nkv * d)      # q, o; k, v
    bnd, by = bound(4.0 * pairs * d, io + 4.0 * b * a * s)
    bnd_b, by_b = bound(10.0 * pairs * d, 2.0 * io + 2.0 * b * s * a * d + 8.0 * b * a * s)
    print(f"    forward {ms:.4f} ms (plain {plain:.4f}, SDPA {sdpa_f:.4f}, bound {bnd:.4f} by "
          f"{by}; {4.0 * pairs * d / ms / 1e9:.1f} TFLOP/s); 24 launches per step")
    print(f"    backward {ms_b:.4f} ms (plain {plain_b:.4f}, SDPA forward+backward "
          f"{sdpa_fb:.4f} less its forward = {sdpa_b:.4f}, bound {bnd_b:.4f} by "
          f"{by_b}; {10.0 * pairs * d / ms_b / 1e9:.1f} TFLOP/s); 24 launches per step")
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:115", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=sdpa_f)
    rows["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/backward.py:115", max_abs_err=errb, ms=ms_b,
        plain_ms=plain_b, bound_ms=bnd_b, bound_by=by_b, library_ms=sdpa_b)
    del qkv, fwd_in, bwd_in, q, k, v, do, o, lse_p, out, lse

    # fused SwiGLU forward and backward: x (4096, 2048), the (2048, 8192)
    # gate/up pair, dh (4096, 8192)
    m, h, f = TOKENS, 2048, 8192
    ins = copies(torch, lambda: (randn(m, h), randn(h, f, scale=h ** -0.5),
                                 randn(h, f, scale=h ** -0.5), randn(m, f)),
                 (m * h + 2 * h * f + m * f) * 2)
    want = fused_mlp_hidden_ref(*ins[0][:3])
    err = compare(torch, fused_mlp_hidden(*ins[0][:3]), want,
                  fused_mlp_hidden_tol(*ins[0][:3], "swiglu", want),
                  f"fused_mlp_hidden swiglu {m}x{h}x{f}")
    del want
    ms, _ = time_ms(torch, [lambda t=t: fused_mlp_hidden(*t[:3]) for t in ins], TRAIN_ITERS)
    plain, _ = time_ms(torch, [lambda t=t: fused_mlp_hidden_ref(*t[:3]) for t in ins],
                       TRAIN_ITERS)
    flops = 4.0 * m * h * f
    bnd, by = bound(flops, 2.0 * (m * h + 2 * h * f + m * f))
    print(f"    {ms:.4f} ms (plain {plain:.4f}, bound {bnd:.4f} by {by}; "
          f"{flops / ms / 1e9:.1f} TFLOP/s); 24 launches per step")
    rows["fused_mlp_hidden_train"] = dict(
        name="fused_mlp_hidden_train", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_mlp.cu",
        replaces="src/repro/kernels/fused_mlp/kernel.py:64", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    want = fused_mlp_bwd_ref(*ins[0], "swiglu")
    got = fused_mlp_bwd(*ins[0], mlp_type="swiglu")
    tols = fused_mlp_bwd_tol(*ins[0], "swiglu", want)
    err = max(compare(torch, g_, w_, t_, f"fused_mlp_bwd swiglu {m}x{h}x{f} {n_}")
              for n_, g_, w_, t_ in zip(("dx", "dwg", "dwu"), got, want, tols))
    del want, got, tols
    ms, _ = time_ms(torch, [lambda t=t: fused_mlp_bwd(*t) for t in ins], TRAIN_ITERS)
    plain, _ = time_ms(torch, [lambda t=t: fused_mlp_bwd_ref(*t) for t in ins], TRAIN_ITERS)
    flops = 12.0 * m * h * f   # g, u recomputed; dx over both pairs; dwg; dwu
    bnd, by = bound(flops, 2.0 * (2 * m * h + 4 * h * f + m * f))
    print(f"    {ms:.4f} ms (plain {plain:.4f}, bound {bnd:.4f} by {by}; "
          f"{flops / ms / 1e9:.1f} TFLOP/s); 24 launches per step (+3 tile GEMMs each)")
    rows["fused_mlp_bwd"] = dict(
        name="fused_mlp_bwd", route="cuda", source="src/repro_torch/kernels/csrc/fused_mlp_bwd.cu",
        replaces="src/repro/kernels/fused_mlp/backward.py:109", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    del ins

    _train_gemm_rows(torch, randn, rows)
    torch.cuda.empty_cache()
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
    nparams = sum(t.numel() for _, t in _paths(params))
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


# --- train phase ------------------------------------------------------------------------

def per_step_launches(cfg) -> dict:
    """Kernel launches one training step implies (one microbatch, remat
    "none"), for L layers:
      linear runs 5 projections per layer (wq, wk, wv, wo, w_down) and
      lm_head: 5L + 1 forward GEMMs ("nn"), as many dgrad ("nt") and wgrad
      ("tn") GEMMs; the fused-MLP backward adds one dgrad launch over both
      pairs (dx) and two wgrad launches (dWg, dWu) per layer:
        matmul nn = 5L + 1, nt = 6L + 1, tn = 7L + 1   (435 at L = 24)
      fused_mlp_hidden = fused_mlp_bwd = flash_attention = flash_attention_bwd = L."""
    L = cfg.num_layers
    return {"matmul": 18 * L + 3, "matmul_nn": 5 * L + 1, "matmul_nt": 6 * L + 1,
            "matmul_tn": 7 * L + 1, "fused_mlp_hidden": L, "fused_mlp_bwd": L,
            "flash_attention": L, "flash_attention_bwd": L, "paged_decode": 0}


def _train_counters():
    from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd, flash_attention_fwd,
                                                         paged_decode)
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd, fused_mlp_hidden
    from repro_torch.kernels.matmul import ops as matmul_ops
    return matmul_ops, {"fused_mlp_hidden": fused_mlp_hidden, "fused_mlp_bwd": fused_mlp_bwd,
                        "flash_attention": flash_attention_fwd,
                        "flash_attention_bwd": flash_attention_bwd, "paged_decode": paged_decode}


def _read_counts(matmul_ops, fns) -> dict:
    counts = {"matmul": matmul_ops.matmul.launches}
    counts.update({f"matmul_{k}": v for k, v in matmul_ops.matmul.by_layout.items()})
    counts.update({name: fn.launches for name, fn in fns.items()})
    return counts


def _reset_counts(matmul_ops, fns) -> None:
    matmul_ops.reset_launches()
    for fn in fns.values():
        fn.launches = 0


def _grads(torch, params, batch, cfg):
    from repro_torch.models import lm_loss
    from repro_torch.optim.adamw import tree_leaves
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), grads


def _grad_rels(gk, gp, names):
    """||g_k - g_p|| / ||g_p|| for every leaf, and for every layer's slice of
    a stacked leaf (a fault in one layer is not averaged over 24), worst
    first: [(ratio, name)]."""
    out = []
    for a, b, n in zip(gk, gp, names):
        if n.startswith("seg"):
            r = (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1).clamp_min(1e-30)
            out += [(x, f"{n}[{i}]") for i, x in enumerate(r.tolist())]
        else:
            out.append((((a - b).norm() / b.norm().clamp_min(1e-30)).item(), n))
    return sorted(out, reverse=True)


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    """Replace module.name by wrap(real) (which keeps real's attributes, the
    launch counter among them) for the duration."""
    real = getattr(module, name)
    setattr(module, name, functools.wraps(real)(wrap(real)))
    try:
        yield
    finally:
        setattr(module, name, real)


def planted_faults(torch):
    """Faults the step-0 check must see, each planted alone on the kernel
    path by wrapping the function its autograd.Function calls:
    (what, module, global name, wrapper of the real function)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_mlp import ops as fused_ops
    from repro_torch.models import linear as linear_mod

    def wgrad_drops_k_tile(real):
        def f(a, b, *rest):
            if a.dim() == 2 and not a.is_contiguous():   # A transposed: x^T @ g
                return real(a[:, :-64], b[:-64], *rest)
            return real(a, b, *rest)
        return f

    def dk_head_zeroed(real):
        calls = []

        def f(*args, **kw):
            dq, dk, dv = real(*args, **kw)
            calls.append(1)
            if len(calls) == 1:      # the backward's first layer: the last one
                dk[:, :, 0] = 0
            return dq, dk, dv
        return f

    def dh_truncated(real):
        def f(x, w_gate, w_up, dh, **kw):
            return real(x, w_gate, w_up, (dh.view(torch.int16) & ~7).view(dh.dtype), **kw)
        return f

    return [("linear's wgrad drops its last 64-token k tile", linear_mod, "matmul",
             wgrad_drops_k_tile),
            ("the last layer's flash backward zeroes kv head 0's dk", flash_ops,
             "flash_attention_bwd", dk_head_zeroed),
            ("the fused-MLP backward reads dh truncated to 4 mantissa bits", fused_ops,
             "fused_mlp_bwd", dh_truncated)]


def step0_check(torch, params, batch, cfg, plain_cfg) -> None:
    """Step-0 loss and gradients, kernel path vs plain path on the same
    params and batch, within TRAIN_LOSS_REL_BOUND / TRAIN_GRAD_REL_BOUND;
    then each planted fault must break the gradient bound."""
    lk, gk = _grads(torch, params, batch, cfg)
    lp, gp = _grads(torch, params, batch, plain_cfg)
    rel_loss = abs(lk - lp) / abs(lp)
    names = [path for path, _ in _paths(params)]
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    rels = _grad_rels(gk, gp, names)
    del gk
    print(f"  step-0 check, kernel path vs plain path: loss {lk:.6f} vs {lp:.6f} (rel "
          f"{rel_loss:.3e}, bound {TRAIN_LOSS_REL_BOUND}); ||g_k - g_p|| / ||g_p|| over "
          f"{len(rels)} leaves and layer slices: worst {rels[0][0]:.3e} ({rels[0][1]}), "
          f"median {rels[len(rels) // 2][0]:.3e} (bound {TRAIN_GRAD_REL_BOUND}); "
          f"all finite: {finite}")
    for r, n in rels[:5]:
        print(f"    {r:.3e}  {n}")
    unseen = []
    for what, module, name, wrap in planted_faults(torch):
        with _patched(module, name, wrap):
            _, gf = _grads(torch, params, batch, cfg)
        frels = _grad_rels(gf, gp, names)
        del gf
        print(f"  planted fault, {what}: worst {frels[0][0]:.3e} ({frels[0][1]}), "
              f"median {frels[len(frels) // 2][0]:.3e}; next "
              + ", ".join(f"{r:.3e} ({n})" for r, n in frels[1:4]))
        if frels[0][0] <= TRAIN_GRAD_REL_BOUND:
            unseen.append(what)
    del gp
    torch.cuda.empty_cache()
    if not (finite and rel_loss <= TRAIN_LOSS_REL_BOUND and rels[0][0] <= TRAIN_GRAD_REL_BOUND):
        fail("train step 0: the kernel path's loss or gradients break their bounds")
    if unseen:
        fail(f"train step 0: the gradient bound does not see the planted faults {unseen}")


def train_phase(torch) -> dict:
    """internlm2-1.8b trained at full width and depth; returns the launch
    counts of the 4 timed steps."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import init_lm
    from repro_torch.optim.adamw import init_opt
    from repro_torch.train.train_step import make_train_step

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), linear_impl="fused",
                              attn_impl="flash")
    plain_cfg = dataclasses.replace(cfg, linear_impl="jnp", attn_impl="naive")
    # lr warms up over the 4 steps (7.5e-5 ... 3e-4): at full lr from the
    # first update, the random-init model's loss jumps (11.95 -> 22.5)
    tc = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=TRAIN_STEPS, learning_rate=3e-4,
                     remat="none")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
                     dtype=torch.float32)
    n_all = sum(t.numel() for _, t in _paths(params))
    n_embed = params["embed"].numel()
    print(f"train: {cfg.name} L={cfg.num_layers} d={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}; {n_all / 1e9:.3f} B "
          f"float32 master params ({(n_all - n_embed) / 1e9:.3f} B outside the embedding); "
          f"compute {cfg.dtype}, linear_impl={cfg.linear_impl}, attn_impl={cfg.attn_impl}, "
          f"AdamW, remat={tc.remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ}")

    def batch_at(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in make_batch(cfg, shape, step, tc.seed).items()}

    step0_check(torch, params, batch_at(0), cfg, plain_cfg)

    opt = init_opt(params, tc)
    step_fn = make_train_step(cfg, tc)
    watch = [params["seg0"]["attn"]["wq"], params["seg0"]["mlp"]["w_gate"], params["lm_head"],
             params["embed"], params["final_norm"]["scale"]]
    before = [w.detach()[..., :64].clone() for w in watch]
    matmul_ops, fns = _train_counters()
    batches = [batch_at(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    _reset_counts(matmul_ops, fns)
    losses, times = [], []
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        print(f"  step {s}: loss {losses[-1]:.4f}  grad_norm {m['grad_norm'].item():.4f}  "
              f"lr {m['lr'].item():.3e}  {times[-1] * 1e3:.1f} ms")
    counts = _read_counts(matmul_ops, fns)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss {losses}")
    moved = [bool((w.detach()[..., :64] != b).any()) for w, b in zip(watch, before)]
    if not all(moved):
        fail(f"train: parameters did not move ({moved})")
    want = {k: v * TRAIN_STEPS for k, v in per_step_launches(cfg).items()}
    print(f"  kernel launches over {TRAIN_STEPS} steps: {json.dumps(counts)}")
    for name, n in counts.items():
        if n != want[name]:
            fail(f"train: {name}: {n} launches, the path implies {want[name]} "
                 f"({TRAIN_STEPS} steps x {want[name] // TRAIN_STEPS})")

    step_s = sorted(times[1:])[len(times[1:]) // 2]   # median of the warm steps
    attn_flops = 14.0 * cfg.num_layers * TRAIN_BATCH * cfg.num_heads * cfg.head_dim \
        * TRAIN_SEQ * (TRAIN_SEQ + 1) / 2
    flops = 6.0 * (n_all - n_embed) * TOKENS + attn_flops
    print(f"  step time {step_s * 1e3:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}), "
          f"{TOKENS / step_s:,.0f} tokens/s, {flops / 1e12:.2f} TFLOP per step = "
          f"{100 * flops / step_s / PEAK_BF16_FLOPS:.1f}% of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; "
          f"peak device memory {peak:.2f} GiB; card {nvidia_smi()}")
    profile_train_step(torch, step_fn, params, opt, batches[0])
    return counts


def profile_train_step(torch, step_fn, params, opt, batch) -> None:
    """Where one training step's time goes: one more step under
    torch.profiler (device-side events only), the top kernels and the
    device-busy share of the profiled step's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"  profiled step: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f}%)")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:14]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def main() -> None:
    torch = setup()
    device_phase(torch)
    build_phase()
    rows = kernel_phase(torch)
    rows.update(train_kernel_phase(torch))
    counts = serve_phase(torch)
    train = train_phase(torch)
    # launches over the main path's runs: the serve run's (the serve-shape
    # rows), then the 4 training steps' (the train-shape rows).  Each row
    # counts the launches of the shapes it checked and timed: matmul_train is
    # linear's forward (the "nn" layout), matmul_dgrad / matmul_wgrad are
    # linear's gradient GEMMs; the fused-MLP backward's own dx ("nt") and
    # dWg / dWu ("tn") tile GEMMs ride in its row, as its ms does.
    launches = {"matmul": counts["matmul"], "fused_mlp_hidden": counts["fused_mlp_hidden"],
                "paged_decode": counts["paged_decode"],
                "matmul_train": train["matmul_nn"],
                "fused_mlp_hidden_train": train["fused_mlp_hidden"],
                "flash_attention": train["flash_attention"],
                "flash_attention_bwd": train["flash_attention_bwd"],
                "fused_mlp_bwd": train["fused_mlp_bwd"],
                "matmul_dgrad": train["matmul_nt"] - train["fused_mlp_bwd"],
                "matmul_wgrad": train["matmul_tn"] - 2 * train["fused_mlp_bwd"]}
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] <= 0:
            fail(f"{name}: no launch on the main path")
    order = ("matmul", "fused_mlp_hidden", "paged_decode", "matmul_train",
             "fused_mlp_hidden_train", "flash_attention", "flash_attention_bwd",
             "fused_mlp_bwd", "matmul_dgrad", "matmul_wgrad")
    print(json.dumps({"kernels": [rows[n] for n in order]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
