#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: the card's name and count, and nvidia-smi's name/power limit;
  2. build: one nvcc per source under src/repro_torch/kernels/csrc, all at
     once, and a link (time and the ptxas register / spill report); every
     instantiation of the bf16 flash forward and backward and of the GEMM
     mainloop (csrc/gemm_sm90.cuh: the matmul, fused-MLP and fused-MLP
     backward kernels) must show warpgroup products (HGMMA) and cp.async
     copies (LDGSTS) in its SASS, and every instantiation of the int8
     mainloop (csrc/gemm_sm90_s8.cuh: the int8 GEMM and fused MLP) integer
     warpgroup products (IGMMA) and LDGSTS, and every instantiation of the
     bf16 SSD chunk kernel (csrc/ssd_chunk.cu ssd_chunk_sm90), of the
     bf16 paged-decode kernel (csrc/paged_decode.cu paged_decode_sm90) and
     of the bf16 SSD backward's key and query walks (csrc/ssd_chunk_bwd.cu
     ssd_bwd_keys, ssd_bwd_queries) HGMMA and LDGSTS; no GEMM, SSD, SSD
     backward or paged-decode instantiation may spill or have its products
     serialized by ptxas (C7511, C7515, C7520); no kernel may issue
     warp-level tensor products (HMMA: WMMA, mma.sync), and no bf16
     instantiation of the f32 FMA tile kernels, of the f32 paged-decode body
     or of the f32 SSD backward, nor the old int8 and SSD WMMA kernels, may
     exist;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the same inputs, every element within its own bound
     (src/repro_torch/kernels/tolerance.py), timed by CUDA events beside its
     bound and, where one PyTorch call computes the same function, that
     call: the serving slice's kernels at its shapes (internlm2-1.8b, 64-row
     GEMMs, a 64-slot bf16 pool; the slot and block-table kernels at
     g = 12, bf16 and int8 pools), the prefix slice's (the block-table
     kernel over a bf16 pool, the slot and block-table kernels over int8
     pools, tables built by a BlockPool), then the training slice's at its shapes
     (4 x 1024 tokens: flash attention forward and backward, each beside
     SDPA, the fused SwiGLU forward and backward, every projection's
     forward, dgrad and wgrad, each also at every bf16 tile beside the
     one the wrapper picks); the f32 branches of the tile GEMM and the
     fused MLP at the serve shapes, timed; flash attention at gpt3-2.7b's
     head splits C0-C3 (head dims 80, 40, 64, 128 at 4 x 2048 tokens) against SDPA and
     the bound at the true head dim; then the int8-weight slice's (the int8 GEMM at every
     projection's shape at 64 and 4096 rows, bit-identical to its plain
     version, beside torch._int_mm, at 64 rows also at other splits of k;
     a row-major weight relaid and counted; the int8 fused SwiGLU hidden), then the
     SSM slice's (the SSD chunk kernel at mamba2-780m's prefill shape at
     fast and slow decay, at zamba2-2.7b's at slow decay, a ragged chunk and
     a misaligned one, bf16 and f32; timed at both prefill shapes), and the
     SSD backward kernels (csrc/ssd_chunk_bwd.cu) at the same shapes (the
     training shapes: 4 x 1024 tokens), bf16 and f32, timed at both training
     shapes beside the forward kernel on the same operands; with `--parent
     DIR` (a checkout of the parent commit) also the parent's SSD backward
     and this one's in turns; then the MoE slice's expert-batched launches
     (csrc/matmul.cu and csrc/fused_mlp.cu, one launch for every expert of a
     stack) at deepseek-v3's decode and prefill capacities and
     llama4-maverick's, expert by expert against their plain versions,
     timed beside their bound, torch.bmm and the 2-D kernel launched once
     per expert;
  4. serve: the port's continuous-batching Engine serving internlm2-1.8b at
     full width (24 layers, random weights from a seed) with
     linear_impl="fused" and the paged decode kernel; every kernel's launch
     count over that run must be > 0 and match the path's shape, and one
     prefill through the plain path on the same weights bounds the logits'
     relative error; every engine run of this and the next phases must
     relay out no int8 weight (the wrappers' relayout counters stay 0);
  5. prefix serve: the same model served from the block-table KV pool
     (Engine(prefix_cache=True), 64-token blocks): a cold and a warm run of
     32 burst requests (75% share a 64-token system prefix) through the
     block-table kernel; a hit request's suffix prefill against a cold
     prefill (logits and the suffix's K/V), with two planted faults the
     bounds must see; a tight pool that must preempt and resume with
     BlockPool.check() after every step; the slot engine, and both engines
     over an int8 pool (the int8 kernels); launch counts per run;
  6. quantized serve: the same model with every GEMM weight prequantized
     to int8 (`quantize_linear_params`), bf16 activations, through the int8
     GEMM and int8 fused-MLP kernels: the serve phase's burst on the slot
     engine (launch counts: 5L + 1 int8 GEMMs and L int8 fused MLPs per
     pass, no bf16 GEMM), profiled; prefill logits against the plain path
     on the same weights and against the bf16 weights, with a planted scale
     fault the bound must see; the prefix engine over an int8 KV pool;
  7. ssm serve: mamba2-780m at full width and depth (48 layers, random
     weights), bf16, linear_impl="fused", served by serve_step: a prefill
     of 4 x 1024 tokens and 31 greedy decode steps, the launch counts of
     each (48 SSD kernels and 289 tile GEMMs per prefill, no SSD kernel
     and 289 GEMMs per decode step); the device time of one prefill's GEMM
     and SSD launches between CUDA events; prefill logits against the plain path
     over all positions and at the worst position; the worst position at
     f32, at random init and at a trained model's slow decay
     (softplus(dt_bias) in [1e-3, 1e-1]), which a planted chunk-state
     fault must break at each; one decode step
     after a prefill of 1000 tokens against a prefill of 1001, which a
     planted fault (zeroed conv tails) must break;
  8. hybrid serve: zamba2-2.7b at full width, 2 of its 9 superblocks, the
     same serve run, launch counts and bf16 logits bounds (its shared
     attention + GELU MLP block through the tile GEMM and the fused MLP
     kernel);
  9. moe serve: deepseek-v3-671b at full width (MLA, 256 experts top-8, a
     shared expert, MTP), 4 of its 61 layers (3 dense, 1 MoE), bf16,
     linear_impl="fused", served by serve_step: a prefill of 4 x 1024 tokens
     and 31 greedy decode steps, the launch counts of each (6 tile GEMMs per
     MLA layer, the router GEMM, one batched fused hidden and one batched
     w_down GEMM per MoE layer, the shared expert's fused MLP and w_down, a
     dense layer's fused MLP and w_down, the head), the device time of one
     decode step and one prefill by kernel; prefill logits against the
     plain path over all positions and at the worst position whose routing
     agrees, each layer's count of tokens routed differently and of dropped
     entries, and two planted faults (one expert's w_down doubled, the
     gates unrenormalised) the bounds must see; the MLA handoff (a decode
     step after a prefill of 1000 tokens against a prefill of 1001) with a
     planted fault (the cached k_rope unrotated); lm_loss's forward
     (lm_loss, aux_loss, mtp_loss) against the plain path, and under the
     gates fault and one expert's router logit doubled, which it must see;
     f32 token identity of the kernel and plain paths at 2 layers, but at a
     near tie of the top-2 logits or of a router's k-th / (k+1)-th
     probability at a token of the diverging row that routes differently;
  10. moe engine: llama4-maverick-400b-a17b at full width (128 experts top-1,
     a shared expert, MoE every 2nd layer), 1 [moe, dense] pair, bf16,
     linear_impl="fused": the slot engine (paged decode) on the serve burst
     and the prefix engine (block-table pool) on the prefix workload, launch
     counts per run; the same logits check and planted faults; f32 token
     identity of each engine's kernel and plain paths;
  11. token identity: at full width, 4 layers, float32, the greedy tokens of
     the slot and prefix engines (roomy and tight), of the int8-KV slot and
     prefix engines, and of the int8-weight slot and prefix engines over
     float and int8 KV must be identical pairwise, but at a near tie; and
     mamba2-780m's kernel path and plain path, likewise;
  12. train: internlm2-1.8b at full width and depth, float32 masters, bf16
     compute, linear_impl="fused", attn_impl="flash", AdamW, 4 x 1024
     tokens: the step-0 loss and every gradient leaf (per layer slice) of
     the kernel path against the plain path (jnp, naive) on the same params
     and batch, with three planted kernel faults that must break the
     gradient bound; then 4 steps of make_train_step (loss, step time,
     tokens/s, share of the card's bf16 peak, peak memory), each kernel's
     launch count against the path's formula, and one profiled step;
  13. ssm train: mamba2-780m at full width and depth (48 layers), float32
     masters, bf16 compute, linear_impl="fused", AdamW, 4 x 1024 tokens:
     the step-0 loss and gradients of the kernel path (the SSD kernel and
     its backward kernel under autograd) against the plain path (jnp, the
     SSD kernels' plain versions, remat "full"), held at bf16 to
     SSM_BF16_GRAD_REL_BOUND, which two of three planted faults in the SSD
     backward must break (the third hides in bf16 rounding and is printed),
     then to the train phase's bounds at f32 and a trained model's slow
     decay, which all three must break; 4 steps of make_train_step (loss, step time, tokens/s, share of
     the bf16 peak, peak memory), launch counts against the path's formula
     (48 SSD forwards and backwards and 867 tile GEMMs a step), one
     profiled step;
  14. hybrid train: zamba2-2.7b at full width, 2 of its 9 superblocks,
     attn_impl="flash" (head dim 80): the same step-0 checks with one
     planted fault held each (bf16: the last layer's dseg, the other two
     printed; f32: dB without its dS term), 2 steps, launch counts (SSD forward and
     backward, flash forward and backward, fused MLP forward and backward,
     tile GEMMs), one profiled step;
  15. tuning: autotune (src/repro_torch/tuning/search.py) internlm2-1.8b's
     serve shapes (the bf16 projections and lm_head at 16 and 64 rows, the
     fused SwiGLU), its int8-serve shapes (the int8 GEMM at 64, 128 and 256
     rows, the int8 fused MLP) and its paged pools (the serve pool, the
     prefix cell's block-table pool) into a cache file in a temporary
     directory, printing every candidate's time, the winner and the rule's
     pick over the winner; each winner bit-identical to a forced launch of
     its geometry and within its bound of the plain version; then, from
     that cache, the serve workload at linear_impl "tuned" and "fused"
     (every lookup at a swept shape a hit, prefill logits against the plain
     path), the prefix engine at 4 layers (its block size from the pool
     entry, BlockPool.check() after every step) and the host's us per
     wrapper call with and without the lookup;
  16. codesign: the paper's Fig. 1 through the port: one gpt3-2.7b block at
     each head split C0-C3 (b 4, s 2048, bf16, fused linear, flash),
     forward and backward, after autotuning its GEMM keys, beside the
     advisor's analytic and measurement-calibrated predictions and the
     orders of all three (printed, not checked).
Before the first phase the run installs an empty default tuning cache, so
phases 2-14 launch the wrappers' rules whatever tuning_cache.json the
checkout holds.  The last line of standard output is the result object; the
kernels object and the card's name and power limit as nvidia-smi prints
them come just before it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# `--parent DIR`: a checkout of the parent commit, for the SSD backward's
# A/B in turns (`ssd_bwd_ab_phase`); not given, the phase does not run
PARENT = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv[1:] else None

# NVIDIA H100 SXM data sheet, dense: bf16 and int8 tensor cores, and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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

# The prefix-cache slice: internlm2-1.8b served from the block-table pool at
# the H100 policy for max_batch 8, max_prompt 128, max_new 32 (64 rows x 192
# deep, prompt buckets 64 / 128); the engine's block size falls back to the
# lattice under the empty tuning cache the run installs first: 64 tokens.
PREFIX_BLOCK = 64
# A pool of 40 blocks (of 192) makes the 32-request workload preempt 3 rows
# and resume them (the block trace depends on lengths and prompts only).
TIGHT_BLOCKS = 40
# The suffix prefill's K and V as written, every layer, against a cold
# prefill's: the two paths round every GEMM output to bf16 after summing
# in another order, as the logits do.
SUFFIX_KV_REL_BOUND = 0.05
# int8 weights against bf16 weights (prefill logits at full width and
# depth, random weights): the relative norm over all logits, and the worst
# vocabulary column's (one output channel of lm_head) relative norm, which
# a planted fault — that channel's scale doubled — must break.
QUANT_LOGITS_REL_BOUND = 0.1
QUANT_COLUMN_REL_BOUND = 0.5
FAULT_CHANNEL = 12345
# int8 kernels against their plain versions on the same int8 weights
# (prefill logits, full depth): both sides sum exactly in integers and
# de-scale by the same f32 products, so the logits agree to rounding only.
QUANT_PLAIN_REL_BOUND = 1e-6
# f32 token identity at reduced depth: a divergence passes only at a near
# tie of the reference's top-2 logits (relative gap).
REDUCED_LAYERS = 4
TOKEN_GAP_REL = 1e-4

# The SSM slice: mamba2-780m (arXiv:2405.21060) served statically at full
# width and depth, a prefill of 4 x 1024 tokens and 31 greedy decode steps;
# zamba2-2.7b (arXiv:2411.15242) at full width, its depth cut to 2 of its 9
# superblocks.
SSM_BATCH, SSM_PROMPT, SSM_GEN = 4, 1024, 32
HYBRID_SUPERBLOCKS = 2
# Prefill logits, kernel path vs plain path (bf16): both round every GEMM
# output and the SSM's elementwise steps to bf16 after summing in another
# order, and the kernel rounds C B^T o L to bf16 where the plain version
# keeps f32.  Over all positions:
SSM_LOGITS_REL_BOUND = 0.05
# ... and at the worst single (row, position), the same bound.  At bf16 it
# catches gross errors only: a doubled chunk state read 2.83e-2 against a
# sound 1.93e-2 on the card (PERF.md), both inside it.
SSM_POSITION_REL_BOUND = 0.05
# The worst position again at f32 (full width and depth), where the two
# paths differ by f32 sums in another order (~1e-6): a planted fault in the
# kernel's chunk state must break this bound.  At random init dt * A
# decays the state within a few steps, so a wrong chunk state shows only at
# the first positions of the next chunk, under the norm over all positions.
SSM_F32_POSITION_REL_BOUND = 1e-4
# seg's steps in the SSD kernel checks: [0, 1) as the JAX kernel's tests
# draw them, under which a key 65 or more steps back weighs at most e^-32
# (only the diagonal and the adjacent key tile count), and [0, SSD_SLOW_DECAY)
# as a trained Mamba2's dt in about [1e-3, 1e-1] gives them, under which
# every key tile and every row of S in a 256-step chunk counts (e^-5 at
# worst).
SSD_SLOW_DECAY = 0.02
# The prefill -> decode handoff: one decode step (the recurrent form) after
# a prefill of SSM_HANDOFF tokens against a prefill of SSM_HANDOFF + 1 (the
# chunked form), the worst row's last-position logits.
SSM_HANDOFF = 1000
SSM_HANDOFF_REL_BOUND = 0.05

# The SSM training slice: mamba2-780m trained at full width and depth on
# TRAIN_BATCH x TRAIN_SEQ tokens for TRAIN_STEPS steps, zamba2-2.7b at full
# width and HYBRID_SUPERBLOCKS superblocks for HYBRID_TRAIN_STEPS steps;
# their step-0 checks hold the kernel path to TRAIN_LOSS_REL_BOUND and
# TRAIN_GRAD_REL_BOUND at f32 and a trained model's slow decay, as the dense
# train phase's.
HYBRID_TRAIN_STEPS = 2
# ... and at bf16, the path as it trains, to this gradient bound (the loss
# bound is TRAIN_LOSS_REL_BOUND).  The roundings of the two paths (the
# forward kernel's bf16 C B^T o L, GEMM outputs summed in another order),
# carried through 48 layers, reach 5.49e-2 on mamba2-780m's sound
# gradients (A_log's layer slices, where the per-position terms cancel),
# above TRAIN_GRAD_REL_BOUND; zamba2-2.7b's 2 superblocks 2.24e-2.  Planted
# faults at bf16 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the last layer's
# dseg zeroed 1.03 (mamba2-780m) and 0.360 (zamba2-2.7b, whose layer slice
# is a superblock's 6 layers), one chunk's dX dropped 0.227 and 8.65e-2 (80
# heads), dB without its dS term 5.89e-2 and 3.00e-2.  The
# bound sits between the sound worst and the faults it must see (dseg, and
# dX on mamba2-780m); the other two hide in bf16 rounding and are held at
# f32 only.
SSM_BF16_GRAD_REL_BOUND = 0.1


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
        # (C7519 notes, the fences ptxas adds around register operands, left out)
        if ("registers" in line or "spill" in line or "Compiling entry" in line) and \
                "C7519" not in line:
            print(f"  ptxas: {line.strip()}")
    sass_check(Path(_build._nvcc()).parent / "cuobjdump", lib.path, lib.log)


# gemm_sm90_kernel<TM, TN, TA, TB, PAIRS, ACT, BWD, BATCH> (csrc/gemm_sm90.cuh)
GEMM_SM90 = "gemm_sm90_kernel"
# int8_sm90_kernel<TM, TN, ACT, T> (csrc/gemm_sm90_s8.cuh)
INT8_SM90 = "int8_sm90_kernel"
# ssd_chunk_sm90<PP> (csrc/ssd_chunk.cu, bf16)
SSD_SM90 = "ssd_chunk_sm90"
# paged_decode_sm90<DP, BKV, QUANT> (csrc/paged_decode.cu, bf16 q)
PAGED_SM90 = "paged_decode_sm90"
# ssd_bwd_keys / ssd_bwd_queries<DNW, SHARED> (csrc/ssd_chunk_bwd.cu, bf16)
SSD_BWD_KEYS, SSD_BWD_QUERIES = "ssd_bwd_keys", "ssd_bwd_queries"
# the warpgroup product each mainloop's SASS must issue: bf16 HGMMA, s8 IGMMA
PRODUCTS = {"flash_fwd_sm90": "HGMMA", "flash_bwd_sm90": "HGMMA", GEMM_SM90: "HGMMA",
            INT8_SM90: "IGMMA", SSD_SM90: "HGMMA", PAGED_SM90: "HGMMA", SSD_BWD_KEYS: "HGMMA",
            SSD_BWD_QUERIES: "HGMMA"}
# kernels that must not exist: bf16 instantiations of the f32-only FMA
# kernels (csrc/gemm_tile.cuh, csrc/fused_mlp_bwd.cu; bf16 runs on
# gemm_sm90), the int8 WMMA tile kernel that gemm_sm90_s8 replaced, the
# bf16 WMMA SSD kernel that ssd_chunk_sm90 replaced, the bf16 CUDA-core
# paged-decode body that paged_decode_sm90 replaced (its f32 one stays), and
# the bf16 CUDA-core SSD backward that ssd_bwd_keys / ssd_bwd_queries
# replaced (its f32 one stays)
OLD_KERNELS = ("gemm_tile_kernelI13__nv_bfloat16", "fused_mlp_bwd_kernelI13__nv_bfloat16",
               "int8_tile_kernel", "ssd_chunk_kernelI13__nv_bfloat16",
               "paged_decode_kernelI13__nv_bfloat16", "ssd_chunk_bwd_kernelI13__nv_bfloat16")
ACTS = {1: "swiglu", 2: "gelu", 3: "relu2"}


def gemm_instance(fn: str) -> str:
    """A readable name of a gemm_sm90_kernel, int8_sm90_kernel,
    ssd_chunk_sm90, paged_decode_sm90, ssd_bwd_keys or ssd_bwd_queries
    instantiation from its mangled template arguments: the kernel it serves,
    the tile and the layout (bf16) or output type (int8), the padded head
    dim (SSD, paged decode), or the dB / dC column slice and the scores'
    route (SSD backward)."""
    for walk in (SSD_BWD_KEYS, SSD_BWD_QUERIES):
        if walk in fn:
            dnw, shared = re.findall(r"L[ib](\d+)E", fn)[:2]
            return (f"ssd_chunk_bwd {walk[8:]} walk, {dnw}-column slices, "
                    f"{'shared C B^T' if shared == '1' else 'per head'}")
    if PAGED_SM90 in fn:
        dp, bkv, quant = re.findall(r"L[ib](\d+)E", fn)[:3]
        return f"paged_decode d<={dp} tile {bkv} {'int8' if quant == '1' else 'bf16'} pool"
    if SSD_SM90 in fn:
        pp, shared = re.findall(r"L[ib](\d+)E", fn)[:2]
        return f"ssd_chunk P<={pp} {'shared C B^T' if shared == '1' else 'per head'}"
    if INT8_SM90 in fn:
        tm, tn, act = (int(v) for v in re.findall(r"Li(\d+)E", fn)[:3])
        out = "bf16" if "__nv_bfloat16" in fn else "f32"
        kind = f"int8_fused_mlp {ACTS[act]}" if act else "int8_matmul"
        return f"{kind} {tm}x{tn} {out} out"
    tm, tn, ta, tb, pairs, act, bwd, batch = (int(v) for v in re.findall(r"L[ib](\d+)E", fn)[:8])
    if bwd:
        kind = f"fused_mlp_bwd {ACTS[act]}"
    elif act:
        kind = f"fused_mlp {ACTS[act]}"
    else:
        kind = f"matmul {'t' if ta else 'n'}{'t' if tb else 'n'}{' pair' if pairs == 2 else ''}"
    return f"{kind}{' expert-batched' if batch else ''} {tm}x{tn}"


def ptxas_report(log: str) -> dict:
    """{mangled name: {"registers": n, "spill": bytes stored + loaded,
    "serialized": whether ptxas serializes its wgmma (C7515: a non-wgmma
    instruction writes accumulators while products are in flight; C7511:
    too few registers for the products in flight; C7520: a product on a
    path that depends on the thread)}} from ptxas -v."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"C75(?:11|15|20)\).*function '(\w+)'", line)
        if m:
            out.setdefault(m.group(1), {"registers": None, "spill": 0})["serialized"] = True
            continue
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"registers": None, "spill": 0, "serialized": False})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_check(cuobjdump: Path, lib_path: Path, log: str) -> None:
    """The tensor-core kernels as compiled: each instantiation of the bf16
    flash forward and backward, of the bf16 GEMM mainloop behind the matmul,
    fused-MLP and fused-MLP-backward kernels, of the int8 mainloop behind
    the int8 GEMM and fused MLP, of the bf16 SSD chunk kernel, of the bf16
    paged-decode kernel and of the bf16 SSD backward's two walks must issue
    warpgroup products (HGMMA; IGMMA for int8) and stage its tiles with
    asynchronous copies (LDGSTS, cp.async; or UTMALDG, TMA); ptxas must
    report no spill and no serialized products for any GEMM, SSD, SSD
    backward or paged-decode instantiation; no kernel of the
    library may issue warp-level tensor products (HMMA: WMMA or mma.sync);
    and none of OLD_KERNELS may exist."""
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[:200]}")
    ops = ("HGMMA", "IGMMA", "LDGSTS", "UTMALDG")
    counts, fn, names, hmma = {}, None, set(), set()
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            names.add(fn)
            continue
        if fn and re.search(r"\bHMMA\b", line):
            hmma.add(fn)
        for kernel in PRODUCTS:
            if fn and kernel in fn:
                per = counts.setdefault(kernel, {}).setdefault(fn, dict.fromkeys(ops, 0))
                for op in ops:
                    per[op] += op in line
    for kernel, product in PRODUCTS.items():
        fns = counts.get(kernel, {})
        mm = [c[product] for c in fns.values()]
        ld = [c["LDGSTS"] + c["UTMALDG"] for c in fns.values()]
        print(f"  sass: {kernel}: {len(fns)} instantiations, {product} {min(mm, default=0)}-"
              f"{max(mm, default=0)} and LDGSTS/UTMALDG {min(ld, default=0)}-"
              f"{max(ld, default=0)} each")
        if not fns or min(mm) == 0 or min(ld) == 0:
            fail(f"{kernel}: an instantiation without wgmma or asynchronous copies in its SASS")
    ptx = ptxas_report(log)
    gemms = {**counts[GEMM_SM90], **counts[INT8_SM90], **counts[SSD_SM90], **counts[PAGED_SM90],
             **counts[SSD_BWD_KEYS], **counts[SSD_BWD_QUERIES]}
    for fn, c in sorted(gemms.items(), key=lambda kv: gemm_instance(kv[0])):
        rep = ptx.get(fn)
        if rep is None:
            fail(f"{gemm_instance(fn)}: no ptxas report for {fn}")
        product = PRODUCTS[INT8_SM90 if INT8_SM90 in fn else GEMM_SM90]
        print(f"    {gemm_instance(fn)}: {product} {c[product]}, LDGSTS {c['LDGSTS']}, UTMALDG "
              f"{c['UTMALDG']}; {rep['registers']} registers, {rep['spill']} bytes spilled"
              f"{', products SERIALIZED (C7511/C7515/C7520)' if rep['serialized'] else ''}")
        if rep["spill"] or rep["serialized"]:
            fail(f"{gemm_instance(fn)}: ptxas spills {rep['spill']} bytes or serializes its "
                 f"wgmma (C7511/C7515/C7520)")
    old = sorted(n for n in names if any(o in n for o in OLD_KERNELS))
    if old:
        fail(f"kernels that must not exist remain: {old}")
    print(f"  sass: {len(hmma)} kernels issue HMMA (WMMA / mma.sync)")
    if hmma:
        fail(f"kernels that still run warp-level tensor products: {sorted(hmma)}")


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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, what bounds it); `peak` is the rate of
    the operations' type."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
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
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "flops": 0.0}
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
        tot["flops"] += 2.0 * ROWS * k * n
        tot["err"] = max(tot["err"], err)
        del bs
    rows["matmul"] = dict(
        name="matmul", route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/kernel.py:35", max_abs_err=tot["err"],
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by="bytes",
        library_ms=tot["library_ms"])
    print(f"  matmul, one call at each shape: {tot['ms']:.4f} ms "
          f"(bound {tot['bound_ms']:.4f}, torch.matmul {tot['library_ms']:.4f}; "
          f"{gemm_rates(tot)})")

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
    print(f"    {ms:.4f} ms (plain {plain:.4f}, bound {bnd:.4f} by {by}; {live} live tokens; "
          f"{paged_pick(b, nkv, a // nkv, d, s_max, 2)}); 24 launches per decode step; host "
          f"{host:.1f} us per call")
    rows["paged_decode"] = dict(
        name="paged_decode", route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/flash_attention/paged.py:97", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    del pools
    paged_group_check(torch, randn, gen)
    paged_long_context(torch, randn, gen)
    return rows


def f32_kernel_phase(torch) -> None:
    """The f32 branches of the tile GEMM and the fused MLP (csrc/gemm_tile.cuh's
    FMA path, the dtype of the token-identity checks) at the serve shapes,
    against their plain versions, timed: they stay as they were while the
    bf16 branches run on csrc/gemm_sm90.cuh."""
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.tolerance import fused_mlp_hidden_tol, matmul_tol

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    print("kernels in f32 (the FMA path; CUDA events, weights rotated past L2):")
    total = 0.0
    for name, ((k, n), _) in MATMUL_SHAPES.items():
        a = randn(ROWS, k)
        bs = copies(torch, lambda: randn(k, n, scale=k ** -0.5), k * n * 4)
        want = matmul_ref(a, bs[0])
        compare(torch, matmul(a, bs[0]), want, matmul_tol(a, bs[0], want),
                f"matmul f32 {ROWS}x{k}x{n} ({name})")
        ms, _ = time_ms(torch, [lambda b=b: matmul(a, b) for b in bs])
        total += ms
        print(f"    {ms:.4f} ms")
        del bs
    h, f = 2048, 8192
    x = randn(ROWS, h)
    ws = copies(torch, lambda: (randn(h, f, scale=h ** -0.5), randn(h, f, scale=h ** -0.5)),
                2 * h * f * 4)
    want = fused_mlp_hidden_ref(x, *ws[0])
    compare(torch, fused_mlp_hidden(x, *ws[0]), want,
            fused_mlp_hidden_tol(x, *ws[0], "swiglu", want), f"fused_mlp_hidden f32 {ROWS}x{h}x{f}")
    ms_f, _ = time_ms(torch, [lambda w=w: fused_mlp_hidden(x, *w) for w in ws])
    print(f"    {ms_f:.4f} ms")
    print(f"  f32: matmul, one call at each shape {total:.4f} ms; fused_mlp_hidden {ms_f:.4f} ms")


def paged_group_check(torch, randn, gen) -> None:
    """The paged kernels at g = 12 (command-r-plus-104b and nemotron-4-340b:
    96 query heads over 8 kv heads), d 128: the slot and the block-table
    kernel over a bf16 and an int8 pool against their plain versions, and
    the slot kernel's time beside g = 2's over the same pool."""
    from repro_torch.kernels.flash_attention.ops import paged_decode, paged_decode_blocktable
    from repro_torch.kernels.flash_attention.ref import (paged_decode_blocktable_ref,
                                                         paged_decode_ref)
    from repro_torch.kernels.tolerance import paged_decode_blocktable_tol, paged_decode_tol
    from repro_torch.quant import quantize_kv

    dev = torch.device("cuda")
    b, a, nkv, d, s_max, bs = 16, 96, 8, 128, 256, 16
    q, q2 = randn(b, a, d), randn(b, 2 * nkv, d)
    kp, vp = randn(b, s_max, nkv, d), randn(b, s_max, nkv, d)
    (kq, ksc), (vq, vsc) = quantize_kv(kp.float()), quantize_kv(vp.float())
    slot_idx = torch.randperm(b, generator=gen, device=dev).to(torch.int32)
    lengths = torch.randint(1, s_max + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[3] = 0
    per_slot = s_max // bs   # the slot pool seen as blocks of bs tokens, slot-major
    tables = (slot_idx.long()[:, None] * per_slot
              + torch.arange(per_slot, device=dev)[None, :]).to(torch.int32)

    def blocks(t):
        return t.reshape(b * per_slot, bs, *t.shape[2:])

    for label, (K, V), sc in (("bf16", (kp, vp), {}),
                              ("int8", (kq, vq), dict(k_scale=ksc, v_scale=vsc))):
        want = paged_decode_ref(q, K, V, slot_idx, lengths, **sc)
        compare(torch, paged_decode(q, K, V, slot_idx, lengths, **sc), want,
                paged_decode_tol(q, K, V, slot_idx, lengths, want, **sc),
                f"paged_decode g=12 {label} b={b} a={a} nkv={nkv} d={d}")
        bsc = {n: blocks(t) for n, t in sc.items()}
        want = paged_decode_blocktable_ref(q, blocks(K), blocks(V), tables, lengths, **bsc)
        compare(torch, paged_decode_blocktable(q, blocks(K), blocks(V), tables, lengths, **bsc),
                want, paged_decode_blocktable_tol(q, blocks(K), blocks(V), tables, lengths, want,
                                                  **bsc),
                f"paged_decode_blocktable g=12 {label} block size {bs}")
    ms12, _ = time_ms(torch, [lambda: paged_decode(q, kp, vp, slot_idx, lengths)])
    ms2, _ = time_ms(torch, [lambda: paged_decode(q2, kp, vp, slot_idx, lengths)])
    plain12, _ = time_ms(torch, [lambda: paged_decode_ref(q, kp, vp, slot_idx, lengths)])
    plain2, _ = time_ms(torch, [lambda: paged_decode_ref(q2, kp, vp, slot_idx, lengths)])
    live = int(lengths.sum().item())
    bnd12 = bound(4.0 * a * d * live, 2.0 * (2 * b * a * d + 2 * live * nkv * d) + 8.0 * b)[0]
    bnd2 = bound(4.0 * 2 * nkv * d * live,
                 2.0 * (2 * b * 2 * nkv * d + 2 * live * nkv * d) + 8.0 * b)[0]
    print(f"    plain g=12 {plain12:.4f} ms, g=2 {plain2:.4f} ms; bound g=12 {bnd12:.4f} ms, "
          f"g=2 {bnd2:.4f} ms (bytes)")
    print(f"    slot kernel, bf16 pool ({int(lengths.sum().item())} live tokens): g=12 {ms12:.4f} "
          f"ms ({paged_pick(b, nkv, a // nkv, d, s_max, 2)}), g=2 {ms2:.4f} ms "
          f"({paged_pick(b, nkv, 2, d, s_max, 2)}) over the same K/V (each K/V tile read once "
          f"at both): {ms12 / ms2:.2f}x")


def paged_pick(b: int, nkv: int, g: int, d: int, capacity: int, itemsize: int) -> str:
    """The bf16 paged-decode kernel's launch at a shape, as the wrapper picks it."""
    from repro_torch.kernels.flash_attention.ops import paged_launch
    geo = paged_launch(b, nkv, g, d, capacity, itemsize)
    return f"tile {geo.tile} x {geo.splits} splits of {geo.split} tokens"


def paged_long_context(torch, randn, gen) -> None:
    """The slot kernel over a long context at internlm2-1.8b's heads: 16
    rows x 4096 live tokens of a bf16 pool (268 MB of K/V), against its
    plain version, timed beside its bytes bound and the rate it reads at."""
    from repro_torch.kernels.flash_attention.ops import paged_decode
    from repro_torch.kernels.flash_attention.ref import paged_decode_ref
    from repro_torch.kernels.tolerance import paged_decode_tol

    dev = torch.device("cuda")
    b, a, nkv, d, s_max = 16, 16, 8, 128, 4096
    q = randn(b, a, d)
    kp, vp = randn(b, s_max, nkv, d), randn(b, s_max, nkv, d)
    slot_idx = torch.randperm(b, generator=gen, device=dev).to(torch.int32)
    lengths = torch.full((b,), s_max, dtype=torch.int32, device=dev)
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths)
    compare(torch, paged_decode(q, kp, vp, slot_idx, lengths), want,
            paged_decode_tol(q, kp, vp, slot_idx, lengths, want),
            f"paged_decode long context b={b} a={a} nkv={nkv} d={d} {s_max} live tokens a row")
    ms, host = time_ms(torch, [lambda: paged_decode(q, kp, vp, slot_idx, lengths)])
    plain, _ = time_ms(torch, [lambda: paged_decode_ref(q, kp, vp, slot_idx, lengths)], iters=5)
    nbytes = 2.0 * b * s_max * nkv * d * 2 + 2.0 * 2 * b * a * d + 8.0 * b
    bnd, by = bound(4.0 * a * d * b * s_max, nbytes)
    print(f"    {ms:.4f} ms (plain {plain:.4f}, bound {bnd:.4f} by {by}; "
          f"{nbytes / ms / 1e6:.0f} GB/s, "
          f"{bnd / ms:.2f} of the bound's speed; {paged_pick(b, nkv, a // nkv, d, s_max, 2)}); "
          f"host {host:.1f} us per call")
    del kp, vp
    torch.cuda.empty_cache()


# --- kernel phase, training shapes -------------------------------------------------------

def _train_gemm_rows(torch, randn, rows) -> None:
    """The forward x @ w, dgrad g @ w^T and wgrad x^T @ g of every
    projection of `linear` at 4096 token rows (the gradients on transposed
    views), against matmul_ref and torch.matmul on the same operands; and
    each shape at every bf16 tile, beside the one `pick_tile` chose."""
    from repro_torch.kernels.matmul.ops import TILES, matmul, pick_tile
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.tolerance import matmul_tol

    for grad in ("forward", "dgrad", "wgrad"):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
               "step_ms": 0.0, "flops": 0.0}
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
            pm, pk = a.shape
            print(tile_sweep_line(forced_tile_ms(torch, ops, TILES), pick_tile(pm),
                                  2.0 * TOKENS * k * n, pk))
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("bound_ms", bnd), ("step_ms", ms * per_step),
                             ("flops", 2.0 * TOKENS * k * n)):
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
              f"{tot['bound_ms']:.4f}, torch.matmul {tot['library_ms']:.4f}; "
              f"{gemm_rates(tot)}); {tot['step_ms']:.2f} ms per step of linear's {grad} GEMMs")


def forced_tile_ms(torch, ops, tiles) -> dict:
    """{tile: ms} of the bf16 tile GEMM on the operand pairs `ops` (one
    call each in turn, as time_ms cycles them) with each output tile forced
    through the C entry, no split of k (these launches count nowhere)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul.ops import transposed
    a, b = ops[0]
    (m, k), n = a.shape, b.shape[1]
    ta, tb = int(transposed("a", a)), int(transposed("b", b))
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.build().lib
    stream = _build.stream_of(a.device)

    def call(pair, tm, tn):
        x, w = pair
        _build.check(lib.repro_matmul(_build.ptr(x), _build.ptr(w), None, None, _build.ptr(out),
                                      None, m, n, k, k, _build.DT_BF16, ta, tb, 1, tm, tn,
                                      stream), "matmul (forced tile)")

    return {(tm, tn): time_ms(torch, [functools.partial(call, o, tm, tn) for o in ops],
                              TRAIN_ITERS)[0] for tm, tn in tiles}


def tile_sweep_line(times: dict, picked, flops: float, k: int) -> str:
    """One shape's forced-tile times, rates and the bytes each tile's blocks
    stage into shared memory per second (its A rows and B columns over all
    of k, most from L2), and the tile the picker chose."""
    parts = []
    for (tm, tn), ms in times.items():
        staged = 2.0 * (flops / (2.0 * k * tm * tn)) * (tm + tn) * k
        parts.append(f"{tm}x{tn} {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s, "
                     f"{staged / ms / 1e9:.2f} TB/s staged)")
    best = min(times, key=times.get)
    return (f"      tiles: {'; '.join(parts)}; picked {picked[0]}x{picked[1]}"
            f"{'' if tuple(picked) == best else f', fastest {best[0]}x{best[1]}'}")


def gemm_rates(tot: dict) -> str:
    """A sum of GEMM calls as a rate, a share of its bound and a multiple of
    torch.matmul's time on the same operands."""
    return (f"{tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s, {tot['bound_ms'] / tot['ms']:.3f} "
            f"of the bound, {tot['ms'] / tot['library_ms']:.2f}x torch.matmul")


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
    print(f"    forward {ms:.4f} ms (plain {plain:.4f}, SDPA {sdpa_f:.4f}: {ms / sdpa_f:.2f}x, "
          f"bound {bnd:.4f} by {by}; {4.0 * pairs * d / ms / 1e9:.1f} TFLOP/s); 24 launches "
          f"per step")
    print(f"    backward {ms_b:.4f} ms (plain {plain_b:.4f}, SDPA forward+backward "
          f"{sdpa_fb:.4f} less its forward = {sdpa_b:.4f}: {ms_b / sdpa_b:.2f}x, bound "
          f"{bnd_b:.4f} by {by_b}; {10.0 * pairs * d / ms_b / 1e9:.1f} TFLOP/s); 24 launches "
          f"per step")
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:115", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=sdpa_f)
    rows["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
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


# gpt3-2.7b's attention at the paper's four head splits of d_model 2560
# (Fig. 1's C0-C3: query heads a at head dim d; multi-head, nkv = a).
GPT3_ATTENTION = {"C0": (32, 80), "C1": (64, 40), "C2": (40, 64), "C3": (20, 128)}
GPT3_BATCH, GPT3_SEQ = 4, 2048


def attention_table_phase(torch) -> None:
    """The attention half of the paper's Fig. 1 on the card: the flash
    forward and backward at gpt3-2.7b's C0-C3 (b 4, s 2048, causal, bf16),
    each checked against its plain version at b 1 (the plain version's f32
    scores at a = 64 take 1 GiB a tensor) and timed at b 4 beside SDPA and
    the bound at the true head dim (the kernels pad d in shared memory)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd,
                                                         flash_attention_fwd, flash_padded_d)
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)
    from repro_torch.kernels.tolerance import flash_attention_bwd_tol, flash_attention_tol

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s = GPT3_BATCH, GPT3_SEQ
    print(f"attention at gpt3-2.7b C0-C3 (d_model 2560, b {b}, s {s}, causal, bf16; CUDA events):")
    for name, (a, d) in GPT3_ATTENTION.items():
        q, k, v, do = (torch.randn((b, s, a, d), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        q1, k1, v1, do1 = q[:1], k[:1], v[:1], do[:1]
        want = flash_attention_ref(q1, k1, v1)
        out, lse = flash_attention_fwd(q1, k1, v1)
        t_out, t_lse = flash_attention_tol(q1, k1, v1, want)
        compare(torch, out, want[0], t_out, f"{name} flash_attention out b=1 a={a} d={d}")
        compare(torch, lse, want[1], t_lse, f"{name} flash_attention lse")
        del t_out, t_lse, out, lse
        gwant = flash_attention_bwd_ref(q1, k1, v1, *want, do1)
        got = flash_attention_bwd(q1, k1, v1, *want, do1)
        tols = flash_attention_bwd_tol(q1, k1, v1, *want, do1, gwant)
        for n_, g_, w_, t_ in zip(("dq", "dk", "dv"), got, gwant, tols):
            compare(torch, g_, w_, t_, f"{name} flash_attention_bwd {n_}")
        del want, gwant, got, tols
        torch.cuda.empty_cache()
        o, lse = flash_attention_fwd(q, k, v)
        ms, _ = time_ms(torch, [lambda: flash_attention_fwd(q, k, v)], TRAIN_ITERS)
        ms_b, _ = time_ms(torch, [lambda: flash_attention_bwd(q, k, v, o, lse, do)], TRAIN_ITERS)
        sdpa_f, sdpa_fb = _sdpa_ms(torch, q, k, v, do)
        pairs = b * a * s * (s + 1) // 2
        io = 2.0 * 4 * b * s * a * d                 # q, k, v, o
        bnd, by = bound(4.0 * pairs * d, io + 4.0 * b * a * s)
        bnd_b, by_b = bound(10.0 * pairs * d, 2.0 * io + 2.0 * b * s * a * d + 8.0 * b * a * s)
        print(f"  {name} a={a} d={d} (padded {flash_padded_d(d)}): forward {ms:.4f} ms (SDPA "
              f"{sdpa_f:.4f}: {ms / sdpa_f:.2f}x; bound {bnd:.4f} by {by}; "
              f"{4.0 * pairs * d / ms / 1e9:.1f} TFLOP/s at the true d); backward {ms_b:.4f} ms "
              f"(SDPA {sdpa_fb - sdpa_f:.4f}: {ms_b / (sdpa_fb - sdpa_f):.2f}x; bound "
              f"{bnd_b:.4f} by {by_b}; {10.0 * pairs * d / ms_b / 1e9:.1f} TFLOP/s)")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


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


def gemm_share(events, busy: float, what: str) -> None:
    """The bf16 GEMM mainloop's kernels (csrc/gemm_sm90.cuh: the tile GEMM,
    the fused MLP forward and the backward's recompute) and the split-k
    reduce, summed over a profile's device-side events, and their share of
    the device-busy time (s)."""
    for name in ("gemm_sm90_kernel", "splitk_reduce_kernel"):
        es = [e for e in events if name in e.key]
        ms = sum(e.self_device_time_total for e in es) / 1e3
        print(f"  {name} in the {what}: {ms:.2f} ms x{sum(e.count for e in es)} = "
              f"{100 * ms / 1e3 / busy:.1f}% of the device-busy time")


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

    t0 = time.perf_counter()
    averages = prof.key_averages()   # aggregated once: over ~10^5 events it takes seconds
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"  profiled rerun: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}% of it; {100 * busy / unprofiled_wall:.1f}% of the "
          f"unprofiled run's {unprofiled_wall:.3f} s), {stats.decode_steps} decode steps")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    shown = events[:10] + [e for e in events[10:] if "splitk_reduce" in e.key]
    for e in shown:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    gemm_share(events, busy, "profiled rerun")
    # the host side: operators by their own host time (launch and dispatch
    # cost, inflated by the profiler's per-op overhead)
    host = sorted(averages, key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"  host time by operator (summed self time "
          f"{sum(e.self_cpu_time_total for e in host) / 1e6:.3f} s):")
    for e in host[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    print(f"  (the profile's aggregation took {time.perf_counter() - t0:.1f} s)")


# --- the prefix-cache slice: kernels ------------------------------------------------------

def prefix_tables(b: int, bs: int, s_max: int, seed: int):
    """Block tables as the prefix engine builds them: a BlockPool takes 64
    rows' prompts of 72-128 tokens, 75% opening with one 64-token system
    prefix (shared blocks), each grown by 0-32 decode tokens; every 7th row
    is dead.  The physical ids are then relabelled by a random permutation.
    Returns (tables (b, s_max // bs) int32 numpy, lengths (b,), number of
    blocks); unallocated entries name the garbage block (id = blocks)."""
    import numpy as np
    from repro_torch.serving.engine import BlockPool
    rng = np.random.default_rng(seed)
    max_blocks = s_max // bs
    nb = b * max_blocks
    bp = BlockPool(nb, bs)
    shared = rng.integers(0, 92544, 64)
    seqs = []
    for r in range(b):
        if r % 7 == 3:
            seqs.append(None)
            continue
        plen = int(rng.integers(72, 129))
        toks = rng.integers(0, 92544, plen)
        if rng.random() < 0.75:
            toks[:64] = shared
        seq, _ = bp.alloc_sequence(toks.tolist())
        bp.commit(seq, toks.tolist())
        for _ in range(int(rng.integers(0, 33))):
            bp.prepare_append(seq)
            bp.advance(seq)
        seqs.append(seq)
    bp.check()
    perm = rng.permutation(nb)
    tables = np.full((b, max_blocks), nb, np.int32)
    for r, seq in enumerate(seqs):
        if seq is not None:
            tables[r, :len(seq.table)] = perm[seq.table]
    lengths = np.asarray([0 if s is None else s.length for s in seqs], np.int32)
    return tables, lengths, nb


def unique_tokens(tables, lengths, bs: int) -> int:
    """The (physical block, position) pairs the live rows read: a token of a
    shared block counts once."""
    return len({(int(tables[r, p // bs]), p % bs)
                for r, n in enumerate(lengths) for p in range(int(n))})


def unshared_tables(lengths, bs: int, max_blocks: int, nb: int, seed: int):
    """Tables for `lengths` in which every row owns its blocks: distinct
    physical ids, randomly permuted, out of `nb`; unallocated entries name
    the garbage block (id = nb)."""
    import numpy as np
    ids = np.random.default_rng(seed).permutation(nb).tolist()
    tables = np.full((len(lengths), max_blocks), nb, np.int32)
    for r, n in enumerate(lengths):
        for j in range(-(-int(n) // bs)):
            tables[r, j] = ids.pop()
    return tables


def prefix_kernel_phase(torch) -> dict:
    """The block-table kernel (bf16 pool), the slot kernel over an int8
    pool and the block-table kernel over an int8 pool, at the prefix serve
    phase's shapes (64 rows, 16 query / 8 kv heads, d 128, 64-token blocks,
    192 deep), against their plain versions; timed beside their bytes
    bound."""
    from repro_torch.kernels.flash_attention.ops import paged_decode, paged_decode_blocktable
    from repro_torch.kernels.flash_attention.ref import (paged_decode_blocktable_ref,
                                                         paged_decode_ref)
    from repro_torch.kernels.tolerance import paged_decode_blocktable_tol, paged_decode_tol
    from repro_torch.quant import quantize_kv

    import numpy as np
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    b, a, nkv, d, bs, s_max = 64, 16, 8, 128, PREFIX_BLOCK, 192
    tables_np, lengths_np, nb = prefix_tables(b, bs, s_max, seed=2)
    tables = torch.as_tensor(tables_np, device=dev)
    lengths = torch.as_tensor(lengths_np, device=dev)
    live = int(lengths_np.sum())
    unique = unique_tokens(tables_np, lengths_np, bs)
    used = int(sum(-(-int(n) // bs) for n in lengths_np))   # table entries the rows read
    first = tables_np[:, 0][lengths_np > 0]
    top = int(np.bincount(first).argmax())
    print(f"kernels at the prefix shapes (b={b} a={a} nkv={nkv} d={d}, {nb} blocks of {bs} "
          f"+ garbage, {live} live tokens over {unique} unique (block, position) pairs, "
          f"{int((lengths_np == 0).sum())} dead rows, {int((first == top).sum())} rows share "
          f"block {top}; CUDA events, pools rotated past L2):")
    q = (torch.randn((b, a, d), generator=gen, device=dev)).to(bf)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def int8_pair(shape):
        (k, ks), (v, vs) = quantize_kv(randn(*shape)), quantize_kv(randn(*shape))
        return k, v, ks, vs

    slot_idx = torch.randperm(b, generator=gen, device=dev).to(torch.int32)
    cases = [
        ("paged_decode_blocktable", "bf16 block pool",
         lambda: (randn(nb + 1, bs, nkv, d).to(bf), randn(nb + 1, bs, nkv, d).to(bf)),
         2 * (nb + 1) * bs * nkv * d * 2, paged_decode_blocktable, paged_decode_blocktable_ref,
         paged_decode_blocktable_tol, tables, 2),
        ("paged_decode_int8", "int8 slot pool", lambda: int8_pair((b, s_max, nkv, d)),
         2 * b * s_max * nkv * (d + 4), paged_decode, paged_decode_ref, paged_decode_tol,
         slot_idx, 1),
        ("paged_decode_blocktable_int8", "int8 block pool",
         lambda: int8_pair((nb + 1, bs, nkv, d)), 2 * (nb + 1) * bs * nkv * (d + 4),
         paged_decode_blocktable, paged_decode_blocktable_ref, paged_decode_blocktable_tol,
         tables, 1)]
    rows = {}
    for name, what, make, nbytes, fn, ref, tol_fn, index, el in cases:
        pools = copies(torch, make, nbytes)

        def args(p):
            kw = {} if len(p) == 2 else dict(k_scale=p[2], v_scale=p[3])
            return (q, p[0], p[1], index, lengths), kw

        a0, kw0 = args(pools[0])
        want = ref(*a0, **kw0)
        err = compare(torch, fn(*a0, **kw0), want, tol_fn(*a0, want, **kw0),
                      f"{name} ({what})")
        ms, host = time_ms(torch, [lambda p=p: (lambda a_, k_: fn(*a_, **k_))(*args(p))
                                   for p in pools])
        plain, _ = time_ms(torch, [lambda p=p: (lambda a_, k_: ref(*a_, **k_))(*args(p))
                                   for p in pools])
        # bytes: q in, out, the K and V (and an int8 pool's two scales) of
        # each token read, once — a block shared by several rows is read
        # from HBM once —, lengths, and the index: each row's table entries
        # of its live blocks (its own memory) or its slot id
        toks = unique if index is tables else live
        scales = 0 if el == 2 else 2 * 4 * toks * nkv
        entries = used if index is tables else b
        bnd, by = bound(4.0 * a * d * live, 2.0 * 2 * b * a * d + 2.0 * toks * nkv * d * el
                        + scales + 4.0 * b + 4.0 * entries)
        print(f"    {ms:.4f} ms (plain {plain:.4f}, bound {bnd:.4f} by {by}; "
              f"{paged_pick(b, nkv, a // nkv, d, s_max, el)}); 24 launches per decode step; "
              f"host {host:.1f} us per call")
        rows[name] = dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces=("src/repro/kernels/flash_attention/paged.py:160" if index is tables
                      else "src/repro/kernels/flash_attention/paged.py:97"),
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
        del pools
    # the table's own cost, apart from what sharing saves: the bf16
    # block-table kernel over a table that shares no block (each row its
    # own permuted blocks, the same lengths), against the float slot kernel
    # (the paged_decode row) at the same lengths; both read every live
    # token's K/V from HBM
    own = torch.as_tensor(unshared_tables(lengths_np, bs, s_max // bs, nb, seed=3), device=dev)
    timed = {}
    for label, make, nbytes, fn, ref, tol_fn, index in [
            ("paged_decode_blocktable (bf16 block pool, no shared block)",
             lambda: (randn(nb + 1, bs, nkv, d).to(bf), randn(nb + 1, bs, nkv, d).to(bf)),
             2 * (nb + 1) * bs * nkv * d * 2, paged_decode_blocktable,
             paged_decode_blocktable_ref, paged_decode_blocktable_tol, own),
            ("paged_decode (bf16 slot pool, the same lengths)",
             lambda: (randn(b, s_max, nkv, d).to(bf), randn(b, s_max, nkv, d).to(bf)),
             2 * b * s_max * nkv * d * 2, paged_decode, paged_decode_ref, paged_decode_tol,
             slot_idx)]:
        pools = copies(torch, make, nbytes)
        want = ref(q, *pools[0], index, lengths)
        compare(torch, fn(q, *pools[0], index, lengths), want,
                tol_fn(q, *pools[0], index, lengths, want), label)
        timed[fn], _ = time_ms(torch, [lambda p=p: fn(q, *p, index, lengths) for p in pools])
        print(f"    {timed[fn]:.4f} ms")
        del pools
    shared_ms = rows["paged_decode_blocktable"]["ms"]
    print(f"    the table's own cost: {timed[paged_decode_blocktable] / timed[paged_decode]:.3f}x "
          f"the slot kernel's time at {live} live tokens, no sharing; the shared table "
          f"({unique} unique tokens) takes {shared_ms / timed[paged_decode_blocktable]:.3f}x "
          f"the unshared one's")
    torch.cuda.empty_cache()
    return rows


# --- the prefix-cache slice: serving ------------------------------------------------------

def _linear_counters():
    """(label, function, counter attribute) of each GEMM / MLP kernel of the
    serving path: the bf16 pair and the int8 pair."""
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.quantized.ops import int8_fused_mlp_hidden, int8_matmul
    return [("matmul", matmul, "launches"), ("fused_mlp_hidden", fused_mlp_hidden, "launches"),
            ("int8_matmul", int8_matmul, "launches"),
            ("int8_fused_mlp", int8_fused_mlp_hidden, "launches")]


def _relayout_counters():
    """(label, function, counter attribute) of the int8 wrappers' weight
    relayouts (a row-major weight copied K-major on the call)."""
    from repro_torch.kernels.quantized.ops import int8_fused_mlp_hidden, int8_matmul
    return [("int8_matmul", int8_matmul, "relayouts"),
            ("int8_fused_mlp", int8_fused_mlp_hidden, "relayouts")]


def _decode_counters():
    """(label, function, counter attribute) of each paged decode variant."""
    from repro_torch.kernels.flash_attention.ops import paged_decode, paged_decode_blocktable
    return [("paged_decode", paged_decode, "launches"),
            ("paged_decode_int8", paged_decode, "int8_launches"),
            ("paged_decode_blocktable", paged_decode_blocktable, "launches"),
            ("paged_decode_blocktable_int8", paged_decode_blocktable, "int8_launches")]


def serve_run(torch, eng, reqs, label: str, decode_kernel: str, **kw):
    """One engine run with every kernel's count set to 0 just before it and
    read just after.  The counts must follow the path: per forward pass
    (prefills + decode steps) 5L + 1 GEMMs and L fused MLPs, on the tile GEMM
    and the bf16 fused MLP (linear_impl="fused") or the int8 kernels
    ("quantized") and none on the other pair; `decode_kernel` L per decode
    step and no other decode variant.  A roomy run must finish
    every request at its length.  No int8 weight may be relaid: the int8
    wrappers' relayout counters, set to 0 with the launch counts, must read
    0 after the run."""
    linear = _linear_counters()
    decs = _decode_counters()
    relays = _relayout_counters()
    for _, fn, attr in linear + decs + relays:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    done, stats = eng.run(reqs, **kw)
    torch.cuda.synchronize()
    counts = {n: getattr(fn, attr) for n, fn, attr in linear + decs}
    relaid = {n: getattr(fn, attr) for n, fn, attr in relays}
    L = eng.cfg.num_layers
    passes = stats.prefills + stats.decode_steps
    want = {n: 0 for n in counts}
    if eng.cfg.linear_impl == "quantized":
        want.update(int8_matmul=passes * (5 * L + 1), int8_fused_mlp=passes * L)
    else:
        want.update(matmul=passes * (5 * L + 1), fused_mlp_hidden=passes * L)
    want[decode_kernel] = stats.decode_steps * L
    print(f"  {label}: {stats.num_requests} requests, {stats.total_generated} tokens in "
          f"{stats.wall_s:.3f} s ({stats.prefills} prefills, {stats.decode_steps} decode steps"
          f", {stats.preemptions} preemptions, {stats.resumes} resumes)")
    print(f"    tok/s {stats.tok_s:.1f} | TTFT p50 {stats.ttft_p50_s * 1e3:.2f} ms p99 "
          f"{stats.ttft_p99_s * 1e3:.2f} ms (hit p50 {_ms(stats.ttft_hit_p50_s)}, cold p50 "
          f"{_ms(stats.ttft_cold_p50_s)}) | ITL p50 {stats.itl_p50_s * 1e3:.2f} ms p99 "
          f"{stats.itl_p99_s * 1e3:.2f} ms | cache_hit_rate {stats.cache_hit_rate:.3f}, "
          f"{stats.cached_tokens} cached of {stats.prompt_tokens} prompt tokens "
          f"({stats.cache_hit_requests} hit requests) | peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"    launches: {json.dumps({k: v for k, v in counts.items() if v or want[k]})}; "
          f"int8 weight relayouts: {json.dumps(relaid)}")
    if any(relaid.values()):
        fail(f"{label}: int8 weights relaid on the serve path: {relaid}")
    for name, n in counts.items():
        if n != want[name]:
            fail(f"{label}: {name}: {n} launches, the path implies {want[name]}")
    if not kw.get("check_invariants"):
        for r, c in zip(reqs, done):
            if c.rid != r.rid or c.finish_reason != "length" or len(c.tokens) != r.max_new_tokens:
                fail(f"{label}: request {r.rid}: {c.finish_reason} with {len(c.tokens)} of "
                     f"{r.max_new_tokens} tokens ({c.detail})")
    for c in done:
        if not all(0 <= t < eng.cfg.vocab_size for t in c.tokens):
            fail(f"{label}: request {c.rid}: token outside the vocabulary")
    return done, stats, counts


@contextlib.contextmanager
def _host_timed(obj, names):
    """Sum the host seconds spent in each named method of `obj` while the
    block runs (the methods are wrapped on the instance, then restored)."""
    spent = {n: 0.0 for n in names}

    def timed(name, real):
        def f(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return f

    for n in names:
        setattr(obj, n, timed(n, getattr(obj, n)))
    try:
        yield spent
    finally:
        for n in names:
            delattr(obj, n)


def _ms(s) -> str:
    return "n/a" if s is None else f"{s * 1e3:.2f} ms"


def _pool_bytes(eng) -> int:
    from repro_torch.serving.engine.kv_pool import seg_leaves
    return sum(t.numel() * t.element_size() for seg in eng.pool.caches for t in seg_leaves(seg))


def _prefix_requests(vocab: int):
    from repro_torch.serving.engine import synthetic_requests
    return synthetic_requests(32, pattern="burst", min_prompt=72, max_prompt=128, min_new=8,
                              max_new=32, vocab=vocab, prefix_share=0.75, shared_prefix_len=64,
                              seed=0)


def _prefix_engine(params, cfg, dev, **kw):
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.serving.engine import Engine
    eng = Engine(params, cfg, max_batch=8, max_prompt=128, max_new=32, use_paged_kernel=True,
                 hw=H100_SXM, device=dev, **kw)
    pol = eng.policy
    if (pol.num_slots, pol.seq_max) != (64, 192):
        fail(f"prefix policy: {pol.num_slots} rows x {pol.seq_max}, expected 64 x 192")
    if kw.get("prefix_cache") and eng.pool.block_size != PREFIX_BLOCK:
        fail(f"prefix engine picked block_size {eng.pool.block_size}, expected {PREFIX_BLOCK}")
    return eng


def prefix_serve_phase(torch) -> dict:
    """internlm2-1.8b at full width and depth (bf16, fused linear, paged
    kernels, H100 policy: 64 rows x 192, 64-token blocks) served from the
    block-table pool: a cold and a warm run of 32 burst requests (75% share
    a 64-token system prefix), the suffix-prefill logits check with its
    planted faults, a tight pool that must preempt and resume, the slot
    engine for comparison, and both engines with an int8 pool.  Returns the
    new decode variants' launches over their runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_lm

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), linear_impl="fused")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    reqs = _prefix_requests(cfg.vocab_size)
    eng = _prefix_engine(params, cfg, dev, prefix_cache=True)
    print(f"prefix serve: {cfg.name} L={cfg.num_layers}, {eng.policy.num_slots} rows x "
          f"{eng.policy.seq_max}, prompt buckets {list(eng.policy.prompt_buckets)}, "
          f"{eng.pool.blocks.num_blocks} blocks of {eng.pool.block_size} tokens (+ garbage); "
          f"{len(reqs)} burst requests, prompts {min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)}, 75% share a 64-token prefix")
    step_s = eng.calibrate_step_s()
    print(f"  calibrated decode step: {step_s * 1e3:.2f} ms; pool {_pool_bytes(eng) / 2**30:.3f}"
          f" GiB bf16")
    torch.cuda.reset_peak_memory_stats()
    with _host_timed(eng.pool, ("prepare_append", "tables")) as host_s:
        cold, cold_stats, counts = serve_run(torch, eng, reqs, "prefix cold",
                                             "paged_decode_blocktable", check_invariants=True)
    steps = max(cold_stats.decode_steps, 1)
    print(f"    host per decode step: prepare_append {host_s['prepare_append'] / steps * 1e6:.1f}"
          f" us ({cold_stats.total_generated - cold_stats.prefills} row appends in all), "
          f"block tables {host_s['tables'] / steps * 1e6:.1f} us")
    warm, warm_stats, _ = serve_run(torch, eng, reqs, "prefix warm", "paged_decode_blocktable")
    if not 0.0 < cold_stats.cache_hit_rate < warm_stats.cache_hit_rate:
        fail(f"cache_hit_rate cold {cold_stats.cache_hit_rate:.3f}, warm "
             f"{warm_stats.cache_hit_rate:.3f}: the cache must hit cold and more warm")
    eng.pool.blocks.check()
    profile_phase(torch, eng, reqs, warm_stats.wall_s)
    suffix_prefill_check(torch, eng, params, cfg, reqs)
    launches = {"paged_decode_blocktable": counts["paged_decode_blocktable"]}
    prefix_bytes = _pool_bytes(eng)
    del eng
    torch.cuda.empty_cache()

    tight = _prefix_engine(params, cfg, dev, prefix_cache=True, num_blocks=TIGHT_BLOCKS)
    done, stats, _ = serve_run(torch, tight, reqs, f"prefix tight ({TIGHT_BLOCKS} blocks, "
                               f"BlockPool.check() after every step)", "paged_decode_blocktable",
                               check_invariants=True)
    preempt_checks(done, stats, "bf16 full depth")
    print(f"    tokens vs the roomy run (printed; bounded in f32 below): {_agreement(cold, done)}")
    del tight

    slot = _prefix_engine(params, cfg, dev)
    sdone, _, _ = serve_run(torch, slot, reqs, "slot engine", "paged_decode")
    print(f"  bf16 full depth, prefix vs slot engine (printed, not bounded): "
          f"{_agreement(sdone, cold)}")
    pool_bytes = {"slot bf16": _pool_bytes(slot)}
    del slot
    torch.cuda.empty_cache()

    for prefix, kernel in ((True, "paged_decode_blocktable_int8"), (False, "paged_decode_int8")):
        kind = "prefix" if prefix else "slot"
        eng8 = _prefix_engine(params, cfg, dev, prefix_cache=prefix, kv_dtype="int8")
        torch.cuda.reset_peak_memory_stats()
        done8, _, c8 = serve_run(torch, eng8, reqs, f"int8 {kind} engine", kernel)
        launches[kernel] = c8[kernel]
        pool_bytes[f"{kind} int8"] = _pool_bytes(eng8)
        print(f"    tokens vs the bf16 {kind} engine (printed, not bounded): "
              f"{_agreement(cold if prefix else sdone, done8)}")
        del eng8
        torch.cuda.empty_cache()
    pool_bytes["prefix bf16"] = prefix_bytes
    print(f"  KV pool bytes ({cfg.num_layers} layers): " + ", ".join(
        f"{k} {v / 2**30:.3f} GiB" for k, v in sorted(pool_bytes.items())))
    del params
    torch.cuda.empty_cache()
    return launches


def suffix_prefill_check(torch, eng, params, cfg, reqs) -> None:
    """(a) One hit request's suffix prefill on the warm cache against a cold
    full prefill of the same prompt, bf16: the last-token logits within
    LOGITS_REL_BOUND (relative norm over the vocabulary), and the suffix's
    K and V as written (every layer) within SUFFIX_KV_REL_BOUND.  Two faults
    planted in the same call must each break one of the bounds: the cached
    prefix read one physical block off, and the start offset shifted by
    one."""
    import numpy as np
    from repro_torch.serving.engine.kv_pool import gather_blocks
    from repro_torch.serving.serve_step import make_prefill_step
    pool, dev, V = eng.pool, eng.device, cfg.vocab_size
    heads = [tuple(r.tokens[:64]) for r in reqs]
    r = next(r for r, h in zip(reqs, heads) if heads.count(h) > 1)
    tokens = np.asarray(r.tokens, np.int32)
    n = len(tokens)
    cold_logits, cold_caches = make_prefill_step(cfg, eng.policy.seq_max)(
        params, {"tokens": torch.as_tensor(tokens[None], device=dev)})
    row = pool.alloc()
    seq = pool.alloc_sequence(row, tokens)
    p = seq.num_cached
    if p != 64:
        fail(f"suffix check: request {r.rid} found {p} cached tokens, expected 64")
    suffix = tokens[p:]
    padded = np.zeros((1, eng.policy.prompt_bucket(len(suffix))), np.int32)
    padded[0, :len(suffix)] = suffix
    padded = torch.as_tensor(padded, device=dev)
    cl = cold_logits[:, :V].float()

    def reading(contig, start):
        logits, contig = eng._prefill(params, padded, len(suffix), start, contig)
        rel = ((logits[:, :V].float() - cl).norm() / cl.norm()).item()
        num = den = 0.0
        for seg, cseg in zip(contig, cold_caches):
            for name in ("k", "v"):
                got, want = seg[name][:, 0, p:n].float(), cseg[name][:, 0, p:n].float()
                num += (got - want).norm().item() ** 2
                den += want.norm().item() ** 2
        return rel, (num / den) ** 0.5

    off = pool._padded_table(seq)
    off[0] = (off[0] + 1) % pool.blocks.num_blocks
    readings = [
        ("sound", reading(pool.gather(row), p)),
        ("fault: the cached prefix read one block off",
         reading(gather_blocks(pool.caches, pool._ids(off), pool.max_blocks, pool.block_size), p)),
        ("fault: the start offset shifted by one", reading(pool.gather(row), p + 1))]
    pool.release(row)
    pool.blocks.check()
    print(f"  suffix prefill (request {r.rid}: {n} tokens, {p} cached, suffix {len(suffix)}) vs "
          f"a cold full prefill, bf16 (bounds: logits {LOGITS_REL_BOUND}, suffix K/V "
          f"{SUFFIX_KV_REL_BOUND}):")
    for what, (rel, kv) in readings:
        print(f"    {what}: logits rel {rel:.3e}, suffix K/V rel {kv:.3e}")
    rel, kv = readings[0][1]
    if rel > LOGITS_REL_BOUND or kv > SUFFIX_KV_REL_BOUND:
        fail("suffix prefill: the hit request's logits or K/V differ from a cold prefill")
    unseen = [w for w, (rel, kv) in readings[1:]
              if rel <= LOGITS_REL_BOUND and kv <= SUFFIX_KV_REL_BOUND]
    if unseen:
        fail(f"suffix prefill: the bounds do not see the planted faults {unseen}")


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def _agreement(ref_done, done) -> str:
    """How far two runs' tokens agree: identical requests, and the share of
    tokens before each request's first divergence."""
    same = sum(c.tokens == r.tokens for r, c in zip(ref_done, done))
    lead = sum(len(c.tokens) if _first_divergence(r.tokens, c.tokens) is None
               else _first_divergence(r.tokens, c.tokens) for r, c in zip(ref_done, done))
    total = sum(len(c.tokens) for c in done)
    return (f"identical {same}/{len(done)} requests, {100 * lead / max(total, 1):.1f}% of "
            f"tokens before the first divergence")


def preempt_checks(done, stats, label: str) -> None:
    """A tight run must preempt and resume, and end every request at its
    length or as preempted-retry-exhausted."""
    reasons = {}
    for c in done:
        reasons[c.finish_reason] = reasons.get(c.finish_reason, 0) + 1
    print(f"    {label}: {stats.preemptions} preemptions, {stats.resumes} resumes, "
          f"finish reasons {reasons}")
    if stats.preemptions <= 0 or stats.resumes <= 0:
        fail(f"{label}: the tight pool did not preempt and resume")
    if set(reasons) - {"length", "preempted-retry-exhausted"}:
        fail(f"{label}: finish reasons {reasons}")


def token_identity_phase(torch) -> None:
    """(b) At full width, f32 and REDUCED_LAYERS layers: greedy tokens
    identical between the slot engine and the prefix engine, roomy and
    tight (a partial of the tight run a prefix of the roomy tokens), and
    between the int8 slot and int8 prefix engines; with int8 weights
    (`quantize_linear_params` of the same params), between the slot and
    prefix engines, and between the slot and prefix engines over int8 KV.
    A divergence fails the run unless the top-2 logits at that step (the
    reference engine's config and params, a plain prefill of the agreed
    context) lie within TOKEN_GAP_REL relative of each other."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_lm
    from repro_torch.models.linear import quantize_linear_params
    from repro_torch.serving.serve_step import make_prefill_step

    import numpy as np
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), num_layers=REDUCED_LAYERS,
                              dtype="float32", linear_impl="fused")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    qparams = quantize_linear_params(params)
    qcfg = dataclasses.replace(cfg, linear_impl="quantized")
    reqs = _prefix_requests(cfg.vocab_size)
    print(f"token identity: {cfg.name} at full width, {REDUCED_LAYERS} layers, float32; "
          f"the prefix workload through nine engines (four with int8 weights)")
    runs = {}
    for label, kw, kernel in (
            ("slot", {}, "paged_decode"),
            ("prefix", dict(prefix_cache=True), "paged_decode_blocktable"),
            ("prefix tight", dict(prefix_cache=True, num_blocks=TIGHT_BLOCKS),
             "paged_decode_blocktable"),
            ("int8 slot", dict(kv_dtype="int8"), "paged_decode_int8"),
            ("int8 prefix", dict(prefix_cache=True, kv_dtype="int8"),
             "paged_decode_blocktable_int8"),
            ("int8-weight slot", {}, "paged_decode"),
            ("int8-weight prefix", dict(prefix_cache=True), "paged_decode_blocktable"),
            ("int8-weight int8 slot", dict(kv_dtype="int8"), "paged_decode_int8"),
            ("int8-weight int8 prefix", dict(prefix_cache=True, kv_dtype="int8"),
             "paged_decode_blocktable_int8")):
        p, c = (qparams, qcfg) if label.startswith("int8-weight") else (params, cfg)
        eng = _prefix_engine(p, c, dev, **kw)
        done, stats, _ = serve_run(torch, eng, reqs, f"f32 {label}", kernel,
                                   check_invariants=eng.prefix_cache)
        runs[label] = (done, stats, eng.cfg, p)
        del eng
    preempt_checks(runs["prefix tight"][0], runs["prefix tight"][1], "f32 prefix tight")

    def gap(ref_cfg, ref_params, r, agreed):
        ctx = torch.as_tensor(np.concatenate([r.tokens, np.asarray(agreed, np.int32)])[None],
                              device=dev)
        with torch.no_grad():
            logits, _ = make_prefill_step(ref_cfg, ctx.shape[1])(ref_params, {"tokens": ctx})
        top = logits[0, :cfg.vocab_size].float().topk(2).values
        return ((top[0] - top[1]) / top[0].abs()).item()

    for ref, other in (("slot", "prefix"), ("slot", "prefix tight"), ("int8 slot", "int8 prefix"),
                       ("int8-weight slot", "int8-weight prefix"),
                       ("int8-weight int8 slot", "int8-weight int8 prefix")):
        ref_done, _, ref_cfg, ref_params = runs[ref]
        for r, a, b in zip(reqs, ref_done, runs[other][0]):
            i = _first_divergence(a.tokens, b.tokens)
            if i is None and (b.finish_reason != "length" or len(b.tokens) == len(a.tokens)):
                continue
            if i is None:
                fail(f"{other} vs {ref}: request {r.rid} ended at {len(b.tokens)} tokens")
            g = gap(ref_cfg, ref_params, r, a.tokens[:i])
            print(f"    {other} vs {ref}: request {r.rid} diverges at token {i}; top-2 logit "
                  f"gap there {g:.3e} relative (near-tie bound {TOKEN_GAP_REL})")
            if g > TOKEN_GAP_REL:
                fail(f"{other} vs {ref}: request {r.rid} diverges at token {i} without a near "
                     f"tie")
        print(f"  f32 {other} vs {ref}: {_agreement(ref_done, runs[other][0])}")
    print(f"  f32 int8-weight slot vs slot (printed, not bounded): "
          f"{_agreement(runs['slot'][0], runs['int8-weight slot'][0])}")
    del params, qparams, runs
    torch.cuda.empty_cache()


# --- the int8-weight slice: kernels --------------------------------------------------------

def identical(torch, got, want, what: str) -> float:
    """The int8 GEMM's bound is zero: every element equal to the plain
    version's (exact integer sums, the same f32 de-scale).  Returns the
    largest absolute difference, as read."""
    torch.cuda.synchronize()
    differ = int((got != want).sum().item())
    err = float((got.float() - want.float()).abs().max().item()) if got.numel() else 0.0
    print(f"  {what}: {differ} of {got.numel()} elements differ from the plain version "
          f"(bound 0), max abs err {err:.3e}")
    if differ or not bool(torch.isfinite(got).all().item()):
        fail(f"{what}: kernel disagrees with its plain version")
    return err


def _int_mm_ms(torch, a_q, ws, iters=ITERS):
    """torch._int_mm (cuBLASLt) on the same int8 operands: the int32 product
    alone, without the de-scale, so it covers less work than the kernel.
    The port's weight is column-major ((k, n) K-major, the `.mT` view of a
    contiguous (n, k) tensor), which cuBLASLt takes as it is.  Returns (ms,
    its int32 sums of ws[0])."""
    ms, _ = time_ms(torch, [lambda w=w: torch._int_mm(a_q, w[0]) for w in ws], iters)
    return ms, torch._int_mm(a_q, ws[0][0])


def int8_kernel_phase(torch) -> dict:
    """The int8 GEMM and the int8 fused MLP against their plain versions on
    the card, at the int8-weight serve path's shapes: int8 operands as the
    wrappers make them (a bf16 activation per row, weights per output
    channel, held K-major as `quantize_weight` holds them), bf16 out.  The
    GEMM at each projection's shape at 64 rows (the decode step and the
    64-token prefill buckets alike), each beside its bound and the decode
    step's sum; at 16 and 32 rows (the smaller
    buckets) and at 4096 rows beside torch._int_mm, bit-identical; a
    row-major weight, relaid by the wrapper, counted and still exact; the
    fused SwiGLU hidden at 64 rows within its bound.  Returns their rows of
    the kernels line (without launch counts)."""
    from repro_torch.kernels.quantized.ops import (int8_fused_mlp_q, int8_matmul, int8_matmul_q,
                                                   launch_shape)
    from repro_torch.kernels.quantized.ref import int8_fused_mlp_ref, int8_matmul_ref
    from repro_torch.kernels.tolerance import int8_fused_mlp_tol
    from repro_torch.quant import quantize_int8, quantize_weight

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def act(rows, k):
        return quantize_int8(torch.randn((rows, k), generator=gen, device=dev).to(bf))

    def weight(k, n):
        w = quantize_weight(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        return w.q, w.scale

    def gemm_bytes(m, k, n):   # int8 operands, f32 scales, bf16 out
        return m * k + k * n + 4.0 * (m + n) + 2.0 * m * n

    rows = {}
    print(f"int8 kernels (int8 operands, weights K-major, bf16 out, CUDA events, weights rotated "
          f"past L2); card {nvidia_smi()}:")
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    step_ms = step_bound = 0.0
    err = 0.0
    for name, ((k, n), per_step) in MATMUL_SHAPES.items():
        a_q, a_s = act(ROWS, k)
        ws = copies(torch, lambda: weight(k, n), k * n)
        got = int8_matmul_q(a_q, a_s, *ws[0], bf)
        err = max(err, identical(torch, got, int8_matmul_ref(a_q, a_s, *ws[0], bf),
                                 f"int8_matmul {ROWS}x{k}x{n} ({name})"))
        ms, host = time_ms(torch, [lambda w=w: int8_matmul_q(a_q, a_s, *w, bf) for w in ws])
        plain, _ = time_ms(torch, [lambda w=w: int8_matmul_ref(a_q, a_s, *w, bf) for w in ws])
        lib, sums = _int_mm_ms(torch, a_q, ws)
        same = bool(torch.equal((sums.float() * a_s * ws[0][1]).to(bf), got))
        bnd, by = bound(2.0 * ROWS * k * n, gemm_bytes(ROWS, k, n), PEAK_INT8_OPS)
        tm, tn, ks = launch_shape(ROWS, n, k, sms)
        print(f"    {ms:.4f} ms = {ms / bnd:.2f}x its bound {bnd:.4f} (by {by}; tile {tm}x{tn}, "
              f"{-(-k // ks)} splits of {ks}); "
              f"plain {plain:.4f}, torch._int_mm {lib:.4f} [int32 product only; its sums "
              f"de-scaled {'equal' if same else 'DIFFER from'} the kernel's]; {per_step} "
              f"launches per decode step; host {host:.1f} us per call")
        if not same:
            fail(f"int8_matmul ({name}): cuBLASLt's int32 sums differ from the kernel's")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bnd)):
            tot[key] += val
        step_ms += per_step * ms
        step_bound += per_step * bnd
        del ws
    print(f"  int8_matmul, one call at each shape: {tot['ms']:.4f} ms = "
          f"{tot['ms'] / tot['bound_ms']:.2f}x the bound {tot['bound_ms']:.4f} (torch._int_mm "
          f"{tot['library_ms']:.4f} for less work); one decode step's 121 launches "
          f"{step_ms:.4f} ms against {step_bound:.4f}")

    # the 16- and 32-token prefill buckets (other split-K counts), bit-identical;
    # 4096 rows (the prompt of a long prefill), bit-identical and timed beside
    # torch._int_mm
    for m in (16, 32, TOKENS):
        long = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for name, ((k, n), _) in MATMUL_SHAPES.items():
            a_q, a_s = act(m, k)
            b_q, b_s = weight(k, n)
            got = int8_matmul_q(a_q, a_s, b_q, b_s, bf)
            err = max(err, identical(torch, got, int8_matmul_ref(a_q, a_s, b_q, b_s, bf),
                                     f"int8_matmul {m}x{k}x{n} ({name})"))
            del got
            if m != TOKENS:
                continue
            ms, _ = time_ms(torch, [lambda: int8_matmul_q(a_q, a_s, b_q, b_s, bf)], TRAIN_ITERS)
            lib, _ = _int_mm_ms(torch, a_q, [(b_q, b_s)], TRAIN_ITERS)
            bnd, by = bound(2.0 * m * k * n, gemm_bytes(m, k, n), PEAK_INT8_OPS)
            for key, val in (("ms", ms), ("library_ms", lib), ("bound_ms", bnd)):
                long[key] += val
            tm, tn, ks = launch_shape(m, n, k, sms)
            print(f"    {ms:.4f} ms ({2.0 * m * k * n / ms / 1e9:.1f} TOP/s; bound {bnd:.4f} "
                  f"by {by}; tile {tm}x{tn}, {-(-k // ks)} splits); torch._int_mm {lib:.4f} "
                  f"({2.0 * m * k * n / lib / 1e9:.1f} TOP/s, int32 product only): "
                  f"{ms / lib:.2f}x")
        if m == TOKENS:
            print(f"  int8_matmul at {m} rows, one call at each shape: {long['ms']:.4f} ms "
                  f"(bound {long['bound_ms']:.4f}), torch._int_mm {long['library_ms']:.4f}")
    torch.cuda.empty_cache()

    # a row-major (k, n) payload, as JAX holds it: relaid by the wrapper on
    # the call, counted, and still exact
    k, n = MATMUL_SHAPES["k/v"][0]
    a_q, a_s = act(ROWS, k)
    b_q, b_s = weight(k, n)
    before = int8_matmul.relayouts
    got = int8_matmul_q(a_q, a_s, b_q.contiguous(), b_s, bf)
    relaid = int8_matmul.relayouts - before
    err = max(err, identical(torch, got, int8_matmul_ref(a_q, a_s, b_q, b_s, bf),
                             f"int8_matmul {ROWS}x{k}x{n} (row-major weight, {relaid} relayout)"))
    if relaid != 1:
        fail(f"int8_matmul: a row-major weight counted {relaid} relayouts, not 1")
    rows["int8_matmul"] = dict(
        name="int8_matmul", route="cuda", source="src/repro_torch/kernels/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/quantized/kernel.py:52", max_abs_err=err, ms=tot["ms"],
        plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by="bytes",
        library_ms=tot["library_ms"])

    # int8 fused SwiGLU hidden: x (64, 2048) against the (2048, 8192) pair
    h, f = 2048, 8192
    x_q, x_s = act(ROWS, h)
    ws = copies(torch, lambda: (*weight(h, f), *weight(h, f)), 2 * h * f)
    want = int8_fused_mlp_ref(x_q, x_s, *ws[0], out_dtype=bf)
    err = compare(torch, int8_fused_mlp_q(x_q, x_s, *ws[0], out_dtype=bf), want,
                  int8_fused_mlp_tol(x_q, x_s, *ws[0], "swiglu", want),
                  f"int8_fused_mlp swiglu {ROWS}x{h}x{f}")
    ms, host = time_ms(torch, [lambda w=w: int8_fused_mlp_q(x_q, x_s, *w, out_dtype=bf)
                               for w in ws])
    plain, _ = time_ms(torch, [lambda w=w: int8_fused_mlp_ref(x_q, x_s, *w, out_dtype=bf)
                               for w in ws])
    bnd, by = bound(2.0 * 2 * ROWS * h * f, ROWS * h + 2.0 * h * f + 4.0 * (ROWS + 2 * f)
                    + 2.0 * ROWS * f, PEAK_INT8_OPS)
    print(f"    {ms:.4f} ms = {ms / bnd:.2f}x its bound {bnd:.4f} (by {by}); plain {plain:.4f}; "
          f"24 launches per decode step ({24 * ms:.4f} ms); host {host:.1f} us per call")
    rows["int8_fused_mlp"] = dict(
        name="int8_fused_mlp", route="cuda",
        source="src/repro_torch/kernels/csrc/int8_fused_mlp.cu",
        replaces="src/repro/kernels/quantized/kernel.py:121", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    del ws
    torch.cuda.empty_cache()
    return rows


# --- the int8-weight slice: serving ---------------------------------------------------------

def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _worst_column(got, want) -> float:
    """The largest relative error of one vocabulary column (one output
    channel of lm_head) over every row and position."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    return ((g - w).norm(dim=0) / w.norm(dim=0).clamp_min(1e-30)).max().item()


def _plain_int8():
    """Run the int8 kernels' plain versions on CUDA tensors for the duration
    (the wrappers' kernel entries replaced by the plain functions)."""
    from repro_torch.kernels.quantized import ops
    from repro_torch.kernels.quantized.ref import int8_fused_mlp_ref, int8_matmul_ref
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(ops, "_int8_matmul_cuda", lambda real: (
        lambda *args: int8_matmul_ref(*args[:5]))))
    stack.enter_context(_patched(ops, "_int8_fused_cuda", lambda real: (
        lambda *args: int8_fused_mlp_ref(*args[:6], mlp_type=args[6], out_dtype=args[7]))))
    return stack


def _param_bytes(tree) -> int:
    """Bytes of a param tree; a QuantizedTensor counts its payload and scales."""
    leaves = [x for _, t in _paths(tree)
              for x in ((t.q, t.scale) if isinstance(t, tuple) else (t,))]
    return sum(x.numel() * x.element_size() for x in leaves)


def quantized_serve_phase(torch) -> dict:
    """internlm2-1.8b at full width and depth, bf16 activations, every GEMM
    weight prequantized to int8 (`quantize_linear_params`), through the
    int8 kernels: the serve phase's 16-request burst on the slot engine
    (paged decode), launch counts per pass, where the time goes; prefill
    logits against the plain path on the same int8 weights and against the
    bf16 weights, with a planted fault; then the prefix engine over an int8
    KV pool on the prefix workload.  Returns the slot run's launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.models import apply_lm, init_lm
    from repro_torch.models.linear import quantize_linear_params
    from repro_torch.quant import QuantizedTensor
    from repro_torch.serving.engine import Engine, synthetic_requests

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), linear_impl="fused")
    qcfg = dataclasses.replace(cfg, linear_impl="quantized")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    t0 = time.perf_counter()
    qparams = quantize_linear_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    nbytes = {n: _param_bytes(p) for n, p in (("bf16", params), ("int8", qparams))}
    print(f"quantized serve: {qcfg.name} L={qcfg.num_layers}, bf16 activations, GEMM weights "
          f"int8 per output channel ({quant_s:.2f} s to quantize): weights "
          f"{nbytes['int8'] / 1e9:.3f} GB against {nbytes['bf16'] / 1e9:.3f} GB in bf16 (the bf16 embedding "
          f"{params['embed'].numel() * 2 / 1e9:.3f} GB stays); card {nvidia_smi()}")

    eng = Engine(qparams, qcfg, max_batch=8, max_prompt=64, max_new=32, use_paged_kernel=True,
                 hw=H100_SXM, device=dev)
    step_s = eng.calibrate_step_s()
    print(f"  calibrated decode step: {step_s * 1e3:.2f} ms; pool {_pool_bytes(eng) / 2**30:.3f} "
          f"GiB bf16")
    reqs = synthetic_requests(16, pattern="burst", min_prompt=16, max_prompt=64, min_new=8,
                              max_new=32, vocab=cfg.vocab_size, seed=0)
    torch.cuda.reset_peak_memory_stats()
    _, stats, counts = serve_run(torch, eng, reqs, "int8-weight slot engine", "paged_decode")
    profile_phase(torch, eng, reqs, stats.wall_s)
    del eng
    torch.cuda.empty_cache()

    # prefill logits: the kernel path against the plain path on the same int8
    # weights, and the int8 weights against the bf16 weights
    prompts = torch.as_tensor(synthetic_tokens(0, 0, 4, 64, cfg.vocab_size), device=dev).long()
    V = cfg.vocab_size
    with torch.no_grad():
        lk = apply_lm(qparams, prompts, qcfg)[0][..., :V]
        with _plain_int8():
            lp = apply_lm(qparams, prompts, qcfg)[0][..., :V]
        lb = apply_lm(params, prompts, cfg)[0][..., :V]
        head = qparams["lm_head"]
        scale = head.scale.clone()
        scale[..., FAULT_CHANNEL] *= 2.0
        lf = apply_lm({**qparams, "lm_head": QuantizedTensor(head.q, scale, head.axis)},
                      prompts, qcfg)[0][..., :V]
    if not all(bool(torch.isfinite(t).all().item()) for t in (lk, lp, lb, lf)):
        fail("quantized prefill logits not finite")
    rel = _rel(lk, lp)
    print(f"  prefill logits (4 x 64 tokens), int8 kernels vs their plain versions on the same "
          f"weights: rel err {rel:.3e} (bound {QUANT_PLAIN_REL_BOUND})")
    if rel > QUANT_PLAIN_REL_BOUND:
        fail(f"quantized prefill logits differ from the plain path by {rel:.3e}")
    readings = [("sound", lk), (f"fault: lm_head channel {FAULT_CHANNEL}'s scale x2", lf)]
    print(f"  int8 weights vs bf16 weights (bounds: logits rel {QUANT_LOGITS_REL_BOUND}, worst "
          f"vocabulary column {QUANT_COLUMN_REL_BOUND}):")
    for what, got in readings:
        agree = (got.argmax(-1) == lb.argmax(-1)).float().mean().item()
        print(f"    {what}: logits rel {_rel(got, lb):.3e}, worst column "
              f"{_worst_column(got, lb):.3e}, greedy agreement {agree:.3f}")
    if _rel(lk, lb) > QUANT_LOGITS_REL_BOUND or \
            _worst_column(lk, lb) > QUANT_COLUMN_REL_BOUND:
        fail("int8-weight logits too far from the bf16-weight logits")
    if _worst_column(lf, lb) <= QUANT_COLUMN_REL_BOUND:
        fail("the int8-vs-bf16 bounds do not see the planted scale fault")
    del lk, lp, lb, lf, params
    torch.cuda.empty_cache()

    eng8 = _prefix_engine(qparams, qcfg, dev, prefix_cache=True, kv_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    serve_run(torch, eng8, _prefix_requests(cfg.vocab_size),
              "int8-weight prefix engine over an int8 KV pool", "paged_decode_blocktable_int8",
              check_invariants=True)
    print(f"    pool {_pool_bytes(eng8) / 2**30:.3f} GiB int8")
    del eng8, qparams
    torch.cuda.empty_cache()
    return counts


# --- the SSM slice --------------------------------------------------------------------------

@contextlib.contextmanager
def _plain_ssd():
    """Run the SSD kernel's and its backward kernel's plain versions on CUDA
    tensors for the duration."""
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref, ssd_chunk_ref
    with _patched(ops, "_ssd_chunk_cuda", lambda real: (lambda *args: ssd_chunk_ref(*args))), \
            _patched(ops, "_ssd_chunk_bwd_cuda",
                     lambda real: (lambda *args: ssd_chunk_bwd_ref(*args))):
        yield


def _ssd_fault():
    """The kernel's chunk state S of chunk 1 doubled, in every layer."""
    from repro_torch.kernels.ssd import ops

    def wrap(real):
        def doubled(*args):
            y, s = real(*args)
            s = s.clone()
            s[..., 1, :, :] *= 2.0
            return y, s
        return doubled
    return _patched(ops, "_ssd_chunk_cuda", wrap)


def ssd_operands(torch, gen, b: int, s: int, nh: int, P: int, N: int, chunk: int, dtype,
                 step: float = 1.0):
    """x_dt, B, C, seg of one SSM layer's prefill as `apply_ssm` hands them
    to `ssd_chunk`: leading dims (b, 1 group, nh heads), x_dt a permuted view
    of (b, s, nh, P), B and C (b, s, N) expanded over the heads, seg the
    within-chunk cumulative sum of steps in (-step, 0] (step 1 as the JAX
    kernel's tests draw it: much faster decay than a trained model's, so
    only keys near the diagonal count; SSD_SLOW_DECAY for the whole
    chunk)."""
    dev = torch.device("cuda")
    Q = min(chunk, s)
    nc = s // Q
    x = (torch.randn((b, nc, Q, 1, nh, P), generator=gen, device=dev) * 0.5).to(dtype)
    B, C = ((torch.randn((b, nc, Q, 1, 1, N), generator=gen, device=dev) * 0.5).to(dtype)
            for _ in range(2))
    seg = -(torch.rand((b, nc, Q, 1, nh), generator=gen, device=dev) * step).cumsum(2)

    def heads(t):
        return t.permute(0, 3, 4, 1, 2, *range(5, t.dim()))
    return (heads(x), heads(B.expand(b, nc, Q, 1, nh, N)), heads(C.expand(b, nc, Q, 1, nh, N)),
            heads(seg))


def ssd_work(b: int, s: int, nh: int, P: int, N: int, chunk: int, elem: int):
    """(operations, bytes) of the SSD chunk function: the causal half of
    C B^T and of (C B^T o L) X, and S = B^T (decay o X); x_dt read and Y
    written once, B and C read once per group, seg read and S written."""
    Q = min(chunk, s)
    pairs, tri = b * nh * (s // Q), Q * (Q + 1) / 2
    flops = pairs * (2.0 * N * tri + 2.0 * P * tri + 2.0 * N * P * Q)
    nbytes = elem * (2 * b * s * nh * P + 2 * b * s * N + pairs * N * P) + 4 * b * s * nh
    return flops, nbytes


def _ssd_launch(ops):
    """The bf16 launch `ssd_chunk` makes for these operands (leading dims
    (b, 1 group, heads))."""
    from repro_torch.kernels.ssd.ops import launch_shape
    x, B, C, _ = ops
    nc, Q, P = x.shape[-3:]
    return launch_shape(tuple(x.shape[:3]), nc, B.stride()[:5], C.stride()[:5], Q, B.shape[-1], P)


def ssd_kernel_phase(torch) -> dict:
    """The SSD chunk kernel against its plain version at mamba2-780m's
    prefill shape (4 x 1024 tokens: 48 heads, 4 chunks of 256, P 64, N 128)
    at the JAX tests' decay and at SSD_SLOW_DECAY, at zamba2-2.7b's (80
    heads, N 64) at the slow decay, a ragged chunk (Q = 100) and a small
    misaligned shape, each in bf16 and f32, every element within
    `ssd_chunk_tol`; then timed at both prefill shapes in bf16 beside the
    bound and the plain version, with the launch `launch_shape` picked, and
    at mamba2-780m's in f32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssd.ops import ssd_chunk
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref
    from repro_torch.kernels.tolerance import ssd_chunk_tol

    shapes = {}
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        c = get_config(arch)
        shapes[arch] = (c.ssm_nheads, c.ssm_head_dim, c.ssm_state, c.ssm_chunk, c.num_layers)
    nh, P, N, chunk, layers = shapes["mamba2-780m"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"ssd kernels (mamba2-780m: {nh} heads, P {P}, N {N}, chunk {chunk}; B / C expanded "
          f"over the heads):")
    zh, zp, zn = shapes["zamba2-2.7b"][:3]
    err = 0.0
    for label, (b, s, h, p, n), step in (
            ("prefill 4 x 1024", (SSM_BATCH, SSM_PROMPT, nh, P, N), 1.0),
            ("prefill 4 x 1024, slow decay", (SSM_BATCH, SSM_PROMPT, nh, P, N), SSD_SLOW_DECAY),
            ("zamba2-2.7b prefill, slow decay", (SSM_BATCH, SSM_PROMPT, zh, zp, zn),
             SSD_SLOW_DECAY),
            ("ragged chunk Q=100", (SSM_BATCH, 100, nh, P, N), 1.0),
            ("misaligned Q=40 P=16 N=16", (2, 40, 3, 16, 16), 1.0)):
        for dtype in (torch.bfloat16, torch.float32):
            ops = ssd_operands(torch, gen, b, s, h, p, n, chunk, dtype, step)
            want = ssd_chunk_ref(*ops)
            got = ssd_chunk(*ops)
            for name, g, w, tol in zip(("Y", "S"), got, want, ssd_chunk_tol(*ops, want)):
                e = compare(torch, g, w, tol, f"ssd_chunk {label} {str(dtype)[6:]} {name}")
                if dtype == torch.bfloat16:     # the row's dtype
                    err = max(err, e)
            del ops, want, got
    b, s = SSM_BATCH, SSM_PROMPT
    rows = {}
    for arch, (h, p, n, q, nl) in shapes.items():
        flops, nbytes = ssd_work(b, s, h, p, n, q, 2)
        ops = copies(torch, lambda: ssd_operands(torch, gen, b, s, h, p, n, q, torch.bfloat16),
                     2 * b * s * (h * p + 2 * n))
        ms, host = time_ms(torch, [lambda o=o: ssd_chunk(*o) for o in ops])
        plain, _ = time_ms(torch, [lambda o=o: ssd_chunk_ref(*o) for o in ops], iters=TRAIN_ITERS)
        bnd, by = bound(flops, nbytes)
        ls = _ssd_launch(ops[0])
        print(f"    bf16 {arch} prefill shape ({h} heads, P {p}, N {n}): {ms:.4f} ms (plain "
              f"{plain:.4f}, bound {bnd:.4f} by {by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} "
              f"MB; {bnd / ms:.1%} of the bound's speed); launch {ls.heads} heads a block, C B^T "
              f"{'shared' if ls.shared else 'per head'}, {ls.grid} blocks of {ls.smem} B; "
              f"{nl} launches per prefill pass of the full model; host {host:.1f} us per call; "
              f"no single PyTorch call computes it")
        rows[arch] = (ms, plain, bnd, by)
        del ops
        torch.cuda.empty_cache()
    ops = copies(torch, lambda: ssd_operands(torch, gen, b, s, nh, P, N, chunk, torch.float32),
                 4 * b * s * (nh * P + 2 * N))
    ms32, _ = time_ms(torch, [lambda o=o: ssd_chunk(*o) for o in ops])
    print(f"    f32 mamba2-780m prefill shape (the FMA kernel, a check dtype): {ms32:.4f} ms")
    del ops
    torch.cuda.empty_cache()
    ms, plain, bnd, by = rows["mamba2-780m"]
    return {"ssd_chunk": dict(
        name="ssd_chunk", route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd/kernel.py:56", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bnd, bound_by=by, library_ms=None)}


def ssd_bwd_work(b: int, s: int, nh: int, P: int, N: int, chunk: int, elem: int):
    """(operations, bytes) of the SSD chunk gradient: the causal half of
    C B^T (once per group, one group) and, per head, of dY X^T, dC, dB and
    dX, and the chunk-state products B dS and X dS^T; x_dt, dY and dX once,
    B and C read and dB and dC written once per group (the function's
    gradient is per group: the kernel's per-head dB and dC, which autograd
    sums over the heads, are its design's own cost, `ssd_bwd_head_bytes`),
    dS read, seg and dseg."""
    Q = min(chunk, s)
    nc = s // Q
    pairs, tri = b * nh * nc, Q * (Q + 1) / 2
    flops = b * nc * 2.0 * N * tri + pairs * (2.0 * tri * (2 * P + 2 * N) + 4.0 * Q * N * P)
    nbytes = elem * (3 * b * s * nh * P + 4 * b * s * N + pairs * N * P) + 8 * b * s * nh
    return flops, nbytes


def ssd_bwd_head_bytes(b: int, s: int, nh: int, N: int, elem: int) -> int:
    """Bytes the backward kernel writes beyond `ssd_bwd_work`'s: dB and dC
    per head rather than per group (one group)."""
    return elem * 2 * b * s * (nh - 1) * N


def ssd_bwd_operands(torch, gen, *args):
    """`ssd_operands(torch, gen, *args)` and the cotangents dY (like x_dt)
    and dS (lead, nc, N, P): the backward's six operands."""
    x, B, C, seg = ssd_operands(torch, gen, *args)
    dY = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    dS = torch.randn((*x.shape[:-2], B.shape[-1], x.shape[-1]), generator=gen,
                     device=x.device).to(x.dtype)
    return x, B, C, seg, dY, dS


def ssd_bwd_kernel_phase(torch) -> dict:
    """The SSD backward kernel (csrc/ssd_chunk_bwd.cu) against its plain
    version at mamba2-780m's training shape (4 x 1024 tokens: 48 heads, 4
    chunks of 256, P 64, N 128, B / C expanded over one group) at the JAX
    tests' decay and at SSD_SLOW_DECAY, at zamba2-2.7b's (80 heads, N 64) at
    the slow decay, the forward phase's ragged chunk (Q = 100) and
    misaligned shape (Q 40, P 16, N 16), each in bf16 and f32, every element
    within `ssd_chunk_bwd_tol`; then timed at both training shapes in bf16
    beside the forward kernel at the same operands, the bound and the plain
    version."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssd.ops import bwd_launch_shape, ssd_chunk, ssd_chunk_bwd
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref
    from repro_torch.kernels.tolerance import ssd_chunk_bwd_tol

    shapes = {}
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        c = get_config(arch)
        shapes[arch] = (c.ssm_nheads, c.ssm_head_dim, c.ssm_state, c.ssm_chunk, c.num_layers)
    nh, P, N, chunk, layers = shapes["mamba2-780m"]
    zh, zp, zn = shapes["zamba2-2.7b"][:3]
    gen = torch.Generator(device="cuda").manual_seed(1)
    print(f"ssd backward (mamba2-780m: {nh} heads, P {P}, N {N}, chunk {chunk}; B / C expanded "
          f"over the heads; dB and dC per head):")
    err = 0.0
    for label, (b, s, h, p, n), step in (
            ("train 4 x 1024", (TRAIN_BATCH, TRAIN_SEQ, nh, P, N), 1.0),
            ("train 4 x 1024, slow decay", (TRAIN_BATCH, TRAIN_SEQ, nh, P, N), SSD_SLOW_DECAY),
            ("zamba2-2.7b train, slow decay", (TRAIN_BATCH, TRAIN_SEQ, zh, zp, zn),
             SSD_SLOW_DECAY),
            ("ragged chunk Q=100", (SSM_BATCH, 100, nh, P, N), 1.0),
            ("misaligned Q=40 P=16 N=16", (2, 40, 3, 16, 16), 1.0)):
        for dtype in (torch.bfloat16, torch.float32):
            ops = ssd_bwd_operands(torch, gen, b, s, h, p, n, chunk, dtype, step)
            want = ssd_chunk_bwd_ref(*ops)
            got = ssd_chunk_bwd(*ops)
            for name, g, w, tol in zip(("dX", "dB", "dC", "dseg"), got, want,
                                       ssd_chunk_bwd_tol(*ops, want)):
                e = compare(torch, g, w, tol, f"ssd_chunk_bwd {label} {str(dtype)[6:]} {name}")
                if dtype == torch.bfloat16:     # the row's dtype
                    err = max(err, e)
            del ops, want, got
            torch.cuda.empty_cache()
    b, s = TRAIN_BATCH, TRAIN_SEQ
    rows = {}
    for arch, (h, p, n, q, nl) in shapes.items():
        flops, nbytes = ssd_bwd_work(b, s, h, p, n, q, 2)
        ops = copies(torch, lambda: ssd_bwd_operands(torch, gen, b, s, h, p, n, q, torch.bfloat16),
                     2 * b * s * (2 * h * p + 2 * n) + 2 * b * s * h * n * p // min(q, s))
        ms, host = time_ms(torch, [lambda o=o: ssd_chunk_bwd(*o) for o in ops], iters=TRAIN_ITERS)
        fwd, _ = time_ms(torch, [lambda o=o: ssd_chunk(*o[:4]) for o in ops])
        plain, _ = time_ms(torch, [lambda o=o: ssd_chunk_bwd_ref(*o) for o in ops[:1]],
                           iters=TRAIN_ITERS // 4)
        bnd, by = bound(flops, nbytes)
        extra = ssd_bwd_head_bytes(b, s, h, n, 2)
        x, B, C = ops[0][:3]
        ls = bwd_launch_shape(tuple(x.shape[:3]), x.shape[3], B.stride()[:5], C.stride()[:5],
                              x.shape[4], n, p)
        print(f"    bf16 {arch} training shape ({h} heads, P {p}, N {n}): backward {ms:.4f} ms "
              f"(forward {fwd:.4f} ms at the same operands; plain {plain:.4f}; bound {bnd:.4f} by "
              f"{by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; {bnd / ms:.1%} of the "
              f"bound's speed, {ms / bnd:.1f}x the bound); the design's per-head dB and dC write "
              f"{extra / 1e6:.1f} MB more ({extra / HBM_BYTES_S * 1e3:.4f} ms at the memory "
              f"rate); two kernels (key walk, then query walk) of {ls.grid} blocks each, "
              f"{ls.heads} heads a block, C B^T {'shared' if ls.shared else 'per head'}, "
              f"at most {ls.smem} B; {nl} wrapper calls per training step of the full model; "
              f"host {host:.1f} us per call; no single PyTorch call computes it")
        rows[arch] = (ms, plain, bnd, by)
        del ops
        torch.cuda.empty_cache()
    ms, plain, bnd, by = rows["mamba2-780m"]
    return {"ssd_chunk_bwd": dict(
        name="ssd_chunk_bwd", route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        replaces="none: XLA autodiff of repro/models/ssm.py:136-145", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)}


def ssd_bwd_ab_phase() -> None:
    """With `--parent DIR` (a checkout of the parent commit): the SSD
    backward of the parent's tree and of this one in turns (parent, change,
    change, parent), each `tuning/ssd_bwd_tiles.py --times` in its own
    process against that tree's package (the bf16 backward at both training
    shapes, the f32 backward and the forward)."""
    script = str(ROOT / "src" / "repro_torch" / "tuning" / "ssd_bwd_tiles.py")
    trees = {"parent": Path(PARENT).resolve(), "change": ROOT}
    print(f"ssd backward a/b in turns (parent {trees['parent']}):")
    for name in ("parent", "change", "change", "parent"):
        env = {**os.environ, "PYTHONPATH": str(trees[name] / "src")}
        out = subprocess.run([sys.executable, script, "--times"], capture_output=True, text=True,
                             env=env, cwd=trees[name])
        if out.returncode:
            fail(f"ssd backward a/b: the {name} tree's times failed: {out.stderr[-2000:]}")
        for line in out.stdout.splitlines()[1:]:
            print(f"  {name}: {line.strip()}")


def _ssm_counters():
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.ssd.ops import ssd_chunk
    return {"matmul": matmul, "fused_mlp_hidden": fused_mlp_hidden, "ssd_chunk": ssd_chunk}


def _ssm_pass_launches(cfg) -> dict:
    """Kernel launches of one forward pass (prefill, or a decode step:
    `ssd_chunk` 0) under linear_impl="fused": six GEMMs per SSM layer, for
    zamba2 four attention GEMMs, one w_down GEMM and one fused MLP per
    superblock, and the head."""
    L = cfg.num_layers
    sb = L // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    return {"matmul": 6 * L + 5 * sb + 1, "fused_mlp_hidden": sb, "ssd_chunk": L}


def _ssm_timed(torch, what, fn, want, counters=None):
    """Run fn() with the counts (`counters`, default the SSM path's) set to
    0 just before and read just after; fail unless they equal `want`.
    Returns (fn's result, host s, device ms between CUDA events around it,
    counts)."""
    counters = counters or _ssm_counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: f.launches for n, f in counters.items()}
    if counts != want:
        fail(f"{what}: launches {counts}, the path implies {want}")
    return out, wall, e0.elapsed_time(e1), counts


def _kernel_device_ms(torch, fn):
    """Run fn() once with a pair of CUDA events around every tile GEMM,
    fused MLP and SSD launch and one pair around the whole.  Returns (the
    whole's device ms, {kernel: summed ms of its launches})."""
    from repro_torch.kernels.fused_mlp import ops as fused_ops
    from repro_torch.kernels.matmul import ops as matmul_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    pairs = {"matmul": [], "fused_mlp_hidden": [], "ssd_chunk": []}

    def timed(name):
        def wrap(real):
            def f(*args):
                e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e[0].record()
                out = real(*args)
                e[1].record()
                pairs[name].append(e)
                return out
            return f
        return wrap
    with contextlib.ExitStack() as stack:
        for module, fname, name in ((matmul_ops, "_matmul_cuda", "matmul"),
                                    (fused_ops, "_fused_cuda", "fused_mlp_hidden"),
                                    (ssd_ops, "_ssd_chunk_cuda", "ssd_chunk")):
            stack.enter_context(_patched(module, fname, timed(name)))
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
    return e0.elapsed_time(e1), {n: sum(a.elapsed_time(b) for a, b in p)
                                 for n, p in pairs.items() if p}


def _per_position(got, want):
    """||got - want|| / ||want|| over the vocabulary at each (row, position)."""
    g, w = got.float(), want.float()
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)


def ssm_serve(torch, cfg, label: str) -> tuple:
    """Static serving of `cfg` on the card, random weights from seed 0: a
    warm prefill of SSM_BATCH x SSM_PROMPT tokens, then a timed one and
    SSM_GEN - 1 greedy decode steps through serve_step, each run's launch
    counts against the path's; one more prefill with each kernel launch
    timed (`_kernel_device_ms`); then the prefill logits at every position,
    kernel path vs plain path (plain GEMMs and MLP, the SSD kernel's plain
    version) on the same weights and tokens.  Returns (params, prompts,
    launches over the timed prefill and decode steps)."""
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.models import apply_lm, init_lm
    from repro_torch.serving.serve_step import make_decode_step, make_prefill_step

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for _, t in _paths(params))
    print(f"{label}: {cfg.name} L={cfg.num_layers} d={cfg.d_model} d_inner={cfg.ssm_d_inner} "
          f"heads={cfg.ssm_nheads} P={cfg.ssm_head_dim} N={cfg.ssm_state} "
          f"chunk={cfg.ssm_chunk} vocab={cfg.vocab_size}; {nparams / 1e9:.3f} B params in "
          f"{cfg.dtype}, linear_impl={cfg.linear_impl} (init {time.perf_counter() - t0:.1f} s)")
    prompts = torch.as_tensor(synthetic_tokens(0, 0, SSM_BATCH, SSM_PROMPT, cfg.vocab_size),
                              device=dev).long()
    prefill = make_prefill_step(cfg, SSM_PROMPT + SSM_GEN)
    decode = make_decode_step(cfg)
    per_pass = _ssm_pass_launches(cfg)
    per_step = {**per_pass, "ssd_chunk": 0}
    V = cfg.vocab_size
    with torch.no_grad():
        prefill(params, {"tokens": prompts})   # warm
        (logits, caches), pre_s, pre_ms, counts = _ssm_timed(
            torch, f"{label} prefill", lambda: prefill(params, {"tokens": prompts}), per_pass)
        tok = torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)
        out, steps = [tok], []

        def run_decode():
            nonlocal tok
            for i in range(SSM_GEN - 1):
                t = time.perf_counter()
                lg, _ = decode(params, tok, caches, SSM_PROMPT + i)
                tok = torch.argmax(lg[:, :V], -1)[:, None].to(torch.int32)
                out.append(tok)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t)
        _, dec_s, dec_ms, dcounts = _ssm_timed(
            torch, f"{label} decode", run_decode,
            {n: (SSM_GEN - 1) * k for n, k in per_step.items()})
        toks = torch.cat(out, 1)
        if not bool(torch.isfinite(logits).all().item()) or not bool(
                ((toks >= 0) & (toks < V)).all().item()):
            fail(f"{label}: non-finite logits or a token outside the vocabulary")
        steps.sort()
        print(f"  prefill {SSM_BATCH} x {SSM_PROMPT}: {pre_s * 1e3:.2f} ms host, {pre_ms:.2f} ms "
              f"between CUDA events ({SSM_BATCH * SSM_PROMPT / pre_s:.0f} tok/s); "
              f"{SSM_GEN - 1} decode steps: {dec_s * 1e3:.1f} ms host, {dec_ms:.1f} ms between "
              f"events, step p50 {steps[len(steps) // 2] * 1e3:.2f} ms, max "
              f"{steps[-1] * 1e3:.2f} ms ({SSM_BATCH * (SSM_GEN - 1) / dec_s:.1f} tok/s); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"  launches per prefill pass {json.dumps(counts)}, per decode step "
              f"{json.dumps(per_step)} (as the path implies)")
        whole, kms = _kernel_device_ms(torch, lambda: prefill(params, {"tokens": prompts}))
        print(f"  one more prefill, CUDA events around each kernel launch: {whole:.2f} ms in "
              f"all; " + ", ".join(f"{n} {v:.2f} ms ({100 * v / whole:.1f}%)"
                                   for n, v in kms.items())
              + f"; the rest (eager PyTorch work and gaps) {whole - sum(kms.values()):.2f} ms")
        launches = {n: counts[n] + dcounts[n] for n in counts}
        del logits, caches
        plain_cfg = dataclasses.replace(cfg, linear_impl="jnp")
        lk = apply_lm(params, prompts, cfg)[0][..., :V]
        with _plain_ssd():
            lp = apply_lm(params, prompts, plain_cfg)[0][..., :V]
        if not (bool(torch.isfinite(lk).all().item()) and bool(torch.isfinite(lp).all().item())):
            fail(f"{label}: prefill logits not finite")
        rel, pos = _rel(lk, lp), _per_position(lk, lp)
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        worst = int(pos.argmax().item())
        print(f"  prefill logits, kernel path vs plain path: rel err {rel:.3e} (bound "
              f"{SSM_LOGITS_REL_BOUND}); worst position {pos.max().item():.3e} at row "
              f"{worst // SSM_PROMPT}, position {worst % SSM_PROMPT} (bound "
              f"{SSM_POSITION_REL_BOUND}); greedy agreement {agree:.3f}")
        if rel > SSM_LOGITS_REL_BOUND or pos.max().item() > SSM_POSITION_REL_BOUND:
            fail(f"{label}: prefill logits differ from the plain path")
    return params, prompts, launches


def slow_decay_dt_bias(shape, seed: int):
    """dt_bias (f32 numpy) with softplus(dt_bias) log-uniform in [1e-3, 1e-1],
    as a trained Mamba2's dt: at random init (dt_bias 0, dt ~ 0.7) the state
    decays within a few steps, so a chunk's state barely reaches the next."""
    import numpy as np
    u = np.exp(np.random.default_rng(seed).uniform(np.log(1e-3), np.log(1e-1), size=shape))
    return np.log(np.expm1(u)).astype(np.float32)


def ssm_serve_phase(torch) -> dict:
    """mamba2-780m at full width and depth, bf16, linear_impl="fused": the
    static serve path (`ssm_serve`); the worst-position logits check at
    f32, at random init and at a trained model's slow decay
    (`slow_decay_dt_bias`), which a planted fault in the kernel's chunk
    state must break at each; the
    prefill -> decode handoff (one decode step after a prefill of
    SSM_HANDOFF tokens against a prefill of one token more), with a planted
    fault (zeroed conv tails) that its bound must see.  Returns the
    launches over the serve run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import apply_lm, init_lm
    from repro_torch.serving.serve_step import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_config("mamba2-780m"), linear_impl="fused")
    params, prompts, launches = ssm_serve(torch, cfg, "ssm serve")
    V = cfg.vocab_size
    with torch.no_grad():
        f32 = dataclasses.replace(cfg, dtype="float32")
        p32 = init_lm(torch.Generator(device="cuda").manual_seed(0), f32, device="cuda")
        for decay in ("random init", "slow decay"):
            if decay == "slow decay":
                p32["seg0"]["ssm"]["dt_bias"].copy_(torch.from_numpy(
                    slow_decay_dt_bias(tuple(p32["seg0"]["ssm"]["dt_bias"].shape), seed=0)))
            lk = apply_lm(p32, prompts, f32)[0][..., :V]
            with _plain_ssd():
                lp = apply_lm(p32, prompts,
                              dataclasses.replace(f32, linear_impl="jnp"))[0][..., :V]
            with _ssd_fault():
                lf = apply_lm(p32, prompts, f32)[0][..., :V]
            readings = {}
            for what, got in (("sound", lk), ("planted fault", lf)):
                pos = _per_position(got, lp)
                readings[what] = pos.max().item()
                print(f"  f32, {f32.num_layers} layers, {decay}, kernel path vs plain path, "
                      f"{what}: rel {_rel(got, lp):.3e}, worst position {readings[what]:.3e} at "
                      f"position {int(pos.argmax().item()) % SSM_PROMPT} (bound "
                      f"{SSM_F32_POSITION_REL_BOUND})")
            if readings["sound"] > SSM_F32_POSITION_REL_BOUND:
                fail(f"f32 prefill logits ({decay}) differ from the plain path at some position")
            if readings["planted fault"] <= SSM_F32_POSITION_REL_BOUND:
                fail(f"the worst-position bound does not see the planted chunk-state fault "
                     f"({decay})")
            del lk, lp, lf
        del p32

        s = SSM_HANDOFF
        ctx = prompts[:, :s + 1]
        want, _ = make_prefill_step(cfg, s + 1)(params, {"tokens": ctx})
        readings = {}
        for what, tails in (("sound", False), ("fault: zeroed conv tails", True)):
            _, caches = make_prefill_step(cfg, s + 1)(params, {"tokens": ctx[:, :s]})
            if tails:
                for seg in caches:
                    for name in ("conv_x", "conv_B", "conv_C"):
                        seg[name].zero_()
            got, _ = make_decode_step(cfg)(params, ctx[:, s:], caches, s)
            readings[what] = _per_position(got[:, :V], want[:, :V]).max().item()
        print(f"  handoff: a decode step after a prefill of {s} tokens vs a prefill of {s + 1}, "
              f"worst row's logits rel err: sound {readings['sound']:.3e}, planted fault "
              f"{readings['fault: zeroed conv tails']:.3e} (bound {SSM_HANDOFF_REL_BOUND})")
        if readings["sound"] > SSM_HANDOFF_REL_BOUND:
            fail("prefill -> decode handoff: the decode step disagrees with a longer prefill")
        if readings["fault: zeroed conv tails"] <= SSM_HANDOFF_REL_BOUND:
            fail("the handoff bound does not see the zeroed conv tails")
    del params
    torch.cuda.empty_cache()
    return launches


def hybrid_serve_phase(torch) -> None:
    """zamba2-2.7b at full width, HYBRID_SUPERBLOCKS superblocks (6 Mamba2
    layers and the shared attention + GELU MLP block each), bf16,
    linear_impl="fused": `ssm_serve` (launch counts per prefill pass and
    decode step, kernel vs plain logits)."""
    from repro_torch.configs.registry import get_config
    full = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(full, linear_impl="fused",
                              num_layers=HYBRID_SUPERBLOCKS * full.hybrid_attn_every)
    ssm_serve(torch, cfg, f"hybrid serve ({HYBRID_SUPERBLOCKS} of "
                          f"{full.num_layers // full.hybrid_attn_every} superblocks)")
    torch.cuda.empty_cache()


def ssm_token_identity_phase(torch) -> None:
    """mamba2-780m at full width, REDUCED_LAYERS layers, float32: the greedy
    tokens of the kernel path (tile GEMM, SSD kernel) and of the plain path,
    SSM_BATCH prompts of 300 tokens (a ragged last chunk) and 16 new tokens,
    identical but at a near tie of the plain path's top-2 logits."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.kernels.ssd.ops import ssd_chunk
    from repro_torch.models import init_lm
    from repro_torch.serving.serve_step import greedy_generate, make_prefill_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=REDUCED_LAYERS,
                              dtype="float32", linear_impl="fused")
    plain_cfg = dataclasses.replace(cfg, linear_impl="jnp")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    prompts = torch.as_tensor(synthetic_tokens(0, 1, SSM_BATCH, 300, cfg.vocab_size),
                              device=dev).long()
    ssd_chunk.launches = 0
    got = greedy_generate(params, cfg, prompts, 16).cpu().numpy()
    if ssd_chunk.launches != REDUCED_LAYERS:
        fail(f"ssm token identity: {ssd_chunk.launches} SSD launches, the path implies "
             f"{REDUCED_LAYERS}")
    with _plain_ssd():
        want = greedy_generate(params, plain_cfg, prompts, 16).cpu().numpy()
        for r, (a, b) in enumerate(zip(want, got)):
            i = _first_divergence(list(a), list(b))
            if i is None:
                continue
            ctx = torch.cat([prompts[r:r + 1], torch.as_tensor(a[None, :i], device=dev).long()], 1)
            with torch.no_grad():
                lg, _ = make_prefill_step(plain_cfg, ctx.shape[1])(params, {"tokens": ctx})
            top = lg[0, :cfg.vocab_size].topk(2).values
            g = ((top[0] - top[1]) / top[0].abs()).item()
            print(f"    row {r} diverges at token {i}; top-2 gap {g:.3e} (near-tie bound "
                  f"{TOKEN_GAP_REL})")
            if g > TOKEN_GAP_REL:
                fail(f"ssm token identity: row {r} diverges at token {i} without a near tie")
    same = int(np.sum(np.all(want == got, axis=1)))
    print(f"ssm token identity: {cfg.name} at full width, {REDUCED_LAYERS} layers, float32: "
          f"kernel path vs plain path, {same}/{SSM_BATCH} rows identical over 16 tokens")
    del params
    torch.cuda.empty_cache()


# --- the MoE slice ------------------------------------------------------------------------

# deepseek-v3-671b (arXiv:2412.19437) at full width (d 7168; MLA, 128 heads,
# q_lora 1536, kv_lora 512, nope 128, rope 64, v 128; dense d_ff 18432; 256
# experts of 2048, top-8, 1 shared; vocab 129280), its 61 layers cut to
# MOE_DEEPSEEK_LAYERS (the 3 leading dense layers and 1 MoE layer, ~15.8 B
# parameters with the MTP head) for one card, served by serve_step (the
# engines refuse MLA, as JAX's do): a prefill of MOE_BATCH x MOE_PROMPT
# tokens and MOE_GEN - 1 greedy decode steps.  llama4-maverick-400b-a17b
# (hf:meta-llama/Llama-4-Maverick-17B-128E) at full width (d 5120, 40 / 8
# heads of 128, dense d_ff 16384, 128 experts of 8192, top-1, 1 shared,
# vocab 202048), its 48 layers cut to MOE_LLAMA4_PAIRS [moe, dense] pair
# (~18.7 B parameters), served by the slot engine on the serve cell's burst
# and by the prefix engine on the prefix cell's workload.
MOE_DEEPSEEK_LAYERS = 4
MOE_LLAMA4_PAIRS = 1
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 1024, 32
# f32 token identity: deepseek-v3 cut further, to 2 layers (1 dense, 1 MoE),
# so the f32 weights (~51 GB) and a 4 x 1024-token prefill fit the card
MOE_F32_DEEPSEEK_LAYERS = 2
# The batched expert launches at the path's shapes: (experts, capacity rows,
# h, f) of each MoE cell's expert stacks (capacity: repro's `_capacity` of
# the tokens of one pass: deepseek-v3's decode step of 4 rows and prefill
# of 4 x 1024 tokens, llama4-maverick's 64-slot decode step and 64-token
# prefill bucket).
MOE_EXPERT_SHAPES = {"deepseek-v3 decode": (256, 8, 7168, 2048),
                     "deepseek-v3 prefill": (256, 160, 7168, 2048),
                     "llama4-maverick": (128, 8, 5120, 8192)}
EXPERT_CHUNK = 16          # experts per slice of a plain-version check (bounds its memory)
EXPERT_ITERS = 10          # timed calls of a batched launch (1-10 ms each)
# Prefill logits, kernel path vs plain path (bf16), over all positions, and
# at the worst (row, position) whose routing agrees between the two paths
# up to it: both paths round every GEMM output to bf16 after summing in
# another order, and a token whose top-k set (or kept entries) differs
# between the two, at a near tie of its router probabilities, takes other
# experts, which attention carries to the row's later positions (so those
# positions are left out of the second bound, and counted).  Bounds set
# from the card's readings (PERF.md).
MOE_LOGITS_REL_BOUND = 0.05
MOE_POSITION_REL_BOUND = 1.5e-2
# lm_loss, aux_loss and mtp_loss (deepseek-v3, 4 x 1024 tokens), kernel path
# vs plain path, each relative: sound readings 5.1e-6 to 9.3e-6 (PERF.md).
# The planted faults MOE_LOSS_FAULTS must each move one of them past it
# (the gates reach every token's MoE output, the router every aux term);
# one expert's w_down doubled is printed, not held: it moves ~160 of 32,768
# entries, and a mean over 4,096 tokens' losses hides that in rounding (the
# logits check holds that fault).
MOE_LOSS_REL_BOUND = 3e-5
MOE_LOSS_FAULTS = ("gates", "router")
# The MLA handoff: a decode step after a prefill of MLA_HANDOFF tokens
# against a prefill of MLA_HANDOFF + 1, the worst row's last-position
# logits (rows whose last token had an expert entry dropped in the longer
# prefill left out: its capacity depends on the whole batch).
MLA_HANDOFF = 1000
MLA_HANDOFF_REL_BOUND = 0.01
# f32 token identity, kernel path vs plain path: a divergence passes only at
# a near tie of the top-2 logits (TOKEN_GAP_REL) or of a router's k-th and
# (k+1)-th probabilities (relative gap).
ROUTER_GAP_REL = 1e-4


def _moe_counters():
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden, fused_mlp_hidden_expert
    from repro_torch.kernels.matmul.ops import matmul, matmul_expert
    return {"matmul": matmul, "fused_mlp_hidden": fused_mlp_hidden,
            "matmul_expert": matmul_expert, "fused_mlp_hidden_expert": fused_mlp_hidden_expert}


def moe_pass_launches(cfg) -> dict:
    """Kernel launches of one forward pass (a prefill, or a decode step)
    under linear_impl="fused": per attention layer 6 tile GEMMs (MLA:
    wq_down, wq_up, wkv_down, wk_up, wv_up, wo) or 4 (GQA); per dense layer
    the fused MLP and its w_down GEMM; per MoE layer the router GEMM, one
    batched fused hidden and one batched w_down GEMM, and the shared
    expert's fused MLP and w_down GEMM; the head."""
    L = cfg.num_layers
    n_moe = sum(cfg.is_moe_layer(i) for i in range(L))
    attn = 6 if cfg.attn_type == "mla" else 4
    shared = 1 if cfg.num_shared_experts else 0
    return {"matmul": attn * L + (L - n_moe) + n_moe * (1 + shared) + 1,
            "fused_mlp_hidden": (L - n_moe) + n_moe * shared,
            "matmul_expert": n_moe, "fused_mlp_hidden_expert": n_moe}


def _moe_device_ms(torch, fn):
    """fn() once with a pair of CUDA events around every tile GEMM, fused
    MLP and batched expert launch, and one pair around the whole.  Returns
    (the whole's device ms, {what: summed ms}); a tile GEMM of more than 64
    rows in a decode step is MLA's decompression (k_nope and v from the
    whole cached latent)."""
    from repro_torch.kernels.fused_mlp import ops as fused_ops
    from repro_torch.kernels.matmul import ops as matmul_ops
    pairs = {}

    def timed(name, rows=None):
        def wrap(real):
            def f(*args, **kw):
                e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e[0].record()
                out = real(*args, **kw)
                e[1].record()
                key = name if rows is None else rows(args)
                pairs.setdefault(key, []).append(e)
                return out
            return f
        return wrap
    with contextlib.ExitStack() as stack:
        for module, fname, name, rows in (
                (matmul_ops, "_matmul_cuda", None, lambda a: (
                    "tile GEMM > 64 rows" if a[0].shape[0] > 64 else "tile GEMM")),
                (fused_ops, "_fused_cuda", "fused_mlp_hidden", None),
                (matmul_ops, "_matmul_expert_cuda", "matmul_expert", None),
                (fused_ops, "_fused_expert_cuda", "fused_mlp_hidden_expert", None)):
            stack.enter_context(_patched(module, fname, timed(name, rows)))
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
    return e0.elapsed_time(e1), {f"{n} x{len(p)}": sum(a.elapsed_time(b) for a, b in p)
                                 for n, p in pairs.items()}


def _check_chunks(torch, got, plain, tol_fn, what: str) -> float:
    """The batched kernel's output against its plain version, EXPERT_CHUNK
    experts at a time (the plain version and the bound in f32 of a whole
    expert stack would take 15-43 GB): every element within its bound."""
    from repro_torch.kernels.tolerance import check
    torch.cuda.synchronize()
    worst, err, ref = 0.0, 0.0, 0.0
    for z in range(0, got.shape[0], EXPERT_CHUNK):
        sl = slice(z, z + EXPERT_CHUNK)
        want = plain(sl)
        ok, e, ratio = check(got[sl], want, tol_fn(sl, want))
        worst, err = max(worst, ratio), max(err, e)
        ref = max(ref, want.float().abs().max().item())
        if not ok:
            fail(f"{what}: experts {z}-{z + EXPERT_CHUNK - 1} disagree with the plain version "
                 f"(worst err / bound {ratio:.3f})")
    print(f"  {what}: max abs err {err:.3e} (max |plain| {ref:.3e}), worst err / bound "
          f"{worst:.3f} ok")
    return err


def moe_kernel_phase(torch) -> dict:
    """The expert-batched launches (csrc/matmul.cu `repro_matmul_expert`,
    csrc/fused_mlp.cu `repro_fused_mlp_expert`) at MOE_EXPERT_SHAPES, bf16,
    each against its plain version expert by expert, timed (one launch for
    all experts) beside its bound, the plain version, torch.bmm (the matmul)
    and the 2-D kernel launched once per expert at the same tile (a
    measurement only).  Returns the rows of the kernels line."""
    from repro_torch.kernels.fused_mlp import ops as fused_ops
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul.ref import matmul_expert_ref
    from repro_torch.kernels.tolerance import fused_mlp_hidden_tol, matmul_tol

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(bf)

    tot = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0)
           for n in ("matmul_expert", "fused_mlp_hidden_expert")}
    print("moe kernels (bf16, CUDA events; every expert stack larger than L2, one copy):")
    for label, (e, cap, h, f) in MOE_EXPERT_SHAPES.items():
        torch.cuda.empty_cache()
        x = randn(e, cap, h)
        wg, wu = randn(e, h, f, scale=h ** -0.5), randn(e, h, f, scale=h ** -0.5)
        got = fused_ops.fused_mlp_hidden_expert(x, wg, wu, mlp_type="swiglu")
        err = _check_chunks(
            torch, got, lambda s: fused_mlp_hidden_ref(x[s], wg[s], wu[s], "swiglu"),
            lambda s, want: fused_mlp_hidden_tol(x[s], wg[s], wu[s], "swiglu", want),
            f"fused_mlp_hidden_expert swiglu {e} x ({cap}x{h}x{f}) ({label})")
        ms, host = time_ms(torch, [lambda: fused_ops.fused_mlp_hidden_expert(
            x, wg, wu, mlp_type="swiglu")], EXPERT_ITERS)
        plain, _ = time_ms(torch, [lambda: fused_mlp_hidden_ref(x, wg, wu, "swiglu")], 2)
        tile, _ = fused_ops.geometry(cap, h, f, bf, "swiglu")
        loop, loop_host = time_ms(torch, [lambda: [fused_ops._fused_cuda(
            x[z], wg[z], wu[z], "swiglu", forced=tile) for z in range(e)]], 2)
        bnd, by = bound(2.0 * 2 * e * cap * h * f, 2.0 * (e * cap * h + 2 * e * h * f + e * cap * f))
        print(f"    {ms:.4f} ms ({2 * 2 * e * h * f / ms / 1e6:.0f} GB/s of weights; plain "
              f"{plain:.4f}, bound {bnd:.4f} by {by}, the 2-D kernel once per expert at tile "
              f"{tile[0]}x{tile[1]} {loop:.4f} ms with {loop_host / 1e3:.2f} ms of host); "
              f"1 launch per MoE layer a pass; host {host:.1f} us per call")
        t = tot["fused_mlp_hidden_expert"]
        t["ms"] += ms
        t["plain_ms"] += plain
        t["bound_ms"] += bnd
        t["err"] = max(t["err"], err)
        del got, wg, wu
        xd = randn(e, cap, f)
        wd = randn(e, f, h, scale=f ** -0.5)
        got = mm_ops.matmul_expert(xd, wd)
        err = _check_chunks(torch, got, lambda s: matmul_expert_ref(xd[s], wd[s]),
                            lambda s, want: matmul_tol(xd[s], wd[s], want),
                            f"matmul_expert {e} x ({cap}x{f}x{h}) w_down ({label})")
        ms, host = time_ms(torch, [lambda: mm_ops.matmul_expert(xd, wd)], EXPERT_ITERS)
        plain, _ = time_ms(torch, [lambda: matmul_expert_ref(xd, wd)], 2)
        lib, lib_host = time_ms(torch, [lambda: torch.bmm(xd, wd)], EXPERT_ITERS)
        (tm, tn, _), _ = mm_ops.geometry(cap, f, h, bf)
        depth = -(-f // mm_ops.BLOCK_K) * mm_ops.BLOCK_K
        loop, loop_host = time_ms(torch, [lambda: [mm_ops._matmul_cuda(
            xd[z], wd[z], None, None, forced=(tm, tn, depth)) for z in range(e)]], 2)
        bnd, by = bound(2.0 * e * cap * f * h, 2.0 * (e * cap * f + e * f * h + e * cap * h))
        print(f"    {ms:.4f} ms ({2 * e * f * h / ms / 1e6:.0f} GB/s of weights; plain "
              f"{plain:.4f}, torch.bmm {lib:.4f}, bound {bnd:.4f} by {by}, the 2-D kernel once "
              f"per expert at tile {tm}x{tn} {loop:.4f} ms with {loop_host / 1e3:.2f} ms of "
              f"host); 1 launch per MoE layer a pass; host {host:.1f} us per call (torch.bmm "
              f"{lib_host:.1f})")
        t = tot["matmul_expert"]
        t["ms"] += ms
        t["plain_ms"] += plain
        t["bound_ms"] += bnd
        t["library_ms"] += lib
        t["err"] = max(t["err"], err)
        del got, xd, wd, x
    torch.cuda.empty_cache()
    rows = {}
    for name, src, rep in (
            ("matmul_expert", "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul/kernel.py:35"),
            ("fused_mlp_hidden_expert", "src/repro_torch/kernels/csrc/fused_mlp.cu",
             "src/repro/kernels/fused_mlp/kernel.py:64")):
        t = tot[name]
        rows[name] = dict(name=name, route="cuda", source=src, replaces=rep,
                          max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                          bound_ms=t["bound_ms"], bound_by="bytes",
                          library_ms=t["library_ms"] if name == "matmul_expert" else None)
        print(f"  {name}, one call at each shape: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}"
              + (f", torch.bmm {t['library_ms']:.4f}" if name == "matmul_expert" else "") + ")")
    return rows


@contextlib.contextmanager
def _moe_fault(torch, kind: str, expert: int = 0):
    """A fault planted on the kernel path only (linear_impl "fused"):
    "w_down": one expert's w_down doubled (its slice of the batched w_down
    GEMM's output); "router": one expert's router logit doubled (its column
    of the router GEMM's output); "gates": the top-k gates left
    unrenormalised."""
    from repro_torch.models import linear as linear_mod
    from repro_torch.models import moe as moe_mod
    if kind == "w_down":
        def wrap(real):
            def f(x, w, **kw):      # under "fused" only w_down runs this GEMM
                out = real(x, w, **kw)
                out[expert] *= 2
                return out
            return f
        with _patched(linear_mod, "matmul_expert", wrap):
            yield
    elif kind == "router":
        def wrap(real):
            def f(x, w, *, impl="jnp"):     # in moe.py only the router calls linear
                out = real(x, w, impl=impl)
                if impl == "fused":
                    out[..., expert] *= 2
                return out
            return f
        with _patched(moe_mod, "linear", wrap):
            yield
    else:
        def wrap(real):
            def f(p, xt, cfg):
                probs, gate, idx = real(p, xt, cfg)
                if cfg.linear_impl == "fused":
                    gate = torch.gather(probs, -1, idx)
                return probs, gate, idx
            return f
        with _patched(moe_mod, "route", wrap):
            yield


@contextlib.contextmanager
def _routing_log(torch):
    """Yields a list to which every `moe.route` call in the block appends
    its router probabilities (t, E), top-k experts (t, k), which of those
    entries apply_moe keeps under its capacity (t, k; recomputed here by
    the same stable sort by expert) and the count of dropped entries, as
    device tensors."""
    from repro_torch.models import moe as moe_mod
    log = []

    def wrap(real):
        def f(p, xt, cfg):
            probs, gate, idx = real(p, xt, cfg)
            t, k = idx.shape
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            se = flat[order]
            start = torch.searchsorted(se, torch.arange(probs.shape[1], device=idx.device))
            keep = torch.arange(t * k, device=idx.device) - start[se] < moe_mod._capacity(t, cfg)
            kept = torch.empty_like(keep)
            kept[order] = keep
            log.append({"probs": probs.detach(), "idx": idx.detach(), "kept": kept.view(t, k),
                        "dropped": (~keep).sum()})
            return probs, gate, idx
        return f
    with _patched(moe_mod, "route", wrap):
        yield log


def _hot_expert(torch, rec) -> tuple[int, int]:
    """(the expert with the most kept entries in a routing record, its count)."""
    load = torch.zeros(rec["probs"].shape[1], device=rec["idx"].device).scatter_add_(
        0, rec["idx"].reshape(-1), rec["kept"].reshape(-1).float())
    hot = int(load.argmax().item())
    return hot, int(load[hot].item())


def _router_gaps(rec):
    """Relative gap of every token's k-th over its (k+1)-th router probability."""
    k = rec["idx"].shape[1]
    v = rec["probs"].topk(k + 1, dim=-1).values
    return (v[:, k - 1] - v[:, k]) / v[:, k - 1]


def _row_router_gap(klog, plog, r: int, rows: int) -> tuple[float, int]:
    """(the smallest router gap (`_router_gaps`, from the plain run) over
    row r's tokens whose top-k set differs between the records of a kernel
    run and a plain run of `rows` rows, inf if none does; their count)."""
    gap, differ = math.inf, 0
    for a, b in zip(klog, plog):
        k = a["idx"].shape[1]
        ia, ib = (rec["idx"].view(rows, -1, k)[r].sort(-1).values for rec in (a, b))
        d = (ia != ib).any(-1)
        differ += int(d.sum().item())
        if bool(d.any().item()):
            gap = min(gap, _router_gaps(b).view(rows, -1)[r][d].min().item())
    return gap, differ


def _routing_report(torch, klog, plog, what: str) -> None:
    """Per MoE layer: tokens whose top-k set differs between the kernel and
    the plain path, and each path's dropped entries."""
    for i, (a, b) in enumerate(zip(klog, plog)):
        differ = int((a["idx"].sort(-1).values != b["idx"].sort(-1).values).any(-1).sum().item())
        print(f"    {what}, MoE layer {i}: {differ} of {a['idx'].shape[0]} tokens route to "
              f"another top-{a['idx'].shape[1]} set; dropped entries kernel "
              f"{int(a['dropped'].item())}, plain {int(b['dropped'].item())}")


def _agreed_positions(torch, cfg, klog, plog, shape):
    """(b, s) mask of the positions whose routing (top-k set and kept
    entries) agrees between two runs in every MoE layer: at the position
    itself, and at every earlier position of the row where an attention
    layer follows the MoE layer (it carries a token's other experts to the
    row's later positions)."""
    mask = torch.ones(shape, dtype=torch.bool, device=klog[0]["idx"].device)
    layers = [i for i in range(cfg.num_layers) if cfg.is_moe_layer(i)]
    for layer, a, b in zip(layers, klog, plog):
        same = ((a["idx"].sort(-1).values == b["idx"].sort(-1).values).all(-1) & (
            torch.where(a["kept"], a["idx"], -1).sort(-1).values
            == torch.where(b["kept"], b["idx"], -1).sort(-1).values).all(-1)).view(shape)
        mask &= same.int().cumprod(-1).bool() if layer < cfg.num_layers - 1 else same
    return mask


def _logit_check(torch, params, prompts, cfg, label: str, problems: list) -> None:
    """Prefill logits of the kernel path against the plain path (jnp, naive)
    over all positions and at the worst position whose routing agrees
    (`_agreed_positions`), with the routing of each; then the two planted
    faults (one expert's w_down doubled, the gates unrenormalised), each of
    which must break a bound."""
    from repro_torch.models import apply_lm
    V = cfg.vocab_size
    plain_cfg = dataclasses.replace(cfg, linear_impl="jnp", attn_impl="naive")

    def run(c):
        with _routing_log(torch) as log:
            return apply_lm(params, prompts, c)[0][..., :V], log
    with torch.no_grad():
        lk, klog = run(cfg)
        lp, plog = run(plain_cfg)
        if not (bool(torch.isfinite(lk).all().item()) and bool(torch.isfinite(lp).all().item())):
            fail(f"{label}: prefill logits not finite")
        _routing_report(torch, klog, plog, label)
        hot, entries = _hot_expert(torch, klog[-1])
        readings = {}
        for what, fault in (("sound", None), ("fault: one expert's w_down doubled", "w_down"),
                            ("fault: gates unrenormalised", "gates")):
            if fault is None:
                got, glog = lk, klog
            else:
                with _moe_fault(torch, fault, hot):
                    got, glog = run(cfg)
            pos = _per_position(got, lp)
            agreed = _agreed_positions(torch, cfg, glog, plog, pos.shape)
            worst = (pos * agreed).max().item()
            readings[what] = (_rel(got, lp), worst)
            print(f"  {label}, prefill logits kernel vs plain path, {what}: rel err "
                  f"{readings[what][0]:.3e} (bound {MOE_LOGITS_REL_BOUND}); worst position "
                  f"{worst:.3e} over the {int(agreed.sum().item())} of {agreed.numel()} whose "
                  f"routing agrees up to them (bound {MOE_POSITION_REL_BOUND}), "
                  f"{pos.max().item():.3e} over all; greedy agreement "
                  f"{(got.argmax(-1) == lp.argmax(-1)).float().mean().item():.3f}"
                  + (f" (expert {hot}, {entries} entries)" if fault == "w_down" else ""))
            del got, pos
        rel, worst = readings["sound"]
        if rel > MOE_LOGITS_REL_BOUND or worst > MOE_POSITION_REL_BOUND:
            problems.append(f"{label}: prefill logits differ from the plain path "
                            f"({rel:.3e}, worst agreed position {worst:.3e})")
        for what in list(readings)[1:]:
            rel, worst = readings[what]
            if rel <= MOE_LOGITS_REL_BOUND and worst <= MOE_POSITION_REL_BOUND:
                problems.append(f"{label}: the logits bounds do not see the {what}")
        del lk, lp


def _near_ties(torch, params, plain_cfg, ctx):
    """(top-2 logit gap at the last position, the smallest router gap
    between the k-th and (k+1)-th probability over every token and MoE
    layer), relative, from a plain prefill of `ctx` (1, s)."""
    from repro_torch.serving.serve_step import make_prefill_step
    with _routing_log(torch) as log, torch.no_grad():
        lg, _ = make_prefill_step(plain_cfg, ctx.shape[1])(params, {"tokens": ctx})
    top = lg[0, :plain_cfg.vocab_size].float().topk(2).values
    rg = min(_router_gaps(r).min().item() for r in log)
    return ((top[0] - top[1]) / top[0].abs()).item(), rg


def _tie_or_fail(g_logit: float, g_router: float, what: str) -> None:
    tie = ("logits" if g_logit <= TOKEN_GAP_REL else
           "router" if g_router <= ROUTER_GAP_REL else None)
    print(f"    {what}: top-2 logit gap {g_logit:.3e} (near-tie bound {TOKEN_GAP_REL}), "
          f"smallest router k / k+1 gap {g_router:.3e} ({ROUTER_GAP_REL}; inf: none to take): "
          f"{'a near tie of the ' + tie if tie else 'NO near tie'}")
    if tie is None:
        fail(f"{what} without a near tie")


def moe_serve_phase(torch) -> dict:
    """deepseek-v3-671b at full width, MOE_DEEPSEEK_LAYERS layers, bf16,
    linear_impl="fused", served by serve_step: a prefill of MOE_BATCH x
    MOE_PROMPT tokens and MOE_GEN - 1 greedy decode steps with the launch
    counts of each; prefill logits against the plain path with the routing
    and two planted faults; the MLA handoff with its planted fault;
    lm_loss's forward (lm_loss, aux_loss, mtp_loss) against the plain path;
    then f32 token identity of the kernel and plain paths.  Returns the
    launches over the serve run."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_batch, synthetic_tokens
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.serving.serve_step import make_decode_step, make_prefill_step

    dev = torch.device("cuda")
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, num_layers=MOE_DEEPSEEK_LAYERS, linear_impl="fused")
    problems = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for _, t in _paths(params))
    print(f"moe serve: {cfg.name} at full width, {cfg.num_layers} of {full.num_layers} layers "
          f"({cfg.first_dense_layers} dense, {cfg.num_moe_layers} MoE), d={cfg.d_model}, MLA "
          f"{cfg.num_heads} heads (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, rope "
          f"{cfg.qk_rope_dim}), {cfg.num_experts} experts of {cfg.moe_d_ff} top-{cfg.top_k} + "
          f"{cfg.num_shared_experts} shared, MTP {cfg.mtp_depth}; {nparams / 1e9:.3f} B params in "
          f"{cfg.dtype} ({_param_bytes(params) / 1e9:.2f} GB; init "
          f"{time.perf_counter() - t0:.1f} s)")
    prompts = torch.as_tensor(synthetic_tokens(0, 0, MOE_BATCH, MOE_PROMPT, cfg.vocab_size),
                              device=dev).long()
    prefill = make_prefill_step(cfg, MOE_PROMPT + MOE_GEN)
    decode = make_decode_step(cfg)
    per_pass = moe_pass_launches(cfg)
    V = cfg.vocab_size
    with torch.no_grad():
        prefill(params, {"tokens": prompts})   # warm
        (logits, caches), pre_s, pre_ms, counts = _ssm_timed(
            torch, "moe serve prefill", lambda: prefill(params, {"tokens": prompts}), per_pass,
            _moe_counters())
        tok = torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)
        out, steps = [tok], []

        def run_decode():
            nonlocal tok
            for i in range(MOE_GEN - 1):
                t = time.perf_counter()
                lg, _ = decode(params, tok, caches, MOE_PROMPT + i)
                tok = torch.argmax(lg[:, :V], -1)[:, None].to(torch.int32)
                out.append(tok)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t)
        _, dec_s, dec_ms, dcounts = _ssm_timed(
            torch, "moe serve decode", run_decode,
            {n: (MOE_GEN - 1) * k for n, k in per_pass.items()}, _moe_counters())
        toks = torch.cat(out, 1)
        if not bool(torch.isfinite(logits).all().item()) or not bool(
                ((toks >= 0) & (toks < V)).all().item()):
            fail("moe serve: non-finite logits or a token outside the vocabulary")
        steps.sort()
        print(f"  prefill {MOE_BATCH} x {MOE_PROMPT}: {pre_s * 1e3:.2f} ms host, {pre_ms:.2f} ms "
              f"between CUDA events ({MOE_BATCH * MOE_PROMPT / pre_s:.0f} tok/s); "
              f"{MOE_GEN - 1} decode steps: {dec_s * 1e3:.1f} ms host, {dec_ms:.1f} ms between "
              f"events, step p50 {steps[len(steps) // 2] * 1e3:.2f} ms, max "
              f"{steps[-1] * 1e3:.2f} ms ({MOE_BATCH * (MOE_GEN - 1) / dec_s:.1f} tok/s); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"  launches per prefill pass and per decode step {json.dumps(per_pass)} (as the "
              f"path implies)")
        launches = {n: counts[n] + dcounts[n] for n in counts}
        for what, fn in (("one more decode step", lambda: decode(
                params, tok, caches, MOE_PROMPT + MOE_GEN - 1)),
                ("one more prefill", lambda: prefill(params, {"tokens": prompts}))):
            t = time.perf_counter()
            whole, kms = _moe_device_ms(torch, fn)
            host = time.perf_counter() - t
            print(f"  {what}, CUDA events around each GEMM / MLP launch: {whole:.2f} ms in all "
                  f"({host * 1e3:.2f} ms host); " + ", ".join(
                      f"{n} {v:.2f} ms ({100 * v / whole:.1f}%)" for n, v in kms.items())
                  + f"; the rest (eager work, MLA scores, gaps) {whole - sum(kms.values()):.2f} ms")
        del logits, caches

        _logit_check(torch, params, prompts, cfg, "moe serve", problems)

        # the MLA handoff
        s = MLA_HANDOFF
        ctx = prompts[:, :s + 1]
        with _routing_log(torch) as log:
            want, _ = make_prefill_step(cfg, s + 1)(params, {"tokens": ctx})
        rows = log[-1]["kept"].view(MOE_BATCH, s + 1, cfg.top_k)[:, -1].all(-1)
        readings = {}

        def unrotated_k_rope(real):
            def f(x, positions, theta=10000.0):
                return x if x.shape[-2] == 1 else real(x, positions, theta)
            return f
        for what, fault in (("sound", False), ("fault: cached k_rope unrotated", True)):
            with (_patched(attn_mod, "apply_rotary", unrotated_k_rope) if fault
                  else contextlib.nullcontext()):
                _, caches = make_prefill_step(cfg, s + 1)(params, {"tokens": ctx[:, :s]})
            got, _ = make_decode_step(cfg)(params, ctx[:, s:], caches, s)
            readings[what] = _per_position(got[:, :V], want[:, :V])[rows].max().item()
            del caches
        print(f"  MLA handoff: a decode step after a prefill of {s} tokens vs a prefill of "
              f"{s + 1}, worst row's logits rel err over {int(rows.sum().item())} of {MOE_BATCH} "
              f"rows (the others' last token lost an expert entry to capacity): sound "
              f"{readings['sound']:.3e}, planted fault "
              f"{readings['fault: cached k_rope unrotated']:.3e} (bound {MLA_HANDOFF_REL_BOUND})")
        if not bool(rows.any().item()):
            problems.append("MLA handoff: every row's last token lost an expert entry")
        if readings["sound"] > MLA_HANDOFF_REL_BOUND:
            problems.append("MLA handoff: the decode step disagrees with a longer prefill")
        if readings["fault: cached k_rope unrotated"] <= MLA_HANDOFF_REL_BOUND:
            problems.append("MLA handoff: the bound does not see the unrotated cached k_rope")
        del want, got

        # lm_loss's forward, kernel path vs plain path, sound and under the
        # planted faults (the w_down fault on the batch's busiest expert)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(
            cfg, ShapeConfig("moe", MOE_PROMPT, MOE_BATCH, "train"), 0, 0).items()}
        plain_cfg = dataclasses.replace(cfg, linear_impl="jnp")
        mp = lm_loss(params, batch, plain_cfg)[1]
        with _routing_log(torch) as log:
            mk = lm_loss(params, batch, cfg)[1]
        hot, _ = _hot_expert(torch, log[0])
        names = ("loss", "lm_loss", "aux_loss", "mtp_loss")
        for name in names:
            a, b = mk[name].item(), mp[name].item()
            rel = abs(a - b) / abs(b)
            print(f"  lm_loss forward, {MOE_BATCH} x {MOE_PROMPT} tokens, {name}: kernel path "
                  f"{a:.6f}, plain path {b:.6f}, rel {rel:.3e} (bound {MOE_LOSS_REL_BOUND})")
            if not math.isfinite(a) or rel > MOE_LOSS_REL_BOUND:
                problems.append(f"lm_loss {name}: {a} against the plain path's {b}")
        for fault, what in (("w_down", f"expert {hot}'s w_down doubled"),
                            ("gates", "gates unrenormalised"),
                            ("router", f"expert {hot}'s router logit doubled")):
            with _moe_fault(torch, fault, hot):
                mf = lm_loss(params, batch, cfg)[1]
            rels = {n: abs(mf[n].item() - mp[n].item()) / abs(mp[n].item()) for n in names}
            held = fault in MOE_LOSS_FAULTS
            print(f"  lm_loss forward, fault: {what}: rel " + ", ".join(
                f"{n} {v:.3e}" for n, v in rels.items())
                + ("" if held else " (printed, not held)"))
            if held and max(rels.values()) <= MOE_LOSS_REL_BOUND:
                problems.append(f"lm_loss: the bound does not see the fault: {what}")
    del params
    torch.cuda.empty_cache()
    moe_serve_identity(torch)
    if problems:
        fail("moe serve: " + "; ".join(problems))
    return launches


def moe_serve_identity(torch) -> None:
    """f32 token identity on deepseek-v3 at full width, cut further to
    MOE_F32_DEEPSEEK_LAYERS layers (1 dense, 1 MoE) so f32 fits: the greedy
    tokens of the kernel path and the plain path through serve_step on the
    serve run's workload, identical but at a near tie of the plain path's
    top-2 logits at that step, or of a router's k-th / (k+1)-th probability
    at a token of that row, up to that step, whose top-k set differs
    between the two runs (the gaps read from the plain run itself)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.models import init_lm
    from repro_torch.serving.serve_step import make_decode_step, make_prefill_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=MOE_F32_DEEPSEEK_LAYERS,
                              first_dense_layers=MOE_F32_DEEPSEEK_LAYERS - 1, dtype="float32",
                              linear_impl="fused")
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    prompts = torch.as_tensor(synthetic_tokens(0, 1, MOE_BATCH, MOE_PROMPT, cfg.vocab_size),
                              device=dev).long()
    V, k = cfg.vocab_size, cfg.top_k
    runs = {}
    for label, c in (("kernel", cfg), ("plain", dataclasses.replace(cfg, linear_impl="jnp"))):
        prefill, decode = make_prefill_step(c, MOE_PROMPT + MOE_GEN), make_decode_step(c)
        gaps = []
        with _routing_log(torch) as log, torch.no_grad():
            lg, caches = prefill(params, {"tokens": prompts})
            out = []
            for i in range(MOE_GEN):
                top = lg[:, :V].topk(2, dim=-1).values
                gaps.append(((top[:, 0] - top[:, 1]) / top[:, 0].abs()).cpu())
                tok = torch.argmax(lg[:, :V], -1)[:, None].to(torch.int32)
                out.append(tok)
                if i < MOE_GEN - 1:
                    lg, _ = decode(params, tok, caches, MOE_PROMPT + i)
        runs[label] = (torch.cat(out, 1).cpu(), gaps, log)
        del caches, lg
    got, want = runs["kernel"][0], runs["plain"][0]
    _, gaps, plog = runs["plain"]
    klog = runs["kernel"][2]
    n_moe = cfg.num_moe_layers
    for r in range(MOE_BATCH):
        i = _first_divergence(want[r].tolist(), got[r].tolist())
        if i is None:
            continue
        # token i comes from call i (the prefill, then decode step i - 1)
        rg, differ = _row_router_gap(klog[:(i + 1) * n_moe], plog[:(i + 1) * n_moe], r,
                                     MOE_BATCH)
        _tie_or_fail(gaps[i][r].item(), rg, f"moe f32 identity: row {r} diverges at token {i} "
                                            f"({differ} of its tokens route to another top-{k} "
                                            f"set up to there)")
    same = int((want == got).all(1).sum().item())
    print(f"moe token identity: {cfg.name} at full width, {cfg.num_layers} layers "
          f"({cfg.first_dense_layers} dense, {n_moe} MoE), float32, serve_step on "
          f"{MOE_BATCH} x {MOE_PROMPT} + {MOE_GEN} tokens: kernel path vs plain path, "
          f"{same}/{MOE_BATCH} rows identical; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    del params
    torch.cuda.empty_cache()


def moe_serve_run(torch, eng, reqs, label: str, decode_kernel, **kw):
    """One engine run of an MoE model with every count set to 0 just
    before and read just after, held to the path's formula: per pass
    (prefills + decode steps) `moe_pass_launches`, and `decode_kernel`
    (None on the plain path) once per attention layer a decode step."""
    from repro_torch.kernels.flash_attention.ops import paged_decode, paged_decode_blocktable
    counters = {**_moe_counters(), "paged_decode": paged_decode,
                "paged_decode_blocktable": paged_decode_blocktable}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    done, stats = eng.run(reqs, **kw)
    torch.cuda.synchronize()
    counts = {n: f.launches for n, f in counters.items()}
    passes = stats.prefills + stats.decode_steps
    want = dict.fromkeys(counts, 0)
    if eng.cfg.linear_impl == "fused":
        want.update({n: passes * v for n, v in moe_pass_launches(eng.cfg).items()})
    if decode_kernel:
        want[decode_kernel] = stats.decode_steps * eng.cfg.num_layers
    print(f"  {label}: {stats.num_requests} requests, {stats.total_generated} tokens in "
          f"{stats.wall_s:.3f} s ({stats.prefills} prefills, {stats.decode_steps} decode steps"
          f", {stats.preemptions} preemptions) | tok/s {stats.tok_s:.1f} | TTFT p50 "
          f"{stats.ttft_p50_s * 1e3:.2f} ms | ITL p50 {stats.itl_p50_s * 1e3:.2f} ms p99 "
          f"{stats.itl_p99_s * 1e3:.2f} ms | cache_hit_rate {stats.cache_hit_rate:.3f} | peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"    launches: {json.dumps({n: v for n, v in counts.items() if v or want[n]})}")
    if counts != want:
        fail(f"{label}: launches {counts}, the path implies {want}")
    for r, c in zip(reqs, done):
        if c.rid != r.rid or c.finish_reason != "length" or len(c.tokens) != r.max_new_tokens:
            fail(f"{label}: request {r.rid}: {c.finish_reason} with {len(c.tokens)} of "
                 f"{r.max_new_tokens} tokens ({c.detail})")
        if not all(0 <= t < eng.cfg.vocab_size for t in c.tokens):
            fail(f"{label}: request {c.rid}: token outside the vocabulary")
    return done, stats, counts


def _llama4_engine(params, cfg, dev, prefix: bool, plain: bool = False):
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.serving.engine import Engine
    c = dataclasses.replace(cfg, linear_impl="jnp") if plain else cfg
    kw = dict(max_prompt=128, prefix_cache=True) if prefix else dict(max_prompt=64)
    return Engine(params, c, max_batch=8, max_new=32, use_paged_kernel=not plain, hw=H100_SXM,
                  device=dev, **kw)


def moe_engine_phase(torch) -> dict:
    """llama4-maverick-400b-a17b at full width, MOE_LLAMA4_PAIRS [moe, dense]
    pair, bf16, linear_impl="fused": the slot engine (paged decode) on the
    serve cell's burst and the prefix engine (block-table pool) on the
    prefix cell's workload, launch counts against the path's; prefill
    logits against the plain path with the routing and two planted faults;
    then f32 token identity of each engine's kernel and plain paths.
    Returns the launches over the two runs."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.models import init_lm
    from repro_torch.serving.engine import synthetic_requests

    dev = torch.device("cuda")
    full = get_config("llama4-maverick-400b-a17b")
    cfg = dataclasses.replace(full, num_layers=2 * MOE_LLAMA4_PAIRS, linear_impl="fused")
    problems = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for _, t in _paths(params))
    print(f"moe engine: {cfg.name} at full width, {MOE_LLAMA4_PAIRS} of "
          f"{full.num_layers // 2} [moe, dense] pairs, d={cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, {cfg.num_experts} experts of "
          f"{cfg.moe_d_ff} top-{cfg.top_k} + {cfg.num_shared_experts} shared, vocab "
          f"{cfg.vocab_size}; {nparams / 1e9:.3f} B params in {cfg.dtype} "
          f"({_param_bytes(params) / 1e9:.2f} GB; init {time.perf_counter() - t0:.1f} s)")
    serve_reqs = synthetic_requests(16, pattern="burst", min_prompt=16, max_prompt=64,
                                    min_new=8, max_new=32, vocab=cfg.vocab_size, seed=0)
    prefix_reqs = _prefix_requests(cfg.vocab_size)
    launches = {}
    for prefix, reqs, kernel in ((False, serve_reqs, "paged_decode"),
                                 (True, prefix_reqs, "paged_decode_blocktable")):
        eng = _llama4_engine(params, cfg, dev, prefix)
        pol = eng.policy
        label = f"{'prefix' if prefix else 'slot'} engine ({pol.num_slots} x {pol.seq_max}" + (
            f", {eng.pool.block_size}-token blocks)" if prefix else ")")
        _, _, counts = moe_serve_run(torch, eng, reqs, label, kernel,
                                     **({"check_invariants": True} if prefix else {}))
        for n, v in counts.items():
            launches[n] = launches.get(n, 0) + v
        del eng
    prompts = torch.as_tensor(synthetic_tokens(0, 0, 4, 64, cfg.vocab_size), device=dev).long()
    _logit_check(torch, params, prompts, cfg, "moe engine", problems)
    del params
    torch.cuda.empty_cache()

    # f32 token identity on the same engines and workloads
    f32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    p32 = init_lm(torch.Generator(device=dev).manual_seed(1), f32, device=dev)
    plain32 = dataclasses.replace(f32, linear_impl="jnp")
    for prefix, reqs in ((False, serve_reqs), (True, prefix_reqs)):
        name = "prefix" if prefix else "slot"
        runs = {}
        for plain in (False, True):
            eng = _llama4_engine(p32, f32, dev, prefix, plain=plain)
            runs[plain], _, _ = moe_serve_run(
                torch, eng, reqs, f"f32 {name} engine, {'plain' if plain else 'kernel'} path",
                None if plain else ("paged_decode_blocktable" if prefix else "paged_decode"),
                **({"check_invariants": True} if prefix else {}))
            del eng
        for r, a, b in zip(reqs, runs[True], runs[False]):
            i = _first_divergence(a.tokens, b.tokens)
            if i is None:
                continue
            ctx = torch.as_tensor(np.concatenate([r.tokens, np.asarray(a.tokens[:i], np.int32)])[
                None], device=dev).long()
            g, rg = _near_ties(torch, p32, plain32, ctx)
            _tie_or_fail(g, rg, f"moe f32 {name} engine: request {r.rid} diverges at token {i} "
                                f"(gaps from a one-row plain prefill of the agreed context)")
        print(f"  f32 {name} engine, kernel path vs plain path ({f32.num_layers} layers, full "
              f"width): {_agreement(runs[True], runs[False])}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del p32
    torch.cuda.empty_cache()
    if problems:
        fail("moe engine: " + "; ".join(problems))
    return launches


# --- train phase ------------------------------------------------------------------------

def per_step_launches(cfg) -> dict:
    """Kernel launches one training step implies (one microbatch, remat
    "none"), for L layers.  The dense decoder:
      linear runs 5 projections per layer (wq, wk, wv, wo, w_down) and
      lm_head: 5L + 1 forward GEMMs ("nn"), as many dgrad ("nt") and wgrad
      ("tn") GEMMs; the fused-MLP backward adds one dgrad launch over both
      pairs (dx) and two wgrad launches (dWg, dWu) per layer:
        matmul nn = 5L + 1, nt = 6L + 1, tn = 7L + 1   (435 at L = 24)
      fused_mlp_hidden = fused_mlp_bwd = flash_attention = flash_attention_bwd = L.
    mamba2 (L Mamba2 layers) and zamba2 (L Mamba2 layers and sb = L / k
    applications of the shared attention + GELU MLP block):
      n = 6L + 5 sb + 1 projections (in_z, in_x, in_B, in_C, in_dt, out_proj
      a Mamba2 layer; wq, wk, wv, wo and w_down an application; the head),
      each one forward, one dgrad and one wgrad GEMM (a tied head's forward
      is "nt" and its dgrad "nn": the same totals per layout); the un-gated
      fused-MLP backward adds one dgrad (dx) and one wgrad (dWu) a block:
        matmul nn = n, nt = tn = n + sb   (867 a step for mamba2-780m)
      ssd_chunk = ssd_chunk_bwd = L; fused_mlp_hidden = fused_mlp_bwd =
      flash_attention = flash_attention_bwd = sb."""
    L = cfg.num_layers
    if cfg.family in ("ssm", "hybrid"):
        sb = L // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        n = 6 * L + 5 * sb + 1
        return {"matmul": 3 * n + 2 * sb, "matmul_nn": n, "matmul_nt": n + sb,
                "matmul_tn": n + sb, "fused_mlp_hidden": sb, "fused_mlp_bwd": sb,
                "flash_attention": sb, "flash_attention_bwd": sb, "paged_decode": 0,
                "ssd_chunk": L, "ssd_chunk_bwd": L}
    return {"matmul": 18 * L + 3, "matmul_nn": 5 * L + 1, "matmul_nt": 6 * L + 1,
            "matmul_tn": 7 * L + 1, "fused_mlp_hidden": L, "fused_mlp_bwd": L,
            "flash_attention": L, "flash_attention_bwd": L, "paged_decode": 0,
            "ssd_chunk": 0, "ssd_chunk_bwd": 0}


def _train_counters():
    from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd, flash_attention_fwd,
                                                         paged_decode)
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd, fused_mlp_hidden
    from repro_torch.kernels.matmul import ops as matmul_ops
    from repro_torch.kernels.ssd.ops import ssd_chunk, ssd_chunk_bwd
    return matmul_ops, {"fused_mlp_hidden": fused_mlp_hidden, "fused_mlp_bwd": fused_mlp_bwd,
                        "flash_attention": flash_attention_fwd,
                        "flash_attention_bwd": flash_attention_bwd, "paged_decode": paged_decode,
                        "ssd_chunk": ssd_chunk, "ssd_chunk_bwd": ssd_chunk_bwd}


def _read_counts(matmul_ops, fns) -> dict:
    counts = {"matmul": matmul_ops.matmul.launches}
    counts.update({f"matmul_{k}": v for k, v in matmul_ops.matmul.by_layout.items()})
    counts.update({name: fn.launches for name, fn in fns.items()})
    return counts


def _reset_counts(matmul_ops, fns) -> None:
    matmul_ops.reset_launches()
    for fn in fns.values():
        fn.launches = 0


def _grads(torch, params, batch, cfg, remat="none"):
    from repro_torch.models import lm_loss
    from repro_torch.optim.adamw import tree_leaves
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, batch, cfg, remat=remat)
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
        def f(a, b, *rest, **kw):
            if a.dim() == 2 and not a.is_contiguous():   # A transposed: x^T @ g
                return real(a[:, :-64], b[:-64], *rest, **kw)
            return real(a, b, *rest, **kw)
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


def _path_rels(torch, params, batch, cfg, plain_cfg, plain, plain_remat, what, grad_bound):
    """Step-0 loss and gradients of the kernel path and of the plain path
    (`plain_cfg` inside `plain()`, with `plain_remat`) on the same params
    and batch, printed beside `grad_bound`.  Returns (loss rel err,
    [(grad rel err, leaf)], all finite, the plain path's gradients, the
    leaves' names)."""
    lk, gk = _grads(torch, params, batch, cfg)
    with plain():
        lp, gp = _grads(torch, params, batch, plain_cfg, remat=plain_remat)
    rel_loss = abs(lk - lp) / abs(lp)
    names = [path for path, _ in _paths(params)]
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    rels = _grad_rels(gk, gp, names)
    del gk
    print(f"  {what}, kernel path vs plain path: loss {lk:.6f} vs {lp:.6f} (rel "
          f"{rel_loss:.3e}, bound {TRAIN_LOSS_REL_BOUND}); ||g_k - g_p|| / ||g_p|| over "
          f"{len(rels)} leaves and layer slices: worst {rels[0][0]:.3e} ({rels[0][1]}), "
          f"median {rels[len(rels) // 2][0]:.3e} (bound {grad_bound}); "
          f"all finite: {finite}")
    for r, n in rels[:5]:
        print(f"    {r:.3e}  {n}")
    return rel_loss, rels, finite, gp, names


def step0_check(torch, params, batch, cfg, plain_cfg, faults=None,
                plain=contextlib.nullcontext, plain_remat="none",
                grad_bound=TRAIN_GRAD_REL_BOUND, check="step-0 check", held=None) -> None:
    """Step-0 loss and gradients, kernel path vs plain path on the same
    params and batch, within TRAIN_LOSS_REL_BOUND / `grad_bound`; then each
    planted fault (`planted_faults` by default) must break the gradient
    bound, or only those named in `held` (the others are printed).  The
    plain path runs `plain_cfg` inside `plain()` (the SSD
    kernels' plain versions for the SSM models), with `plain_remat`."""
    rel_loss, rels, finite, gp, names = _path_rels(torch, params, batch, cfg, plain_cfg, plain,
                                                   plain_remat, check, grad_bound)
    unseen = []
    for what, module, name, wrap in planted_faults(torch) if faults is None else faults:
        with _patched(module, name, wrap):
            _, gf = _grads(torch, params, batch, cfg)
        frels = _grad_rels(gf, gp, names)
        del gf
        shown = held is not None and what not in held
        print(f"  planted fault{' (printed, not held)' if shown else ''}, {what}: worst "
              f"{frels[0][0]:.3e} ({frels[0][1]}), median {frels[len(frels) // 2][0]:.3e}; next "
              + ", ".join(f"{r:.3e} ({n})" for r, n in frels[1:4]))
        if frels[0][0] <= grad_bound and not shown:
            unseen.append(what)
    del gp
    torch.cuda.empty_cache()
    if not (finite and rel_loss <= TRAIN_LOSS_REL_BOUND and rels[0][0] <= grad_bound):
        fail(f"train {check}: the kernel path's loss or gradients break their bounds")
    if unseen:
        fail(f"train {check}: the gradient bound does not see the planted faults {unseen}")


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


FLASH_KERNELS = ("flash_fwd_sm90", "attention_di", "flash_bwd_sm90", "dq_convert")


def profile_train_step(torch, step_fn, params, opt, batch, kernels=FLASH_KERNELS,
                       what="flash attention") -> None:
    """Where one training step's time goes: one more step under
    torch.profiler (device-side events only), the top kernels and the
    device-busy share of the profiled step's wall, the `kernels` (`what`)
    and the GEMM mainloop's share."""
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
    flash = {name: [e for e in events if name in e.key] for name in kernels}
    ms = {n: sum(e.self_device_time_total for e in es) / 1e3 for n, es in flash.items()}
    print(f"  {what} in the profiled step: " + ", ".join(
        f"{n} {v:.2f} ms x{sum(e.count for e in flash[n])}" for n, v in ms.items())
        + f"; {sum(ms.values()):.2f} ms = {100 * sum(ms.values()) / 1e3 / busy:.1f}% of the "
        f"device-busy time")
    gemm_share(events, busy, "profiled step")


# --- the SSM training slice ------------------------------------------------------------

def ssd_planted_faults(torch):
    """Faults in the SSD backward the step-0 check must see, each planted
    alone by wrapping `ssd_chunk_bwd` (what `_SSDChunk.backward` calls):
    (what, module, global name, wrapper of the real function)."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    def db_without_ds(real):
        def f(x, B, C, seg, dY, dS):
            dx, _, dc, dseg = real(x, B, C, seg, dY, dS)
            return dx, real(x, B, C, seg, dY, torch.zeros_like(dS))[1], dc, dseg
        return f

    def last_dseg_zeroed(real):
        calls = []

        def f(*args):
            dx, db, dc, dseg = real(*args)
            calls.append(1)
            if len(calls) == 1:      # the backward's first layer: the last one
                dseg = torch.zeros_like(dseg)
            return dx, db, dc, dseg
        return f

    def dx_chunk_dropped(real):
        def f(*args):
            dx, db, dc, dseg = real(*args)
            dx[:, :, 0, 1] = 0       # the first head of each group, chunk 1, every layer
            return dx, db, dc, dseg
        return f

    return [("dB without its dS term (the chunk-state path)", ssd_ops, "ssd_chunk_bwd",
             db_without_ds),
            ("the last layer's dseg zeroed", ssd_ops, "ssd_chunk_bwd", last_dseg_zeroed),
            ("dX of chunk 1 of one head dropped", ssd_ops, "ssd_chunk_bwd", dx_chunk_dropped)]


def ssm_leaf(params, name: str):
    """The stacked leaf `name` of the Mamba2 layers (mamba2's seg0/ssm,
    zamba2's seg0/layers/ssm)."""
    seg = params["seg0"]
    return (seg["ssm"] if "ssm" in seg else seg["layers"]["ssm"])[name]


def ssm_train(torch, cfg, label: str, steps: int, faults, bf16_held) -> dict:
    """Train `cfg` on the card from float32 masters (seed 0), bf16 compute,
    AdamW, TRAIN_BATCH x TRAIN_SEQ tokens: the step-0 gradients against the
    plain path (linear_impl "jnp", naive attention, the SSD kernels' plain
    versions, remat "full" to hold its memory down), held at bf16 to
    SSM_BF16_GRAD_REL_BOUND with every `ssd_planted_faults` fault planted
    (those named in `bf16_held` must break it), and at f32 and slow decay
    to the train phase's bounds with `faults` planted; then
    `steps` steps of make_train_step (loss, step time, tokens/s, FLOPs
    share, peak memory), each kernel's launches against
    `per_step_launches`, and one profiled step.  Returns the launches over
    the timed steps."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import init_lm
    from repro_torch.optim.adamw import init_opt
    from repro_torch.train.train_step import make_train_step

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    plain_cfg = dataclasses.replace(cfg, linear_impl="jnp", attn_impl="naive")
    tc = TrainConfig(total_steps=steps, warmup_steps=steps, learning_rate=3e-4, remat="none")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
                     dtype=torch.float32)
    n_all = sum(t.numel() for _, t in _paths(params))
    print(f"{label}: {cfg.name} L={cfg.num_layers} d={cfg.d_model} d_inner={cfg.ssm_d_inner} "
          f"heads={cfg.ssm_nheads} P={cfg.ssm_head_dim} N={cfg.ssm_state} chunk={cfg.ssm_chunk} "
          f"vocab={cfg.vocab_size}; {n_all / 1e9:.3f} B float32 master params; compute "
          f"{cfg.dtype}, linear_impl={cfg.linear_impl}, attn_impl={cfg.attn_impl}, AdamW, "
          f"remat={tc.remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ} (init "
          f"{time.perf_counter() - t0:.1f} s)")

    def batch_at(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in make_batch(cfg, shape, step, tc.seed).items()}

    # At bf16 (the path as it trains) the step-0 check is held to
    # SSM_BF16_GRAD_REL_BOUND, with the same faults; then at f32 and a
    # trained model's slow decay to TRAIN_GRAD_REL_BOUND, as the ssm serve
    # phase's worst-position check, where the paths differ by f32 sums only.
    t0 = time.perf_counter()
    step0_check(torch, params, batch_at(0), cfg, plain_cfg, faults=ssd_planted_faults(torch),
                plain=_plain_ssd, plain_remat="full", grad_bound=SSM_BF16_GRAD_REL_BOUND,
                check=f"step-0 check at {cfg.dtype}", held=bf16_held)
    f32 = dataclasses.replace(cfg, dtype="float32")
    dt_bias = ssm_leaf(params, "dt_bias")
    init_dt = dt_bias.detach().clone()
    with torch.no_grad():
        dt_bias.copy_(torch.from_numpy(slow_decay_dt_bias(tuple(dt_bias.shape), seed=0)))
    print(f"  at f32 and slow decay (softplus(dt_bias) in [1e-3, 1e-1]):")
    step0_check(torch, params, batch_at(0), f32,
                dataclasses.replace(f32, linear_impl="jnp", attn_impl="naive"), faults=faults,
                plain=_plain_ssd, plain_remat="full", check="step-0 check at float32")
    with torch.no_grad():
        dt_bias.copy_(init_dt)
    print(f"  step-0 checks and their planted faults: {time.perf_counter() - t0:.1f} s")

    opt = init_opt(params, tc)
    step_fn = make_train_step(cfg, tc)
    watch = [*(ssm_leaf(params, n) for n in ("in_x", "in_B", "A_log", "dt_bias")),
             params["embed"], params["final_norm"]["scale"]]
    before = [w.detach()[..., :64].clone() for w in watch]
    matmul_ops, fns = _train_counters()
    batches = [batch_at(i) for i in range(steps)]
    torch.cuda.synchronize()
    _reset_counts(matmul_ops, fns)
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        print(f"  step {i}: loss {losses[-1]:.4f}  grad_norm {m['grad_norm'].item():.4f}  "
              f"lr {m['lr'].item():.3e}  {times[-1] * 1e3:.1f} ms")
    counts = _read_counts(matmul_ops, fns)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss {losses}")
    moved = [bool((w.detach()[..., :64] != b).any()) for w, b in zip(watch, before)]
    if not all(moved):
        fail(f"{label}: parameters did not move ({moved})")
    want = {k: v * steps for k, v in per_step_launches(cfg).items()}
    print(f"  kernel launches over {steps} steps: {json.dumps(counts)} (as the path implies)")
    for name, n in counts.items():
        if n != want[name]:
            fail(f"{label}: {name}: {n} launches, the path implies {want[name]} "
                 f"({steps} steps x {want[name] // steps})")

    warm = sorted(times[1:])
    step_s = warm[len(warm) // 2]       # median of the warm steps
    sb = cfg.num_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    shared = sum(t.numel() for _, t in _paths(params.get("shared", {})))
    n_embed = 0 if cfg.tie_embeddings else params["embed"].numel()
    # 6 per parameter and token (a tied head's GEMM is the embedding's, the
    # shared block's weights count once per application), the SSD kernels'
    # own products and the shared attention's causal half
    b, s = TRAIN_BATCH, TRAIN_SEQ
    ssd = sum(w(b, s, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, 2)[0]
              for w in (ssd_work, ssd_bwd_work))
    attn = 14.0 * sb * b * cfg.num_heads * cfg.head_dim * s * (s + 1) / 2 if sb else 0.0
    flops = 6.0 * (n_all - n_embed + max(sb - 1, 0) * shared) * TOKENS + cfg.num_layers * ssd \
        + attn
    print(f"  step time {step_s * 1e3:.1f} ms (median of steps 1-{steps - 1}), "
          f"{TOKENS / step_s:,.0f} tokens/s, {flops / 1e12:.2f} TFLOP per step = "
          f"{100 * flops / step_s / PEAK_BF16_FLOPS:.1f}% of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; "
          f"peak device memory {peak:.2f} GiB; card {nvidia_smi()}")
    profile_train_step(torch, step_fn, params, opt, batches[0],
                       kernels=("ssd_chunk_sm90", SSD_BWD_KEYS, SSD_BWD_QUERIES, *FLASH_KERNELS),
                       what="the SSD kernels and flash")
    del params, opt, batches
    torch.cuda.empty_cache()
    return counts


def ssm_train_phase(torch) -> dict:
    """mamba2-780m trained at full width and depth (48 layers, d 1536),
    linear_impl="fused", TRAIN_STEPS steps, with the SSD backward's three
    planted faults (at bf16 the two that bf16 rounding does not hide are
    held); returns the launches over the timed steps."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("mamba2-780m"), linear_impl="fused")
    faults = ssd_planted_faults(torch)
    return ssm_train(torch, cfg, "ssm train", TRAIN_STEPS, faults, [f[0] for f in faults[1:]])


def hybrid_train_phase(torch) -> dict:
    """zamba2-2.7b at full width, HYBRID_SUPERBLOCKS of its superblocks (as
    the hybrid serve phase), linear_impl="fused", attn_impl="flash" (head
    dim 80), HYBRID_TRAIN_STEPS steps, with one planted fault held at each
    precision: the chunk-state term of dB at f32, the last layer's dseg at
    bf16."""
    from repro_torch.configs.registry import get_config
    full = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(full, linear_impl="fused", attn_impl="flash",
                              num_layers=HYBRID_SUPERBLOCKS * full.hybrid_attn_every)
    faults = ssd_planted_faults(torch)
    return ssm_train(torch, cfg, f"hybrid train ({HYBRID_SUPERBLOCKS} of "
                                 f"{full.num_layers // full.hybrid_attn_every} superblocks)",
                     HYBRID_TRAIN_STEPS, faults[:1], [faults[1][0]])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# --- tuning phase -----------------------------------------------------------------------

# The tuning slice: launch geometries measured at internlm2-1.8b's serve and
# int8-serve shapes, written to a cache file and read back through the
# wrappers' `tuned=True` lookups.  (k, n) of each bf16 projection (q/o, k/v,
# the MLP's gate/up, its down) and the lm_head, at TUNE_ROWS rows (64: the
# serve cell's prefill bucket and decode batch; 16: a smaller decode batch);
# the int8 GEMM at INT8_TUNE_ROWS (65-256 rows: where tuning/int8_tiles.py found
# the rule's 128 x 256 slower than 64 x 128).
TUNE_GEMMS = {"q/o": (2048, 2048), "k/v": (2048, 1024), "gate/up": (2048, 8192),
              "w_down": (8192, 2048), "lm_head": (2048, 92544)}
TUNE_ROWS = (16, 64)
INT8_TUNE_GEMMS = {"q/o": (2048, 2048), "k/v": (2048, 1024), "w_down": (8192, 2048),
                   "lm_head": (2048, 92544)}
INT8_TUNE_ROWS = (64, 128, 256)
FUSED_TUNE_ROWS = (64, 256)    # the int8 fused SwiGLU (64: the serve cell's)
TUNE_ITERS, TUNE_WARMUP = 20, 3


def _winner_line(cfg, rule: str, win: str) -> str:
    return (f"    winner {win} {cfg.time_us:.2f} us (std {cfg.time_us_std:.2f}); the rule's pick "
            f"{rule} {cfg.baseline_us:.2f} us = {cfg.speedup_vs_default:.3f}x the winner "
            f"({cfg.candidates_tried} candidates)")


def _tuned_check(torch, fn, call, forced, want, tol, what: str) -> None:
    """The tuned call (which must hit) bit-identical to a forced launch of
    the winner's geometry and within `tol` of the plain version (tol None:
    equal to it, the int8 GEMM's bound)."""
    before = fn.tuned_hits
    got = call()
    torch.cuda.synchronize()
    if fn.tuned_hits != before + 1:
        fail(f"{what}: the tuned call did not hit the cache")
    if not torch.equal(got, forced()):
        fail(f"{what}: the tuned call differs from a forced launch of its entry's geometry")
    if tol is None:
        identical(torch, got, want, f"{what} tuned (= forced launch)")
    else:
        compare(torch, got, want, tol, f"{what} tuned (= forced launch)")


def _sweep_gemms(torch, cache, search, dev, gen):
    from repro_torch.kernels.matmul import ops as mops
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.tolerance import matmul_tol
    from repro_torch.tuning.candidates import split_depth
    for m in TUNE_ROWS:
        for name, (k, n) in TUNE_GEMMS.items():
            print(f"  matmul {name} {m}x{k}x{n} (block_m, block_n, split_k):", flush=True)
            cfg = search.autotune_matmul(m, k, n, cache=cache, iters=TUNE_ITERS,
                                         warmup=TUNE_WARMUP, verbose=True)
            tm, tn, ks = mops.launch_shape(m, n, k, torch.bfloat16, 132)
            b = cfg.blocks
            print(_winner_line(cfg, f"{tm}x{tn}/{-(-k // ks)}",
                               f"{b['block_m']}x{b['block_n']}/{b['split_k']}"))
            a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
            geo = (b["block_m"], b["block_n"], split_depth(k, b["split_k"], mops.BLOCK_K))
            want = matmul_ref(a, w)
            _tuned_check(torch, mops.matmul, lambda: mops.matmul(a, w, tuned=True),
                         lambda: mops._matmul_cuda(a, w, None, None, forced=geo), want,
                         matmul_tol(a, w, want), f"matmul {m}x{k}x{n}")
            del a, w, want
    torch.cuda.empty_cache()


def _sweep_fused(torch, cache, search, dev, gen):
    from repro_torch.kernels.fused_mlp import ops as fops
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
    from repro_torch.kernels.tolerance import fused_mlp_hidden_tol
    m, (h, f) = ROWS, TUNE_GEMMS["gate/up"]
    print(f"  fused_mlp_swiglu {m}x{h}x{f} (block_m, block_f):", flush=True)
    cfg = search.autotune_fused_mlp(m, h, f, cache=cache, iters=TUNE_ITERS, warmup=TUNE_WARMUP,
                                    verbose=True)
    rule = fops.pick_tile(m, torch.bfloat16)
    tile = (cfg.blocks["block_m"], cfg.blocks["block_f"])
    print(_winner_line(cfg, "x".join(map(str, rule)), "x".join(map(str, tile))))
    x = torch.randn((m, h), generator=gen, device=dev).to(torch.bfloat16)
    wg, wu = ((torch.randn((h, f), generator=gen, device=dev) * h ** -0.5).to(torch.bfloat16)
              for _ in range(2))
    want = fused_mlp_hidden_ref(x, wg, wu, "swiglu")
    _tuned_check(torch, fops.fused_mlp_hidden, lambda: fops.fused_mlp_hidden(x, wg, wu, tuned=True),
                 lambda: fops._fused_cuda(x, wg, wu, "swiglu", forced=tile), want,
                 fused_mlp_hidden_tol(x, wg, wu, "swiglu", want), f"fused_mlp {m}x{h}x{f}")


def _sweep_int8(torch, cache, search, dev, gen):
    from repro_torch.kernels.quantized import ops as qops
    from repro_torch.kernels.quantized.ref import int8_fused_mlp_ref, int8_matmul_ref
    from repro_torch.kernels.tolerance import int8_fused_mlp_tol
    from repro_torch.quant import quantize_int8, quantize_weight
    from repro_torch.tuning.candidates import split_depth
    for m in INT8_TUNE_ROWS:
        for name, (k, n) in INT8_TUNE_GEMMS.items():
            print(f"  int8_matmul {name} {m}x{k}x{n} (block_m, block_n, split_k):", flush=True)
            cfg = search.autotune_int8_matmul(m, k, n, cache=cache, iters=TUNE_ITERS,
                                              warmup=TUNE_WARMUP, verbose=True)
            tm, tn, ks = qops.launch_shape(m, n, k, 132)
            b = cfg.blocks
            print(_winner_line(cfg, f"{tm}x{tn}/{-(-k // ks)}",
                               f"{b['block_m']}x{b['block_n']}/{b['split_k']}"))
            a_q, a_s = quantize_int8(torch.randn((m, k), generator=gen, device=dev)
                                     .to(torch.bfloat16))
            wq = quantize_weight((torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
                                 .to(torch.bfloat16))
            ws = wq.scale.reshape(1, -1)
            geo = (b["block_m"], b["block_n"], split_depth(k, b["split_k"], qops.BLOCK_K))
            _tuned_check(torch, qops.int8_matmul,
                         lambda: qops.int8_matmul_q(a_q, a_s, wq.q, ws, torch.bfloat16,
                                                    tuned=True, act_dtype=torch.bfloat16),
                         lambda: qops._int8_matmul_cuda(a_q, a_s, wq.q, ws, torch.bfloat16,
                                                        forced=geo),
                         int8_matmul_ref(a_q, a_s, wq.q, ws, torch.bfloat16), None,
                         f"int8_matmul {m}x{k}x{n}")
            del wq
    torch.cuda.empty_cache()
    h, f = TUNE_GEMMS["gate/up"]
    for m in FUSED_TUNE_ROWS:
        print(f"  int8_fused_mlp_swiglu {m}x{h}x{f} (block_m, block_f):", flush=True)
        cfg = search.autotune_int8_fused_mlp(m, h, f, cache=cache, iters=TUNE_ITERS,
                                             warmup=TUNE_WARMUP, verbose=True)
        tile = (cfg.blocks["block_m"], cfg.blocks["block_f"])
        print(_winner_line(cfg, "x".join(map(str, qops.fused_tile(m))), "x".join(map(str, tile))))
        x_q, x_s = quantize_int8(torch.randn((m, h), generator=gen, device=dev).to(torch.bfloat16))
        (gq, gs), (uq, us) = ((w.q, w.scale.reshape(1, -1)) for w in (
            quantize_weight((torch.randn((h, f), generator=gen, device=dev) * h ** -0.5)
                            .to(torch.bfloat16)) for _ in range(2)))
        want = int8_fused_mlp_ref(x_q, x_s, gq, gs, uq, us, out_dtype=torch.bfloat16)
        _tuned_check(torch, qops.int8_fused_mlp_hidden,
                     lambda: qops.int8_fused_mlp_q(x_q, x_s, gq, gs, uq, us,
                                                   out_dtype=torch.bfloat16, tuned=True,
                                                   act_dtype=torch.bfloat16),
                     lambda: qops._int8_fused_cuda(x_q, x_s, gq, gs, uq, us, "swiglu",
                                                   torch.bfloat16, forced=tile), want,
                     int8_fused_mlp_tol(x_q, x_s, gq, gs, uq, us, "swiglu", want),
                     f"int8_fused_mlp {m}x{h}x{f}")


def _sweep_paged(torch, cache, search, dev, gen):
    """The serve pool (64 slots x 128) and the prefix cell's block-table
    pool (64 rows x 192); each winner checked at lengths the serve run sees
    (16-96 live tokens, dead rows)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (paged_decode_blocktable_ref,
                                                         paged_decode_ref)
    from repro_torch.kernels.tolerance import paged_decode_blocktable_tol, paged_decode_tol
    b, nkv, a, d = ROWS, 8, 16, 128
    q = torch.randn((b, a, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.randint(16, 97, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[::7] = 0

    print(f"  paged_decode {b} rows over {b} slots x 128 (tile, splits):", flush=True)
    cfg = search.autotune_paged_decode(b, b, 128, nkv, a, d, cache=cache, iters=TUNE_ITERS,
                                       warmup=TUNE_WARMUP, verbose=True)
    rule = fops.paged_launch(b, nkv, a // nkv, d, 128, 2)
    print(_winner_line(cfg, f"{rule.tile}/{rule.splits}",
                       f"{cfg.blocks['tile']}/{cfg.blocks['splits']}"))
    kp, vp = (torch.randn((b, 128, nkv, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    slot = torch.arange(b, dtype=torch.int32, device=dev)
    want = paged_decode_ref(q, kp, vp, slot, lengths)
    geo = (cfg.blocks["tile"], cfg.blocks["splits"])
    _tuned_check(torch, fops.paged_decode,
                 lambda: fops.paged_decode(q, kp, vp, slot, lengths, tuned=True),
                 lambda: fops._paged_cuda(fops.paged_decode, q, kp, vp, None, None, slot,
                                          lengths, 0, None, geo), want,
                 paged_decode_tol(q, kp, vp, slot, lengths, want), "paged_decode serve pool")

    s_max = 192
    print(f"  paged_decode_blocktable_pool {b} rows x {s_max} (block_size, tile, splits):",
          flush=True)
    cfg = search.autotune_paged_decode_blocktable(b, b, s_max, nkv, a, d, cache=cache,
                                                  iters=TUNE_ITERS, warmup=TUNE_WARMUP,
                                                  verbose=True)
    rule = fops.paged_launch(b, nkv, a // nkv, d, s_max, 2)
    print(_winner_line(cfg, f"{PREFIX_BLOCK}/{rule.tile}/{rule.splits}", "/".join(
        str(cfg.blocks[k]) for k in ("block_size", "tile", "splits"))))
    bs = cfg.blocks["block_size"]
    mb = s_max // bs
    nb = b * mb
    kb, vb = (torch.randn((nb, bs, nkv, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    tables = torch.randperm(nb, generator=gen, device=dev).to(torch.int32).reshape(b, mb)
    entry = cache.get("paged_decode_blocktable", (b, nb, bs, nkv, a, d), "bfloat16", "h100")
    want = paged_decode_blocktable_ref(q, kb, vb, tables, lengths)
    geo = (entry.blocks["tile"], entry.blocks["splits"])
    _tuned_check(torch, fops.paged_decode_blocktable,
                 lambda: fops.paged_decode_blocktable(q, kb, vb, tables, lengths, tuned=True),
                 lambda: fops._paged_cuda(fops.paged_decode_blocktable, q, kb, vb, None, None,
                                          tables, lengths, mb, None, geo), want,
                 paged_decode_blocktable_tol(q, kb, vb, tables, lengths, want),
                 f"paged_decode_blocktable {bs}-token blocks")
    return cfg


@contextlib.contextmanager
def _lookups(modules):
    """Record every tuned lookup the wrappers of `modules` make while the
    block runs: {(op, shape): [lookups, hits]}."""
    seen = {}

    def wrap(real):
        def f(op, shape, dtype, hw_name):
            cfg = real(op, shape, dtype, hw_name)
            n = seen.setdefault((op, shape), [0, 0])
            n[0] += 1
            n[1] += cfg is not None
            return cfg
        return f
    reals = [(m, m.lookup) for m in modules]
    for m, real in reals:
        m.lookup = wrap(real)
    try:
        yield seen
    finally:
        for m, real in reals:
            m.lookup = real


def _tuned_serve(torch, params, cfg, dev, swept) -> None:
    """The serve cell's workload with the tuned cache installed: every GEMM
    and fused-MLP lookup at a swept shape must hit, and the prefill logits
    stay within LOGITS_REL_BOUND of the plain path."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.kernels.fused_mlp import ops as fops
    from repro_torch.kernels.matmul import ops as mops
    from repro_torch.serving.engine import Engine, synthetic_requests
    from repro_torch.serving.serve_step import make_prefill_step

    reqs = synthetic_requests(16, pattern="burst", min_prompt=16, max_prompt=64, min_new=8,
                              max_new=32, vocab=cfg.vocab_size, seed=0)
    for impl in ("tuned", "fused"):
        icfg = dataclasses.replace(cfg, linear_impl=impl)
        eng = Engine(params, icfg, max_batch=8, max_prompt=64, max_new=32,
                     use_paged_kernel=True, hw=H100_SXM, device=dev)
        eng.calibrate_step_s()
        for fn in (mops.matmul, fops.fused_mlp_hidden):
            fn.launches = fn.tuned_hits = fn.tuned_misses = 0
        with _lookups((mops, fops)) as seen:
            done, stats = eng.run(reqs)
            torch.cuda.synchronize()
        launched = mops.matmul.launches + fops.fused_mlp_hidden.launches
        hits = mops.matmul.tuned_hits + fops.fused_mlp_hidden.tuned_hits
        at_swept = {k: v for k, v in seen.items() if k in swept}
        misses = mops.matmul.tuned_misses + fops.fused_mlp_hidden.tuned_misses
        print(f"  tuned serve, linear_impl={impl!r}: {stats.total_generated} tokens, tok/s "
              f"{stats.tok_s:.1f}, ITL p50 {stats.itl_p50_s * 1e3:.2f} ms; {launched} GEMM and "
              f"fused-MLP launches, {hits} tuned hits, {misses} misses; lookups (calls/hits): "
              + ", ".join(f"{op} {'x'.join(map(str, s))} {n}/{h}"
                          for (op, s), (n, h) in sorted(seen.items())))
        if not at_swept or any(h != n for n, h in at_swept.values()):
            fail(f"tuned serve ({impl}): a launch at a swept shape missed the cache: {at_swept}")
        if sum(n for n, _ in seen.values()) != launched:
            fail(f"tuned serve ({impl}): {launched} launches but "
                 f"{sum(n for n, _ in seen.values())} lookups")
        for r, c in zip(reqs, done):
            if c.finish_reason != "length" or len(c.tokens) != r.max_new_tokens:
                fail(f"tuned serve: request {r.rid}: {c.finish_reason}")
        del eng
    tcfg = dataclasses.replace(cfg, linear_impl="tuned")
    prompts = torch.as_tensor(synthetic_tokens(0, 0, 4, 64, cfg.vocab_size), device=dev)
    lk, _ = make_prefill_step(tcfg, 64)(params, {"tokens": prompts})
    lp, _ = make_prefill_step(dataclasses.replace(cfg, linear_impl="jnp"), 64)(
        params, {"tokens": prompts})
    lk, lp = lk[:, :cfg.vocab_size].float(), lp[:, :cfg.vocab_size].float()
    rel = ((lk - lp).norm() / lp.norm()).item()
    print(f"  tuned prefill logits vs the plain path: rel err {rel:.3e} (bound {LOGITS_REL_BOUND})")
    if not torch.isfinite(lk).all() or rel > LOGITS_REL_BOUND:
        fail(f"tuned prefill logits differ from the plain path by {rel:.3e}")


def _tuned_prefix(torch, cfg, dev, pool_entry) -> None:
    """The prefix engine at REDUCED_LAYERS layers must take its block size
    from the pool entry; the prefix workload with BlockPool.check() after
    every step."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels.flash_attention.ops import paged_decode_blocktable as pbt
    from repro_torch.models import init_lm
    from repro_torch.serving.engine import Engine

    rcfg = dataclasses.replace(cfg, num_layers=REDUCED_LAYERS, linear_impl="fused")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), rcfg, device=dev)
    eng = Engine(params, rcfg, max_batch=8, max_prompt=128, max_new=32, use_paged_kernel=True,
                 prefix_cache=True, hw=H100_SXM, device=dev)
    bs = pool_entry.blocks["block_size"]
    print(f"  tuned prefix engine ({REDUCED_LAYERS} layers): block size {eng.pool.block_size} "
          f"(the pool entry's {bs}; the fallback {PREFIX_BLOCK}), "
          f"{eng.pool.blocks.num_blocks} blocks (+ garbage)")
    if eng.pool.block_size != bs:
        fail(f"the prefix engine took block size {eng.pool.block_size}, not the entry's {bs}")
    pbt.tuned_hits = pbt.tuned_misses = 0
    done, stats, _ = serve_run(torch, eng, _prefix_requests(cfg.vocab_size),
                               "tuned prefix (BlockPool.check() after every step)",
                               "paged_decode_blocktable", check_invariants=True)
    eng.pool.blocks.check()
    print(f"    block-table lookups: {pbt.tuned_hits} hits, {pbt.tuned_misses} misses (the "
          f"kernel-level entries key num_rows x max_blocks blocks, as JAX's search does; the "
          f"engine's pool holds one more, its garbage block)")


def _host_us(torch, dev, gen) -> None:
    """The host's us per wrapper call with the lookup (tuned, a memoized
    hit) and without (the rule), at the serve shapes, the card asleep."""
    from repro_torch.kernels.flash_attention.ops import paged_decode
    from repro_torch.kernels.matmul.ops import matmul
    a = torch.randn((ROWS, 2048), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((2048, 2048), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((ROWS, 16, 128), generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn((ROWS, 128, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    slot = torch.arange(ROWS, dtype=torch.int32, device=dev)
    lengths = torch.full((ROWS,), 96, dtype=torch.int32, device=dev)
    rows = []
    for name, call in (("matmul 64x2048x2048", lambda t: matmul(a, w, tuned=t)),
                       ("paged_decode serve pool",
                        lambda t: paged_decode(q, kp, kp, slot, lengths, tuned=t))):
        us = {False: [], True: []}
        for t in (False, True) * 3:       # in turns
            us[t].append(time_ms(torch, [lambda t=t: call(t)], 200)[1])
        rows.append(f"{name} {min(us[False]):.1f} without, {min(us[True]):.1f} with the lookup")
    print("  host us per wrapper call (min of 3 x 200 calls, in turns): " + "; ".join(rows))


def tuning_phase(torch):
    """Autotune the serve and int8-serve shapes into a cache file in a
    temporary directory (every candidate's time, the winner, the rule's pick
    over the winner; each winner bit-identical to a forced launch of its
    geometry and within its bound of the plain version), reload it, install
    it, and run the serve workload (tuned and fused), the prefix engine at
    4 layers and the host's cost of a lookup against it.  Returns the
    installed cache."""
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_lm
    from repro_torch.tuning import search
    from repro_torch.tuning.cache import TuningCache, set_default_cache

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cache = TuningCache(os.path.join(tmp, "tuning_cache.json"))
        set_default_cache(cache)
        print(f"tuning: autotune on {torch.cuda.get_device_name(0)} into {cache.path} (us a "
              f"call, CUDA events, operands rotated past L2, {TUNE_ITERS} calls a candidate):")
        _sweep_gemms(torch, cache, search, dev, gen)
        _sweep_fused(torch, cache, search, dev, gen)
        _sweep_int8(torch, cache, search, dev, gen)
        pool_entry = _sweep_paged(torch, cache, search, dev, gen)
        cache.save()
        cache = TuningCache.load(cache.path)
        print(f"  {len(cache)} entries saved and reloaded")
    set_default_cache(cache)
    torch.cuda.empty_cache()
    swept = {("matmul", (m, k, n)) for m in TUNE_ROWS for k, n in TUNE_GEMMS.values()}
    swept.add(("fused_mlp_swiglu", (ROWS, *TUNE_GEMMS["gate/up"])))
    cfg = get_config("internlm2-1.8b")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    _tuned_serve(torch, params, cfg, dev, swept)
    del params
    torch.cuda.empty_cache()
    _tuned_prefix(torch, cfg, dev, pool_entry)
    _host_us(torch, dev, gen)
    torch.cuda.empty_cache()
    return cache


# --- codesign phase: the paper's Fig. 1 through the port ----------------------------------

CODESIGN_ITERS = 5


def _layer_gemm_shapes(h: int, f: int, m: int):
    """(op, (m, k, n)) of every GEMM key one gpt3 block's forward and
    backward look up through `linear` and the fused MLP (linear_impl
    "fused", GELU): q/k/v/o forward and dgrad (m, h, h), their wgrad
    (h, m, h); the fused hidden (m, h, f); its backward's dx (m, f, h) and
    dW (h, m, f); w_down forward (m, f, h), dgrad (m, h, f), wgrad (f, m, h)."""
    return [("matmul", (m, h, h)), ("matmul", (h, m, h)), ("fused_mlp_gelu", (m, h, f)),
            ("matmul", (m, f, h)), ("matmul", (h, m, f)), ("matmul", (m, h, f)),
            ("matmul", (f, m, h))]


def codesign_phase(torch, cache) -> None:
    """One dense block of each gpt3-2.7b variant C0-C3 (b 4, s 2048, bf16,
    linear_impl="fused", attn_impl="flash"), forward and backward, timed by
    CUDA events, after autotuning the block's GEMM keys into `cache` (the
    same for all four: a x hd = 2560).  Prints per variant the measured ms,
    TFLOP/s over 3 x the forward GEMMs of `layer_gemms`, speed vs C0, the
    advisor's analytic and MeasuredProfile-calibrated predictions and both
    orders.  The order is a finding, not a check."""
    from repro_torch.configs.gpt3_2p7b import VARIANTS
    from repro_torch.core import gemm_model, transformer_gemms
    from repro_torch.core.hardware import get_hardware
    from repro_torch.models.blocks import apply_stack, init_segment
    from repro_torch.tuning import search

    dev = torch.device("cuda")
    hw = get_hardware("h100")
    b, s = GPT3_BATCH, GPT3_SEQ
    c0 = VARIANTS["c0"]
    h, f, m = c0.d_model, c0.d_ff, b * s
    print(f"codesign: gpt3-2.7b C0-C3 one block, b {b}, s {s}, bf16, fused linear, flash; "
          f"autotuning its GEMM keys:", flush=True)
    for op, (mm, k, n) in _layer_gemm_shapes(h, f, m):
        if op == "matmul":
            cfg = search.autotune_matmul(mm, k, n, cache=cache, iters=CODESIGN_ITERS, warmup=2)
        else:
            cfg = search.autotune_fused_mlp(mm, k, n, mlp_type="gelu", cache=cache,
                                            iters=CODESIGN_ITERS, warmup=2)
        print(f"  {op} {mm}x{k}x{n}: winner {cfg.blocks} {cfg.time_us:.1f} us; the rule's pick "
              f"{cfg.baseline_us:.1f} us = {cfg.speedup_vs_default:.3f}x", flush=True)
    profile = gemm_model.MeasuredProfile.from_cache(cache, "h100")
    print(f"  MeasuredProfile: {len(profile.points)} measured matmul shapes, calibration "
          f"(median measured / analytic) {profile.calibration:.3f}")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {}
    for name, vcfg in VARIANTS.items():
        cfg = dataclasses.replace(vcfg, linear_impl="fused", attn_impl="flash",
                                  dtype="bfloat16")
        seg = init_segment(gen, cfg, "dense", 1, device=dev, dtype=torch.bfloat16)
        for _, t in _paths(seg):
            t.requires_grad_(True)
        x = torch.randn((b, s, h), generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
        dy = torch.randn((b, s, h), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.arange(s, device=dev)

        def step():
            y, _, _ = apply_stack([("dense", seg)], cfg, x, positions=pos)
            y.backward(dy)
        step()
        step()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(CODESIGN_ITERS):
            step()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / CODESIGN_ITERS
        if not all(torch.isfinite(t.grad).all() for _, t in _paths(seg)):
            fail(f"codesign {name}: non-finite gradients")
        gemms = transformer_gemms.layer_gemms(cfg, b, s, mode="train")
        flops = 3 * sum(g.flops for g in gemms)
        rows[name] = dict(heads=cfg.num_heads, hd=cfg.head_dim, ms=ms, tflops=flops / ms / 1e9,
                          analytic=3 * gemm_model.total_time(gemms, hw) * 1e3,
                          calibrated=3 * gemm_model.total_time(gemms, hw, profile) * 1e3)
        del seg, x, dy
        torch.cuda.empty_cache()
    base = rows["c0"]
    for name, r in rows.items():
        print(f"  {name.upper()} {r['heads']} x {r['hd']}: measured {r['ms']:.3f} ms "
              f"({r['tflops']:.1f} TFLOP/s over 3 x the forward GEMMs), "
              f"{base['ms'] / r['ms']:.3f}x C0; predicted (model, no card) analytic {r['analytic']:.3f} ms "
              f"({base['analytic'] / r['analytic']:.3f}x), calibrated {r['calibrated']:.3f} ms "
              f"({base['calibrated'] / r['calibrated']:.3f}x)")
    for what in ("ms", "analytic", "calibrated"):
        order = " < ".join(n.upper() for n in sorted(rows, key=lambda n: rows[n][what]))
        print(f"  order by {'measured' if what == 'ms' else what} time: {order}")



def main() -> None:
    t0 = time.perf_counter()
    torch = setup()
    device_phase(torch)
    # an empty default tuning cache: every phase before the tuning phase
    # launches its wrappers' rules, whatever tuning_cache.json the checkout holds
    from repro_torch.tuning.cache import TuningCache, set_default_cache
    set_default_cache(TuningCache())
    print("tuning: an empty default cache installed (every phase up to the tuning phase runs "
          "the wrappers' rules)")
    spent = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        spent[name] = time.perf_counter() - t
        return out

    phase("build", build_phase)
    rows = phase("kernels", kernel_phase, torch)
    rows.update(phase("prefix kernels", prefix_kernel_phase, torch))
    rows.update(phase("train kernels", train_kernel_phase, torch))
    phase("f32 kernels", f32_kernel_phase, torch)
    phase("attention table", attention_table_phase, torch)
    rows.update(phase("int8 kernels", int8_kernel_phase, torch))
    rows.update(phase("ssd kernels", ssd_kernel_phase, torch))
    rows.update(phase("ssd backward", ssd_bwd_kernel_phase, torch))
    rows.update(phase("moe kernels", moe_kernel_phase, torch))
    if PARENT:
        phase("ssd backward a/b", ssd_bwd_ab_phase)
    counts = phase("serve", serve_phase, torch)
    prefix = phase("prefix serve", prefix_serve_phase, torch)
    quantized = phase("quantized serve", quantized_serve_phase, torch)
    ssm = phase("ssm serve", ssm_serve_phase, torch)
    phase("hybrid serve", hybrid_serve_phase, torch)
    moe = phase("moe serve", moe_serve_phase, torch)
    moe_engine = phase("moe engine", moe_engine_phase, torch)
    phase("token identity", token_identity_phase, torch)
    phase("ssm token identity", ssm_token_identity_phase, torch)
    train = phase("train", train_phase, torch)
    ssm_train_counts = phase("ssm train", ssm_train_phase, torch)
    phase("hybrid train", hybrid_train_phase, torch)
    cache = phase("tuning", tuning_phase, torch)
    phase("codesign", codesign_phase, torch, cache)
    print(f"phases (s): {json.dumps({k: round(v, 1) for k, v in spent.items()})}; all "
          f"{time.perf_counter() - t0:.1f} s")
    # launches over the main path's runs: the serve run's (the serve-shape
    # rows), then the 4 training steps' (the train-shape rows).  Each row
    # counts the launches of the shapes it checked and timed: matmul_train is
    # linear's forward (the "nn" layout), matmul_dgrad / matmul_wgrad are
    # linear's gradient GEMMs; the fused-MLP backward's own dx ("nt") and
    # dWg / dWu ("tn") tile GEMMs ride in its row, as its ms does.
    # The prefix slice's rows count their runs in the prefix serve phase: the
    # cold block-table run, the int8 slot and the int8 prefix engine's runs.
    # The int8-weight slice's rows count the int8-weight slot engine's run.
    # The SSM slice's row counts the ssm serve run (a prefill and the decode
    # steps; the decode steps launch none).  The SSD backward's row counts the
    # ssm train phase's timed steps (mamba2-780m, one a layer a step).  The
    # MoE slice's rows count the moe serve phase's prefill and decode steps
    # (deepseek-v3) and the moe engine phase's slot and prefix runs
    # (llama4-maverick), one launch per MoE layer a pass.
    launches = {"matmul": counts["matmul"], "fused_mlp_hidden": counts["fused_mlp_hidden"],
                "paged_decode": counts["paged_decode"], **prefix,
                "int8_matmul": quantized["int8_matmul"],
                "int8_fused_mlp": quantized["int8_fused_mlp"],
                "matmul_train": train["matmul_nn"],
                "fused_mlp_hidden_train": train["fused_mlp_hidden"],
                "flash_attention": train["flash_attention"],
                "flash_attention_bwd": train["flash_attention_bwd"],
                "fused_mlp_bwd": train["fused_mlp_bwd"],
                "matmul_dgrad": train["matmul_nt"] - train["fused_mlp_bwd"],
                "matmul_wgrad": train["matmul_tn"] - 2 * train["fused_mlp_bwd"],
                "ssd_chunk": ssm["ssd_chunk"],
                "ssd_chunk_bwd": ssm_train_counts["ssd_chunk_bwd"],
                "matmul_expert": moe["matmul_expert"] + moe_engine["matmul_expert"],
                "fused_mlp_hidden_expert": moe["fused_mlp_hidden_expert"]
                + moe_engine["fused_mlp_hidden_expert"]}
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] <= 0:
            fail(f"{name}: no launch on the main path")
    order = ("matmul", "fused_mlp_hidden", "paged_decode", "paged_decode_blocktable",
             "paged_decode_int8", "paged_decode_blocktable_int8", "matmul_train",
             "fused_mlp_hidden_train", "flash_attention", "flash_attention_bwd",
             "fused_mlp_bwd", "matmul_dgrad", "matmul_wgrad", "int8_matmul", "int8_fused_mlp",
             "ssd_chunk", "ssd_chunk_bwd", "matmul_expert", "fused_mlp_hidden_expert")
    print(json.dumps({"kernels": [rows[n] for n in order]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
