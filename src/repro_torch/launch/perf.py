"""§Perf hillclimbing: run named treatments of a (arch x shape) cell
through the dry run and compare the three roofline terms (the JAX
package's `launch/perf.py`, with every cell, treatment and hypothesis).

Each treatment is hypothesis -> change; the measurement is the traced
step's roofline terms on the H100 (`launch/dryrun.py`: analytic, from the
op counter).  Where the baseline keeps naive attention's s^2 tensors, the
row adds the flash-substituted memory term: the counted s^2 bytes
replaced by the port's flash kernels' traffic (`flash_kernel_bytes`),
priced at the H100's HBM rate and peak (`core/hardware.py`).

    PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen --out perf.jsonl

Two of JAX's treatments mean something else in the port: `serve_tp_only`
is how the port always serves (its serve steps refuse FSDP), so the
command_r_decode baseline and its tp_only_params row trace the same
step; `no_tp` re-purposes the model axis as the port's outer data axis.
"""
import argparse
import json

from ..configs.base import SHAPES
from ..configs.registry import get_config
from ..core.hardware import get_hardware
from ..kernels.flash_attention.ops import FLASH_QUERY_TILE, flash_bwd_cost, flash_cost
from .dryrun import HW, run_cell

# treatment := (tag, cfg_patch, tc_patch, hypothesis)
CELLS = {
    # §Perf pair 1: most representative of the paper's technique
    # (GPT-family dense; memory-bound baseline from naive Table-II attention)
    "qwen": ("qwen1.5-4b", "train_4k", [
        ("baseline", {}, {},
         "paper-faithful Table II decomposition; expect memory-dominant"),
        ("blocked_attn", {"attn_impl": "blocked", "attn_block_kv": 1024}, {},
         "streaming softmax removes resident s^2 scores; memory term down"),
        ("blocked+mb4", {"attn_impl": "blocked"}, {"microbatch_per_device": 4},
         "4x fewer grad-accum rounds => 4x fewer FSDP weight re-gathers and "
         "larger GEMMs; memory & collective terms down"),
        ("blocked+mb8", {"attn_impl": "blocked"}, {"microbatch_per_device": 8},
         "push accumulation further; check for diminishing returns"),
        ("blocked+mb4+dots", {"attn_impl": "blocked"},
         {"microbatch_per_device": 4, "remat": "dots"},
         "checkpoint only matmul outputs: less recompute, compute term down"),
        ("advisor_heads", {"attn_impl": "blocked", "num_heads": 32,
                           "num_kv_heads": 32, "head_dim": 80},
         {"microbatch_per_device": 4},
         "co-design check: qwen a=20 does not divide tp=16 (shard "
         "quantization); a=32 divides but head_dim falls 128->80 "
         "(tile quantization) — measure which effect dominates"),
        ("advisor_naive", {"num_heads": 32, "num_kv_heads": 32,
                           "head_dim": 80}, {},
         "a=32 with naive attention so the s^2 census (and the Pallas "
         "flash substitution) composes with the divisibility fix"),
        ("advisor_naive+mb4", {"num_heads": 32, "num_kv_heads": 32,
                               "head_dim": 80}, {"microbatch_per_device": 4},
         "stack divisibility fix + 4x fewer FSDP gather rounds + flash "
         "kernel substitution: the beyond-paper optimized candidate"),
        ("advisor_naive+mb4+sp", {"num_heads": 32, "num_kv_heads": 32,
                                  "head_dim": 80, "seq_parallel": True},
         {"microbatch_per_device": 4},
         "Megatron sequence parallelism: residual-stream norms/adds run "
         "1/16 seq-sharded; activation memory traffic between TP blocks "
         "drops ~t-fold"),
    ]),
    # §Perf pair 2: most collective-bound (MoE + MLA + FSDP)
    "deepseek": ("deepseek-v3-671b", "train_4k", [
        ("baseline", {}, {},
         "EP dispatch + per-microbatch FSDP gathers; expect collective-dominant"),
        ("mb4", {}, {"microbatch_per_device": 4},
         "4x fewer microbatches => 4x fewer param all-gather rounds; "
         "collective term down ~proportionally"),
        ("mb4+blocked", {"attn_impl": "blocked"}, {"microbatch_per_device": 4},
         "MLA s^2 scores also memory-heavy at s=4096; memory term down"),
        ("mb4+cap1.0", {"moe_capacity_factor": 1.0},
         {"microbatch_per_device": 4},
         "tighter expert capacity: 20% less dispatch all-to-all traffic"),
        ("mb16_runner", {}, {"microbatch_per_device": 16},
         "extreme accumulation: collective floor test (activation memory "
         "would rise on real HW; dry-run bounds the collective win)"),
        ("mb4+a2a_dispatch", {"moe_dispatch": "shard_map"},
         {"microbatch_per_device": 4},
         "explicit EP schedule (shard_map): tokens are replicated over the "
         "EP axis, so dispatch is fully local and the combine is ONE bf16 "
         "psum of (t_loc, h) per layer — replaces XLA's multi-pass f32 "
         "gather/all-reduce combine (11 TB/chip measured)"),
    ]),
    # bonus serving cell: decode latency is bound by weight streaming; FSDP
    # param sharding (right for training) re-gathers weights every token
    "command_r_decode": ("command-r-plus-104b", "decode_32k", [
        ("baseline", {}, {},
         "serving with training-style FSDP params: expect per-token weight "
         "all-gathers to dominate the collective term"),
        ("tp_only_params", {}, {"serve_tp_only": True},
         "TP-only param sharding (104B bf16 / 16 = 13 GB/chip, fits without "
         "optimizer state): collectives collapse; memory term becomes the "
         "physics floor params/HBM_bw ~ 16 ms/token"),
    ]),
    # bonus cell: the most compute-bound arch — remat policy is the lever
    "nemotron": ("nemotron-4-340b", "train_4k", [
        ("baseline", {}, {},
         "full remat: fwd recomputed in bwd => ~4/3 of minimal GEMM flops"),
        ("dots", {}, {"remat": "dots"},
         "checkpoint matmul outputs only: recompute drops, compute term "
         "down ~20-25%; memory term may rise (saved dot outputs)"),
        ("dots+mb4", {}, {"remat": "dots", "microbatch_per_device": 4},
         "larger per-chip GEMMs on top"),
    ]),
    # §Perf pair 3: worst train-cell roofline fraction (tiny model on a big
    # mesh: per-shard widths fall under the 128-lane tile at tp=16)
    "whisper": ("whisper-small", "train_4k", [
        ("baseline", {}, {},
         "d_model/tp = 48 < 128 lanes: shard-quantization-bound"),
        ("blocked_attn", {"attn_impl": "blocked"}, {},
         "remove s^2 score traffic first"),
        ("no_tp", {}, {"no_tp": True},
         "advisor hidden_shard_alignment fix: drop TP entirely (params "
         "replicate over model axis; whisper is 0.24B so they fit), all TP "
         "collectives disappear, every GEMM regains full-width shards"),
        ("no_tp+blocked", {"attn_impl": "blocked"}, {"no_tp": True},
         "compose both fixes"),
        ("no_tp+blocked+mb4", {"attn_impl": "blocked"},
         {"no_tp": True, "microbatch_per_device": 4},
         "fewer accumulation rounds on top"),
        ("no_tp+naive+mb4", {}, {"no_tp": True, "microbatch_per_device": 4},
         "naive attention so the flash-kernel substitution applies on top "
         "of the no-TP fix: the beyond-paper optimized candidate"),
    ]),
}


def flash_kernel_bytes(arch: str, shape_name: str, mb: int, cfg_patch=None) -> float:
    """A rank's HBM traffic of the port's flash kernels in place of naive
    attention over one train step at 16 x 16: per query tile of
    FLASH_QUERY_TILE rows (the forward kernel's), `flash_cost` of that tile
    against the keys it reads (the causal prefix), so each tile re-reads
    its K / V; the forward twice (remat="full" recomputes it) and the
    backward (`flash_bwd_cost`) once, every layer, every microbatch."""
    import dataclasses
    cfg = get_config(arch)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    sh_ = SHAPES[shape_name]
    if not cfg.num_heads:
        return 0.0
    tp, dp = 16, 16
    s = sh_.seq_len
    n_micro = max(sh_.global_batch // (dp * mb), 1)
    a_pc = max(cfg.num_heads // tp, 1)
    kv_pc = max(cfg.num_kv_heads // tp, 1)
    per_layer = 0.0
    for q0 in range(0, s, FLASH_QUERY_TILE):
        rows = min(FLASH_QUERY_TILE, s - q0)
        keys = q0 + rows
        args = (mb, rows, keys, a_pc, kv_pc, cfg.head_dim, False, 2)
        per_layer += 2 * flash_cost(*args)[1] + flash_bwd_cost(*args)[1]
    return cfg.num_layers * n_micro * per_layer


def flash_substituted(row: dict, arch: str, shape: str, tc_patch: dict,
                      cfg_patch: dict) -> dict:
    """flash_sub_memory_s and flash_sub_roofline_fraction of a traced row
    with s^2 bytes, on the H100."""
    hw = get_hardware(HW)
    mb = tc_patch.get("microbatch_per_device", 1)
    sub_bytes = row["hlo_bytes"] - row["s2_bytes"] + flash_kernel_bytes(arch, shape, mb,
                                                                       cfg_patch)
    mem_s = sub_bytes / hw.hbm_bw
    return {"flash_sub_memory_s": mem_s,
            "flash_sub_roofline_fraction": row["model_flops_per_chip"]
            / max(row["compute_s"], mem_s, row["collective_s"]) / hw.peak_flops}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    arch, shape, treatments = CELLS[args.cell]
    out_f = open(args.out, "a") if args.out else None
    for tag, cfg_patch, tc_patch, hypothesis in treatments:
        if args.only and args.only != tag:
            continue
        row = run_cell(arch, shape, False, cfg_patch=dict(cfg_patch),
                       tc_patch=dict(tc_patch), tag=tag)
        row["hypothesis"] = hypothesis
        # kernel-substituted memory term (the port's flash kernels in place
        # of the naive attention the baseline traces)
        if row.get("status") == "ok" and row.get("s2_bytes"):
            row.update(flash_substituted(row, arch, shape, dict(tc_patch), dict(cfg_patch)))
        if out_f:
            out_f.write(json.dumps(row) + "\n")
            out_f.flush()
        brief = {k: row.get(k) for k in
                 ("tag", "status", "compute_s", "memory_s", "collective_s",
                  "dominant", "roofline_fraction", "flash_sub_roofline_fraction", "error")}
        print(json.dumps(brief), flush=True)
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
