"""Production-mesh dry run: trace every (architecture x input-shape) cell on
the production meshes and price it on the H100's roofline (the JAX
package's `launch/dryrun.py`).

JAX lowers and compiles each cell for a 16 x 16 (or 2 x 16 x 16) mesh of
placeholder devices and walks the compiled HLO.  The port has no compiler
and no partitioner: per cell this module
  1. builds the production mesh as a virtual mesh seen from rank 0
     (`launch/mesh.virtual_mesh`: each collective returns a tensor of the
     right shape and dtype without communicating) and the `Plan` over it
     (KV heads replicated where `model` outnumbers them);
  2. builds meta stand-ins of rank 0's params, optimizer state, batch and
     caches (`launch/input_specs.py`);
  3. runs rank 0's train step, prefill or decode on the meta device under
     the op counter (`core/op_analysis.py`): dot FLOPs, the eager program's
     bytes, each hand-written kernel charged by its `cost` function, the
     collectives' wire bytes; one microbatch traced and counted n_micro
     times (the HLO walk's trip-count rule);
  4. hands the counts to `roofline.build_report` with the H100's peak, HBM
     and NVLink rates (`core/hardware.py`).
A cell whose query heads do not split over `model` runs as halo heads
(`sharding.head_span`): its row's "halo" holds the traced rank's heads
computed against its own share of them (the attention FLOPs' factor, that
rank's and the mean over the ranks) and the bytes of the halo gathers,
which its collective bytes include; `validate_divisibility`'s head entry
stays among its warnings, as in JAX.  A cell the plan refuses is
`status: "error"` with the refusal.  Serving holds params whole over `data` (the port's
serve steps refuse FSDP), so prefill and decode cells run as JAX's
`serve_tp_only` treatment does.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k [--multipod]
  python -m repro_torch.launch.dryrun --all [--multipod] --out results.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Optional

import torch

from ..configs.base import SHAPES, MeshConfig, ModelConfig, ShapeConfig, TrainConfig
from ..configs.registry import get_config
from ..core import advisor, op_analysis, roofline
from ..core.hardware import get_hardware
from ..parallel import comm
from ..parallel import sharding as sh
from ..serving.serve_step import make_decode_step, make_prefill_step
from ..train.train_step import make_train_step
from .input_specs import input_specs, opt_structs, param_structs, tree_bytes
from .mesh import production_mesh_config, virtual_mesh

ASSIGNED = [
    "zamba2-2.7b", "qwen1.5-4b", "nemotron-4-340b", "internlm2-1.8b",
    "command-r-plus-104b", "deepseek-v3-671b", "llama4-maverick-400b-a17b",
    "internvl2-76b", "whisper-small", "mamba2-780m",
]

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

HW = "h100"


def cell_supported(cfg: ModelConfig, shape: ShapeConfig):
    """(runnable, reason-if-skipped), JAX's rule."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: O(s^2) at 524k skipped per task spec"
    return True, ""


def _train_config(cfg: ModelConfig) -> TrainConfig:
    big = cfg.param_count() > 60e9
    return TrainConfig(optimizer="adamw8bit" if big else "adamw",
                       remat="full", microbatch_per_device=1)


def model_flops_total(cfg: ModelConfig, shape: ShapeConfig, flops_mult: float) -> float:
    """Useful FLOPs per step: 6·N_active·D (train) / 2·N_active·D (serve)."""
    n = cfg.active_param_count()
    if shape.mode == "decode":
        d = shape.global_batch  # one token per sequence
    else:
        d = shape.global_batch * shape.seq_len
    return (2.0 * flops_mult) * n * d


def warnings_for(cfg: ModelConfig, mesh_cfg: MeshConfig, global_batch: int) -> list:
    """JAX's warnings (the advisor's findings, then `validate_divisibility`),
    the advisor's on the H100."""
    out = [f"{f.rule}: {f.message}"
           for f in advisor.check_alignment(cfg, hw=get_hardware(HW), tp=mesh_cfg.model,
                                            global_batch=global_batch)
           if f.severity != "ok"]
    return out + sh.validate_divisibility(cfg, mesh_cfg, global_batch)


def _mesh_config(multi_pod: bool, no_tp: bool, serving: bool) -> MeshConfig:
    """The production mesh; `no_tp` (JAX's patch) makes the model axis more
    data parallelism with params replicated over it: the port's outer data
    axis `pod` (FSDP stays on `data`, as JAX's specs keep it); serving holds
    params whole over data."""
    base = production_mesh_config(multi_pod=multi_pod)
    if no_tp:
        base = MeshConfig(pod=base.pod * base.model, data=base.data, model=1)
    return dataclasses.replace(base, fsdp=not serving)


def trace_cell(arch: str, shape_name: str, multi_pod: bool = False,
               cfg_patch: Optional[dict] = None, tc_patch: Optional[dict] = None,
               rank: int = 0, cfg: Optional[ModelConfig] = None):
    """Trace one cell's step for `rank` on the meta device under the op
    counter.  Returns (Counter, meta): meta holds the mesh, n_micro, the
    optimizer, the argument bytes and the flops multiplier."""
    cfg = cfg or get_config(arch)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    tc_patch = dict(tc_patch or {})
    no_tp = bool(tc_patch.pop("no_tp", False))
    tc_patch.pop("serve_tp_only", None)     # the port's serving always is
    shape = SHAPES[shape_name]
    serving = shape.mode != "train"
    mesh_cfg = _mesh_config(multi_pod, no_tp, serving)
    mesh = virtual_mesh(mesh_cfg, rank, sh.kv_replication(cfg, mesh_cfg.model))
    plan = sh.Plan(cfg, mesh)
    dp = mesh_cfg.dp
    small_batch = shape.global_batch < dp
    # b < dp: the batch replicated over the data axes (JAX's _fix_small_batch)
    rows = shape.global_batch if small_batch else shape.global_batch // dp
    meta = {"mesh": mesh_cfg, "num_chips": mesh_cfg.num_devices, "rows": rows}
    if shape.mode == "train":
        tc = _train_config(cfg)
        if tc_patch:
            tc = dataclasses.replace(tc, **tc_patch)
        n_micro = 1 if small_batch else max(rows // tc.microbatch_per_device, 1)
        params = param_structs(cfg, plan=plan)
        opt = opt_structs(cfg, tc, plan)
        # the global batch; `Plan.batch_rows` takes this rank's rows (b < dp: all of them)
        batch = input_specs(cfg, shape)
        args = tree_bytes(params) + tree_bytes(opt) + tree_bytes(batch) * rows // \
            batch["tokens"].shape[0]
        step = make_train_step(cfg, tc, n_micro=n_micro, plan=plan)
        with op_analysis.count(trace_one=True) as counter:
            step(params, opt, batch)
        counter.counts.loops.setdefault("microbatch", n_micro)
        meta.update(n_micro=n_micro, optimizer=tc.optimizer, flops_mult=3.0)
    else:
        params = param_structs(cfg, dtype=torch.bfloat16, plan=plan)
        ins = input_specs(cfg, shape, plan, rows=rows)
        with torch.no_grad():
            if shape.mode == "prefill":
                step = make_prefill_step(cfg, shape.seq_len, plan)
                args = tree_bytes(params) + tree_bytes(ins)
                with op_analysis.count() as counter:
                    step(params, ins)
            else:
                enc = None
                if cfg.is_encoder_decoder:
                    enc = torch.empty((rows, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                                      device="meta")
                step = make_decode_step(cfg, plan)
                args = tree_bytes(params) + tree_bytes(ins["token"]) + \
                    tree_bytes(ins["caches"]) + tree_bytes(enc)
                with op_analysis.count() as counter:
                    step(params, ins["token"], ins["caches"], ins["index"], enc)
        meta.update(flops_mult=1.0)
    meta["argument_bytes"] = args
    meta["halo"] = halo_row(cfg, mesh_cfg.model, rank, counter.counts.coll)
    return counter, meta


def halo_row(cfg: ModelConfig, t: int, rank: int, coll: dict) -> Optional[dict]:
    """Halo heads at `model` = t (None where the heads split): rank's query
    heads computed and its own share of them (num_heads / t), their ratio
    (the factor on its attention FLOPs) and the mean ratio over the t
    ranks, and the halo gathers' wire bytes by JAX kind (from the census's
    `coll`, under `comm.HALO_KINDS`)."""
    if cfg.attn_type != "gqa" or not cfg.num_heads or t == 1 \
            or not sh.head_span(cfg, t, rank).halo:
        return None
    own = cfg.num_heads / t
    heads = [sh.head_span(cfg, t, r).q for r in range(t)]
    h0, h1 = heads[rank]
    gathered = {base: coll.get(kind, 0.0) for kind, base in comm.HALO_KINDS.items()}
    return {"heads": h1 - h0, "own_heads": own, "flops_factor": (h1 - h0) / own,
            "mean_flops_factor": sum(b - a for a, b in heads) / t / own,
            "gather_bytes": gathered, "gather_total": sum(gathered.values())}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             cfg_patch: Optional[dict] = None, tc_patch: Optional[dict] = None,
             tag: str = "", cfg: Optional[ModelConfig] = None) -> dict:
    """One row: JAX's keys but the HLO-only ones (`trace_s` in place of
    lower_s / compile_s; no cost_analysis_flops_raw, no hlo_len)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if tag:
        row["tag"] = tag
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        row.update({"status": "skipped", "reason": reason})
        return row
    try:
        patched = dataclasses.replace(cfg, **cfg_patch) if cfg_patch else cfg
        t0 = time.time()
        counter, meta = trace_cell(arch, shape_name, multi_pod, cfg_patch, tc_patch, cfg=cfg)
        t1 = time.time()
        counts = counter.counts
        mem_row = {"argument_bytes": meta["argument_bytes"],
                   "peak_bytes": meta["argument_bytes"] + counter.peak_bytes}
        coll = {k: counts.coll.get(k, 0.0) for k in op_analysis.COLLECTIVES}
        for kind, base in comm.HALO_KINDS.items():
            coll[base] += counts.coll.get(kind, 0.0)
        coll["total"] = sum(coll.values())
        rep = roofline.build_report(
            arch, shape_name, mesh_name, meta["num_chips"], counts.flops, counts.bytes, coll,
            model_flops_total(patched, shape, meta["flops_mult"]), hw=get_hardware(HW),
            bytes_per_device=mem_row["peak_bytes"])
        row.update({
            "status": "ok",
            "trace_s": round(t1 - t0, 1),
            "loops": counts.loops,
            "s2_bytes": counts.s2_bytes,
            "hlo_flops": rep.hlo_flops,
            "hlo_bytes": rep.hlo_bytes,
            "coll_bytes": rep.coll_bytes,
            "coll_breakdown": rep.coll_breakdown,
            "compute_s": rep.compute_s,
            "memory_s": rep.memory_s,
            "collective_s": rep.collective_s,
            "dominant": rep.dominant,
            "model_flops_per_chip": rep.model_flops,
            "useful_ratio": rep.useful_ratio,
            "roofline_fraction": rep.roofline_fraction,
            "mem": mem_row,
            "warnings": warnings_for(patched, production_mesh_config(multi_pod=multi_pod),
                                     shape.global_batch),
            "n_micro": meta.get("n_micro"),
            "kernels": counts.kernels,
        })
        if meta["halo"] is not None:
            row["halo"] = meta["halo"]
    except Exception as e:
        row.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=SHAPE_ORDER + [None])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = SHAPE_ORDER if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    out_f = open(args.out, "a") if args.out else None
    n_ok = n_err = n_skip = 0
    for a, s, mp in cells:
        row = run_cell(a, s, mp)
        line = json.dumps(row)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()
        status = row["status"]
        n_ok += status == "ok"
        n_err += status == "error"
        n_skip += status == "skipped"
        brief = {k: row.get(k) for k in
                 ("arch", "shape", "mesh", "status", "dominant",
                  "roofline_fraction", "trace_s", "error")}
        print(json.dumps(brief), flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)
    if out_f:
        out_f.close()
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
