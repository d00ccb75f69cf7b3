"""The port's dry run and op counter against the JAX package on the CPU.

  * the dry run's helpers (`cell_supported`, `_train_config`,
    `model_flops_total`, the warnings: the advisor's findings on the H100
    and `validate_divisibility`) equal JAX's for all 40 (arch, shape) cells,
    JAX's read in one subprocess (importing `repro.launch.dryrun` sets
    XLA_FLAGS to 512 host devices);
  * the op counter's dot FLOPs equal JAX's `analyze_hlo(...).flops` of the
    compiled step at relative 1e-9: internlm2-smoke (jnp linear, naive
    attention), a train step at 4 x 64 tokens at remat "none" and "full",
    a prefill and a decode step;
  * a CPU run and a meta trace of the same step count the same (flash and
    fused impls), a dropped charge breaks that, each kernel's charge is its
    `cost` function's, and with no counter on no cost is computed;
  * tracing n_micro = 4 in full equals one microbatch counted 4 times;
  * the virtual group's collective census at world 4 equals four gloo
    ranks' census, rank by rank and kind by kind;
  * every assigned architecture, cut to 2 layers, dry-runs at 16 x 16: ok,
    or (qwen1.5-4b, llama4, whisper-small) refused by its query heads.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core.hlo_analysis import analyze_hlo
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_lm as jax_init_lm
from repro.optim.adamw import init_opt as jax_init_opt
from repro.serving.serve_step import make_decode_step as jax_decode_step
from repro.serving.serve_step import make_prefill_step as jax_prefill_step
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import SHAPES, MeshConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import op_analysis
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_mlp import ops as fused_ops
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import virtual_mesh
from repro_torch.models import init_lm
from repro_torch.optim.adamw import init_opt, tree_map
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step
from torch_parallel_cases import run_suite

ARCH = "internlm2-1.8b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH = 64, 4

_JAX_HELPERS = r"""
import json, sys
sys.path.insert(0, "src")
from repro.launch import dryrun as d
from repro.configs.base import SHAPES
from repro.configs.registry import get_config
from repro.core import advisor
from repro.core.hardware import get_hardware
from repro.launch.mesh import production_mesh_config
from repro.parallel import sharding as sh
out = {}
for a in d.ASSIGNED:
    cfg = get_config(a)
    tc = d._train_config(cfg)
    for s in d.SHAPE_ORDER:
        shape = SHAPES[s]
        mc = production_mesh_config()
        warn = [f"{f.rule}: {f.message}" for f in advisor.check_alignment(
            cfg, hw=get_hardware("h100"), tp=mc.model, global_batch=shape.global_batch)
            if f.severity != "ok"] + sh.validate_divisibility(cfg, mc, shape.global_batch)
        out[f"{a}|{s}"] = dict(supported=list(d.cell_supported(cfg, shape)),
                               tc=[tc.optimizer, tc.remat, tc.microbatch_per_device],
                               flops={str(m): d.model_flops_total(cfg, shape, m)
                                      for m in (1.0, 3.0)},
                               warnings=warn)
from repro.launch import perf
print(json.dumps({"assigned": d.ASSIGNED, "shapes": d.SHAPE_ORDER, "cells": out,
                  "perf": perf.CELLS}))
"""


@pytest.fixture(scope="module")
def jax_helpers():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_HELPERS], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_dryrun_helpers_match_jax(jax_helpers):
    """All 40 (arch, shape) cells: the lists, cell_supported, _train_config,
    model_flops_total at both multipliers (exact) and the warnings (JAX's
    rule at dryrun.py:132-136, the advisor's on the H100)."""
    assert jax_helpers["assigned"] == dryrun.ASSIGNED
    assert jax_helpers["shapes"] == dryrun.SHAPE_ORDER
    assert len(jax_helpers["cells"]) == 40
    for key, want in jax_helpers["cells"].items():
        arch, s = key.split("|")
        cfg, shape = get_config(arch), SHAPES[s]
        tc = dryrun._train_config(cfg)
        assert list(dryrun.cell_supported(cfg, shape)) == want["supported"], key
        assert [tc.optimizer, tc.remat, tc.microbatch_per_device] == want["tc"], key
        for m, f in want["flops"].items():
            assert dryrun.model_flops_total(cfg, shape, float(m)) == f, key
        assert dryrun.warnings_for(cfg, MeshConfig(data=16, model=16),
                                   shape.global_batch) == want["warnings"], key


def test_perf_cells_match_jax(jax_helpers):
    """launch/perf.py's cells: every arch, shape, treatment, patch and
    hypothesis string JAX's."""
    from repro_torch.launch import perf
    assert json.loads(json.dumps(perf.CELLS)) == jax_helpers["perf"]


def test_perf_flash_substitution_on_the_h100():
    """The flash-substituted memory term: the s^2 bytes replaced by the
    port's flash kernels' traffic (its cost functions per 64-row query
    tile), priced at the H100's HBM rate; a rank's rows a step are the same
    in 16 microbatches of one row or 4 of four, and so is the traffic."""
    from repro_torch.core.hardware import get_hardware
    from repro_torch.launch import perf
    row = {"hlo_bytes": 5e12, "s2_bytes": 4e12, "model_flops_per_chip": 1e14,
           "compute_s": 0.1, "collective_s": 0.05}
    sub = perf.flash_substituted(row, "qwen1.5-4b", "train_4k", {}, {"num_heads": 32,
                                                                     "num_kv_heads": 32,
                                                                     "head_dim": 80})
    fb = perf.flash_kernel_bytes("qwen1.5-4b", "train_4k", 1, {"num_heads": 32,
                                                               "num_kv_heads": 32,
                                                               "head_dim": 80})
    hw = get_hardware("h100")
    assert sub["flash_sub_memory_s"] == pytest.approx((1e12 + fb) / hw.hbm_bw)
    assert sub["flash_sub_roofline_fraction"] == pytest.approx(
        1e14 / max(0.1, sub["flash_sub_memory_s"]) / hw.peak_flops)
    assert fb > 0 and perf.flash_kernel_bytes("qwen1.5-4b", "train_4k", 4, {
        "num_heads": 32, "num_kv_heads": 32, "head_dim": 80}) == pytest.approx(fb)


# --- dot FLOPs against JAX's HLO walk -------------------------------------------------

def _port_params(cfg, dev="cpu"):
    return init_lm(torch.Generator().manual_seed(0), cfg, device=dev, dtype=torch.float32)


def _port_batch(cfg, dev="cpu", batch=BATCH, seq=SEQ, step=0):
    shape = ShapeConfig("t", seq, batch, "train")
    return {k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, shape, step, 0).items()}


def _count_train(cfg, tc, dev="cpu", n_micro=1, trace_one=False, batch=BATCH, warm=True):
    params = _port_params(cfg) if dev == "cpu" else tree_map(lambda t: t.to(dev),
                                                            _port_params(cfg))
    step = make_train_step(cfg, tc, n_micro=n_micro)
    if warm:   # per-device caches (the rotary table) are filled outside the count
        make_train_step(cfg, tc)(tree_map(lambda t: t.clone(), params),
                                 init_opt(params, tc), _port_batch(cfg, dev, batch=batch))
    opt, data = init_opt(params, tc), _port_batch(cfg, dev, batch=batch)
    with op_analysis.count(trace_one) as c:
        step(params, opt, data)
    return c.counts


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_dot_flops_match_jax_hlo(remat):
    jcfg = jax_smoke(ARCH)
    jtc = JaxTrainConfig(total_steps=4, warmup_steps=1, remat=remat)
    params = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    batch = {k: jnp.asarray(v) for k, v in
             jax_make_batch(jcfg, JaxShapeConfig("t", SEQ, BATCH, "train"), 0, 0).items()}
    txt = jax.jit(jax_make_train_step(jcfg, jtc)).lower(
        params, jax_init_opt(params, jtc), batch).compile().as_text()
    want = analyze_hlo(txt).flops
    got = _count_train(get_smoke_config(ARCH),
                       TrainConfig(total_steps=4, warmup_steps=1, remat=remat), "meta")
    assert got.flops == pytest.approx(want, rel=1e-9)
    assert got.flops == {"none": 346_030_080, "full": 427_819_008}[remat]


def test_serve_dot_flops_match_jax_hlo():
    """Prefill of 2 x 12 tokens into a 16-deep cache, then one decode step."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, jcfg.vocab_size),
                    np.int32)
    pre = jax.jit(jax_prefill_step(jcfg, 16)).lower(jparams, {"tokens": toks}).compile()
    _, jcaches = jax.jit(jax_prefill_step(jcfg, 16))(jparams, {"tokens": toks})
    dec = jax.jit(jax_decode_step(jcfg)).lower(
        jparams, jnp.zeros((2, 1), jnp.int32), jcaches, jnp.asarray(12, jnp.int32)).compile()
    params = _port_params(cfg)
    with torch.no_grad():
        make_prefill_step(cfg, 16)(params, {"tokens": torch.from_numpy(toks)})   # warm
        with op_analysis.count() as c_pre:
            _, caches = make_prefill_step(cfg, 16)(params, {"tokens": torch.from_numpy(toks)})
        with op_analysis.count() as c_dec:
            make_decode_step(cfg)(params, torch.zeros((2, 1), dtype=torch.int32), caches, 12)
    assert c_pre.counts.flops == pytest.approx(analyze_hlo(pre.as_text()).flops, rel=1e-9)
    assert c_dec.counts.flops == pytest.approx(analyze_hlo(dec.as_text()).flops, rel=1e-9)


# --- CPU against meta, kernel charges, microbatches ---------------------------------

@pytest.mark.parametrize("impls", [("fused", "flash"), ("jnp", "naive")])
def test_cpu_run_and_meta_trace_count_the_same(impls):
    """One train step of internlm2-smoke: FLOPs, bytes, s2 bytes, dots and
    every kernel's launches, FLOPs and bytes equal on the CPU (plain
    versions run, opaque) and on meta (the kernels planned, not run)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), linear_impl=impls[0], attn_impl=impls[1])
    tc = TrainConfig(total_steps=4, warmup_steps=1, remat="none")
    cpu, meta = _count_train(cfg, tc, "cpu"), _count_train(cfg, tc, "meta")
    assert cpu.as_dict() == meta.as_dict()
    assert (cpu.s2_bytes, cpu.kernels) == (meta.s2_bytes, meta.kernels)
    if impls[0] == "fused":
        assert set(cpu.kernels) == {"matmul", "fused_mlp_hidden", "fused_mlp_bwd",
                                    "flash_attention_fwd", "flash_attention_bwd"}
        assert cpu.dots == 0        # every product through a kernel
    else:
        assert cpu.kernels == {} and cpu.dots > 0


def test_kernel_charges_are_their_cost_functions():
    """Each wrapper, called once on the CPU under the counter, charges
    exactly its cost function (the fused backward: the recompute and its
    three tile GEMMs, `bwd_launches`)."""
    g = torch.Generator().manual_seed(0)
    m, k, n, f = 24, 32, 40, 48
    x, w = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g)
    wg, wu, dh = (torch.randn(k, f, generator=g), torch.randn(k, f, generator=g),
                  torch.randn(m, f, generator=g))
    q = torch.randn(2, 20, 4, 16, generator=g)
    kv = torch.randn(2, 20, 2, 16, generator=g)
    with op_analysis.count() as c:
        matmul_ops.matmul(x, w)
        fused_ops.fused_mlp_hidden(x, wg, wu)
        fused_ops.fused_mlp_bwd(x, wg, wu, dh)
        o, lse = flash_ops.flash_attention_fwd(q, kv, kv, causal=True)
        flash_ops.flash_attention_bwd(q, kv, kv, o, lse, q, causal=True)
    want = {}

    def add(name, fl, nb):
        row = want.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += fl
        row["bytes"] += nb
    add("matmul", *matmul_ops.cost(m, k, n, 4))
    add("fused_mlp_hidden", *fused_ops.cost(m, k, f, True, 4))
    for launch in fused_ops.bwd_launches(m, k, f, True, 4):
        add(*launch)
    add("flash_attention_fwd", *flash_ops.flash_cost(2, 20, 20, 4, 2, 16, True, 4))
    add("flash_attention_bwd", *flash_ops.flash_bwd_cost(2, 20, 20, 4, 2, 16, True, 4))
    assert c.counts.kernels == want
    assert c.counts.flops == sum(r["flops"] for r in want.values())
    assert c.counts.bytes == sum(r["bytes"] for r in want.values())


def test_a_dropped_charge_breaks_cpu_against_meta():
    """The fault chip_smoke plants on the card: the fused MLP's charge
    dropped from the meta trace alone makes it differ from the CPU run."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), linear_impl="fused", attn_impl="flash")
    tc = TrainConfig(total_steps=4, warmup_steps=1, remat="none")
    cpu = _count_train(cfg, tc, "cpu")
    real = op_analysis.Counter.charge

    def dropped(self, name, flops, nbytes):
        if name != "fused_mlp_hidden":
            real(self, name, flops, nbytes)
    op_analysis.Counter.charge = dropped
    try:
        meta = _count_train(cfg, tc, "meta")
    finally:
        op_analysis.Counter.charge = real
    assert cpu.flops != meta.flops and "fused_mlp_hidden" not in meta.kernels


def test_no_counter_no_charge_work():
    """With no counter on, a wrapper's block is one shared null context and
    its cost function is never called (the wrappers' host time per call)."""
    def cost():
        raise AssertionError("cost computed with no counter on")
    assert op_analysis.kernel("matmul", cost) is op_analysis.kernel(None, cost)
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 16, generator=g), torch.randn(16, 4, generator=g)
    torch.testing.assert_close(matmul_ops.matmul(x, w), x @ w)


@pytest.mark.parametrize("gated", [True, False])
def test_fused_bwd_bound_counts_the_function(gated):
    """chip_smoke's bound for the whole fused backward: the launches' FLOPs,
    but bytes of the function (x, the weights and dh read once, dx and the
    weight gradients written once), fewer than the launches' sum, which
    also counts the recompute's weight reads and dg / du round trips."""
    m, h, f, e = 24, 32, 48, 3
    nw = 2 if gated else 1
    for k in (0, e):
        launches = fused_ops.bwd_launches(m, h, f, gated, 2, k)
        flops, nbytes = fused_ops.bwd_function_cost(m, h, f, gated, 2, k)
        assert flops == sum(fl for _, fl, _ in launches) == max(k, 1) * 6 * nw * m * h * f
        assert nbytes == max(k, 1) * 2 * (2 * m * h + 2 * nw * h * f + m * f)
        assert nbytes < sum(nb for _, _, nb in launches)


def test_microbatches_traced_once_equal_the_full_loop():
    """n_micro = 4 traced in full equals its first microbatch counted 4
    times with the per-step rest once (JAX's trip-count rule)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), linear_impl="fused", attn_impl="flash")
    tc = TrainConfig(total_steps=4, warmup_steps=1, remat="none")
    full = _count_train(cfg, tc, "meta", n_micro=4, batch=8)
    one = _count_train(cfg, tc, "meta", n_micro=4, trace_one=True, batch=8)
    assert full.as_dict() == one.as_dict()
    assert (full.kernels, full.s2_bytes) == (one.kernels, one.s2_bytes)
    assert one.loops == {"microbatch": 4}
    single = _count_train(cfg, tc, "meta", batch=2)
    assert one.kernels["matmul"]["launches"] == 4 * single.kernels["matmul"]["launches"]


# --- collectives: the virtual group against gloo ------------------------------------

def test_virtual_census_equals_gloo_world_of_four(tmp_path):
    """One train step of internlm2-smoke at (data 2, model 2): each of four
    gloo ranks' census equals the virtual mesh's trace of that rank on meta,
    kind by kind."""
    job = dict(case="census", dir=str(tmp_path), arch=ARCH, data=2, model=2, total_steps=4,
               grad_clip=1.0, seq=16, batch=4)
    gloo = run_suite(tmp_path, [job])[0]
    cfg = get_smoke_config(ARCH)
    tc = TrainConfig(total_steps=4, warmup_steps=1, grad_clip=1.0, remat="none", seed=0)
    for rank in range(4):
        plan = sh.Plan(cfg, virtual_mesh(MeshConfig(data=2, model=2), rank))
        params = plan.shard(init_lm(None, cfg, device="meta", dtype=torch.float32))
        with comm.census() as rec:
            make_train_step(cfg, tc, plan=plan)(params, init_opt(params, tc),
                                                _port_batch(cfg, "meta", batch=4, seq=16))
        assert rec == gloo[rank], rank
        assert rec["all-reduce"] > 0 and rec["all-gather"] > 0 and rec["reduce-scatter"] > 0


# --- cut production runs --------------------------------------------------------------

def _cut(arch):
    cfg = get_config(arch)
    kw = {"num_layers": 2}
    if cfg.first_dense_layers:
        kw["first_dense_layers"] = 1
    if cfg.hybrid_attn_every:
        kw["num_layers"] = cfg.hybrid_attn_every
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = 2
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("arch", dryrun.ASSIGNED)
def test_cut_production_dryrun(arch):
    """train_4k at 16 x 16, each arch cut in depth: ok with positive terms
    and H100 numbers; qwen1.5-4b, llama4 and whisper-small, whose query
    heads do not split over 16, run as halo heads: the head count stays a
    warning, and the row counts the halo gathers inside its collective
    bytes and the attention FLOPs' factor over the rank's own heads."""
    row = dryrun.run_cell(arch, "train_4k", cfg=_cut(arch))
    cfg = get_config(arch)
    assert row["status"] == "ok", row.get("traceback")
    if cfg.num_heads % 16:
        halo = row["halo"]
        assert f"num_heads {cfg.num_heads} % tp 16 != 0" in row["warnings"]
        assert 0 < halo["gather_total"] < row["coll_bytes"]
        assert halo["gather_bytes"]["all-gather"] <= row["coll_breakdown"]["all-gather"]
        assert halo["heads"] > halo["own_heads"] == cfg.num_heads / 16
        assert halo["flops_factor"] > 1 and halo["mean_flops_factor"] > 1
    else:
        assert "halo" not in row
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0 and row["coll_bytes"] > 0
    assert row["loops"] == {"microbatch": 16} and row["n_micro"] == 16
    assert row["mem"]["peak_bytes"] > row["mem"]["argument_bytes"] > 0
    assert 0 < row["roofline_fraction"] < 1
    assert row["compute_s"] == pytest.approx(row["hlo_flops"] / 989e12)


def test_dryrun_cli_prints_ok(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k"])
    assert e.value.code == 0
    assert '"status": "ok"' in capsys.readouterr().out
