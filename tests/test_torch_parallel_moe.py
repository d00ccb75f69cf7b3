"""The port's expert parallelism against the JAX package on the CPU.

In one subprocess world of 4 ranks over gloo (`tests/torch_parallel_cases.py`),
lm_loss and every gradient leaf (loss within 1e-4, gradients within the JAX training
suite's atol=2e-4, rtol=2e-3):
  * llama4-smoke at model=2, moe_dispatch="auto": experts, heads and vocab
    sharded on `model`, against JAX's single-device step; a dropped
    all-reduce breaks it;
  * llama4-smoke at (data 2, model 2), moe_dispatch="shard_map", at a
    capacity factor that drops entries: against JAX's `apply_moe_shardmap`
    on a 1 x 1 mesh with the activation context set, run on each data
    rank's rows (JAX's local capacity, `t_loc`), averaged; the global
    capacity of "auto" breaks it;
  * deepseek-smoke (MLA, top-2 of 8 experts, a shared expert, MTP) at
    data=2, "auto", at a capacity factor that drops entries (counted on the
    single-device run: > 0): against JAX's single-device step, whose
    capacity and slots are the global batch's; packing each rank's tokens
    alone breaks it.
In process: without a plan, "shard_map" is JAX's fallback with the
activation context cleared ("auto").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.data.pipeline import make_batch as jax_make_batch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.models.moe_shardmap import apply_moe_shardmap as jax_apply_moe_shardmap
from repro.parallel import sharding as jsh
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import lm_loss, moe
from repro_torch.models.convert import params_from_jax
from torch_parallel_cases import flat_paths, run_suite

LLAMA4, DEEPSEEK = "llama4-maverick-400b-a17b", "deepseek-v3-671b"
SEQ, BATCH = 16, 4
LOSS_TOL = 1e-4
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)


def save_params(d, params) -> None:
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "params.npz", **flat_paths(jax.tree.map(np.asarray, params)))


def _jax_loss_grads(cfg, params, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch, cfg), has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, flat_paths(
        jax.tree.map(np.asarray, grads))


def _batch(cfg, rows=slice(None)):
    b = jax_make_batch(cfg, JaxShapeConfig("t", SEQ, BATCH, "train"), 0, 0)
    return {k: jnp.asarray(v[rows]) for k, v in b.items()}


def _grad_gap(out, key, grads):
    """Fails unless every gradient leaf is within GRAD_TOL; returns the
    largest excess over it (<= 0: within)."""
    worst = -np.inf
    for path, want in grads.items():
        got = out[f"{key}grads/{path}"]
        excess = np.abs(got - want) - (GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want))
        worst = max(worst, float(excess.max()))
    return worst


CF = 0.5   # a capacity factor at which entries drop


def _jax_llama4_shardmap_halves(params):
    """JAX's shard_map on a 1 x 1 mesh with the activation context set, on
    each data rank's rows (its local capacity), averaged."""
    jcfg = dataclasses.replace(jax_smoke(LLAMA4), moe_dispatch="shard_map",
                               moe_capacity_factor=CF)
    mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    halves = []
    jsh.set_activation_context(("data",), mesh=mesh)
    try:
        with mesh:
            for rows in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
                halves.append(_jax_loss_grads(jcfg, params, _batch(jcfg, rows)))
    finally:
        jsh.clear_activation_context()
    metrics = {k: np.mean([h[1][k] for h in halves]) for k in halves[0][1]}
    grads = {k: (halves[0][2][k] + halves[1][2][k]) / 2 for k in halves[0][2]}
    return metrics, grads


def _drops(cfg, params, batch):
    """Dropped entries over every MoE layer of the port's single-device
    forward (the routing JAX's takes, on the same params)."""
    seen = []
    route = moe.route

    def counting(p, xt, c):
        probs, gate, idx = route(p, xt, c)
        counts = torch.bincount(idx.reshape(-1), minlength=c.num_experts)
        seen.append(int((counts - moe._capacity(xt.shape[0], c)).clamp_min(0).sum()))
        return probs, gate, idx

    moe.route = counting
    try:
        with torch.no_grad():
            lm_loss(params, batch, cfg)
    finally:
        moe.route = route
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three cases in one world of 4 ranks, beside JAX's references."""
    root = tmp_path_factory.mktemp("parallel_moe")
    jl = jax_smoke(LLAMA4)
    lparams = jax_init_lm(jax.random.PRNGKey(0), jl)
    _, lmetrics, lgrads = _jax_loss_grads(jl, lparams, _batch(jl))
    jd = dataclasses.replace(jax_smoke(DEEPSEEK), moe_capacity_factor=CF)
    dparams = jax_init_lm(jax.random.PRNGKey(0), jd)
    _, dmetrics, dgrads = _jax_loss_grads(jd, dparams, _batch(jd))
    cfg = dataclasses.replace(get_smoke_config(DEEPSEEK), moe_capacity_factor=CF)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, ShapeConfig("t", SEQ, BATCH, "train"), 0, 0).items()}
    drops = _drops(cfg, params_from_jax(jax.tree.map(np.asarray, dparams), cfg, "cpu",
                                        dtype=torch.float32), batch)
    ref = {"llama4_auto": (lmetrics, lgrads),
           "llama4_shardmap": _jax_llama4_shardmap_halves(lparams),
           "deepseek": (dmetrics, dgrads)}
    save_params(root / "llama4", lparams)
    save_params(root / "deepseek", dparams)
    common = dict(case="grads", seq=SEQ, batch=BATCH)
    jobs = {"llama4_auto": dict(common, dir=str(root / "llama4"), arch=LLAMA4, data=1, model=2,
                                faults=["dropped_allreduce"]),
            "llama4_shardmap": dict(common, dir=str(root / "llama4_sm"), arch=LLAMA4, data=2,
                                    model=2, params=str(root / "llama4"),
                                    cfg=dict(moe_dispatch="shard_map", moe_capacity_factor=CF),
                                    faults=["shardmap_global"]),
            "deepseek": dict(common, dir=str(root / "deepseek"), arch=DEEPSEEK, data=2, model=1,
                             cfg=dict(moe_capacity_factor=CF), faults=["local_capacity"])}
    (root / "llama4_sm").mkdir()
    outs = run_suite(root, list(jobs.values()))
    return {name: (ref[name], out) for name, out in zip(jobs, outs)} | {"drops": drops}


def test_llama4_ep_model2_auto_matches_jax(runs):
    (metrics, grads), out = runs["llama4_auto"]
    for name in ("loss", "aux_loss"):
        assert abs(float(out[name]) - metrics[name]) <= LOSS_TOL, name
    assert _grad_gap(out, "", grads) <= 0
    assert abs(float(out["dropped_allreduce/loss"]) - metrics["loss"]) > 100 * LOSS_TOL


def test_llama4_shardmap_2x2_matches_jax_per_data_shard(runs):
    (metrics, grads), out = runs["llama4_shardmap"]
    for name in ("loss", "aux_loss"):
        assert abs(float(out[name]) - metrics[name]) <= LOSS_TOL, name
    assert _grad_gap(out, "", grads) <= 0
    assert _grad_gap(out, "shardmap_global/", grads) > 0


def test_deepseek_data2_auto_global_capacity_matches_jax(runs):
    assert sum(runs["drops"]) > 0, runs["drops"]
    (metrics, grads), out = runs["deepseek"]
    for name in ("loss", "lm_loss", "aux_loss", "mtp_loss"):
        assert abs(float(out[name]) - metrics[name]) <= LOSS_TOL, name
    assert _grad_gap(out, "", grads) <= 0
    assert _grad_gap(out, "local_capacity/", grads) > 0


def test_shardmap_without_a_plan_is_jax_fallback():
    """No plan: "shard_map" is the "auto" dispatch, as JAX's
    apply_moe_shardmap with the activation context cleared."""
    jcfg = dataclasses.replace(jax_smoke(LLAMA4), moe_dispatch="shard_map")
    cfg = dataclasses.replace(get_smoke_config(LLAMA4), moe_dispatch="shard_map")
    params = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    p = jax.tree.map(lambda t: t[0], params["seg0"]["moe_blk"]["moe"])
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 8, jcfg.d_model))
    jsh.clear_activation_context()
    want, waux = jax_apply_moe_shardmap(p, x, jcfg)
    tp = {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, dict) else
              {kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()})
          for k, v in p.items()}
    got, aux = moe.apply_moe(tp, torch.from_numpy(np.asarray(x)), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert abs(float(aux) - float(waux)) <= 1e-6
