"""Halo heads: query heads (and KV heads) that do not split over `model`,
against the JAX package's single-device run on the CPU.

JAX's spec trees split wq / wk / wv (bq / bk / bv) and wo's rows mid-head
where the heads do not split, and GSPMD partitions the step.  The port keeps
those slices as data: each rank gathers the q / k / v columns of the heads
its query columns touch (`sharding.gather_heads`, whose backward
reduce-scatters), computes those heads whole, caches their KV heads whole
and keeps its own output columns for the row-parallel wo
(`sharding.head_span`).

In process: the plan takes every production-mesh architecture, and
qwen1.5-4b and whisper-small at model=8; `head_span`'s rules.  In one
subprocess world of 4 ranks over gloo (`tests/torch_parallel_cases.py`),
held against JAX's run computed here on the same params and inputs, four
smoke variants whose heads do not split: qwen1.5 with 5 heads / 5 KV heads
(1.25 heads a rank at model=4, 2.5 at model=2; its qkv bias), llama4 with
10 heads over 2 KV heads (KV replicated twice at model=4, 2.5 heads a
rank), whisper with 6 heads (encoder, self- and cross-attention) and
internlm2 with 6 heads over 3 KV heads (g = 2: spans widened to whole KV
groups).  Each is served (prefill and 3 greedy decode steps: every step's
logits within 1e-4 of JAX's, the greedy tokens identical, rank 0's cache
holding its touched KV heads as JAX's cache holds them) and trained 2 AdamW
steps (the losses and every param within 1e-4, every gradient leaf of step
0 within 1e-4 of JAX's relative to the leaf's largest entry), at model=4
or (data 1, model 4) and, for the odd head counts, model=2 or (data 2,
model 2); qwen1.5 also under `seq_parallel`, and its (2, 2) checkpoint
restored at model=1.  The planted faults (the halo gather's backward left
unsummed; each rank gathering its neighbour's head) must each break their
bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_lm as jax_init_lm
from repro.models.lm import apply_encoder as jax_apply_encoder
from repro.optim.adamw import init_opt as jax_init_opt
from repro.serving.serve_step import make_decode_step as jax_decode_step
from repro.serving.serve_step import make_prefill_step as jax_prefill_step
from repro.train import train_step as jax_train_step_mod
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import MeshConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import cache_structs
from repro_torch.launch.mesh import Mesh, production_mesh_config, virtual_mesh
from repro_torch.parallel import sharding as sh
from torch_parallel_cases import finish_suite, flat_paths, start_suite

TOL = 1e-4
SEQ, BATCH, STEPS = 16, 4, 2     # the train runs
PROMPT, N_DEC = 8, 3             # the serve runs
VARIANTS = {"qwen": ("qwen1.5-4b", dict(num_heads=5, num_kv_heads=5)),
            "llama4": ("llama4-maverick-400b-a17b", dict(num_heads=10, num_kv_heads=2)),
            "whisper": ("whisper-small", dict(num_heads=6, num_kv_heads=6)),
            "gqa": ("internlm2-1.8b", dict(num_heads=6, num_kv_heads=3))}
HALO, NEIGHBOUR = "halo_grad_unsummed", "neighbour_head"
CHECKPOINTED = "train/qwen/2x2"       # saved at (2, 2), restored at model=1
# name: (variant, seq_parallel, data, model, planted faults)
SERVES = {"serve/qwen/model4": ("qwen", False, 1, 4, [NEIGHBOUR]),
          "serve/qwen/model2": ("qwen", False, 1, 2, []),
          "serve/llama4/model4": ("llama4", False, 1, 4, [NEIGHBOUR]),
          "serve/whisper/model4": ("whisper", False, 1, 4, [NEIGHBOUR]),
          "serve/gqa/model4": ("gqa", False, 1, 4, []),
          "serve/gqa/model2": ("gqa", False, 1, 2, [NEIGHBOUR]),
          "serve/sp/qwen/model4": ("qwen", True, 1, 4, [])}
TRAINS = {"train/qwen/1x4": ("qwen", False, 1, 4, [HALO, NEIGHBOUR]),
          "train/qwen/2x2": ("qwen", False, 2, 2, [HALO]),
          "train/llama4/1x4": ("llama4", False, 1, 4, [HALO]),
          "train/whisper/1x4": ("whisper", False, 1, 4, [HALO]),
          "train/gqa/2x2": ("gqa", False, 2, 2, [HALO]),
          "train/sp/qwen/1x4": ("qwen", True, 1, 4, [])}


def _jcfg(variant, sp=False):
    arch, patch = VARIANTS[variant]
    return dataclasses.replace(jax_smoke(arch), seq_parallel=sp, **patch)


@functools.lru_cache(maxsize=None)
def _params(variant):
    return jax.jit(jax_init_lm, static_argnums=1)(jax.random.PRNGKey(0), _jcfg(variant))


def _serve_inputs(jcfg):
    batch = jax_make_batch(jcfg, JaxShapeConfig("s", PROMPT, 2, "train"), 7, 0)
    return {k: np.asarray(v) for k, v in batch.items() if k in ("tokens", "encoder_frames")}


@functools.lru_cache(maxsize=None)
def _jax_serve(variant, sp):
    """JAX's prefill and N_DEC greedy decode steps: each step's logits, the
    tokens fed and the first layer's K cache after the last step."""
    jcfg, params = _jcfg(variant, sp), _params(variant)
    inputs = _serve_inputs(jcfg)
    s0 = inputs["tokens"].shape[1]
    logits, caches = jax.jit(jax_prefill_step(jcfg, s0 + N_DEC))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    enc_out = (jax_apply_encoder(params, jnp.asarray(inputs["encoder_frames"]), jcfg)
               if "encoder_frames" in inputs else None)
    decode = jax.jit(jax_decode_step(jcfg))
    steps, toks = [np.asarray(logits)], []
    for i in range(N_DEC):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, caches = decode(params, tok, caches, jnp.asarray(s0 + i, jnp.int32), enc_out)
        steps.append(np.asarray(logits))
    out = dict(logits=np.stack(steps), tokens=np.concatenate(toks, 1))
    if "k" in caches[0]:
        out["cache_k"] = np.asarray(caches[0]["k"])
    return out


@functools.lru_cache(maxsize=None)
def _jax_train(variant, sp):
    """JAX's STEPS AdamW steps: the losses, the params after the last step
    and the gradients step 0 applied (`apply_updates` wrapped while the
    step is traced)."""
    jcfg = _jcfg(variant, sp)
    tc = JaxTrainConfig(total_steps=4, warmup_steps=1, optimizer="adamw", grad_clip=1.0,
                        remat="none")
    real = jax_train_step_mod.apply_updates

    def step_and_grads(params, opt, batch):
        seen = []

        def apply_updates(params, grads, *args):
            seen.append(grads)
            return real(params, grads, *args)
        jax_train_step_mod.apply_updates = apply_updates
        try:
            out = jax_make_train_step(jcfg, tc)(params, opt, batch)
        finally:
            jax_train_step_mod.apply_updates = real
        return out, seen[0]

    step = jax.jit(step_and_grads)
    params = _params(variant)
    opt = jax_init_opt(params, tc)
    losses, grads = [], None
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in
                 jax_make_batch(jcfg, JaxShapeConfig("t", SEQ, BATCH, "train"), i, 0).items()}
        (params, opt, m), g = step(params, opt, batch)
        losses.append(float(m["loss"]))
        grads = grads or flat_paths(jax.tree.map(np.asarray, g))
    return dict(losses=np.array(losses), params=flat_paths(jax.tree.map(np.asarray, params)),
                grads=grads)


def _jobs(root):
    jobs = {}
    for variant in VARIANTS:
        d = root / "params" / variant
        d.mkdir(parents=True)
        np.savez(d / "params.npz", **flat_paths(jax.tree.map(np.asarray, _params(variant))))
    for name, (variant, sp, data, model, faults) in {**SERVES, **TRAINS}.items():
        d = root / name
        d.mkdir(parents=True)
        arch, patch = VARIANTS[variant]
        job = dict(dir=str(d), params=str(root / "params" / variant), arch=arch,
                   cfg=dict(patch, seq_parallel=sp), data=data, model=model, faults=faults)
        if name in SERVES:
            np.savez(d / "inputs.npz", **_serve_inputs(_jcfg(variant, sp)))
            job.update(case="serve", decode=N_DEC, fsdp=False)
        else:
            job.update(case="train", steps=STEPS, total_steps=4, grad_clip=1.0, seq=SEQ,
                       batch=BATCH, optimizer="adamw", grads=True,
                       checkpoint=name == CHECKPOINTED)
        jobs[name] = job
    d = root / "restore"
    d.mkdir()
    jobs["restore"] = dict(jobs[CHECKPOINTED], case="restore", dir=str(d), data=1, model=1,
                           ckpt=str(root / CHECKPOINTED / "ckpt"), faults=[])
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job in one world of 4 ranks, beside its JAX reference:
    {job name: (reference, outputs)}."""
    root = tmp_path_factory.mktemp("parallel_heads")
    jobs = _jobs(root)
    proc = start_suite(root, list(jobs.values()))
    refs = {}
    for name, (variant, sp, *_) in {**SERVES, **TRAINS}.items():
        refs[name] = (_jax_serve if name in SERVES else _jax_train)(variant, sp)
    outs = finish_suite(proc, list(jobs.values()), timeout=400)
    return {name: (refs.get(name), out) for name, out in zip(jobs, outs)}


def _serve_gap(ref, out, key=""):
    return float(np.max(np.abs(out[key + "logits"] - ref["logits"])))


def _train_gap(ref, out, key=""):
    """The losses', the params' after the last step and step 0's worst
    gradient leaf's (relative to the leaf's largest entry) largest gap."""
    gap = float(np.max(np.abs(out[key + "loss"] - ref["losses"])))
    for path, want in ref["params"].items():
        gap = max(gap, float(np.max(np.abs(out[f"{key}params/{path}"] - want))))
    for path, want in ref["grads"].items():
        err = float(np.max(np.abs(out[f"{key}grads/{path}"] - want)))
        gap = max(gap, err / max(float(np.max(np.abs(want))), 1e-30))
    return gap


# --- in process -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", dryrun.ASSIGNED)
def test_plan_takes_the_production_mesh(arch):
    """16 x 16: every assigned architecture, whether or not its heads split
    over 16; a virtual mesh's Plan is built from rank 0's view."""
    cfg = get_config(arch)
    mesh_cfg = production_mesh_config()
    sh.check_supported(cfg, mesh_cfg)
    plan = sh.Plan(cfg, virtual_mesh(mesh_cfg, 0, sh.kv_replication(cfg, mesh_cfg.model)))
    assert plan.tp == 16


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "whisper-small"])
def test_plan_takes_model8(arch):
    """model=8, one H100 node's NVLink domain: 20 and 12 heads do not split,
    and run as halo heads on every rank."""
    cfg = get_config(arch)
    sh.check_supported(cfg, MeshConfig(model=8))
    assert sh.Plan(cfg, Mesh(MeshConfig(model=8))).tp == 8
    assert all(sh.head_span(cfg, 8, r).halo for r in range(8))


def test_head_span_partitions_qwen_at_16():
    """qwen1.5-4b at 16: the ranks' own columns partition wq's 2560 columns
    in order (160 each, JAX's slices), their touched heads cover all 20, each
    rank computes 2 heads where it owns 1.25, and the straddled heads are
    computed on two ranks."""
    cfg = get_config("qwen1.5-4b")
    spans = [sh.head_span(cfg, 16, r) for r in range(16)]
    assert [s.cols for s in spans] == [(160 * r, 160 * (r + 1)) for r in range(16)]
    touched = [h for s in spans for h in range(*s.q)]
    assert set(touched) == set(range(20))
    assert all(s.q[1] - s.q[0] == 2 and s.kv == s.q and s.halo for s in spans)
    twice = [h for h in range(20) if touched.count(h) == 2]
    assert len(twice) == 12 and len(touched) == 32


def test_head_span_rules():
    """llama4 at 16: KV heads replicated twice, each rank's touched query
    heads in its one KV head's group of 5; GQA with KV heads that neither
    split nor replicate (6 heads over 3 at model 4): spans widened to whole
    groups of 2; heads that split: the rank's own heads, no halo."""
    cfg = get_config("llama4-maverick-400b-a17b")
    for r in range(16):
        s = sh.head_span(cfg, 16, r)
        assert s.kv == (r // 2, r // 2 + 1) and s.halo
        assert s.kv[0] * 5 <= s.q[0] < s.q[1] <= s.kv[1] * 5
    gqa = dataclasses.replace(get_config("internlm2-1.8b"), num_heads=6, num_kv_heads=3,
                              head_dim=16)
    got = [(s.q, s.kv) for s in (sh.head_span(gqa, 4, r) for r in range(4))]
    assert got == [((0, 2), (0, 1)), ((0, 4), (0, 2)), ((2, 6), (1, 3)), ((4, 6), (2, 3))]
    even = get_config("internlm2-1.8b")
    assert sh.head_span(even, 2, 1) == sh.HeadSpan((1024, 2048), (8, 16), (4, 8), False)


def test_cache_holds_touched_kv_heads_and_cache_specs_stay_jax():
    """qwen1.5-4b decode at 16 x 16: each rank caches the KV heads it
    touches, whole (2 of 20), while `cache_specs` stay JAX's (the sequence
    sharded over `model`): the same numbers, another layout."""
    cfg = get_config("qwen1.5-4b")
    mesh_cfg = dataclasses.replace(production_mesh_config(), fsdp=False)
    for r in (0, 5):
        plan = sh.Plan(cfg, virtual_mesh(mesh_cfg, r))
        caches = cache_structs(cfg, 2, 64, plan)
        assert caches[0]["k"].shape == (cfg.num_layers, 2, 64, 2, cfg.head_dim)
    assert sh.cache_specs(cfg, Mesh(mesh_cfg))[0]["k"] == (None, "data", "model", None, None)


def test_gather_heads_on_one_rank():
    """`gather_heads` on one rank (no group): the identity on the columns
    it keeps, and its backward the gradient itself."""
    x = torch.arange(24.0).reshape(2, 12).requires_grad_()
    y = sh.gather_heads(x, 1, 3, 4)
    assert torch.equal(y, x[:, 4:12])
    y.sum().backward()
    assert torch.equal(x.grad, torch.cat([torch.zeros(2, 4), torch.ones(2, 8)], 1))


# --- the world of 4 ranks ---------------------------------------------------------------

@pytest.mark.parametrize("job", sorted(SERVES))
def test_serve_matches_jax(runs, job):
    """Prefill and 3 greedy decode steps: every step's logits within 1e-4 of
    JAX's single-device run, the greedy tokens identical."""
    ref, out = runs[job]
    assert _serve_gap(ref, out) <= TOL
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])


@pytest.mark.parametrize("job", sorted(j for j in SERVES if SERVES[j][0] != "llama4"))
def test_rank_caches_its_touched_kv_heads_whole(runs, job):
    """Rank 0's first-layer K cache after the last decode step holds the KV
    heads its query columns touch, whole, as JAX's cache holds them."""
    ref, out = runs[job]
    variant, sp, data, model, _ = SERVES[job]
    arch, patch = VARIANTS[variant]
    k0, k1 = sh.head_span(dataclasses.replace(get_config(arch), **patch, head_dim=16),
                          model, 0).kv
    assert out["cache_k"].shape[-2] == k1 - k0
    np.testing.assert_allclose(out["cache_k"], ref["cache_k"][..., k0:k1, :], atol=TOL, rtol=0)


@pytest.mark.parametrize("job", sorted(TRAINS))
def test_train_matches_jax(runs, job):
    """2 AdamW steps: both losses and every param after them within 1e-4 of
    JAX's, and every gradient leaf of step 0 within 1e-4 of JAX's relative
    to the leaf's largest entry."""
    ref, out = runs[job]
    assert _train_gap(ref, out) <= TOL


def test_halo_checkpoint_restores_at_model1(runs):
    """The (2, 2) run's checkpoint (FSDP and halo heads' mid-head column
    slices) restored at model=1: every leaf equal to what the mesh held,
    gathered; the update count restored."""
    trained, out = runs[CHECKPOINTED][1], runs["restore"][1]
    assert int(out["step"]) == STEPS and int(out["opt_step"]) == STEPS
    for path in runs[CHECKPOINTED][0]["params"]:
        np.testing.assert_array_equal(out[f"restored/{path}"], trained[f"params/{path}"])


@pytest.mark.parametrize("job,fault", [(j, f) for j, v in {**SERVES, **TRAINS}.items()
                                       for f in v[4]])
def test_planted_faults_break_it(runs, job, fault):
    """The halo gather's backward keeping each rank's own partial (no sum
    over the ranks that computed a head), or each rank gathering its
    neighbour's head: past 10 x the bound."""
    ref, out = runs[job]
    gap = (_serve_gap if job in SERVES else _train_gap)(ref, out, f"{fault}/")
    assert gap > 10 * TOL, gap
