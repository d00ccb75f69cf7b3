"""Tensor and sequence parallelism of the MLA, SSM, hybrid, encoder-decoder
and VLM families against the JAX package's single-device step, on the CPU.

In one subprocess world of 4 ranks over gloo (`tests/torch_parallel_cases.py`,
started before JAX's references are computed here, so the two overlap):
each family's smoke config (mamba2, zamba2, deepseek with its MTP head,
whisper, internvl2) served at model=2 (prefill and 4 greedy decode steps:
every step's logits within 1e-4 of JAX's, the greedy tokens identical) and
trained one AdamW step at (data 2, model 2) (step 0's loss and every param
after the step within 1e-4, and every gradient leaf of step 0 within 1e-4
of `jax.grad`'s, relative to the leaf's largest entry: at step 1 Adam's
update is about lr * sign(g), so the params alone cannot see a gradient
of the wrong size); internlm2-smoke and llama4-smoke the same with
`seq_parallel=True`, against JAX with the flag.  Each planted fault
(`torch_parallel_cases.FAULTS`) must move its result past 100 x the bound:
MLA's gathered latent replaced by the rank's own slice, the SSD gated
norm's sum over `model` dropped, the sequence-parallel reduce-scatter
replaced by a local slice, the encoder's row-parallel all-reduces dropped,
and, in the training step, each of those and the sequence-parallel norm
gains' sum over `model` dropped.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from torch_parallel_cases import finish_suite, flat_paths, start_suite

TOL = 1e-4
SEQ, BATCH = 16, 4          # the (2, 2) train step
PROMPT, N_DEC = 8, 4        # the model=2 serve run
FAMILIES = ["mamba2-780m", "zamba2-2.7b", "deepseek-v3-671b", "whisper-small", "internvl2-76b"]
SEQ_PARALLEL = ["internlm2-1.8b", "llama4-maverick-400b-a17b"]
# (job, planted fault): each must break its job's bound
FAULTS = [("serve/deepseek-v3-671b", "latent_slice"),
          ("serve/mamba2-780m", "norm_sum_dropped"),
          ("train/sp/internlm2-1.8b", "seq_local_slice"),
          ("serve/whisper-small", "encoder_allreduce_dropped"),
          ("train/deepseek-v3-671b", "latent_slice"),
          ("train/mamba2-780m", "norm_sum_dropped"),
          ("train/zamba2-2.7b", "norm_sum_dropped"),
          ("train/whisper-small", "encoder_allreduce_dropped"),
          ("train/sp/internlm2-1.8b", "seq_norm_sum_dropped")]


def _jcfg(arch, sp=False):
    return dataclasses.replace(jax_smoke(arch), seq_parallel=sp)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The arch's smoke params, initialised once (under jit: eager init
    took 7-15 s for the SSM and MLA configs)."""
    return jax.jit(jax_init_lm, static_argnums=1)(jax.random.PRNGKey(0), jax_smoke(arch))


def _serve_inputs(jcfg):
    """The prompt tokens (2, PROMPT) and the model's patches or frames."""
    lead = jcfg.num_patches if jcfg.family == "vlm" else 0
    batch = jax_make_batch(jcfg, JaxShapeConfig("s", PROMPT + lead, 2, "train"), 7, 0)
    return {k: np.asarray(v) for k, v in batch.items()
            if k in ("tokens", "patch_embeds", "encoder_frames")}


def _jax_serve(arch, sp):
    """JAX's prefill and N_DEC greedy decode steps: each step's logits and
    the tokens fed."""
    jcfg = _jcfg(arch, sp)
    params = _params(arch)
    inputs = _serve_inputs(jcfg)
    s0 = inputs["tokens"].shape[1] + (jcfg.num_patches if "patch_embeds" in inputs else 0)
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
    return dict(logits=np.stack(steps), tokens=np.concatenate(toks, 1))


def _jax_train(arch, sp):
    """JAX's first AdamW step: its loss, the params after it, and the
    gradients it applied (returned from the same trace: `apply_updates`
    is wrapped while the step is traced, so one compile gives both)."""
    jcfg = _jcfg(arch, sp)
    tc = JaxTrainConfig(total_steps=4, warmup_steps=1, optimizer="adamw", grad_clip=1.0,
                        remat="none")
    params = _params(arch)
    batch = {k: jnp.asarray(v) for k, v in
             jax_make_batch(jcfg, JaxShapeConfig("t", SEQ, BATCH, "train"), 0, 0).items()}
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

    (params, _, m), grads = jax.jit(step_and_grads)(params, jax_init_opt(params, tc), batch)
    return dict(loss=float(m["loss"]), params=flat_paths(jax.tree.map(np.asarray, params)),
                grads=flat_paths(jax.tree.map(np.asarray, grads)))


def _save_params(d, arch):
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "params.npz", **flat_paths(jax.tree.map(np.asarray, _params(arch))))


def _jobs(root):
    """{name: job}: serve/<arch>, train/<arch>, and the sequence-parallel
    serve/sp/<arch>, train/sp/<arch>."""
    jobs = {}
    faults = {}
    for job, fault in FAULTS:
        faults.setdefault(job, []).append(fault)
    for arch, sp in [(a, False) for a in FAMILIES] + [(a, True) for a in SEQ_PARALLEL]:
        pre = "sp/" if sp else ""
        d = root / arch
        if not d.exists():
            _save_params(d, arch)
        cfg = {"seq_parallel": sp}
        name = f"serve/{pre}{arch}"
        sd = root / name
        sd.mkdir(parents=True)
        np.savez(sd / "inputs.npz", **_serve_inputs(_jcfg(arch, sp)))
        jobs[name] = dict(case="serve", dir=str(sd), params=str(d), arch=arch, cfg=cfg, data=1,
                          model=2, decode=N_DEC, faults=faults.get(name, []))
        name = f"train/{pre}{arch}"
        td = root / name
        td.mkdir(parents=True)
        jobs[name] = dict(case="train", dir=str(td), params=str(d), arch=arch, cfg=cfg, data=2,
                          model=2, steps=1, total_steps=4, grad_clip=1.0, seq=SEQ, batch=BATCH,
                          optimizer="adamw", grads=True, faults=faults.get(name, []))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of this file in one world of 4 ranks, beside its JAX
    reference: {job name: (reference, outputs)}."""
    root = tmp_path_factory.mktemp("parallel_families")
    jobs = _jobs(root)
    proc = start_suite(root, list(jobs.values()))
    refs = {}
    for name, job in jobs.items():
        sp = job["cfg"]["seq_parallel"]
        refs[name] = (_jax_serve if job["case"] == "serve" else _jax_train)(job["arch"], sp)
    outs = finish_suite(proc, list(jobs.values()))
    return {name: (refs[name], out) for name, out in zip(jobs, outs)}


def _serve_gap(ref, out, key=""):
    return float(np.max(np.abs(out[key + "logits"] - ref["logits"])))


def _train_gap(ref, out, key=""):
    """The step-0 loss's and the updated params' largest absolute gap."""
    gap = abs(float(out[key + "loss"][0]) - ref["loss"])
    for path, want in ref["params"].items():
        gap = max(gap, float(np.max(np.abs(out[f"{key}params/{path}"] - want))))
    return gap


def _grad_gap(ref, out, key=""):
    """Step 0's worst gradient leaf: its largest gap relative to the leaf's
    largest entry."""
    gap = 0.0
    for path, want in ref["grads"].items():
        err = float(np.max(np.abs(out[f"{key}grads/{path}"] - want)))
        gap = max(gap, err / max(float(np.max(np.abs(want))), 1e-30))
    return gap


SERVE_JOBS = [f"serve/{a}" for a in FAMILIES] + [f"serve/sp/{a}" for a in SEQ_PARALLEL]
TRAIN_JOBS = [f"train/{a}" for a in FAMILIES] + [f"train/sp/{a}" for a in SEQ_PARALLEL]


@pytest.mark.parametrize("job", SERVE_JOBS)
def test_serve_model2_matches_jax(runs, job):
    """Prefill and 4 greedy decode steps at model=2: every step's logits
    within 1e-4 of JAX's single-device steps, the greedy tokens identical
    (the MLA latent cache whole on each rank, the SSM state and conv_x tail
    the rank's heads and channels, the encoder output computed under the
    plan)."""
    ref, out = runs[job]
    assert _serve_gap(ref, out) <= TOL
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])


@pytest.mark.parametrize("job", TRAIN_JOBS)
def test_train_2x2_matches_jax(runs, job):
    """One AdamW step at (data 2, model 2): step 0's loss and every param
    after the step within 1e-4 of JAX's (deepseek with its MoE aux loss and
    MTP head; whisper's encoder, learned positions and cross-attention;
    internvl2's patches under one causal mask)."""
    ref, out = runs[job]
    assert _train_gap(ref, out) <= TOL


@pytest.mark.parametrize("job", TRAIN_JOBS)
def test_train_2x2_grads_match_jax(runs, job):
    """Step 0's gradients at (data 2, model 2), reduced as the step reduces
    them and gathered whole: every leaf within 1e-4 of `jax.grad`'s,
    relative to the leaf's largest entry (a sum over `model` counted twice,
    or one shard's partial where the sum was due, breaks it)."""
    ref, out = runs[job]
    assert _grad_gap(ref, out) <= TOL


@pytest.mark.parametrize("job,fault", FAULTS)
def test_planted_faults_break_it(runs, job, fault):
    ref, out = runs[job]
    if job.startswith("serve"):
        gap = _serve_gap(ref, out, f"{fault}/")
    else:
        gap = max(_train_gap(ref, out, f"{fault}/"), _grad_gap(ref, out, f"{fault}/"))
    assert gap > 100 * TOL, gap
