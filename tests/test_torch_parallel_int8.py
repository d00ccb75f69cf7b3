"""Int8 weights (linear_impl="quantized") under tensor parallelism, against
the JAX package's single-device int8 run on the CPU.

A column-parallel product keeps its whole fan-in, so its scales are the
unsharded run's as they stand; a row-parallel one (wo, w_down) takes each
activation row's absmax, and a per-call weight's column absmax, as a MAX
over `model` (`models/linear.py` `_row_int8`); a prequantized weight
(`quantize_linear_params`) shards its payload and keeps its scales whole.

In one subprocess world of 4 ranks over gloo (`tests/torch_parallel_cases.py`),
held against JAX's run computed here on the same params: internlm2-smoke
served on one device and at model=2 and model=4 (its 2 KV heads
replicated twice), with float weights quantized per call and with
prequantized weights (prefill and 3 decode steps: every step's logits
within 1e-4 of JAX's int8 run, the greedy tokens identical; every
row-parallel product's activation and weight codes and scales, gathered
over `model`, equal to the quantization of its gathered operands, and its
activation codes equal to the unsharded run's bit for bit); and one
AdamW step on one device and at (data 2, model 2) on the int8 path, both
held to JAX's step (every step-0 gradient leaf within JAX_GRAD_REL of the
leaf's largest entry, the loss within JAX_LOSS_REL, every param after the
step within JAX_PARAM_BOUND) and the (2, 2) step to the one-device step
(loss, every gradient leaf relative to the leaf's largest entry, every
param within 1e-4).  The planted faults (the activation scale's MAX over `model`
dropped; the weight scale's dropped; the codes taken at the shard's own
absmax under the MAX's scale) must each break the codes' bound and the
logits' bound against JAX, or the train step's bounds against JAX and
against the one-device step.
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
from repro.optim.adamw import init_opt as jax_init_opt
from repro.serving.serve_step import make_decode_step as jax_decode_step
from repro.serving.serve_step import make_prefill_step as jax_prefill_step
from repro.train import train_step as jax_train_step_mod
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import MeshConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import sharding as sh
from torch_parallel_cases import finish_suite, flat_paths, start_suite

ARCH = "internlm2-1.8b"
TOL = 1e-4
SEQ, BATCH = 16, 4          # the (2, 2) train step
PROMPT, N_DEC = 12, 3       # the serve runs
ACT, WEIGHT = "act_scale_unreduced", "weight_scale_unreduced"
CODES = "codes_at_shard_absmax"
# name: (model, prequantized, planted faults)
SERVES = {"serve/model1": (1, False, []),
          "serve/model2": (2, False, [ACT, WEIGHT, CODES]),
          "serve/model4": (4, False, [ACT, WEIGHT]),
          "serve/model2/prequantized": (2, True, [ACT]),
          "serve/model4/prequantized": (4, True, [ACT])}
# name: (data, model, planted faults)
TRAINS = {"train/1x1": (1, 1, []), "train/2x2": (2, 2, [ACT, WEIGHT])}
# The port's int8 step against JAX's, on one device and sharded alike.  The
# int8 GEMMs are exact on both sides, but XLA sums the f32 norms and
# attention around them in another order, which can move an activation
# across an int8 rounding step (tests/test_torch_quantized.py
# test_apply_lm_forward_and_grads_match_jax).  At this batch one does: an
# element of sequence 3's token 1 lies 4.3e-6 of a step from a tie, and
# that sequence's later logits move 2e-2-5e-2 (the other three sequences
# agree within 1e-6).  It moves the loss 2.9e-4 (relative) and the
# gradient leaves up to 3.9e-3 of their largest entry (w_gate); the
# planted scale faults move them 3.0e-2-3.5e-2.
JAX_LOSS_REL = 1e-3
JAX_GRAD_REL = 1e-2
# Adam's first step moves each element by lr * g / (|g| + eps), at most lr:
# two runs whose gradients differ can differ by 2 lr after it (an element
# whose gradient is near 0, or of the other sign), plus f32 rounding; the
# step's lr is the peak (warmup_steps=1), both packages' default
LR = JaxTrainConfig().learning_rate
JAX_PARAM_BOUND = 2 * LR + 1e-6


def _jcfg():
    return dataclasses.replace(jax_smoke(ARCH), linear_impl="quantized")


@functools.lru_cache(maxsize=None)
def _params():
    return jax.jit(jax_init_lm, static_argnums=1)(jax.random.PRNGKey(0), _jcfg())


def _tokens():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, PROMPT), 0,
                                         _jcfg().vocab_size), np.int32)


def _jax_serve():
    jcfg, params = _jcfg(), _params()
    logits, caches = jax.jit(jax_prefill_step(jcfg, PROMPT + N_DEC))(
        params, {"tokens": jnp.asarray(_tokens())})
    decode = jax.jit(jax_decode_step(jcfg))
    steps, toks = [np.asarray(logits)], []
    for i in range(N_DEC):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, caches = decode(params, tok, caches, jnp.asarray(PROMPT + i, jnp.int32))
        steps.append(np.asarray(logits))
    return dict(logits=np.stack(steps), tokens=np.concatenate(toks, 1))


def _jax_train():
    """JAX's first AdamW step on the int8 path: its loss, the params after
    it and the gradients it applied (`apply_updates` wrapped while the step
    is traced)."""
    jcfg = _jcfg()
    tc = JaxTrainConfig(total_steps=4, warmup_steps=1, optimizer="adamw", grad_clip=1.0,
                        remat="none")
    params = _params()
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The serve and train jobs in one world of 4 ranks, beside JAX's
    references: {job name: (reference, outputs)}."""
    root = tmp_path_factory.mktemp("parallel_int8")
    pdir = root / "params"
    pdir.mkdir()
    np.savez(pdir / "params.npz", **flat_paths(jax.tree.map(np.asarray, _params())))
    cfg = {"linear_impl": "quantized"}
    jobs = {}
    for name, (model, pre, faults) in SERVES.items():
        d = root / name
        d.mkdir(parents=True)
        np.save(d / "tokens.npy", _tokens())
        jobs[name] = dict(case="serve", dir=str(d), params=str(pdir), arch=ARCH, cfg=cfg,
                          data=1, model=model, decode=N_DEC, prequantized=pre, codes=True,
                          faults=faults)
    for name, (data, model, faults) in TRAINS.items():
        d = root / name
        d.mkdir(parents=True)
        jobs[name] = dict(case="train", dir=str(d), params=str(pdir), arch=ARCH, cfg=cfg,
                          data=data, model=model, steps=1, total_steps=4, grad_clip=1.0, seq=SEQ,
                          batch=BATCH, optimizer="adamw", grads=True, faults=faults)
    proc = start_suite(root, list(jobs.values()))
    serve, train = _jax_serve(), _jax_train()
    outs = finish_suite(proc, list(jobs.values()))
    return {name: (train if name in TRAINS else serve, out) for name, out in zip(jobs, outs)}


def test_plan_takes_int8_weights_under_tensor_parallelism():
    """The refusal is lifted: int8 weights at model 2, (2, 2) and model 4."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), linear_impl="quantized")
    for mesh_cfg in (MeshConfig(model=2), MeshConfig(data=2, model=2), MeshConfig(model=4)):
        sh.check_supported(cfg, mesh_cfg)
        assert sh.Plan(cfg, Mesh(mesh_cfg)).tp == mesh_cfg.model


@pytest.mark.parametrize("job", sorted(SERVES))
def test_serve_matches_jax_int8(runs, job):
    """Prefill and 3 decode steps: every step's logits within 1e-4 of JAX's
    single-device int8 run, the greedy tokens identical."""
    ref, out = runs[job]
    assert float(np.max(np.abs(out["logits"] - ref["logits"]))) <= TOL
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])


def _row_products():
    return 2 * get_smoke_config(ARCH).num_layers * (1 + N_DEC)


@pytest.mark.parametrize("job", sorted(SERVES))
def test_row_parallel_codes_bit_for_bit(runs, job):
    """Every row-parallel product of the run (each layer's wo and w_down,
    prefill and decode): its activation's int8 codes and row scales, and a
    per-call weight's codes and column scales, gathered over `model`, equal
    the quantization of the gathered operands; its activation codes equal
    the unsharded run's bit for bit.  Layer 0's wo row scales do too (its
    input is computed alike by every run: exact int32 sums in the
    column-parallel products, whole heads); after a `tp_exit` a row scale
    may differ from the unsharded run's by the f32 sum's order."""
    out, one = runs[job][1], runs["serve/model1"][1]
    assert len(out["row_codes_unequal"]) == _row_products()
    assert int(out["row_codes_unequal"].sum()) == 0
    for i in range(_row_products()):
        np.testing.assert_array_equal(out[f"row_codes/{i}"], one[f"row_codes/{i}"])
        np.testing.assert_allclose(out[f"row_scales/{i}"], one[f"row_scales/{i}"], rtol=TOL)
    np.testing.assert_array_equal(out["row_scales/0"], one["row_scales/0"])


SERVE_FAULTS = [(j, f) for j, (_, _, fs) in SERVES.items() for f in fs]


@pytest.mark.parametrize("job,fault", SERVE_FAULTS)
def test_planted_scale_faults_break_the_codes(runs, job, fault):
    """A scale's MAX over `model` dropped, or the codes taken at the
    shard's own absmax: the codes leave their gathered operands'
    quantization, and the unsharded run's."""
    out, one = runs[job][1], runs["serve/model1"][1]
    assert int(out[f"{fault}/row_codes_unequal"].sum()) > 0
    assert any(not np.array_equal(out[f"{fault}/row_codes/{i}"], one[f"row_codes/{i}"])
               for i in range(_row_products()))


@pytest.mark.parametrize("job,fault", SERVE_FAULTS)
def test_planted_scale_faults_break_the_logits(runs, job, fault):
    """Each planted fault moves the logits past the 1e-4 bound against
    JAX's int8 run."""
    ref, out = runs[job]
    assert float(np.max(np.abs(out[f"{fault}/logits"] - ref["logits"]))) > TOL


def _train_gap(ref, out, key=""):
    """(step 0's loss gap, the worst gradient leaf's gap relative to the
    leaf's largest entry, the params' largest gap after the step) of a
    train run against another."""
    loss = abs(float(out[key + "loss"][0]) - float(ref["loss"][0]))
    grads = params = 0.0
    for k, want in ref.items():
        if k.startswith("grads/"):
            err = float(np.max(np.abs(out[key + k] - want)))
            grads = max(grads, err / max(float(np.max(np.abs(want))), 1e-30))
        elif k.startswith("params/"):
            params = max(params, float(np.max(np.abs(out[key + k] - want))))
    return loss, grads, params


def _jax_gap(jax_ref, out, key=""):
    """(step 0's loss gap relative to JAX's, the worst gradient leaf's gap
    relative to the leaf's largest entry, the params' largest gap after the
    step) of a train run against JAX's step."""
    loss = abs(float(out[key + "loss"][0]) - jax_ref["loss"]) / abs(jax_ref["loss"])
    grads = max(float(np.max(np.abs(out[f"{key}grads/{k}"] - want)))
                / max(float(np.max(np.abs(want))), 1e-30) for k, want in jax_ref["grads"].items())
    params = max(float(np.max(np.abs(out[f"{key}params/{k}"] - want)))
                 for k, want in jax_ref["params"].items())
    return loss, grads, params


def _held_to_jax(jax_ref, out):
    loss, grads, params = _jax_gap(jax_ref, out)
    assert loss <= JAX_LOSS_REL
    assert grads <= JAX_GRAD_REL
    assert params <= JAX_PARAM_BOUND


def test_train_2x2_step0_matches_jax_int8(runs):
    """One AdamW step at (data 2, model 2) on the int8 path (straight-through
    gradients, dx from each row-parallel shard) against JAX's single-device
    step: the loss within JAX_LOSS_REL, every gradient leaf within
    JAX_GRAD_REL of the leaf's largest entry, every param after the step
    within JAX_PARAM_BOUND; and against the same step on one device: step
    0's loss, every gradient leaf (relative to the leaf's largest entry)
    and every param after the step within 1e-4."""
    jax_ref, out = runs["train/2x2"]
    _held_to_jax(jax_ref, out)
    assert max(_train_gap(runs["train/1x1"][1], out)) <= TOL


def test_train_one_device_step0_matches_jax_int8(runs):
    """The same step on one device against JAX's, within the same bounds."""
    _held_to_jax(*runs["train/1x1"])


@pytest.mark.parametrize("fault", TRAINS["train/2x2"][2])
def test_train_2x2_planted_scale_faults_break_it(runs, fault):
    """A scale's MAX over `model` dropped in the (2, 2) step: its step 0
    leaves the 1e-4 bound against the step on one device, and its
    gradients leave JAX_GRAD_REL against JAX's step."""
    jax_ref, out = runs["train/2x2"]
    one = runs["train/1x1"][1]
    assert max(_train_gap(one, out, f"{fault}/")) > TOL
    assert _jax_gap(jax_ref, out, f"{fault}/")[1] > JAX_GRAD_REL
