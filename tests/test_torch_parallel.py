"""The port's parallelism against the JAX package on the CPU.

In process: the port's spec trees (`param_specs`, `batch_specs`,
`cache_specs`, `strip_axis`) equal JAX's leaf by leaf for every registered
smoke family, JAX's on a 1 x 1 `jax.sharding.Mesh` (as tests/test_sharding.py
builds them), and `validate_divisibility` gives JAX's messages.

In one subprocess world of 4 ranks over gloo (`tests/torch_parallel_cases.py`,
with its own timeout), held against JAX's single-device results computed here:
internlm2-smoke trained at (data 2, model 2) for 3 f32 steps with a binding
clip norm, at AdamW (losses and params within 1e-4; one step each under
remat="full" and "dots", whose backward gathers each layer again) and at
adamw8bit (after every step: int8 codes within one code of JAX's; params
and row scales within 1e-4 or twice the gap JAX shows against itself when
only its sum order changes); prefill + decode at model=2
(logits within 1e-4; rank 0's cache holds the first KV head of JAX's);
the GPipe pipeline at 2 and 4 stages against tests/test_pipeline.py's
sequential stack (outputs and gradients within 1e-5); and elastic restore:
the (2, 2) checkpoint restored onto (4, 1), whole leaves bit-identical, and
the next step against JAX's fourth.  Each planted fault
(`torch_parallel_cases.FAULTS`: a dropped all-reduce, gradients not
summed over data, the clip norm of one rank's blocks, adamw8bit's absmax
over one rank's part of a row) must break its test's bound.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig as JaxMeshConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.configs.registry import list_archs as jax_list_archs
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_lm as jax_init_lm
from repro.optim.adamw import init_opt as jax_init_opt
from repro.parallel import sharding as jsh
from repro.serving.serve_step import make_decode_step as jax_decode_step
from repro.serving.serve_step import make_prefill_step as jax_prefill_step
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import MeshConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import Mesh, production_mesh_config
from repro_torch.models import init_lm
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.pipeline import split_layers_into_stages
from torch_parallel_cases import flat_paths, run_suite

ARCH = "internlm2-1.8b"
TOL = 1e-4
SEQ, BATCH = 16, 4
TRAIN_FAULTS = ["dropped_allreduce", "no_data_average", "local_clip_norm"]


def save_params(d: Path, params) -> None:
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "params.npz", **flat_paths(jax.tree.map(np.asarray, params)))


# --- spec trees --------------------------------------------------------------------------

def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _jax_spec_leaves(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(path): tuple(spec) for path, spec in leaves}


def _port_spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_spec_leaves(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_spec_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


SMOKE_ARCHS = sorted(jax_list_archs())


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_spec_trees_equal_jax(arch):
    """param_specs (with and without FSDP), strip_axis, batch_specs and
    cache_specs, leaf by leaf against JAX's on a 1 x 1 mesh."""
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = jax.eval_shape(lambda k: jax_init_lm(k, jcfg), jax.random.PRNGKey(0))
    params = init_lm(None, cfg, device="meta")
    jm, m = _jax_mesh(), Mesh(MeshConfig())
    for fsdp in (True, False):
        want = jsh.param_specs(jparams, jcfg, jm, fsdp=fsdp)
        got = sh.param_specs(params, cfg, m, fsdp=fsdp)
        assert _port_spec_leaves(got) == _jax_spec_leaves(want)
        assert _port_spec_leaves(sh.strip_axis(got)) == _jax_spec_leaves(jsh.strip_axis(want))
    assert _port_spec_leaves(sh.batch_specs(cfg, m)) == _jax_spec_leaves(
        jsh.batch_specs(jcfg, jm))
    assert _port_spec_leaves(sh.cache_specs(cfg, m)) == _jax_spec_leaves(
        jsh.cache_specs(jcfg, jm))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama4-maverick-400b-a17b", "mamba2-780m",
                                  "whisper-small", "gpt3-2.7b-c0"])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 3), (16, 16), (3, 5)])
def test_validate_divisibility_matches_jax(arch, mesh):
    data, model = mesh
    for batch in (8, 12, 7):
        want = jsh.validate_divisibility(jax_smoke(arch), JaxMeshConfig(data=data, model=model),
                                         batch)
        got = sh.validate_divisibility(get_smoke_config(arch),
                                       MeshConfig(data=data, model=model), batch)
        assert got == want


def test_production_mesh_config_matches_jax():
    from repro.launch.mesh import production_mesh_config as jax_pmc
    for multi in (False, True):
        assert dataclasses.asdict(production_mesh_config(multi_pod=multi)) == \
            dataclasses.asdict(jax_pmc(multi_pod=multi))


def test_split_layers_into_stages_rule():
    """JAX's assertion text for L % stages (tests/test_pipeline.py)."""
    import torch
    staged = split_layers_into_stages({"w": torch.zeros(8, 4, 4)}, 4)
    assert staged["w"].shape == (4, 2, 4, 4)
    with pytest.raises(AssertionError, match="paper"):
        split_layers_into_stages({"w": torch.zeros(7, 4, 4)}, 2)


def test_serving_refuses_fsdp_plans():
    """The serve steps take params whole over data: a plan whose params are
    sharded over data (FSDP) is refused by name; fsdp=False is taken."""
    from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
    cfg = get_smoke_config(ARCH)
    fsdp = sh.Plan(cfg, Mesh(MeshConfig(data=2)))
    for make in (lambda p: make_prefill_step(cfg, 16, p), lambda p: make_decode_step(cfg, p)):
        with pytest.raises(ValueError, match="fsdp=False"):
            make(fsdp)
        make(sh.Plan(cfg, Mesh(MeshConfig(data=2, fsdp=False))))


def test_local_shard_blocks_cover_the_leaf():
    """The blocks of every rank of a (2, 2) mesh tile the leaf exactly."""
    import torch
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec in (("data", "model"), ("model", "data"), (None, "model"), ()):
        blocks = {}
        for r in range(4):
            blocks[r] = sh.local_shard(t, spec, Mesh(MeshConfig(data=2, model=2), rank=r))
        seen = torch.cat([b.reshape(-1) for b in blocks.values()])
        reps = 4 // int(np.prod([Mesh(MeshConfig(data=2, model=2)).axis_size(e)
                                    for e in spec]))
        assert sorted(seen.tolist()) == sorted(t.reshape(-1).tolist() * reps)


# --- the subprocess suite: JAX's references here, one world of ranks -----------------

def _jax_train(optimizer: str, steps: int, n_micro: int = 1):
    """JAX's single-device run: its initial params, losses, grad norms, and
    (flat params, opt) after each step."""
    jcfg = jax_smoke(ARCH)
    tc = JaxTrainConfig(total_steps=4, warmup_steps=1, optimizer=optimizer, grad_clip=1.0,
                        remat="none")
    params = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    init = params
    opt = jax_init_opt(params, tc)
    step = jax.jit(jax_make_train_step(jcfg, tc, n_micro=n_micro))
    shape = JaxShapeConfig("t", SEQ, BATCH, "train")
    losses, norms, states = [], [], []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in jax_make_batch(jcfg, shape, i, 0).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        states.append((flat_paths(jax.tree.map(np.asarray, params)), opt))
    return dict(init=init, losses=np.array(losses), norms=np.array(norms), states=states)


def _jax_serve(n_dec: int):
    jcfg = jax_smoke(ARCH)
    params = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, jcfg.vocab_size),
                      np.int32)
    logits, caches = jax.jit(jax_prefill_step(jcfg, 12 + n_dec))(params, {"tokens": toks})
    decode = jax.jit(jax_decode_step(jcfg))
    steps = [np.asarray(logits)]
    for i in range(n_dec):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, caches = decode(params, tok, caches, jnp.asarray(12 + i, jnp.int32))
        steps.append(np.asarray(logits))
    return dict(params=params, tokens=toks, logits=np.stack(steps),
                cache_k=np.asarray(caches[0]["k"]))


PIPE_L, PIPE_M, PIPE_B, PIPE_D = 8, 6, 2, 16


def _jax_pipeline_reference():
    """tests/test_pipeline.py's stack and its sequential result, with the
    gradient of sum(out * r) for every layer."""
    key = jax.random.PRNGKey(0)
    w = jax.random.normal(key, (PIPE_L, PIPE_D, PIPE_D)) * (0.5 / PIPE_D ** 0.5)
    x = jax.random.normal(jax.random.fold_in(key, 1), (PIPE_M, PIPE_B, PIPE_D))
    r = jax.random.normal(jax.random.fold_in(key, 2), (PIPE_M, PIPE_B, PIPE_D))

    def seq(w, x1):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, x1, w)[0]

    def run(w):
        return jax.vmap(lambda x1: seq(w, x1))(x)

    return dict(inputs=dict(w=np.asarray(w), x=np.asarray(x), r=np.asarray(r)),
                y=np.asarray(run(w)), grad=np.asarray(jax.grad(lambda w: jnp.sum(run(w) * r))(w)))


def _job(optimizer, d, **kw):
    return dict(case="train", dir=str(d), arch=ARCH, data=2, model=2, steps=3, total_steps=4,
                grad_clip=1.0, seq=SEQ, batch=BATCH, optimizer=optimizer, **kw)


N_DEC = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of this file in one world of 4 ranks, beside its JAX
    reference: {name: (reference, outputs)}."""
    root = tmp_path_factory.mktemp("parallel")
    ref = {"adamw": _jax_train("adamw", 4), "adamw8bit": _jax_train("adamw8bit", 3),
           "adamw8bit_witness": _jax_train("adamw8bit", 3, n_micro=2),
           "micro": _jax_train("adamw", 1, n_micro=2),
           "serve": _jax_serve(N_DEC), "pipeline": _jax_pipeline_reference()}
    for name in ("adamw", "adamw8bit", "micro", "serve"):
        save_params(root / name, ref[name]["init" if name != "serve" else "params"])
    np.save(root / "serve" / "tokens.npy", ref["serve"]["tokens"])
    jobs = {"adamw": _job("adamw", root / "adamw", checkpoint=True, faults=TRAIN_FAULTS),
            "adamw8bit": _job("adamw8bit", root / "adamw8bit",
                              faults=["local_absmax", "late_local_absmax"]),
            "micro": dict(_job("adamw", root / "micro"), steps=1, n_micro=2),
            "remat_full": dict(_job("adamw", root / "adamw"), dir=str(root / "remat_full"),
                               params=str(root / "adamw"), steps=1, remat="full"),
            "remat_dots": dict(_job("adamw", root / "adamw"), dir=str(root / "remat_dots"),
                               params=str(root / "adamw"), steps=1, remat="dots"),
            "restore": dict(_job("adamw", root / "restore"), case="restore", data=4, model=1,
                            ckpt=str(root / "adamw" / "ckpt")),
            "serve": dict(case="serve", dir=str(root / "serve"), arch=ARCH, data=1, model=2,
                          decode=N_DEC, faults=["dropped_allreduce"])}
    for stages in (2, 4):
        d = root / f"pipeline{stages}"
        d.mkdir()
        np.savez(d / "inputs.npz", **ref["pipeline"]["inputs"])
        jobs[f"pipeline{stages}"] = dict(case="pipeline", dir=str(d), world=stages)
    for name in ("restore", "remat_full", "remat_dots"):
        (root / name).mkdir()
    outs = run_suite(root, list(jobs.values()))
    out = dict(zip(jobs, outs))
    ref["restore"] = ref["remat_full"] = ref["remat_dots"] = ref["adamw"]
    ref["pipeline2"] = ref["pipeline4"] = ref["pipeline"]
    return {name: (ref[name], out[name]) for name in jobs} | {
        "adamw_out": out["adamw"], "adamw8bit_witness": ref["adamw8bit_witness"]}


def _worst(out, key, losses, params, norms):
    """The largest gap of a run to JAX's: absolute over its losses and
    params, relative over its grad norms (Adam's update barely sees the clip
    scale, the grad norm it reports does)."""
    gap = float(np.max(np.abs(out[key + "loss"] - losses)))
    gap = max(gap, float(np.max(np.abs(out[key + "grad_norm"] / norms - 1))))
    for path, want in params.items():
        gap = max(gap, float(np.max(np.abs(out[f"{key}params/{path}"] - want))))
    return gap


def test_train_2x2_matches_jax(runs):
    """3 AdamW steps at (data 2, model 2): losses, grad norms (the clip
    binds: every norm > 1) and every param leaf within 1e-4 of JAX's."""
    ref, out = runs["adamw"]
    assert np.all(ref["norms"][:3] > 1.0)
    assert _worst(out, "", ref["losses"][:3], ref["states"][2][0], ref["norms"][:3]) <= TOL


def _gathers_a_step(out, steps):
    top, layer = (int(n) for n in out["fsdp_leaves"])
    return int(out["fsdp_gathers"]) / steps, top, layer


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_2x2_remat_matches_jax(runs, remat):
    """One step at (data 2, model 2) under remat="full" / "dots": loss, grad
    norm and params within 1e-4 of JAX's first step.  FSDP gathers each
    layer's leaves inside the recomputed body, so the backward gathers them
    again: twice the layer gathers of remat="none", whose step gathers each
    data-sharded leaf once where it is used (every layer's, the embedding
    and the head)."""
    ref, out = runs[f"remat_{remat}"]
    assert _worst(out, "", ref["losses"][:1], ref["states"][0][0], ref["norms"][:1]) <= TOL
    n, top, layer = _gathers_a_step(out, 1)
    n_none, top_none, layer_none = _gathers_a_step(runs["adamw_out"], 3)
    assert (top, layer) == (top_none, layer_none) and top == 2 and layer > 0
    assert n_none == top + layer
    assert n == top + 2 * layer


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_train_2x2_planted_faults_break_it(runs, fault):
    ref, out = runs["adamw"]
    assert _worst(out, f"{fault}/", ref["losses"][:3], ref["states"][2][0],
                  ref["norms"][:3]) > 10 * TOL


def test_train_2x2_microbatched_matches_jax(runs):
    """One step at (data 2, model 2) in 2 microbatches (each rank takes its
    row of each global microbatch, as JAX shards it): loss, grad norm and
    params within 1e-4 of JAX's n_micro=2 step."""
    ref, out = runs["micro"]
    assert _worst(out, "", ref["losses"], ref["states"][0][0], ref["norms"]) <= TOL


def _state(ref, i):
    """JAX's params and int8 moments after step i + 1, keyed as the port's
    outputs are."""
    params, opt = ref["states"][i]
    out = {f"params/{k}": v for k, v in params.items()}
    for name, tree in (("m", opt.m), ("v", opt.v)):
        out.update({f"{name}/{k}": v for k, v in
                    flat_paths(jax.tree.map(np.asarray, tree)).items()})
    return out


def _step(out, key, i):
    pre = f"{key}step{i}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _int8_gaps(got, want):
    """[largest param gap, largest int8 code gap, largest relative row-scale
    gap] of a state to `want`."""
    gaps = [0.0, 0, 0.0]
    for k, w in want.items():
        g = got[k]
        if k.startswith("params/"):
            gaps[0] = max(gaps[0], float(np.max(np.abs(g - w))))
        elif k.endswith("/codes"):
            gaps[1] = max(gaps[1], int(np.max(np.abs(g.astype(np.int32) - w.astype(np.int32)))))
        elif k.endswith("/scale"):
            gaps[2] = max(gaps[2], float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))))
    return gaps


def test_train_adamw8bit_2x2_matches_jax(runs):
    """The same at adamw8bit, held after every one of the 3 steps: losses
    and grad norms within 1e-4; every int8 moment code (m and v) within
    one code of JAX's; params and row scales (absmax / 127 over the whole
    row, which a column- or row-parallel block splits) within 1e-4, or
    within twice the gap that JAX's own run shows when only its sum order
    changes (JAX at n_micro=2 against JAX at n_micro=1, the witness).
    Where an int8 code is small, a sum in another order moves it one code
    and the update by up to m / eps, in JAX's algorithm as in the port's:
    the witness moves params by up to ~0.1 at step 3, as the port does.
    A rank-local absmax breaks the codes and scales at step 1; the same
    from step 2 on leaves step 1 whole and breaks step 2."""
    ref, out = runs["adamw8bit"]
    witness = runs["adamw8bit_witness"]
    assert float(np.max(np.abs(out["loss"] - ref["losses"]))) <= TOL
    assert float(np.max(np.abs(out["grad_norm"] / ref["norms"] - 1))) <= TOL
    for i in range(3):
        want = _state(ref, i)
        got = _int8_gaps(_step(out, "", i), want)
        bound = _int8_gaps(_state(witness, i), want)
        assert got[1] <= 1, (i, got)
        assert got[0] <= max(TOL, 2 * bound[0]), (i, got, bound)
        assert got[2] <= max(TOL, 2 * bound[2]), (i, got, bound)
    early = _int8_gaps(_step(out, "local_absmax/", 0), _state(ref, 0))
    assert early[1] > 1 and early[2] > 100 * TOL, early
    late = [_int8_gaps(_step(out, "late_local_absmax/", i), _state(ref, i)) for i in (0, 1)]
    assert late[0][1] <= 1 and late[0][2] <= TOL, late
    assert late[1][1] > 1, late


def test_elastic_restore_2x2_onto_4x1(runs):
    """The (2, 2) checkpoint restored onto (4, 1): every leaf bit-identical
    to what (2, 2) held, the update count restored, and the next step (batch
    3) within 1e-4 of JAX's fourth step."""
    ref, out = runs["restore"]
    trained = runs["adamw_out"]
    assert int(out["step"]) == 3 and int(out["opt_step"]) == 3
    for path in ref["states"][2][0]:
        np.testing.assert_array_equal(out[f"restored/{path}"], trained[f"params/{path}"])
    assert abs(float(out["loss"][0]) - ref["losses"][3]) <= TOL
    for path, want in ref["states"][3][0].items():
        np.testing.assert_allclose(out[f"params/{path}"], want, atol=TOL, rtol=0)


def test_prefill_decode_model2_matches_jax(runs):
    """serve_step's prefill and 3 greedy decode steps at model=2: every
    step's logits within 1e-4 of JAX's single-device steps; rank 0's cache
    holds JAX's first KV head (the port shards the cache by KV head where
    JAX's cache_specs shard the sequence); a dropped all-reduce breaks it."""
    ref, out = runs["serve"]
    np.testing.assert_allclose(out["logits"], ref["logits"], atol=TOL, rtol=0)
    kv_loc = jax_smoke(ARCH).num_kv_heads // 2
    np.testing.assert_allclose(out["cache_k"], ref["cache_k"][..., :kv_loc, :], atol=TOL, rtol=0)
    assert np.max(np.abs(out["dropped_allreduce/logits"] - ref["logits"])) > 100 * TOL


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_sequential(runs, stages):
    """tests/test_pipeline.py's case (8 tanh layers, 6 microbatches of 2 x
    16) at 2 and 4 stages: every rank's outputs, and the gradient of
    sum(out * r) for every layer, within 1e-5 of JAX's sequential stack."""
    ref, outs = runs[f"pipeline{stages}"]
    assert len(outs) == stages
    for out in outs:
        np.testing.assert_allclose(out["y"], ref["y"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out["grad"], ref["grad"], atol=1e-5, rtol=1e-5)
