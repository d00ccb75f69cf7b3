"""KV heads replicated under tensor parallelism, against the JAX package on
the CPU.

Where `model` is a multiple of num_kv_heads larger than it, rank r holds
query heads [r a / t, (r + 1) a / t) and the one KV head they read, r nkv //
t, as its wk / wv columns and its cache; the replicas' gradients are summed
over the ranks that hold the KV head (`Plan.kv_group`), a checkpoint keeps
one replica of each block, and a restore onto any mesh replicates again.

In process: which production-mesh architectures the plan takes, and the
blocks of a replicated leaf.  In one subprocess world of 4 ranks over gloo
(`tests/torch_parallel_cases.py`), held against JAX's single-device run
computed here: internlm2-smoke (4 heads, 2 KV heads) served at model=4
(prefill + 3 decode steps: logits within 1e-4, rank 0's cache holding JAX's
first KV head) and trained at model=4 for 2 AdamW steps with a binding
clip norm (losses, grad norms, every gradient leaf of step 0 and every
param within 1e-4); the model=4 checkpoint restored at model=1, every leaf
equal to the gathered state.  The planted fault (`kv_grads_unsummed`: the
replicas' wk / wv gradients left unsummed) must break the train bound.
"""
from pathlib import Path

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
from repro.models import lm_loss as jax_lm_loss
from repro.optim.adamw import init_opt as jax_init_opt
from repro.serving.serve_step import make_decode_step as jax_decode_step
from repro.serving.serve_step import make_prefill_step as jax_prefill_step
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import MeshConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch.mesh import Mesh, production_mesh_config
from repro_torch.parallel import sharding as sh
from torch_parallel_cases import finish_suite, flat_paths, start_suite

ARCH = "internlm2-1.8b"
TOL = 1e-4
SEQ, BATCH, N_DEC = 16, 4, 3
MODEL = 4
REPLICATED = ("zamba2-2.7b", "internlm2-1.8b", "nemotron-4-340b", "command-r-plus-104b",
              "internvl2-76b", "deepseek-v3-671b", "mamba2-780m")
REFUSED = {"qwen1.5-4b": 20, "llama4-maverick-400b-a17b": 40, "whisper-small": 12}


@pytest.mark.parametrize("arch", REPLICATED)
def test_production_mesh_takes_the_arch(arch):
    """16 x 16: the plan takes the seven; KV heads fewer than 16 are
    replicated (internlm2, nemotron, command-r, internvl2: 8 KV heads, two
    ranks each)."""
    cfg = get_config(arch)
    sh.check_supported(cfg, production_mesh_config())
    plan = sh.Plan(cfg, Mesh(production_mesh_config()))
    want = 16 // cfg.num_kv_heads if cfg.attn_type == "gqa" and cfg.num_kv_heads < 16 else 1
    assert plan.kv_rep == want


@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_production_mesh_refuses_heads_that_do_not_split(arch):
    """The refusal is lifted: query heads that do not split over 16 run as
    halo heads.  validate_divisibility still lists the head count (JAX's
    warning); the plan takes the arch, every rank's span is a halo, and
    llama4's 40 / 8 keeps its KV heads replicated."""
    cfg = get_config(arch)
    assert cfg.num_heads == REFUSED[arch]
    mesh_cfg = production_mesh_config()
    sh.check_supported(cfg, mesh_cfg)
    assert f"num_heads {REFUSED[arch]} % tp 16 != 0" in sh.validate_divisibility(
        cfg, mesh_cfg, mesh_cfg.dp)
    plan = sh.Plan(cfg, Mesh(mesh_cfg))
    assert plan.kv_rep == (2 if cfg.num_kv_heads == 8 else 1)
    assert all(sh.head_span(cfg, 16, r).halo for r in range(16))


def test_only_the_plans_replica_group_is_made():
    """A mesh holds the replica group of the size it was made with; a Plan
    whose KV replication the mesh lacks is refused by name."""
    from repro_torch.launch.mesh import virtual_mesh
    cfg = get_smoke_config(ARCH)
    rep = sh.kv_replication(cfg, MODEL)
    mesh = virtual_mesh(MeshConfig(model=MODEL), 1, kv_rep=rep)
    assert rep == 2 and sh.Plan(cfg, mesh).kv_group.size == rep
    assert [k for k in mesh._groups if isinstance(k, tuple)] == [("model", rep)]
    with pytest.raises(ValueError, match="kv_rep=2"):
        sh.Plan(cfg, virtual_mesh(MeshConfig(model=MODEL), 1))
    assert sh.Plan(cfg, Mesh(MeshConfig(model=MODEL))).kv_group is None   # no groups at all


@pytest.mark.parametrize("rows,n_micro", [(2, 1), (3, 1), (8, 1), (8, 2)])
def test_batch_rows_replicates_a_batch_smaller_than_dp(rows, n_micro):
    """JAX's `_fix_small_batch`: a microbatch of fewer rows than dp is
    taken whole by every data rank; a larger one splits, one slice a rank."""
    dp = 4
    plan = sh.Plan(get_smoke_config(ARCH), Mesh(MeshConfig(data=dp), rank=1))
    batch = {"tokens": torch.arange(rows * 3).reshape(rows, 3)}
    got = plan.batch_rows(batch, n_micro)["tokens"]
    mb = rows // n_micro
    if mb < dp:
        assert torch.equal(got, batch["tokens"])
    else:
        loc = mb // dp
        want = batch["tokens"].reshape(n_micro, mb, 3)[:, loc:2 * loc].reshape(-1, 3)
        assert torch.equal(got, want)


def test_replicated_blocks_of_a_kv_leaf():
    """At model 4 over 2 KV heads, ranks 0-1 hold KV head 0's columns and
    ranks 2-3 KV head 1's; a replicated leaf's blocks gathered to the host
    give the whole leaf; wq stays split four ways."""
    cfg = get_smoke_config(ARCH)
    hd = cfg.head_dim
    wk = torch.arange(cfg.d_model * 2 * hd, dtype=torch.float32).reshape(cfg.d_model, 2 * hd)
    meshes = [Mesh(MeshConfig(model=MODEL), rank=r) for r in range(MODEL)]
    plan = sh.Plan(cfg, meshes[0])
    assert plan.kv_rep == 2 and plan.rep_of(("seg0", "attn", "wk")) == 2
    assert plan.rep_of(("seg0", "attn", "wq")) == 1
    blocks = [sh.local_shard(wk, (None, "model"), m, 2) for m in meshes]
    for r, b in enumerate(blocks):
        torch.testing.assert_close(b, wk[:, (r // 2) * hd:(r // 2 + 1) * hd], rtol=0, atol=0)
    wq = torch.zeros(cfg.d_model, cfg.num_heads * hd)
    assert sh.local_shard(wq, (None, "model"), meshes[3]).shape == (cfg.d_model, hd)


def save_params(d: Path, params) -> None:
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "params.npz", **flat_paths(jax.tree.map(np.asarray, params)))


def _jax_train(steps: int):
    jcfg = jax_smoke(ARCH)
    tc = JaxTrainConfig(total_steps=4, warmup_steps=1, optimizer="adamw", grad_clip=1.0,
                        remat="none")
    params = init = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    opt = jax_init_opt(params, tc)
    step = jax.jit(jax_make_train_step(jcfg, tc))
    shape = JaxShapeConfig("t", SEQ, BATCH, "train")
    batch0 = {k: jnp.asarray(v) for k, v in jax_make_batch(jcfg, shape, 0, 0).items()}
    grads = jax.grad(lambda p: jax_lm_loss(p, batch0, jcfg)[0])(params)
    losses, norms, states = [], [], []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in jax_make_batch(jcfg, shape, i, 0).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        states.append(flat_paths(jax.tree.map(np.asarray, params)))
    return dict(init=init, losses=np.array(losses), norms=np.array(norms), states=states,
                grads=flat_paths(jax.tree.map(np.asarray, grads)))


def _tokens():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         jax_smoke(ARCH).vocab_size), np.int32)


def _jax_serve():
    jcfg = jax_smoke(ARCH)
    params = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    toks = _tokens()
    logits, caches = jax.jit(jax_prefill_step(jcfg, 12 + N_DEC))(params, {"tokens": toks})
    decode = jax.jit(jax_decode_step(jcfg))
    steps = [np.asarray(logits)]
    for i in range(N_DEC):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, caches = decode(params, tok, caches, jnp.asarray(12 + i, jnp.int32))
        steps.append(np.asarray(logits))
    return dict(params=params, tokens=toks, logits=np.stack(steps),
                cache_k=np.asarray(caches[0]["k"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of ranks runs while JAX's references are computed here."""
    root = tmp_path_factory.mktemp("parallel_kv")
    params = jax_init_lm(jax.random.PRNGKey(0), jax_smoke(ARCH))
    save_params(root / "train", params)
    save_params(root / "serve", params)
    np.save(root / "serve" / "tokens.npy", _tokens())
    (root / "restore").mkdir()
    train = dict(case="train", dir=str(root / "train"), arch=ARCH, data=1, model=MODEL, steps=2,
                 total_steps=4, grad_clip=1.0, seq=SEQ, batch=BATCH, optimizer="adamw",
                 grads=True, checkpoint=True, faults=["kv_grads_unsummed"])
    jobs = {"train": train,
            "restore": dict(train, case="restore", dir=str(root / "restore"), model=1,
                            ckpt=str(root / "train" / "ckpt"), faults=[]),
            "serve": dict(case="serve", dir=str(root / "serve"), arch=ARCH, data=1, model=MODEL,
                          decode=N_DEC)}
    proc = start_suite(root, list(jobs.values()))
    ref = {"train": _jax_train(2), "serve": _jax_serve()}
    return ref, dict(zip(jobs, finish_suite(proc, list(jobs.values()))))


def _train_gap(out, key, ref):
    gap = float(np.max(np.abs(out[key + "loss"] - ref["losses"])))
    gap = max(gap, float(np.max(np.abs(out[key + "grad_norm"] / ref["norms"] - 1))))
    for path, want in ref["states"][-1].items():
        gap = max(gap, float(np.max(np.abs(out[f"{key}params/{path}"] - want))))
    return gap


def test_serve_model4_matches_jax(runs):
    """Prefill and 3 decode steps at model=4 over 2 KV heads: every step's
    logits within 1e-4 of JAX's; rank 0's cache holds JAX's KV head 0."""
    ref, out = runs[0]["serve"], runs[1]["serve"]
    np.testing.assert_allclose(out["logits"], ref["logits"], atol=TOL, rtol=0)
    assert out["cache_k"].shape[-2] == 1
    np.testing.assert_allclose(out["cache_k"], ref["cache_k"][..., :1, :], atol=TOL, rtol=0)


def test_train_model4_matches_jax(runs):
    """2 AdamW steps at model=4 (the clip binds): losses, grad norms and
    every param within 1e-4 of JAX's, and step 0's gradient of every leaf
    (wk / wv summed over their two replicas) within 1e-4 of jax.grad."""
    ref, out = runs[0]["train"], runs[1]["train"]
    assert np.all(ref["norms"] > 1.0)
    assert _train_gap(out, "", ref) <= TOL
    for path, want in ref["grads"].items():
        np.testing.assert_allclose(out[f"grads/{path}"], want, atol=TOL, rtol=0, err_msg=path)


def test_train_model4_planted_fault_breaks_it(runs):
    """The replicas' wk / wv gradients left unsummed: the step-0 gradients
    of wk and wv, and the trained params, leave the bound."""
    ref, out = runs[0]["train"], runs[1]["train"]
    assert _train_gap(out, "kv_grads_unsummed/", ref) > 10 * TOL
    for leaf in ("wk", "wv"):
        key = f"kv_grads_unsummed/grads/seg0/attn/{leaf}"
        assert np.max(np.abs(out[key] - ref["grads"][f"seg0/attn/{leaf}"])) > 10 * TOL


def test_checkpoint_model4_restores_at_model1(runs):
    """The model=4 checkpoint (one replica of each KV block) restored at
    model=1: every leaf equal to what model=4 held, gathered; the update
    count restored."""
    trained, out = runs[1]["train"], runs[1]["restore"]
    assert int(out["step"]) == 2 and int(out["opt_step"]) == 2
    for path in runs[0]["train"]["states"][-1]:
        np.testing.assert_array_equal(out[f"restored/{path}"], trained[f"params/{path}"])
