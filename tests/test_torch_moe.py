"""The port's MoE family against the JAX package: the MoE layer, the
batched expert GEMMs, whole models (llama4-smoke: GQA, top-1 MoE in `pair`
segments; deepseek-smoke: MLA, top-2 MoE after a dense layer, MTP), the
loss with its aux and MTP terms and its gradients, greedy generation and
the engines.

Params are made by the JAX package and converted with `params_from_jax`;
activations and tokens come from a seed with numpy.  Both smoke configs
run in f32.  Tolerances: 2e-5 (abs and rel) for a layer or model output,
both sides in f32 with sums in another order; the JAX training suite's
`atol=2e-4, rtol=2e-3` for the loss and every gradient leaf; exact for
tokens.  The JAX side's "fused" path runs its Pallas kernels in interpret
mode, as its own tests do; the port's runs its kernels' plain versions on
CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core.hardware import H100_SXM as JAX_H100
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import apply_lm as jax_apply_lm
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.models.linear import expert_fused_hidden as jax_expert_fused_hidden
from repro.models.linear import expert_linear as jax_expert_linear
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import init_moe as jax_init_moe
from repro.serving.engine import BucketPolicy as JaxBucketPolicy
from repro.serving.engine import Engine as JaxEngine
from repro.serving.serve_step import greedy_generate as jax_greedy_generate
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.models import apply_lm, init_lm, lm_loss
from repro_torch.models import moe as moe_mod
from repro_torch.models.blocks import stack_plan
from repro_torch.models.convert import params_from_jax
from repro_torch.models.linear import expert_fused_hidden, expert_linear
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.moe import _capacity, apply_moe, init_moe
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving.engine import BucketPolicy, Engine, synthetic_requests
from repro_torch.serving.serve_step import greedy_generate

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
LLAMA4, DEEPSEEK = "llama4-maverick-400b-a17b", "deepseek-v3-671b"
ARCHS = [LLAMA4, DEEPSEEK]


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _walk(tree, prefix="", sort=True):
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from _walk(tree[k], f"{prefix}{k}/", sort)
    else:
        yield prefix[:-1], tree


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(jax cfg, jax params, port cfg, port params) of one MoE smoke model."""
    jcfg = jax_get_smoke_config(request.param)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(request.param)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _layer(arch, impl="jnp", **kw):
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), linear_impl=impl, **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), linear_impl=impl, **kw)
    jp = jax_init_moe(jax.random.PRNGKey(1), jcfg)
    return jcfg, jp, cfg, _tree_t(jp)


# --- the MoE layer ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["jnp", "fused"])
@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_apply_moe_matches_jax(arch, impl, capacity_factor, monkeypatch):
    """y and the aux loss; at capacity factor 0.25 entries drop and the last
    expert's window is full, so its last slot (JAX's trash row e*cap-1) is
    a real slot that the dropped entries must not overwrite."""
    kw = {} if capacity_factor is None else {"moe_capacity_factor": capacity_factor}
    jcfg, jp, cfg, p = _layer(arch, impl, **kw)
    x = _np(np.random.default_rng(0), (2, 64, cfg.d_model))
    jy, jaux = jax_apply_moe(jp, jnp.asarray(x), jcfg)
    routed, real_route = [], moe_mod.route

    def route(*args):
        out = real_route(*args)
        routed.append(out[2])
        return out
    monkeypatch.setattr(moe_mod, "route", route)
    y, aux = apply_moe(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    (idx,) = routed
    cap = _capacity(128, cfg)
    per_expert = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    if capacity_factor is not None:
        assert int((per_expert - cap).clamp_min(0).sum()) > 0 and int(per_expert[-1]) >= cap


@pytest.mark.parametrize("impl", ["jnp", "pallas", "tuned"])
def test_expert_linear_matches_jax(impl):
    rng = np.random.default_rng(2)
    x, w = _np(rng, (4, 16, 24)), _np(rng, (4, 24, 40), 24 ** -0.5)
    want = np.asarray(jax_expert_linear(jnp.asarray(x), jnp.asarray(w), impl=impl))
    np.testing.assert_allclose(expert_linear(_t(x), _t(w), impl=impl).numpy(), want, **TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_expert_fused_hidden_matches_jax(mlp_type):
    rng = np.random.default_rng(3)
    x = _np(rng, (3, 16, 32))
    wg, wu = _np(rng, (3, 32, 48), 32 ** -0.5), _np(rng, (3, 32, 48), 32 ** -0.5)
    want = np.asarray(jax_expert_fused_hidden(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                                              mlp_type=mlp_type))
    got = expert_fused_hidden(_t(x), _t(wg), _t(wu), mlp_type=mlp_type)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_expert_paths_refuse_what_is_not_ported():
    """relu2 is refused, as in JAX; the quantized expert path is ported and
    bit-identical to JAX's under `jax.jit`; shard_map dispatch is ported
    (tests/test_torch_parallel_moe.py) and without a sharding plan is the
    "auto" dispatch, as JAX's falls back without a mesh."""
    rng = np.random.default_rng(9)
    xq, wq = _np(rng, (2, 8, 16)), _np(rng, (2, 16, 8), 0.25)
    want = np.asarray(jax.jit(lambda x, w: jax_expert_linear(x, w, impl="quantized"))(
        jnp.asarray(xq), jnp.asarray(wq)))
    np.testing.assert_array_equal(expert_linear(_t(xq), _t(wq), impl="quantized").numpy(), want)
    x, w = torch.zeros(2, 8, 16), torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="mlp_type"):
        expert_fused_hidden(x, None, w, mlp_type="relu2")
    cfg = dataclasses.replace(get_smoke_config(LLAMA4), moe_dispatch="shard_map")
    p = init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    got, aux = apply_moe(p, x, cfg)
    want, want_aux = apply_moe(p, x, dataclasses.replace(cfg, moe_dispatch="auto"))
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


# --- the properties of tests/test_moe.py, on the port --------------------------------

def _moe_cfg(**kw):
    base = dict(name="m", family="moe", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
                d_ff=64, vocab_size=128, mlp_type="swiglu", num_experts=4, top_k=2,
                moe_d_ff=48, moe_capacity_factor=8.0, dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


def _moe_params(cfg, seed=5):
    return init_moe(torch.Generator().manual_seed(seed), cfg)


def test_identical_experts_equal_single_mlp():
    """With every expert's weights identical and no drops, MoE(x) == MLP(x)
    (the gates renormalize to 1)."""
    cfg = _moe_cfg()
    p = _moe_params(cfg)
    for k in ("w_up", "w_gate", "w_down"):
        p[k] = p[k][:1].expand_as(p[k]).contiguous()
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(0)) * 0.5
    y, _ = apply_moe(p, x, cfg)
    dense = dataclasses.replace(cfg, d_ff=cfg.moe_d_ff)
    want = apply_mlp({k: p[k][0] for k in ("w_gate", "w_up", "w_down")},
                     x.reshape(-1, cfg.d_model), dense)
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), want, atol=1e-4, rtol=1e-4)


def test_aux_loss_bounds():
    """The load-balance loss is >= 1 (perfectly balanced) and finite."""
    cfg = _moe_cfg()
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    _, aux = apply_moe(_moe_params(cfg), x, cfg)
    assert torch.isfinite(aux) and aux.item() >= 0.99  # E sum(f_i P_i) >= 1


def test_capacity_drops_are_bounded():
    """With a tiny capacity the output is still finite and shaped."""
    cfg = _moe_cfg(moe_capacity_factor=0.25)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(2))
    y, _ = apply_moe(_moe_params(cfg), x, cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()


@pytest.mark.parametrize("tokens", [1, 7, 64, 1000, 1024, 4096])
def test_capacity_alignment(tokens):
    """The capacity rounds up to a multiple of 8, at least 8 (JAX's rule)."""
    from repro.models.moe import _capacity as jax_capacity
    cfg = _moe_cfg()
    assert _capacity(tokens, cfg) % 8 == 0 and _capacity(tokens, cfg) >= 8
    assert _capacity(tokens, cfg) == jax_capacity(tokens, cfg)


def test_grad_flows_through_dispatch():
    cfg = _moe_cfg()
    p = _moe_params(cfg)
    for v in tree_leaves(p):
        v.requires_grad_(True)
    x = torch.randn(1, 32, cfg.d_model, generator=torch.Generator().manual_seed(3)) * 0.5
    y, aux = apply_moe(p, x, cfg)
    grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux, list(tree_leaves(p)))
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(g.abs().sum().item() for g in grads) > 0
    router = dict(zip([k for k, _ in _walk(p, sort=False)], grads))["router"]
    assert router.abs().sum().item() > 0    # through the gate weights


# --- whole models --------------------------------------------------------------------

def test_params_from_jax_converts_moe_trees(smoke):
    """Every leaf converts with its JAX shape, nothing is left over
    (params_from_jax raises on a leftover): the stacked expert stacks
    (L, E, h, f), the router, the shared expert, the MTP tree."""
    jcfg, jparams, cfg, params = smoke
    want = dict(_walk(jax.tree.map(np.asarray, jparams)))
    got = dict(_walk(params))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
    kinds = [k for k, _ in stack_plan(cfg)]
    moe = params[f"seg{kinds.index('moe')}"]["moe"] if "moe" in kinds \
        else params["seg0"]["moe_blk"]["moe"]
    L = moe["w_up"].shape[0]
    e, h, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert moe["w_up"].shape == moe["w_gate"].shape == (L, e, h, f)
    assert moe["w_down"].shape == (L, e, f, h) and moe["router"].shape == (L, h, e)
    assert moe["shared"]["w_up"].shape == (L, h, f * cfg.num_shared_experts)
    if cfg.mtp_depth:
        assert set(params["mtp"]) == {"proj", "block", "norm"}
        assert params["mtp"]["proj"].shape == (2 * h, h)
        assert params["mtp"]["block"]["attn"]["wkv_down"].dim() == 2   # not stacked
    # the port's own init has the same tree
    mine = init_lm(None, cfg, device="meta")
    assert {p: tuple(t.shape) for p, t in _walk(mine)} == \
        {p: tuple(t.shape) for p, t in got.items()}


@pytest.mark.parametrize("impl", ["jnp", "fused"])
def test_apply_lm_logits_match_jax(smoke, impl):
    """Logits and the aux loss; the JAX side runs jnp (its interpret-mode
    kernels agree with it: test_apply_moe_matches_jax)."""
    jcfg, jparams, cfg, params = smoke
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _, jaux = jax_apply_lm(jparams, jnp.asarray(toks), jcfg)
    got, _, aux = apply_lm(params, _t(toks).long(), dataclasses.replace(cfg, linear_impl=impl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    assert aux.item() > 0.5 * sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))


def test_lm_loss_metrics_and_gradients_match_jax(smoke):
    """loss, lm_loss, aux_loss and (deepseek) mtp_loss, and every gradient
    leaf, on the plain path (jnp, naive), f32 masters."""
    jcfg, jparams, cfg, _ = smoke
    np_batch = jax_make_batch(jcfg, JaxShapeConfig("t", 16, 2, "train"), 0, 0)
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, jbatch, jcfg), has_aux=True)(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", dtype=torch.float32)
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm_loss(params, {k: torch.from_numpy(v) for k, v in np_batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    keys = {"loss", "lm_loss", "aux_loss"} | ({"mtp_loss"} if cfg.mtp_depth else set())
    assert set(metrics) == set(jm) == keys
    for k in keys:
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), **GRAD_TOL, err_msg=k)
    want = dict(_walk(jax.tree.map(np.asarray, jgrads)))
    paths = [path for path, _ in _walk(params, sort=False)]
    assert set(paths) == set(want)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[path], **GRAD_TOL, err_msg=path)


def test_greedy_tokens_match_jax(smoke):
    """Prefill + decode through serve_step (deepseek: MLA's latent cache;
    llama4: the pair's two GQA caches)."""
    jcfg, jparams, cfg, params = smoke
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(jax_greedy_generate(jparams, jcfg, jnp.asarray(prompt), 6))
    got = greedy_generate(params, dataclasses.replace(cfg, linear_impl="fused"),
                          _t(prompt).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


# --- the engines (llama4: GQA, `pair` caches) -------------------------------------------

POLICY = dict(num_slots=4, prompt_buckets=(16, 32), seq_max=64)


@pytest.fixture(scope="module")
def llama4():
    jcfg = jax_get_smoke_config(LLAMA4)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(LLAMA4)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_llama4_engines_match_jax(llama4, prefix_cache):
    """Greedy tokens of the slot engine (paged decode) and of the prefix
    engine (block-table pool, shared prompt prefixes), each against the
    JAX engine on the same policy, requests and weights.  (MoE capacity
    depends on the whole batch, so each engine is compared with its JAX
    counterpart, not with the other.)"""
    jcfg, jparams, cfg, params = llama4
    reqs = synthetic_requests(8, pattern="burst", min_prompt=10, max_prompt=30, min_new=3,
                              max_new=8, vocab=cfg.vocab_size, prefix_share=0.75,
                              shared_prefix_len=16, seed=6)
    kw = dict(prefix_cache=True, block_size=8) if prefix_cache else {}
    jdone, _ = JaxEngine(jparams, jcfg, policy=JaxBucketPolicy(**POLICY), hw=JAX_H100,
                         **kw).run(reqs)
    eng = Engine(params, dataclasses.replace(cfg, linear_impl="fused"),
                 policy=BucketPolicy(**POLICY), hw=H100_SXM, use_paged_kernel=True,
                 device="cpu", **kw)
    assert [k for k, _ in stack_plan(cfg)] == ["pair"]
    assert set(eng.pool.caches[0]) == {"moe_blk", "dense_blk"}
    done, stats = eng.run(reqs)
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert all(c.finish_reason == "length" for c in done)
    if prefix_cache:
        assert stats.cached_tokens > 0
        eng.pool.blocks.check()
