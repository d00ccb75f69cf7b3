"""The MoE family's training path and int8 expert path in the port, against
the JAX package.

`expert_linear` (impl "pallas", "tuned", "quantized") and
`expert_fused_hidden` (swiglu, gelu) under autograd run the port's
Functions (`_ExpertLinear`, `_QuantizedExpertLinear`, `_FusedHiddenExpert`),
whose backwards call the batched kernels' wrappers: on CPU tensors their
plain versions.  Their gradients are held to `jax.grad` of the same JAX
function (one Pallas kernel per expert under `lax.map`, interpret mode);
the quantized forward is bit-identical to JAX's under `jax.jit` (both sum
the int8 products exactly and take the same f32 de-scale).  Then `lm_loss`,
its metrics and every gradient leaf of both MoE smoke configs at
linear_impl "fused" and "quantized" (f32 masters), built once per config
in a module-scoped fixture: JAX's whole-model gradients at the kernel
impls take 6-29 s each here.

Tolerances: the JAX training suite's `atol=2e-4, rtol=2e-3` (GRAD_TOL) for
every gradient and the loss, both sides in f32 with sums in another order;
exact for the quantized expert forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.models.linear import expert_fused_hidden as jax_expert_fused_hidden
from repro.models.linear import expert_linear as jax_expert_linear
from repro_torch import obs
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.fused_mlp import ops as fused_ops
from repro_torch.kernels.fused_mlp.backward import fused_mlp_bwd_expert_ref, fused_mlp_bwd_ref
from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.kernels.matmul.ref import matmul_expert_ref
from repro_torch.kernels.quantized.ops import int8_matmul_expert, int8_matmul_expert_q
from repro_torch.kernels.quantized.ref import int8_matmul_ref
from repro_torch.models import linear as linear_mod
from repro_torch.models import lm_loss
from repro_torch.models.convert import params_from_jax
from repro_torch.models.linear import expert_fused_hidden, expert_linear
from repro_torch.optim.adamw import tree_leaves
from repro_torch.quant import quantize_int8, quantize_weight

GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
LLAMA4, DEEPSEEK = "llama4-maverick-400b-a17b", "deepseek-v3-671b"


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _walk(tree, prefix="", sort=True):
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from _walk(tree[k], f"{prefix}{k}/", sort)
    else:
        yield prefix[:-1], tree


# --- the expert functions ------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "tuned", "quantized"])
def test_expert_linear_grads_match_jax(impl):
    """Forward and both gradients against `jax.grad` of JAX's expert_linear
    at the same impl (quantized: straight-through, the float dgrad and
    wgrad per expert); the quantized forward bit-identical."""
    rng = np.random.default_rng(20)
    x, w, ct = _np(rng, (4, 16, 48)), _np(rng, (4, 48, 40), 48 ** -0.5), _np(rng, (4, 16, 40))

    def jfwd(x, w):
        return jax_expert_linear(x, w, impl=impl)

    jy = np.asarray(jax.jit(jfwd)(jnp.asarray(x), jnp.asarray(w)))
    jdx, jdw = jax.jit(jax.grad(lambda x, w: jnp.sum(jfwd(x, w) * ct), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = expert_linear(tx, tw, impl=impl)
    if impl == "quantized":
        np.testing.assert_array_equal(y.detach().numpy(), jy)
    else:
        np.testing.assert_allclose(y.detach().numpy(), jy, **GRAD_TOL)
    (y * _t(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **GRAD_TOL)
    with torch.no_grad():                       # serving: the wrapper directly
        assert torch.equal(expert_linear(_t(x), _t(w), impl=impl), y.detach())


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_expert_fused_hidden_grads_match_jax(mlp_type):
    rng = np.random.default_rng(21)
    x, ct = _np(rng, (3, 16, 32)), _np(rng, (3, 16, 48))
    wg, wu = _np(rng, (3, 32, 48), 32 ** -0.5), _np(rng, (3, 32, 48), 32 ** -0.5)
    gated = mlp_type == "swiglu"

    def jloss(x, wg, wu):
        return jnp.sum(jax_expert_fused_hidden(x, wg if gated else None, wu,
                                               mlp_type=mlp_type) * ct)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    tx, twg, twu = (_t(a).requires_grad_() for a in (x, wg, wu))
    (expert_fused_hidden(tx, twg if gated else None, twu, mlp_type=mlp_type) * _t(ct)).sum() \
        .backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[0]), **GRAD_TOL)
    np.testing.assert_allclose(twu.grad.numpy(), np.asarray(jgrads[2]), **GRAD_TOL)
    if gated:
        np.testing.assert_allclose(twg.grad.numpy(), np.asarray(jgrads[1]), **GRAD_TOL)
    else:
        assert twg.grad is None


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def f(*args, **kw):
        calls.append((name, args))
        return real(*args, **kw)
    monkeypatch.setattr(module, name, f)


def _layout(t):
    return "t" if matmul_ops.expert_transposed("test", t) else "n"


@pytest.mark.parametrize("impl", ["fused", "quantized"])
def test_expert_backwards_call_the_batched_wrappers(impl, monkeypatch):
    """Under autograd the Functions' backwards call `matmul_expert` on
    `.mT` views, nt (the dgrad) and tn (the wgrad), once each, and
    `fused_mlp_bwd_expert` once (on a CUDA tensor it launches the nt pair
    and two tn products: tests/test_torch_cuda.py); without a recorded
    gradient neither runs."""
    calls = []
    _spy(monkeypatch, linear_mod, "matmul_expert", calls)
    _spy(monkeypatch, linear_mod, "fused_mlp_bwd_expert", calls)
    rng = np.random.default_rng(22)
    x = _t(_np(rng, (2, 8, 16))).requires_grad_()
    w = _t(_np(rng, (2, 16, 24), 0.25)).requires_grad_()
    y = expert_linear(x, w, impl=impl)
    forward = list(calls)
    y.sum().backward()
    got = [(n, _layout(a[0]) + _layout(a[1]), len(a)) for n, a in calls[len(forward):]]
    assert sorted(got) == [("matmul_expert", "nt", 2), ("matmul_expert", "tn", 2)]
    calls.clear()
    wg, wu = (_t(_np(rng, (2, 16, 24), 0.25)).requires_grad_() for _ in range(2))
    expert_fused_hidden(x, wg, wu, mlp_type="swiglu").sum().backward()
    assert [(n, len(a)) for n, a in calls] == [("fused_mlp_bwd_expert", 4)]
    calls.clear()
    with torch.no_grad():
        expert_linear(x, w, impl=impl)
        expert_fused_hidden(x, wg, wu, mlp_type="swiglu")
    assert [n for n, _ in calls] == ([] if impl == "quantized" else ["matmul_expert"])


# --- the plain versions the card is held against ---------------------------------------

@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_fused_mlp_bwd_expert_plain_version(mlp_type):
    """Per expert, the 2-D plain backward; that equals autograd of the plain
    forward; `fused_mlp_bwd_expert` on CPU tensors is it."""
    rng = np.random.default_rng(23)
    x, dh = _t(_np(rng, (3, 8, 16))), _t(_np(rng, (3, 8, 20)))
    wg, wu = _t(_np(rng, (3, 16, 20), 0.25)), _t(_np(rng, (3, 16, 20), 0.25))
    wg = wg if mlp_type == "swiglu" else None
    dx, dwg, dwu = fused_ops.fused_mlp_bwd_expert(x, wg, wu, dh, mlp_type=mlp_type)
    for z in range(3):
        want = fused_mlp_bwd_ref(x[z], None if wg is None else wg[z], wu[z], dh[z], mlp_type)
        torch.testing.assert_close(dx[z], want[0], rtol=0, atol=0)
        torch.testing.assert_close(dwu[z], want[2], rtol=0, atol=0)
        if wg is not None:
            torch.testing.assert_close(dwg[z], want[1], rtol=0, atol=0)
    ins = [t.clone().requires_grad_() for t in (x, wg, wu) if t is not None]
    out = fused_mlp_hidden_ref(ins[0], ins[1] if wg is not None else None, ins[-1], mlp_type)
    grads = torch.autograd.grad(out, ins, dh)
    torch.testing.assert_close(dx, grads[0], **dict(atol=1e-5, rtol=1e-5))
    torch.testing.assert_close(dwu, grads[-1], **dict(atol=1e-5, rtol=1e-5))
    assert fused_mlp_bwd_expert_ref(x, wg, wu, dh, mlp_type)[0].equal(dx)


def test_matmul_expert_plain_version_takes_views_and_pairs():
    rng = np.random.default_rng(24)
    g, w, x = (_t(_np(rng, s)) for s in ((2, 8, 12), (2, 10, 12), (2, 8, 10)))
    g1, w1 = _t(_np(rng, (2, 8, 12))), _t(_np(rng, (2, 10, 12)))
    torch.testing.assert_close(matmul_ops.matmul_expert(g, w.mT, g1, w1.mT),
                               g @ w.mT + g1 @ w1.mT)
    torch.testing.assert_close(matmul_ops.matmul_expert(x.mT, g), x.mT @ g)
    torch.testing.assert_close(matmul_expert_ref(x.mT, g), x.mT @ g)
    with pytest.raises(ValueError, match="3-D"):
        matmul_ops.expert_transposed("t", x[0])
    with pytest.raises(ValueError, match=r"\.mT views"):
        matmul_ops.expert_transposed("t", x.transpose(0, 1))


def test_int8_matmul_expert_is_the_2d_path_per_expert(monkeypatch):
    """Per-row activation and per-expert, per-channel weight quantization,
    then per expert the 2-D plain int8 GEMM: bit-identical; a stack
    quantized a slice of experts at a time gives the same payload and
    scales as the whole stack at once."""
    from repro_torch.kernels.quantized import ops
    rng = np.random.default_rng(25)
    x, w = _t(_np(rng, (3, 8, 64))), _t(_np(rng, (3, 64, 40), 0.125))
    got = int8_matmul_expert(x, w)
    wq = quantize_weight(w)
    assert wq.q.mT.is_contiguous() and wq.scale.shape == (3, 1, 40)
    for z in range(3):
        a_q, a_s = quantize_int8(x[z], axis=-1)
        w_q = quantize_weight(w[z])
        assert torch.equal(got[z], int8_matmul_ref(a_q, a_s, w_q.q, w_q.scale, x.dtype))
    a_q, a_s = quantize_int8(x, axis=-1)
    assert torch.equal(int8_matmul_expert_q(a_q, a_s, wq.q, wq.scale, x.dtype), got)
    assert torch.equal(int8_matmul_expert(x, wq), got)
    monkeypatch.setattr(ops, "EXPERT_QUANT_ELEMS", 64 * 40 * 2)     # two experts a slice
    sliced = ops.quantize_experts(w)
    assert torch.equal(sliced.q, wq.q) and torch.equal(sliced.scale, wq.scale)
    assert sliced.q.mT.is_contiguous()
    assert torch.equal(int8_matmul_expert(x, w), got)


def test_expert_backward_dispatch_rows():
    """With observability on, one backward pass through the expert Functions
    records the batched backward's dispatch rows (plain on the CPU)."""
    obs.enable(annotate_device=False)
    try:
        rng = np.random.default_rng(26)
        x = _t(_np(rng, (2, 8, 16))).requires_grad_()
        wg, wu = (_t(_np(rng, (2, 16, 24), 0.25)).requires_grad_() for _ in range(2))
        w = _t(_np(rng, (2, 16, 24), 0.25)).requires_grad_()
        (expert_fused_hidden(x, wg, wu, mlp_type="swiglu").sum()
         + expert_linear(x, w, impl="quantized").sum()).backward()
        rows = {(e["name"], e["args"]["impl"], e["args"]["site"], tuple(e["args"]["shape"]))
                for e in obs.get_tracer().events() if e.get("cat") == "dispatch"}
    finally:
        obs.disable()
        obs.reset()
    assert ("fused_mlp_bwd_expert", "plain", "swiglu", (2, 8, 16, 24)) in rows
    assert ("int8_matmul", "plain", "expert", (2, 8, 16, 24)) in rows
    assert ("matmul_expert", "plain", "", (2, 8, 24, 16)) in rows     # the dgrads
    assert ("matmul_expert", "plain", "", (2, 16, 8, 24)) in rows     # the wgrads


# --- whole models: lm_loss and every gradient leaf ------------------------------------

@pytest.fixture(scope="module", params=[(a, i) for a in (LLAMA4, DEEPSEEK)
                                        for i in ("fused", "quantized")],
                ids=lambda p: f"{p[0].split('-')[0]}-{p[1]}")
def model_ref(request):
    """JAX's lm_loss, metrics and gradients of one MoE smoke config at one
    kernel impl (f32 masters), and the port's params and batch."""
    arch, impl = request.param
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), linear_impl=impl)
    cfg = dataclasses.replace(get_smoke_config(arch), linear_impl=impl)
    jparams = jax_init_lm(jax.random.PRNGKey(3), jcfg)
    np_batch = jax_make_batch(jcfg, JaxShapeConfig("t", 16, 2, "train"), 0, 0)
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jbatch, jcfg), has_aux=True))(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", dtype=torch.float32)
    return dict(cfg=cfg, params=params, batch={k: torch.from_numpy(v) for k, v in np_batch.items()},
                metrics={k: float(v) for k, v in jm.items()},
                grads=dict(_walk(jax.tree.map(np.asarray, jgrads))))


def test_lm_loss_and_every_gradient_match_jax(model_ref, monkeypatch):
    """loss, lm_loss, aux_loss (and deepseek's mtp_loss), and every
    gradient leaf, with the expert stacks through the Functions (counted)."""
    cfg, params = model_ref["cfg"], model_ref["params"]
    taken = []
    reals = {cls: cls.apply for cls in (linear_mod._ExpertLinear,
                                        linear_mod._QuantizedExpertLinear,
                                        linear_mod._FusedHiddenExpert)}
    for cls, real in reals.items():
        monkeypatch.setattr(cls, "apply", (lambda real, name: lambda *a: (
            taken.append(name), real(*a))[1])(real, cls.__name__))
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm_loss(params, model_ref["batch"], cfg)
    grads = torch.autograd.grad(loss, leaves)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    want_taken = ({"fused": ["_FusedHiddenExpert", "_ExpertLinear"],
                   "quantized": ["_QuantizedExpertLinear"] * (3 if cfg.mlp_type == "swiglu" else 2)
                   }[cfg.linear_impl]) * n_moe
    assert sorted(taken) == sorted(want_taken)
    assert set(metrics) == set(model_ref["metrics"])
    for k, v in model_ref["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), v, **GRAD_TOL, err_msg=k)
    want = model_ref["grads"]
    paths = [path for path, _ in _walk(params, sort=False)]
    assert set(paths) == set(want)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[path], **GRAD_TOL, err_msg=path)


def test_adamw_slices_give_the_same_bits(monkeypatch):
    """The float32 AdamW update runs a slice of a leaf at a time (its
    temporaries bounded beside a full-width MoE's state): elementwise, so
    any slice size gives the same parameters and moments."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(37, 53, generator=gen), "b": {"c": torch.randn(300, generator=gen)}}
    grads = {"a": torch.randn(37, 53, generator=gen), "b": {"c": torch.randn(300, generator=gen)}}
    tc = TrainConfig(total_steps=4, warmup_steps=1)
    runs = []
    for chunk in (adamw.UPDATE_CHUNK, 64):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        p = adamw.tree_map(torch.clone, params)
        opt = adamw.init_opt(p, tc)
        for _ in range(2):
            p, opt, _ = adamw.apply_updates(p, grads, opt, tc)
        runs.append([*tree_leaves(p), *tree_leaves(opt.m), *tree_leaves(opt.v)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not torch.equal(runs[0][0], params["a"])
