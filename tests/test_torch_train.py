"""The port's training path vs the JAX package's, on internlm2-smoke (f32).

Params are made by the JAX package and converted with
`params_from_jax(..., dtype=torch.float32)` (float32 masters, as training
holds them); batches come from the numpy data pipeline, identical in both.
The JAX references are computed once per module.  Tolerances: the JAX
suite's own `atol=2e-4, rtol=2e-3` (tests/test_flash_backward.py:155) for
the loss and every gradient leaf; 1e-5 (abs and rel) for one optimizer
update on identical inputs (float32, the same arithmetic leaf by leaf).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import lm_loss
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.train_step import make_train_step

ARCH = "internlm2-1.8b"
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
IMPLS = [("jnp", "naive"), ("fused", "flash")]
SEQ, BATCH = 24, 2   # seq not a multiple of the 128 blocks: the JAX kernels pad, the port masks


def _walk(tree, prefix="", sort=True):
    """(path, leaf) pairs: in sorted key order (JAX's flattening), or in
    insertion order (the port's) with sort=False."""
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from _walk(tree[k], f"{prefix}{k}/", sort)
    else:
        yield prefix[:-1], tree


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """JAX params, the port's f32 masters, one batch, and per impl pair the
    JAX loss and gradients (numpy, by leaf path)."""
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    np_batch = make_batch(cfg, ShapeConfig("t", SEQ, BATCH, "train"), 0, 0)
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    out = {}
    for li, ai in IMPLS:
        c = dataclasses.replace(jcfg, linear_impl=li, attn_impl=ai)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, c=c: jax_lm_loss(p, jbatch, c), has_aux=True))(jparams)
        out[(li, ai)] = (float(loss), dict(_walk(_np_tree(grads))))
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, np_batch=np_batch, jbatch=jbatch,
                grads=out)


def _port_params(ref):
    return params_from_jax(_np_tree(ref["jparams"]), ref["cfg"], "cpu", dtype=torch.float32)


def _port_batch(ref):
    return {k: torch.from_numpy(v) for k, v in ref["np_batch"].items()}


def _port_grads(params, batch, cfg, remat="none"):
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm_loss(params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    paths = [path for path, _ in _walk(params, sort=False)]
    return loss.item(), {p: g.numpy() for p, g in zip(paths, grads)}, metrics


def test_params_from_jax_keeps_f32_masters(ref):
    """Training parity rests on the bridge: with dtype=float32 every leaf
    arrives as the JAX master itself, bit for bit, in memory of its own (an
    in-place update must not write the JAX buffer)."""
    params = _port_params(ref)
    want = dict(_walk(_np_tree(ref["jparams"])))
    got = dict(_walk(params))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
        assert not np.shares_memory(t.numpy(), want[path]), path


def test_make_batch_identical(ref):
    for step, seed in ((0, 0), (3, 1234)):
        shape = ShapeConfig("t", 40, 6, "train")
        got = make_batch(ref["cfg"], shape, step, seed, process_index=1, process_count=2)
        want = jax_make_batch(ref["jcfg"], JaxShapeConfig("t", 40, 6, "train"), step, seed,
                              process_index=1, process_count=2)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("linear_impl,attn_impl", IMPLS)
def test_lm_loss_and_grads_match_jax(ref, linear_impl, attn_impl):
    """Loss and every leaf's gradient; (fused, flash) runs the port's kernel
    wrappers on CPU tensors (their plain versions) through the
    autograd.Functions, against JAX's Pallas kernels in interpret mode."""
    cfg = dataclasses.replace(ref["cfg"], linear_impl=linear_impl, attn_impl=attn_impl)
    loss, grads, metrics = _port_grads(_port_params(ref), _port_batch(ref), cfg)
    want_loss, want = ref["grads"][(linear_impl, attn_impl)]
    np.testing.assert_allclose(loss, want_loss, **GRAD_TOL)
    assert metrics["lm_loss"].item() == loss
    assert grads.keys() == want.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g, want[path], err_msg=path, **GRAD_TOL)


def test_kernel_path_grads_equal_plain_path(ref):
    """On the CPU the kernel wrappers run their plain versions, so the
    (fused, flash) path's gradients match the (jnp, naive) path's to f32
    rounding: the autograd.Functions compute the same derivatives."""
    base = ref["cfg"]
    _, gk, _ = _port_grads(_port_params(ref), _port_batch(ref),
                           dataclasses.replace(base, linear_impl="fused", attn_impl="flash"))
    _, gp, _ = _port_grads(_port_params(ref), _port_batch(ref), base)
    for path in gp:
        np.testing.assert_allclose(gk[path], gp[path], atol=2e-5, rtol=2e-4, err_msg=path)


@pytest.mark.parametrize("linear_impl,attn_impl", IMPLS)
def test_remat_full_equals_none(ref, linear_impl, attn_impl):
    """Recomputing each layer in the backward changes no number."""
    cfg = dataclasses.replace(ref["cfg"], linear_impl=linear_impl, attn_impl=attn_impl)
    l0, g0, _ = _port_grads(_port_params(ref), _port_batch(ref), cfg, remat="none")
    l1, g1, _ = _port_grads(_port_params(ref), _port_batch(ref), cfg, remat="full")
    assert l0 == l1
    for path in g0:
        np.testing.assert_array_equal(g0[path], g1[path], err_msg=path)


def test_remat_dots_raises(ref):
    with pytest.raises(NotImplementedError, match="remat-policy"):
        lm_loss(_port_params(ref), _port_batch(ref), ref["cfg"], remat="dots")


# --- optimizer ---------------------------------------------------------------------------

def _tc(optimizer):
    kw = dict(total_steps=10, warmup_steps=3, learning_rate=1e-2, optimizer=optimizer)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_apply_updates_matches_jax(ref, optimizer):
    """Two updates from the same numpy params and gradients (the JAX smoke
    model's gradient, scaled so the clip engages on the first step)."""
    jtc, tc = _tc(optimizer)
    _, grads_np = ref["grads"][("jnp", "naive")]
    jparams = ref["jparams"]
    jgrads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [jnp.asarray(grads_np[p]) for p, _ in _walk(_np_tree(jparams))])
    params = _port_params(ref)
    jopt, opt = jax_adamw.init_opt(jparams, jtc), adamw.init_opt(params, tc)
    for scale in (50.0, 0.5):
        jparams, jopt, jm = jax_adamw.apply_updates(
            jparams, jax.tree.map(lambda g: g * scale, jgrads), jopt, jtc)
        grads = {p: torch.from_numpy(grads_np[p] * np.float32(scale)) for p in grads_np}
        tgrads = adamw.tree_map(lambda _, path: grads[path], params,
                                _paths_tree(params))
        params, opt, m = adamw.apply_updates(params, tgrads, opt, tc)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
    assert int(opt.step) == int(jopt.step) == 2
    want = dict(_walk(_np_tree(jparams)))
    for path, t in _walk(params):
        bad = ~np.isclose(t.numpy(), want[path], atol=1e-5, rtol=1e-5)
        # adamw8bit: where a moment's f32 value differs in its last bit, its
        # int8 code may round one step apart, and that element's second
        # update moves with it; such elements may make up 0.1% of a leaf
        limit = 0 if optimizer == "adamw" else max(1, int(1e-3 * bad.size))
        assert bad.sum() <= limit, (path, int(bad.sum()))
    deq = (lambda q: adamw.dequantize_i8(q).numpy()) if optimizer == "adamw8bit" \
        else (lambda t: t.numpy())
    jdeq = (lambda q: np.asarray(jax_adamw.dequantize_i8(q))) if optimizer == "adamw8bit" \
        else np.asarray
    is_q = adamw._is_quant
    for got_tree, want_tree in ((opt.m, jopt.m), (opt.v, jopt.v)):
        got = list(tree_leaves(got_tree, is_q))
        want_l = jax.tree_util.tree_flatten(want_tree, is_leaf=jax_adamw._QUANT_LEAF)[0]
        # JAX flattens dicts in sorted-key order, the port in insertion order
        order = [p for p, _ in _walk(params, sort=False)]
        sorted_paths = [p for p, _ in _walk(params)]
        got_by_path = dict(zip(order, got))
        for path, w in zip(sorted_paths, want_l):
            g = got_by_path[path]
            # 8-bit codes may round one step apart where f32 sums differ in
            # the last bit: one code step is absmax/127 of the row
            tol = 1e-5 if optimizer == "adamw" else 1.01 * np.abs(jdeq(w)).max() / 127 + 1e-12
            np.testing.assert_allclose(deq(g), jdeq(w), atol=tol, rtol=1e-5, err_msg=path)


def _paths_tree(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _paths_tree(v, f"{prefix}{k}/") for k, v in tree.items()}
    return prefix[:-1]


def test_quantize_i8_matches_jax():
    rng = np.random.default_rng(0)
    for shape in [(), (7,), (3, 130), (2, 4, 33)]:
        x = np.asarray(rng.standard_normal(shape) * 3, dtype=np.float32)
        got = adamw.quantize_i8(torch.from_numpy(x))
        want = jax_adamw.quantize_i8(jnp.asarray(x))
        np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
        np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=1e-7)
        np.testing.assert_allclose(adamw.dequantize_i8(got, shape).numpy(),
                                   np.asarray(jax_adamw.dequantize_i8(want, shape)), rtol=1e-7)


def test_lr_schedule_and_clip_match_jax():
    jtc, tc = _tc("adamw")
    jlr, lr = jax_adamw.lr_schedule(jtc), adamw.lr_schedule(tc)
    for step in (0, 1, 2, 3, 5, 9, 10, 12):
        np.testing.assert_allclose(lr(torch.tensor(step, dtype=torch.int32)).item(),
                                   float(jlr(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        jg, jn = jax_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        g, n = adamw.clip_by_global_norm(adamw.tree_map(torch.from_numpy, tree), max_norm)
        np.testing.assert_allclose(n.item(), float(jn), rtol=1e-6)
        np.testing.assert_allclose(g["b"]["c"].numpy(), np.asarray(jg["b"]["c"]), rtol=1e-6)


# --- the train step ----------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_trajectory_matches_jax(ref, n_micro):
    """Three steps of make_train_step on the kernel path (fused, flash):
    loss and grad-norm per step within 1e-4 relative.  Both sides run f32
    and differ only in summation order (~1e-6 relative per GEMM); AdamW
    bounds each update by lr, so three steps carry that to ~1e-5 in the
    loss."""
    jtc = JaxTrainConfig(total_steps=3, warmup_steps=1, remat="none")
    tc = TrainConfig(total_steps=3, warmup_steps=1, remat="none")
    jcfg = dataclasses.replace(ref["jcfg"], linear_impl="fused", attn_impl="flash")
    cfg = dataclasses.replace(ref["cfg"], linear_impl="fused", attn_impl="flash")
    jstep = jax.jit(jax_make_train_step(jcfg, jtc, n_micro=n_micro))
    step = make_train_step(cfg, tc, n_micro=n_micro)
    jparams, params = ref["jparams"], _port_params(ref)
    jopt, opt = jax_adamw.init_opt(jparams, jtc), adamw.init_opt(params, tc)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    for s in range(3):
        b = make_batch(cfg, shape, s, 0)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {s} {key}")


@pytest.mark.parametrize("argv", [
    ["--attn-impl", "flash", "--linear-impl", "fused", "--microbatch", "1"],
    ["--optimizer", "adamw8bit", "--remat", "full"]])
def test_train_launcher_runs_on_cpu_when_asked(argv, capsys):
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                "--global-batch", "2", "--seq-len", "16", "--log-every", "1", *argv])
    out = capsys.readouterr().out
    assert "step     1" in out and out.rstrip().endswith("done")


def test_functions_only_when_a_gradient_is_recorded(ref, monkeypatch):
    """The serve path (no_grad, or leaves without grad) calls the kernel
    wrappers directly and never pays an autograd.Function."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_mlp import ops as fused_ops
    from repro_torch.models import linear as linear_mod

    def refuse(*a):
        raise AssertionError("autograd.Function taken")
    for fn in (linear_mod._Linear, fused_ops._FusedHidden, flash_ops._Flash):
        monkeypatch.setattr(fn, "apply", refuse)
    cfg = dataclasses.replace(ref["cfg"], linear_impl="fused", attn_impl="flash")
    params = _port_params(ref)
    with torch.no_grad():
        lm_loss(params, _port_batch(ref), cfg)
    lm_loss(params, _port_batch(ref), cfg)      # no leaf requires grad
    params["seg0"]["mlp"]["w_up"].requires_grad_(True)
    with pytest.raises(AssertionError, match="Function taken"):
        lm_loss(params, _port_batch(ref), cfg)


@pytest.mark.parametrize("argv,slice_name", [
    (["--resume"], "checkpoint"), (["--checkpoint-every", "5"], "checkpoint"),
    (["--data", "2"], "parallelism")])
def test_train_launcher_refuses_unported_flags(argv, slice_name):
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match=slice_name):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu", *argv])


def test_train_launcher_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
